"""The port's host pool for external true models (``utils.parallel``).

A process-backend map of an external module: the workers come from a
forkserver whose template preloads torch and ``bayesfast_tpu_torch``, and
none of them imports jax or initializes CUDA. This module imports no jax
itself, so that the workers, which import it to unpickle the model, stay
free of it. A process has one forkserver, whose preloads the first pool to
start it fixes, so each check runs in a fresh interpreter: another test in
the same process (the JAX package's pool preloads jax) cannot decide it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bayesfast_tpu_torch as bt
from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.utils import parallel


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


def external_model(x):
    """A true model that reports where it ran: its output, then whether its
    process has jax, torch and this package loaded, and a CUDA context."""
    return np.concatenate([
        np.asarray(x) ** 2,
        [float('jax' in sys.modules), float('torch' in sys.modules),
         float('bayesfast_tpu_torch' in sys.modules),
         float(torch.cuda.is_initialized())]])


def _external_map():
    """Map ``external_model`` over a 2-worker process pool; returns the
    outputs and the workers' flags."""
    D = 3
    mod = bt.Module(fun=external_model, input_vars='x',
                    output_vars=['m', 'flags'], input_shapes=[D],
                    output_shapes=[D, 4], traceable=False)
    pipe = bt.Pipeline(module_list=[mod], input_vars='x', input_shapes=[D])
    x = np.arange(12.0).reshape(4, D)
    old = parallel.get_backend()
    parallel.set_backend((2, 'processes'))
    try:
        assert parallel.get_backend().kind == 'processes'
        vds = pipe.fun(x)
    finally:
        parallel.set_backend(old)
    m = np.stack([vd.fun['m'] for vd in vds])
    np.testing.assert_array_equal(m, x ** 2)
    return np.stack([vd.fun['flags'] for vd in vds])


def _run_fresh(code):
    """Run ``code`` in a fresh interpreter that imports this module as
    ``tp``; fails with its output unless it exits 0."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here, os.path.dirname(here), os.environ.get('PYTHONPATH', '')]))
    pre = ('import warnings\n'
           'import numpy as np\n'
           'import test_torch_parallel as tp\n'
           "tp.tconfig.set_device('cpu')\n")
    out = subprocess.run([sys.executable, '-c', pre + code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_process_backend_external_map():
    # no jax, torch and the port preloaded, no CUDA context, in every
    # worker; once the port's pool has started the server, a later preload
    # list (the JAX package's) changes nothing, and new workers stay as
    # they were
    _run_fresh(
        'from multiprocessing import forkserver\n'
        'with warnings.catch_warnings():\n'
        "    warnings.simplefilter('error')\n"
        '    flags = tp._external_map()\n'
        "    forkserver.set_forkserver_preload(['numpy', 'jax'])\n"
        '    assert tp.parallel._foreign_forkserver() is None\n'
        '    tp.parallel._shutdown_proc_pools()\n'
        '    flags2 = tp._external_map()\n'
        'np.testing.assert_array_equal(flags, np.tile([0., 1., 1., 0.], '
        '(4, 1)))\n'
        'np.testing.assert_array_equal(flags2, flags)\n')


def test_foreign_forkserver_is_detected():
    # the JAX package's pool starts the forkserver with jax preloaded; the
    # port's pool then warns, takes spawn workers, and they carry no jax
    _run_fresh(
        'from bayesfast_tpu.utils import parallel as jp\n'
        "with jp.ParallelBackend(2, kind='processes') as b:\n"
        '    assert b.map(abs, [-1, -2, -3]) == [1, 2, 3]\n'
        'from multiprocessing import forkserver\n'
        'assert forkserver._forkserver._forkserver_pid is not None\n'
        'assert tp.parallel._foreign_forkserver() == '
        "['numpy', 'jax', 'bayesfast_tpu']\n"
        'with warnings.catch_warnings(record=True) as w:\n'
        "    warnings.simplefilter('always')\n"
        '    flags = tp._external_map()\n'
        "assert any(\"uses 'spawn'\" in str(x.message) for x in w), w\n"
        "assert ('spawn', 2) not in tp.parallel._proc_pools\n"
        "pool = tp.parallel._proc_pools['forkserver', 2]\n"
        "assert pool._mp_context.get_start_method() == 'spawn'\n"
        'np.testing.assert_array_equal(flags, np.tile([0., 1., 1., 0.], '
        '(4, 1)))\n')


def test_thread_and_serial_backends_agree():
    D = 3
    mod = bt.Module(fun=lambda x: np.asarray(x) ** 2 + 1.0, input_vars='x',
                    output_vars='m', input_shapes=[D], output_shapes=[D],
                    traceable=False)
    pipe = bt.Pipeline(module_list=[mod], input_vars='x', input_shapes=[D])
    x = np.linspace(-1, 1, 15).reshape(5, D)
    old = parallel.get_backend()
    outs = []
    try:
        for backend in (parallel.ParallelBackend(serial=True), 3, None):
            parallel.set_backend(backend)
            outs.append(np.stack([vd.fun['m'] for vd in pipe.fun(x)]))
    finally:
        parallel.set_backend(old)
    for o in outs:
        np.testing.assert_array_equal(o, x ** 2 + 1.0)
    with pytest.raises(ValueError):
        parallel.ParallelBackend(kind='gpus')
