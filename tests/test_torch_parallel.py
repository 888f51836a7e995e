"""The port's host pool for external true models (``utils.parallel``).

A process-backend map of an external module: the workers come from a
forkserver whose template preloads torch and ``bayesfast_tpu_torch``, and
none of them imports jax or initializes CUDA. This module imports no jax
itself, so that the workers, which import it to unpickle the model, stay
free of it.
"""

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


def test_process_backend_external_map():
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
    flags = np.stack([vd.fun['flags'] for vd in vds])
    np.testing.assert_array_equal(m, x ** 2)
    # no jax, torch and the port preloaded, no CUDA context, in every worker
    np.testing.assert_array_equal(flags, np.tile([0., 1., 1., 0.], (4, 1)))


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
