"""The launch shape of the CUDA NUTS kernels (``csrc/nuts_launch.cuh``:
``launch_shape``, which ``csrc/nuts_kernels.cuh::launch_kernel`` launches
by), built from its header with the host's C++ compiler and checked on the
CPU: a density that each warp evaluates alone takes the smallest power of
two ``w`` with ``ceil(C / w) <= 132`` on a card of 132 SMs (8 when none
below 8 does), a collective one (its functor has ``drain``: the
PolyGaussian surrogate, ``PolyBlock``, a traced density whose matrices
stream through shared tiles) keeps 8; and the shared-memory bytes a launch
asks for hold exactly its ``w`` checkpoint stacks when they fit.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.core.density import DensityLite
from bayesfast_tpu_torch.samplers import nuts_cuda as tnc

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'bayesfast_tpu_torch', 'csrc')
_MAX_SMEM = 232448
_SHIM = """#include "nuts_launch.cuh"
extern "C" void shape(int C, int D, int maxdepth, long long dens_elems,
                      int itemsize, int per_warp, int n_sm, long long* out) {
  const LaunchShape s = launch_shape(C, D, maxdepth, (size_t)dens_elems,
                                     (size_t)itemsize, per_warp != 0, n_sm);
  out[0] = s.warps;
  out[1] = s.blocks;
  out[2] = s.stk_smem;
  out[3] = (long long)s.bytes;
}
"""


@pytest.fixture(scope='module')
def launch_shape(tmp_path_factory):
    """``launch_shape`` of the header, as (warps, blocks, stk_smem,
    bytes)."""
    cxx = shutil.which('g++') or shutil.which('c++')
    if cxx is None:
        pytest.skip('no C++ compiler on this host')
    d = tmp_path_factory.mktemp('nuts_launch')
    src, lib = d / 'shim.cpp', d / 'shim.so'
    src.write_text(_SHIM)
    subprocess.run([cxx, '-std=c++17', '-shared', '-fPIC', '-I', _CSRC,
                    '-o', str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).shape
    fn.restype = None

    def call(C, D, maxdepth, itemsize, per_warp=True, n_sm=132,
             dens_bytes=0):
        out = (ctypes.c_longlong * 4)()
        fn(int(C), int(D), int(maxdepth),
           ctypes.c_longlong(dens_bytes // itemsize), int(itemsize),
           int(per_warp), int(n_sm), out)
        return dict(warps=out[0], blocks=out[1], stacks_smem=bool(out[2]),
                    bytes=out[3])

    return call


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


# (C, warps a block) of a per-warp density on a card of 132 SMs
RULE = ((1, 1), (16, 1), (64, 1), (132, 1), (133, 2), (256, 2), (1024, 8),
        (4096, 8))


@pytest.mark.parametrize('C, w', RULE)
def test_per_warp_density_spreads_few_chains(launch_shape, C, w):
    shape = launch_shape(C, 48, 10, 8)
    assert shape['warps'] == w and shape['blocks'] == -(-C // w)
    assert shape['blocks'] <= 132 or w == 8
    # on a card of fewer SMs the same rule takes more warps a block
    assert launch_shape(C, 48, 10, 8, n_sm=16)['warps'] == next(
        (v for v in (1, 2, 4) if -(-C // v) <= 16), 8)


def _streamed_density():
    """A D = 4 density with a 4 x 990 matrix: its adjoint's rows stream
    through shared tiles (``ops/codegen.py::_Layout``)."""
    W = torch.as_tensor(np.random.default_rng(2).normal(size=(4, 990)))

    def logp(x):
        return torch.sum(torch.exp(0.01 * (x @ W.to(x))), -1)

    return DensityLite(logp=logp, input_size=4)


def _struct(header, name):
    """The body of ``struct name`` in a header of csrc/."""
    with open(os.path.join(_CSRC, header)) as f:
        text = f.read()
    start = text.index(f'struct {name} {{')
    return text[start:text.index('\n};', start)]


def _drains(density, dim):
    """Whether the generated functor of ``density`` (float64) has a
    ``drain``, which makes it collective (``nuts_kernels.cuh::kPerWarp``)."""
    like = torch.zeros(64, dim, dtype=torch.float64)
    program = tnc._spec_entry(density, like)[2]['program']
    return 'void drain()' in program.source(torch.float64)


def test_collective_densities_keep_eight_warps(launch_shape):
    assert launch_shape(64, 4, 10, 8, per_warp=False)['warps'] == 8
    assert launch_shape(1, 4, 10, 8, per_warp=False)['blocks'] == 1
    # the surrogate's functors meet their block at barriers; the compiled-in
    # banana, Gaussian and anchors do not
    for name in ('PolyGaussian', 'PolyBlock'):
        assert 'void drain()' in _struct('nuts_poly.cuh', name)
    for name in ('Banana', 'Gaussian', 'Funnel', 'Ring', 'Cauchy'):
        assert 'drain' not in _struct('nuts_densities.cuh', name)
    # a traced density is collective when its matrices stream
    assert _drains(_streamed_density(), 4)
    small = DensityLite(logp=lambda x: -0.5 * torch.sum(x * x, -1),
                        input_size=4)
    assert not _drains(small, 4)


@pytest.mark.parametrize('C, D, depth, itemsize, dens_bytes', [
    (64, 48, 10, 8, 0), (201, 48, 8, 8, 0), (1024, 64, 10, 8, 0),
    (64, 256, 12, 8, 0), (1024, 256, 12, 8, 0), (256, 32, 10, 4, 9728)])
def test_launch_bytes_hold_the_warps_stacks(launch_shape, C, D, depth,
                                            itemsize, dens_bytes):
    shape = launch_shape(C, D, depth, itemsize, dens_bytes=dens_bytes)
    w = shape['warps']
    # a stack holds max(depth - 1, 1) frames of 4 D + 3 values
    frames = max(depth - 1, 1) * (4 * D + 3) * itemsize
    fit = dens_bytes + w * frames <= _MAX_SMEM
    assert shape['stacks_smem'] == fit
    assert shape['bytes'] == dens_bytes + (w * frames if fit else 0)
    # at D = 256, depth 12, float64 eight stacks are past a block; one fits
    if (C, D) == (64, 256):
        assert w == 1 and fit
    if (C, D) == (1024, 256):
        assert w == 8 and not fit
