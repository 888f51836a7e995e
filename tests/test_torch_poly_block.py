"""The block-wide PolyGaussian past D = 64 (``csrc/nuts_poly.cuh::PolyBlock``)
on the CPU: its shared-memory plan and its units.

At NE = 3..8 (D 65..256) the block evaluates the density for its eight
chains together: the Hessians' and WT's products are split over the
block's threads, each chain's own sums stay with its warp. The plan
(``samplers/nuts_cuda.py::poly_smem_plan`` / ``_poly_layout``) lays the
block out as the kernel does, and the launch refuses any other layout, so
these tests hold it against ``PolyBlock``'s layout written out here from
the header (the scales, 64 bytes of control words, each chain's x, xa,
phi, gphi, red and g buffers and r and m at full precision, the integer
tables, the staged features and the two tiles): at the wide Recipe's shape
(D = 100, M = 457, F = 146) and at D = 72 and 250 in float32 and float64,
within a block's 232,448 bytes; every plan past D = 64 on the block-wide
schedule, none at D <= 64; the unit sources at NE = 3..8 name it. The
kernels' outputs are held bitwise against the unchanged plain version on
the card (``chip_smoke.py`` [17a]); the plain version's parity with the
Pallas kernels at D = 72 / 100 is ``tests/test_torch_wide_plan.py``'s.
"""

import pytest
import torch

from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.samplers import nuts_cuda as nc

LIMIT = 232448
NL = 9  # the wide Recipe's nonlinear parameters (quadratic in them)


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


def _wide_shape(D, M=457):
    """(M, F, NNZ) of the wide Recipe's surrogate at D parameters
    (``examples/wide_recipe.py``): D + 1 linear features, NL (NL + 1) / 2
    quadratic; a sparse-row entry a linear feature, two a quadratic."""
    return M, D + 1 + NL * (NL + 1) // 2, D + NL * (NL + 1)


def _up4(n):
    return (n + 3) // 4 * 4


def _block_bytes(D, M, F, NNZ, full, depth, itemsize, rows, tile):
    """``PolyBlock::smem_elems`` (and the stacks of ``launch_kernel``) as
    ``csrc/nuts_poly.cuh`` writes them, in bytes."""
    P = 32 * -(-D // 32)
    kvec = 16 // itemsize
    nt = -(-(F - rows) // tile) if tile else 0
    n_phi = _up4(rows + nt * tile if tile else F)
    o_phi = P + _up4(P + 1)
    o_red = o_phi + n_phi + _up4(F)
    warp = o_red + 2 * P + (3 if full else 1) * _up4(M)
    ints = _up4(-(-(3 * F + D + 1 + 3 * NNZ) * 4 // itemsize))
    v = -(-rows // kvec)
    rs = 0 if rows <= 0 else (v + 1 if v % 2 == 0 else v) * kvec
    ctl = 64 // itemsize
    own = (2 * P + ctl + 8 * warp + ints + M * rs + 2 * M * tile) * itemsize
    stacks = 8 * max(depth - 1, 1) * (4 * D + 3) * itemsize
    return own + stacks if own + stacks <= LIMIT else own, \
        own + stacks <= LIMIT


@pytest.mark.parametrize('itemsize', [4, 8], ids=['float32', 'float64'])
@pytest.mark.parametrize('D', [72, 100, 250])
def test_block_plan_matches_the_kernel_layout(D, itemsize):
    """At D = 72, 100 (the wide Recipe) and 250, float32 and float64: the
    plan is on the block-wide schedule (``block``; the Hessians in device
    memory), its bytes are PolyBlock's layout of its rows and tile, within
    a block, and one more vector of staged features would not fit."""
    M, F, NNZ = _wide_shape(D)
    plan = nc.poly_smem_plan(D, M, F, NNZ, False, 10, itemsize)
    assert plan['block'] is True and plan['hess_smem'] is False
    tile = plan.get('tile', 0)
    want, stk = _block_bytes(D, M, F, NNZ, False, 10, itemsize,
                             plan['rows'], tile)
    assert plan['bytes'] == want and plan['stacks_smem'] == stk
    assert plan['bytes'] <= LIMIT
    assert plan['row_stride'] % (16 // itemsize) == 0
    if plan['rows'] < F:
        n = 16 // itemsize
        assert _block_bytes(D, M, F, NNZ, False, 10, itemsize,
                            plan['rows'] + n, tile)[0] > LIMIT
    if tile:
        assert plan['stream'] and plan['tile'] == nc._TILE[itemsize]
        assert plan['tile_bytes'] == M * tile * itemsize < 1 << 20


def test_wide_recipe_plan_keeps_its_tiles():
    """The wide Recipe's plan at D = 100 streams through the dtype's tiles
    beside 36 staged features in float32 and 6 in float64 (the staged
    counts of the per-warp layout: the block-wide buffers fit in the same
    room); at D = 250 float64 no two tiles fit, and the block reads the
    features past the staged ones from device memory."""
    p32 = nc.poly_smem_plan(100, *_wide_shape(100), False, 10, 4)
    p64 = nc.poly_smem_plan(100, *_wide_shape(100), False, 10, 8)
    assert (p32['rows'], p32['tile']) == (36, 32)
    assert (p64['rows'], p64['tile']) == (6, 16)
    p250 = nc.poly_smem_plan(250, *_wide_shape(250), False, 10, 8)
    assert 'stream' not in p250 and 0 < p250['rows'] < _wide_shape(250)[1]


@pytest.mark.parametrize('full', [False, True], ids=['diag', 'full'])
@pytest.mark.parametrize('itemsize', [4, 8], ids=['float32', 'float64'])
def test_every_plan_past_64_is_block_wide(itemsize, full):
    """Every plan at D 65..256 (any lane width, any path) takes the
    block-wide schedule and matches PolyBlock's layout; none at D <= 64
    (csrc/nuts.cu's PolyGaussian, whose plan is as before)."""
    M = 120 if full else 457
    for D in (65, 96, 97, 128, 160, 192, 224, 256):
        _, F, NNZ = _wide_shape(D)
        for depth in (6, 10):
            plan = nc.poly_smem_plan(D, M, F, NNZ, full, depth, itemsize)
            assert plan.get('block') is True, (D, plan)
            want, stk = _block_bytes(D, M, F, NNZ, full, depth, itemsize,
                                     plan['rows'], plan.get('tile', 0))
            assert (plan['bytes'], plan['stacks_smem']) == (want, stk)
            assert plan['bytes'] <= LIMIT
    for D in (27, 64):
        plan = nc.poly_smem_plan(D, M, 73, 117, full, 10, itemsize)
        assert 'block' not in plan and 'hess_smem' not in plan


@pytest.mark.parametrize('ne', range(3, 9))
def test_units_name_the_block_schedule(ne):
    """Every unit at NE = 3..8, both dtypes and paths, says that the block
    evaluates its chains together (``PolyBlock``) and instantiates
    ``launch_poly_unit`` at its lane width."""
    for dt, real in ((torch.float32, 'float'), (torch.float64, 'double')):
        for stream in (False, True):
            src = nc.poly_unit_source(32 * ne, dt, stream)
            assert 'PolyBlock' in src
            assert f'launch_poly_unit<{real}, {ne}, ' in src

