"""A traced density's matrices past a block's shared memory, streamed
through two shared-memory tiles that the block's eight chains share
(``ops/codegen.py::_Layout``, ``csrc/nuts_device.cuh::tiled_matvec``), on
the CPU.

* The tile schedule: every emitted streamed ``mv`` node in the functor's
  order of evaluation, each node's row groups and column tiles in order,
  covering every (row group, input slot) of its matrix exactly once an
  evaluation; the generated source carries the same table and first
  tiles, its ``TileRing`` and its bulk copies and mbarriers.
* The tiled product's loop order emulated in torch (each tile copied from
  ``launch_params`` as the block copies it, each lane's 32 partial sums
  added slot by slot across the column tiles, then the halving levels) is
  bitwise the interpreter's ``mv`` (``ops/trace.py``: ``warp_sum`` over
  the products), on MVN-250's P^T and P and on the column tiles of a
  D = 4 program's 1000-wide adjoint, in float32 and float64.
* ``check_limits`` counts the two tile buffers beside the x buffers.
* A program with no streamed matrix (the traced bench banana, the donut
  Recipe's plans) generates no tick, drain, tile table, tile step or
  barrier.
"""

import numpy as np
import pytest
import torch

from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.examples.wide_gaussians import mvn_250
from bayesfast_tpu_torch.ops.codegen import (MAX_SMEM, _Layout, _order,
                                             _slots, check_limits,
                                             launch_params)
from bayesfast_tpu_torch.ops.densities import warp_sum
from bayesfast_tpu_torch.ops.trace import TraceError, trace_density


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the
    CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


def _wide(n, seed=2, dtype=torch.float64):
    """A D = 4 program with a 4 x n constant matrix, traced in ``dtype``:
    its forward product reads n rows of 4, its adjoint 32 rows of n
    (column tiles once a row group passes a buffer)."""
    W = torch.as_tensor(np.random.default_rng(seed).normal(size=(4, n)))

    def fn(x):
        return torch.sum(torch.exp(0.01 * (x @ W.to(x))), -1)

    return trace_density(fn, 4, dtype)


def _mvn():
    return mvn_250()[0].kernel_spec()['program']


# (program, dtype, tiles an evaluation, slots a tile): MVN-250's two
# products (8 row groups each, whole rows), the D = 4 program's adjoint in
# float32 (its forward matrix staged) and both of its products in float64,
# and one with an odd count of tiles
CASES = {
    'mvn_f32': (_mvn, torch.float32, 16, 8),
    'mvn_f64': (_mvn, torch.float64, 16, 8),
    'wide_f32': (lambda: _wide(1000), torch.float32, 6, 6),
    'wide_f64': (lambda: _wide(1000), torch.float64, 36, 10),
    'wide_odd_f64': (lambda: _wide(990), torch.float64, 35, 10),
}
_PROGRAMS = {}


def _case(name):
    make, dtype, nt, te = CASES[name]
    if name not in _PROGRAMS:
        _PROGRAMS[name] = make()
    return _PROGRAMS[name], dtype, nt, te


def _streamed(prog, lay):
    """The emitted mv nodes whose matrix streams, in the functor's
    order."""
    return [i for i in _order(prog) if prog.nodes[i].op == 'mv'
            and not lay.mats[lay.mat(prog.nodes[i].attr)][7]]


@pytest.mark.parametrize('name', list(CASES))
def test_schedule_covers_every_tile_once(name):
    """Every streamed product's (row group, input slot) pairs, each
    exactly once an evaluation, node by node in the functor's order, row
    groups and column tiles in order; each tile's offset, row stride and
    width address its part of the padded copy, and its shared-memory row
    stride keeps a load phase's 8 rows on distinct bank groups."""
    prog, dtype, nt, te = _case(name)
    itemsize = dtype.itemsize
    pad = 16 // itemsize
    lay = _Layout(prog, itemsize)
    assert len(lay.tiles) == nt and lay.te == te
    nodes = _streamed(prog, lay)
    assert nodes and [t[0] for t in lay.tiles] == sorted(
        [t[0] for t in lay.tiles], key=nodes.index)
    for i in nodes:
        k0, tw, ts = lay.node_tiles[i]
        mine = [t for t in lay.tiles if t[0] == i]
        assert lay.tiles[k0:k0 + len(mine)] == mine
        _, _, _, n, rows, stride, base, _ = lay.mats[lay.mat(
            prog.nodes[i].attr)]
        ni = _slots(n)
        assert tw == min(ni, te) and ts == 32 * tw + pad
        assert (ts * itemsize) % 128 == 16
        assert 32 * ts <= lay.tile_elems
        seen = []
        for _, o, c, off, st, vecs, tts in mine:
            width = vecs * pad // 32
            assert (st, tts) == (stride, ts) and 1 <= width <= tw
            assert off == base + 32 * o * stride + 32 * c * tw
            assert (off * itemsize) % 16 == 0
            seen += [(o, c * tw + e) for e in range(width)]
        assert seen == [(o, e) for o in range(rows // 32) for e in range(ni)]
    assert lay.l2_bytes() == sum(32 * t[5] * 16 for t in lay.tiles)
    # the source carries the schedule: its table and each product's first
    # tile
    src = prog.source(dtype)
    table = ',\n'.join(f'    {{{t[3]}, {t[4]}, {t[5]}, {t[6]}}}'
                       for t in lay.tiles)
    assert f'__constant__ int kTiles[{nt}][4] = {{\n{table}}};' in src
    for i in nodes:
        k0, tw, ts = lay.node_tiles[i]
        n = lay.mats[lay.mat(prog.nodes[i].attr)][3]
        assert (f'tiled_matvec<Real, {_slots(n)}, ') in src
        assert f', {n}, {tw}, {ts}, {k0}>(*this, xbuf, ' in src
    assert src.count('tiled_matvec<Real') == len(nodes)
    assert 'tile_tick(*this, true);' in src and 'tile_drain(*this)' in src
    # each tile one bulk copy of thread 0 (one a row in column tiles),
    # counted with every thread's arrival on its buffer's mbarrier
    assert 'bulk_tile(tile(t), kTiles[t][3], par + kTiles[t][0]' in src
    assert src.count('mbar_init(tile_bar(') == 2
    assert src.count('kWarps * 32 + 1);') == 2
    assert f'if (s < {nt}) mbar_arrive_wait(tile_bar(s & 1));' in src
    assert '__ldg' not in src and 'true>' not in src
    # nuts_device.cuh's TileRing of nt tiles: an odd count ends in a step
    # that reads no tile, taken once, after the last streamed product
    assert f'struct Traced : TileRing<{nt}> {{' in src
    assert src.count(f'tile_step(*this, {nt});') == nt % 2
    if nt % 2:
        last = src.rindex('tiled_matvec<Real')
        assert src.index(f'tile_step(*this, {nt});') > last


def _tiled_product(lay, i, par, x):
    """Node ``i``'s product as the functor takes it: x in the warp's
    buffer (zeros past n); for each row group its column tiles in the
    schedule's order, each copied as the block copies it (32 rows of
    ``vecs`` 16-byte vectors from the launch's parameters at the tile's
    offset and row stride) into a buffer of its shared-memory row stride;
    lane l's 32 partial sums (row 32 o + l) take slot e's products in
    turn, the first slot's as they are; then the halving levels."""
    C = x.shape[0]
    pad = 16 // par.element_size()
    n = x.shape[1]
    ni = _slots(n)
    xb = torch.nn.functional.pad(x, (0, 32 * ni - n))
    out = {}
    for _, o, c, off, stride, vecs, ts in [t for t in lay.tiles
                                           if t[0] == i]:
        buf = par.new_zeros(32, ts)
        for r in range(32):
            buf[r, :vecs * pad] = par[off + r * stride:
                                      off + r * stride + vecs * pad]
        tw = lay.node_tiles[i][1]
        for ee in range(vecs * pad // 32):
            e = c * tw + ee
            p = buf[None, :, 32 * ee:32 * ee + 32] * \
                xb[:, None, 32 * e:32 * e + 32]
            out[o] = p if e == 0 else out[o] + p
    ys = []
    for o in sorted(out):
        s = out[o]
        for half in (16, 8, 4, 2, 1):
            s = s[..., :half] + s[..., half:2 * half]
        ys.append(s[..., 0])
    return torch.cat(ys, dim=-1).reshape(C, -1)


@pytest.mark.parametrize('name', ['mvn_f32', 'mvn_f64', 'wide_f32',
                                  'wide_f64', 'wide_odd_f64'])
def test_tiled_product_is_the_interpreters(name):
    """The tiled loop order, on the launch's parameters, is the
    interpreter's ``mv`` (``warp_sum`` over the (C, m, n) products) bit
    for bit: MVN-250's P^T and P, the D = 4 program's 1000- and 990-wide
    adjoints in column tiles (and its forward rows in float64)."""
    prog, dtype, _, _ = _case(name)
    lay = _Layout(prog, dtype.itemsize)
    packed = prog.pack(dtype)
    par = launch_params(prog, packed)
    rng = np.random.default_rng(11)
    for i in _streamed(prog, lay):
        idx, tr = prog.nodes[i].attr
        m, n = prog.matrix(idx, tr)
        x = torch.as_tensor(rng.normal(size=(3, n)), dtype=dtype)
        off = prog.offsets[idx]
        m0, n0 = prog.consts[idx][0].shape
        M = packed[off:off + m0 * n0].view(m0, n0)
        M = M.T if tr else M
        want = warp_sum(M[None] * x[:, None, :])
        got = _tiled_product(lay, i, par, x)
        assert torch.equal(got[:, :m], want)
        assert not got[:, m:].any()


def test_check_limits_counts_the_tiles():
    """A 4 x 3500 matrix at D = 4 in float64: its adjoint's x buffers
    (8 warps x 3520 values) fit a block alone, not beside two tiles of
    one slot, and the trace refuses it there; float32 takes it. MVN-250's
    shared memory is its two tiles, the x buffers and the two tiles'
    mbarriers."""
    with pytest.raises(TraceError, match='tile buffers'):
        _wide(3500)
    prog = _wide(3500, dtype=torch.float32)
    lay = _Layout(prog, 8)
    assert 8 * lay.xbuf * 8 <= MAX_SMEM < lay.smem * 8
    assert lay.tile_elems == 32 * (32 + 2)
    with pytest.raises(TraceError, match='tile buffers'):
        check_limits(prog, 8)
    check_limits(prog, 4)
    for itemsize, stride in ((4, 260), (8, 258)):
        lay = _Layout(_mvn(), itemsize)
        assert lay.smem == 2 * 32 * stride + 8 * 256 + 16 // itemsize
        assert lay.tile_off == 0 and lay.xbuf_off == 2 * 32 * stride
        assert lay.bar_off == (2 * 32 * stride + 8 * 256) * itemsize


def _donut_programs():
    """The donut Recipe's two plans (its OptimizeStep's linear surrogate
    and the SampleSteps' quadratic one, then the user's ``f_1`` and the
    decay), traced from the Recipe's objects before any fit."""
    from bayesfast_tpu_torch.examples import donut_recipe
    rec = donut_recipe.build()
    rt, den = rec.recipe_trace, rec.density
    den.use_surrogate = True
    progs = []
    for plan in (rt._s_optimize.surrogate_list,
                 rt._strategy._sample_steps[0].surrogate_list):
        den.surrogate_list = list(plan)
        progs.append(den.kernel_spec()['program'])
    return progs


@pytest.mark.parametrize('which', ['bench_banana', 'donut'])
def test_no_streamed_matrix_no_ticks(which):
    """Every matrix of the traced bench banana and of the donut's plans
    is staged: their sources have no tick, drain, tile table, bulk copy
    or barrier, and their layouts no tile buffers."""
    if which == 'bench_banana':
        from bayesfast_tpu_torch.examples.user_densities import bench_banana
        progs = [bench_banana()[0].kernel_spec()['program']]
    else:
        progs = _donut_programs()
    for prog in progs:
        for dt in (torch.float32, torch.float64):
            lay = _Layout(prog, dt.itemsize)
            assert not lay.tiles and not lay.tile_elems
            assert lay.smem == lay.xbuf_off + 8 * lay.xbuf
            src = prog.source(dt)
            for word in ('tick', 'drain', 'kTiles', 'bar_sync', 'bar_count',
                         'tiled_matvec', 'load_tile', 'tile_step',
                         'TileRing', 'mbar', 'bulk'):
                assert word not in src, (which, dt, word)
