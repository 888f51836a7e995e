"""The streamed path of the PolyGaussian NUTS kernels
(``samplers/nuts_cuda.py::poly_smem_plan``, ``_stream_tiles``,
``_stream_params``; ``csrc/nuts.cu::PolyGaussian<T, NE, true>``).

When the coefficients WT do not fit in a block's shared memory, a launch
stages the first ``rows`` features and streams the others through two
shared-memory tiles of ``tile`` features, which the block's eight chains
share: each tile row is one output's features, its 16-byte vectors
swizzled so that the rows of one load phase sit on distinct bank groups.
The kernel cannot run here, so these CPU tests hold what it is given and
the order it sums in: the plan's arithmetic and fields, the tiles'
layout, the packed parameters it reads them from, and a torch emulation
of its sums (the staged features, then the tiles in order) that must give
the plain version's logp and gradient bit for bit at the cubic DES-like
shape (27 parameters, 457 outputs, 238 features).
"""

import numpy as np
import pytest
import torch

from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.ops import densities
from bayesfast_tpu_torch.ops.densities import DENSITY_IDS, poly_gaussian_spec
from bayesfast_tpu_torch.samplers import nuts_cuda as nc

LIMIT = 232448
DES_D, DES_M, DES_NL = 27, 457, np.arange(9)


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


def _cubic_spec(seed=0, bound=True, decay=True):
    """A cubic DES-shaped PolyGaussian spec (linear on 27, quadratic,
    cubic-2 and cubic-3 on 9), seeded coefficients scaled to keep the
    likelihood finite at the test points."""
    rng = np.random.default_rng(seed)
    n = DES_NL.size
    widths = {'quadratic': n * (n + 1) // 2, 'cubic-2': n * n,
              'cubic-3': n * (n - 1) * (n - 2) // 6}
    configs = [('linear', np.arange(DES_D), np.arange(DES_M),
                rng.normal(size=(DES_M, DES_D + 1)) / 10)] + [
        (o, DES_NL, np.arange(DES_M), rng.normal(size=(DES_M, w)) / 30)
        for o, w in widths.items()]
    H = rng.normal(size=(DES_D, DES_D))
    b = dict(mu=rng.normal(size=DES_D) / 10, hess=H @ H.T / DES_D,
             alpha=2.0, f_mu=rng.normal(size=DES_M)) if bound else None
    dc = dict(mu=np.zeros(DES_D), hess=np.eye(DES_D), alpha_2=20.0,
              gamma=3.0) if decay else None
    return poly_gaussian_spec(DES_D, configs, DES_M,
                              rng.normal(size=DES_M) / 3,
                              np.full(DES_M, 4.0), -2.5, bound=b, decay=dc)


def _plan(spec, itemsize, depth=10, **kw):
    M, F, NNZ = (int(v) for v in spec['scalars'][2:5])
    return nc.poly_smem_plan(DES_D, M, F, NNZ, bool(spec['scalars'][9]),
                             depth, itemsize, **kw)


def _swz(j, nv):
    """The swizzle of ``PolyGaussian::swl``: the vector of tile row j that
    holds logical vector v is v ^ swz(j)."""
    return j % 8 if nv >= 8 else (j // (8 // nv)) % nv


def _own_elems(F, NNZ, itemsize, n_phi):
    """The density's own shared memory at D = 27, M = 457 (the scales'
    and Hessians' 2 P (P + n) + 2 P, eight warps' buffers, the integer
    tables), in elements."""
    n = 16 // itemsize
    ints = -(-(3 * F + DES_D + 1 + 3 * NNZ) * 4 // itemsize)
    ints = -(-ints // 4) * 4
    warp = 32 + 36 + -(-n_phi // 4) * 4 + -(-F // 4) * 4 + 256 + 460
    return 2 * 32 * (32 + n) + 64 + 8 * warp + ints


@pytest.mark.parametrize('itemsize', [4, 8])
def test_des_cubic_plan_streams(itemsize):
    """Two tiles of ``_TILE[itemsize]`` features take their room from the
    staged features; phi grows to the last tile's padding; the stacks stay
    in device memory; one more 16-byte vector of staged features would
    not fit."""
    spec = _cubic_spec()
    M, F, NNZ = (int(v) for v in spec['scalars'][2:5])
    assert (M, F, NNZ) == (457, 238, 612)
    plan = _plan(spec, itemsize)
    n, tile = 16 // itemsize, nc._TILE[itemsize]
    rows = plan['rows']
    assert plan['stream'] and plan['tile'] == tile
    assert 0 <= rows < F and rows % n == 0
    assert plan['tile_bytes'] == M * tile * itemsize
    n_tiles = -(-(F - rows) // tile)
    own = _own_elems(F, NNZ, itemsize, rows + n_tiles * tile)
    assert plan['bytes'] == (own + M * plan['row_stride']
                             + 2 * M * tile) * itemsize
    assert plan['row_stride'] == nc._coef_stride(rows, itemsize)
    assert not plan['stacks_smem'] and plan['bytes'] <= LIMIT
    more = nc._poly_layout(DES_D, M, F, NNZ, False, 10, itemsize, rows + n,
                           tile)
    assert more['bytes'] > LIMIT
    assert (rows, n_tiles) == {4: (28, 7), 8: (0, 15)}[itemsize]


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('tile', [8, 16, 32])
def test_no_streamed_plan_exceeds_a_block(itemsize, tile):
    n = 16 // itemsize
    for D in (3, 27, 64):
        for M in (5, 457, 1000):
            for F in (40, 238, 400):
                for full in (False, True):
                    try:
                        p = nc.poly_smem_plan(D, M, F, 3 * F, full, 10,
                                              itemsize, tile)
                    except ValueError:
                        continue
                    assert p['bytes'] <= LIMIT
                    if not p.get('stream'):
                        # all of WT staged, or not even two tiles fit
                        assert p['rows'] == F or nc._poly_layout(
                            D, M, F, 3 * F, full, 10, itemsize, 0,
                            tile)['bytes'] > LIMIT
                        assert set(p) == {'rows', 'row_stride',
                                          'stacks_smem', 'bytes'}
                        continue
                    assert p['rows'] < F and p['rows'] % n == 0
                    assert p['tile'] == tile
                    assert p['tile_bytes'] == M * tile * itemsize
                    # all of WT would not fit: streaming only then
                    assert nc._poly_layout(D, M, F, 3 * F, full, 10,
                                           itemsize, F)['bytes'] > LIMIT


def test_a_tile_of_zero_keeps_each_chain_reading():
    spec = _cubic_spec()
    for itemsize, rows in ((4, 92), (8, 30)):
        plan = _plan(spec, itemsize, tile=0)
        assert 'stream' not in plan and plan['rows'] == rows


def test_fargs_carry_the_streamed_plan():
    spec = _cubic_spec()
    sc = spec['scalars']
    plan = _plan(spec, 4)
    fargs = nc._fargs(1000., -1.5, sc, (0.8, 0.05, 0.75, 10.), plan)
    assert len(fargs) == 8 + nc._N_EXTRA == 22
    assert fargs[8:16] == [float(v) for v in sc[2:]]
    # rows staged, bytes, stacks in shared memory; then the path, the
    # features a tile and a tile's bytes, which the launch holds against
    # the kernel's own layout
    assert fargs[16:] == [float(plan['rows']), float(plan['bytes']), 0.0,
                          1.0, float(plan['tile']),
                          float(plan['tile_bytes'])]
    assert nc._spec_plan(DENSITY_IDS['poly_gaussian'], sc, DES_D, 10,
                         4) == plan


@pytest.mark.parametrize('itemsize', [4, 8])
@pytest.mark.parametrize('tile', [8, 16, 32])
def test_stream_tiles_layout(itemsize, tile):
    """Tile t, row j, logical vector v sits at vector v ^ swz(j) and holds
    features rows + t tile + n v .. of output j (zeros past F); the 8 rows
    of a load phase read 8 distinct 16-byte bank groups."""
    dt = torch.float32 if itemsize == 4 else torch.float64
    n, F, M, rows = 16 // itemsize, 53, 37, 8
    WT = torch.arange(1, F * M + 1, dtype=dt).reshape(F, M)
    flat = nc._stream_tiles(WT, rows, tile)
    nt, nv = -(-(F - rows) // tile), tile // n
    assert flat.numel() == nt * M * tile
    t4 = flat.view(nt, M, nv, n)
    for t in range(nt):
        for j in range(M):
            for v in range(nv):
                got = t4[t, j, v ^ _swz(j, nv)]
                for i in range(n):
                    f = rows + t * tile + v * n + i
                    assert got[i] == (WT[f, j] if f < F else 0)
    for v in range(nv):
        for j0 in range(0, M - 8, 8):
            banks = {((j * nv + (v ^ _swz(j, nv))) % 8)
                     for j in range(j0, j0 + 8)}
            assert len(banks) == 8


def test_stream_params_put_the_tiles_where_the_kernel_reads_them():
    """The launch spec's packed vector, zeros to the next multiple of 32
    elements, then the tiles: ``PolyGaussian::locate`` finds them at the
    integer tables' end rounded up to 32."""
    spec = _cubic_spec()
    spec['transform'] = dict(
        lo=torch.zeros(DES_D, dtype=torch.float64),
        width=torch.ones(DES_D, dtype=torch.float64),
        m_lohi=torch.zeros(DES_D, dtype=torch.float64),
        m_lo=torch.zeros(DES_D, dtype=torch.float64),
        m_hi=torch.zeros(DES_D, dtype=torch.float64), logw=0.0)

    class Den:
        has_kernel_spec = True

        def kernel_spec(self):
            return spec

        def kernel_spec_key(self):
            return 'cubic'

    den, like = Den(), torch.zeros(4, DES_D, dtype=torch.float32)
    plan = _plan(spec, 4)
    par = nc._stream_params(den, like, plan)
    dpar = nc._spec_for(den, like)[2]
    M, F, NNZ = (int(v) for v in spec['scalars'][2:5])
    D = DES_D
    # locate(): WT, dat, vinv, fmu, mup, Hp, mud, Hd, lo, diff, then the
    # integer tables
    ints_end = (F * M + 3 * M + D + D * D + D + D * D + 2 * D
                + 3 * F + D + 1 + 3 * NNZ)
    assert dpar.numel() == ints_end
    off = -(-ints_end // 32) * 32
    assert torch.equal(par[:ints_end], dpar)
    assert not par[ints_end:off].any()
    WT = dpar[:F * M].view(F, M)
    assert torch.equal(par[off:], nc._stream_tiles(WT, plan['rows'],
                                                   plan['tile']))
    assert nc._stream_params(den, like, plan) is par


def _streamed_sums(plan, itemsize):
    """The kernel's forward and back sums, emulated: staged features
    first, then each tile's features read back from ``_stream_tiles``
    through the swizzle, padded with zero features; the back pass's
    coefficients read the same way, each feature's sum in the warp's
    order."""
    rows, tile = plan['rows'], plan['tile']
    n = 16 // itemsize

    def read_tiles(WT):
        F, M = WT.shape
        nt, nv = -(-(F - rows) // tile), tile // n
        t4 = nc._stream_tiles(WT, rows, tile).view(nt, M, nv, n)
        j = torch.arange(M)
        feats = []
        for t in range(nt):
            for v in range(nv):
                vec = t4[t, j, v ^ _swz(j, nv)]          # (M, n)
                feats += [vec[:, i] for i in range(n)]
        return torch.stack(feats)                         # (nt tile, M)

    def sums(WT, phi):
        m0 = torch.zeros((phi.shape[0], WT.shape[1]), dtype=phi.dtype)
        for f in range(rows):
            m0 = m0 + WT[f] * phi[:, f:f + 1]
        streamed = read_tiles(WT)
        phi_p = torch.nn.functional.pad(
            phi, (0, rows + streamed.shape[0] - phi.shape[1]))
        for k in range(streamed.shape[0]):
            m0 = m0 + streamed[k] * phi_p[:, rows + k:rows + k + 1]
        return m0

    def grads(WT, gm0):
        W = torch.cat([WT[:rows], read_tiles(WT)[:WT.shape[0] - rows]])
        return densities.warp_sum(W[None] * gm0[:, None, :])

    return sums, grads


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('tile', [None, 8, 16])
def test_streamed_order_is_the_plain_versions_bit_for_bit(monkeypatch,
                                                          dtype, tile):
    """logp and gradient through the streamed sums equal the plain
    version's (``_poly_gaussian_lpg``) bit for bit at the cubic DES-like
    shape, with the bound and the decay on."""
    spec = _cubic_spec()
    itemsize = torch.tensor([], dtype=dtype).element_size()
    plan = _plan(spec, itemsize, tile=tile)
    assert plan['stream']
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(6, DES_D)) * [[0.1], [0.5], [1.],
                                                       [2.], [3.], [4.]],
                        dtype=dtype)
    logp, grad = densities._poly_gaussian_lpg(spec, x)
    assert torch.isfinite(logp).all() and torch.isfinite(grad).all()
    sums, grads = _streamed_sums(plan, itemsize)
    monkeypatch.setattr(densities, '_feature_sums', sums)
    monkeypatch.setattr(densities, '_feature_grads', grads)
    spec.pop('_cast', None)
    logp_s, grad_s = densities._poly_gaussian_lpg(spec, x)
    assert torch.equal(logp_s, logp)
    assert torch.equal(grad_s, grad)
