"""The shared-memory plan of the PolyGaussian NUTS kernels
(``samplers/nuts_cuda.py::poly_smem_plan``).

A launch with the Recipe's surrogate density stages the first ``rows``
features of the coefficients WT in a block's shared memory, beside the
density's own buffers (the integer tables hold three indices a feature and
three a sparse-row entry) and, when they still fit, the checkpoint stacks.
The plan is computed on the host and passed to ``csrc/nuts.cu`` in the
launch's double arguments, so these CPU tests hold it: at the DES-like
Recipe's shape (27 parameters, 457 outputs, 73 features) float32 stages all
of WT and the stacks, float64 a part of WT and streams the rest in tiles;
with the cubic surrogate (238 features) both stage a part and stream the
rest; and no plan ever asks for more than a block may have (232,448 bytes
on sm_90). The spec's cache key follows the
surrogate's own input scales.
"""

import numpy as np
import pytest

from bayesfast_tpu_torch import config as tconfig
from bayesfast_tpu_torch.ops.densities import DENSITY_IDS, poly_gaussian_spec
from bayesfast_tpu_torch.samplers import nuts_cuda as nc

LIMIT = 232448
# the DES-like Recipe's surrogate: linear in 27 parameters, quadratic in 9
DES_D, DES_M, DES_NL = 27, 457, np.arange(9)


@pytest.fixture(autouse=True, scope='module')
def _on_cpu():
    """The port runs on the GPU unless asked: these tests ask for the CPU."""
    old = tconfig.set_device('cpu')
    yield
    tconfig.set_device(old)


def _des_scalars(M=DES_M, full=False, cubic=False):
    """The launch scalars of a DES-shaped PolyGaussian spec (random
    coefficients, seeded); ``cubic`` adds the cubic-2 and cubic-3 configs
    on the nine nonlinear parameters."""
    rng = np.random.default_rng(0)
    n = DES_NL.size
    widths = {'quadratic': n * (n + 1) // 2, 'cubic-2': n * n,
              'cubic-3': n * (n - 1) * (n - 2) // 6}
    orders = ['quadratic'] + (['cubic-2', 'cubic-3'] if cubic else [])
    configs = [('linear', np.arange(DES_D), np.arange(M),
                rng.normal(size=(M, DES_D + 1)))] + [
        (o, DES_NL, np.arange(M), rng.normal(size=(M, widths[o])))
        for o in orders]
    prec = np.eye(M) if full else None
    spec = poly_gaussian_spec(DES_D, configs, M, np.zeros(M),
                              None if full else np.ones(M), 0.0, prec=prec)
    return spec['scalars']


def _plan(scalars, itemsize, depth=10, **kw):
    M, F, NNZ = (int(v) for v in scalars[2:5])
    return nc.poly_smem_plan(DES_D, M, F, NNZ, bool(scalars[9]), depth,
                             itemsize, **kw)


def test_des_float32_stages_all_of_wt_and_the_stacks():
    sc = _des_scalars()
    assert tuple(int(v) for v in sc[2:5]) == (457, 73, 117)
    plan = _plan(sc, 4)
    # 7,744 elements of the density's own buffers, 64 of the scales, the
    # integer tables' 600 (3 x 73 + 28 + 3 x 117 ints) and 8 warps x 256 of
    # the back pass's scratch, 457 rows of 76 (73 features in whole 16-byte
    # vectors, an odd count of them), 8 warps x 9 frames x 111
    assert plan == dict(rows=73, row_stride=76, stacks_smem=True,
                        bytes=(7744 + 64 + 600 + 8 * 256 + 457 * 76
                               + 8 * 9 * 111) * 4)
    assert plan['bytes'] == 212720 <= LIMIT
    # the launch spec's own plan is the same
    dens_id = DENSITY_IDS['poly_gaussian']
    assert nc._spec_plan(dens_id, sc, DES_D, 10, 4) == plan


def test_des_float64_stages_part_of_wt():
    sc = _des_scalars()
    # WT does not fit: the streamed path, two tiles of 16 features (58,496
    # bytes each) and 6 features staged beside 80 KB of the density's own
    # buffers and scratch, phi padded to 6 + 5 x 16 = 86 features (88 a
    # warp, 12 more than 76); the 64 KB of stacks stay in global scratch
    plan = _plan(sc, 8)
    assert plan == dict(rows=6, row_stride=6, stacks_smem=False,
                        bytes=(10028 + 8 * 12 + 457 * 6 + 2 * 457 * 16) * 8,
                        stream=True, tile=16, tile_bytes=457 * 16 * 8)
    assert plan['bytes'] <= LIMIT
    # without tiles each chain reads the unstaged features: the coefficients
    # get the room, 38 of 73 features; the stacks, which would leave room
    # for 22, stay in global scratch
    untiled = _plan(sc, 8, tile=0)
    assert untiled == dict(rows=38, row_stride=38, stacks_smem=False,
                           bytes=(10028 + 457 * 38) * 8)
    assert (10028 + 457 * 38 + 7992) * 8 > LIMIT
    assert (10028 + 457 * 22 + 7992) * 8 <= LIMIT


def test_float32_at_m_2000_stages_part_of_wt():
    sc = _des_scalars(M=2000)
    plan = _plan(sc, 4)
    assert 0 < plan['rows'] < 73 and plan['rows'] % 4 == 0
    assert plan['bytes'] <= LIMIT
    # four features more would not fit even without the stacks
    assert plan['bytes'] + 2000 * 4 * 4 > LIMIT
    # the full-precision likelihood's buffers leave less room
    full = _plan(_des_scalars(M=2000, full=True), 4)
    assert full['rows'] < plan['rows']


def test_a_plan_of_no_rows_is_legal():
    # M = 5000 in float32: the density's own buffers and the stacks fit,
    # one 16-byte vector of features for every output does not
    plan = nc.poly_smem_plan(DES_D, 5000, 73, 117, False, 10, 4)
    assert plan == dict(rows=0, row_stride=0, stacks_smem=True,
                        bytes=plan['bytes'])
    assert plan['bytes'] <= LIMIT
    fargs = nc._fargs(1000., 0.5, (1., 2., 5000, 73, 117, 1, 1, 3., 9., 0),
                      (0., 0., 0., 0.), plan)
    # rows, bytes, stacks; then not the streamed path (two tiles of 5000
    # outputs do not fit either), no tile
    assert fargs[16:] == [0.0, float(plan['bytes']), 1.0, 0.0, 0.0, 0.0]
    # buffers that alone exceed a block raise before any launch
    with pytest.raises(ValueError, match='shared memory'):
        nc.poly_smem_plan(DES_D, 20000, 73, 117, True, 10, 4)


@pytest.mark.parametrize('itemsize', [4, 8])
def test_no_plan_exceeds_a_block(itemsize):
    n = 16 // itemsize
    cap = LIMIT // itemsize
    for D in (1, 5, 27, 32, 33, 64):
        for M in (1, 10, 457, 2000, 5000):
            for F in (1, 7, 73, 300):
                for full in (False, True):
                    for depth in (1, 5, 10, 15):
                        try:
                            p = nc.poly_smem_plan(D, M, F, 2 * F, full,
                                                  depth, itemsize)
                        except ValueError:
                            continue
                        r = p['rows']
                        assert p['bytes'] <= LIMIT
                        assert 0 <= r <= F
                        assert r == F or r % n == 0
                        rs = p['row_stride']
                        assert rs == nc._coef_stride(r, itemsize)
                        assert rs >= r and rs % n == 0
                        # an odd count of vectors a row: conflict-free
                        assert r == 0 or (rs // n) % 2 == 1
                        stacks = 8 * max(depth - 1, 1) * (4 * D + 3)
                        if not p['stacks_smem']:
                            assert p['bytes'] // itemsize + stacks > cap


def test_fargs_carry_the_plan():
    sc = _des_scalars()
    plan = _plan(sc, 4)
    fargs = nc._fargs(1000., -1.5, sc, (0.8, 0.05, 0.75, 10.), plan)
    assert len(fargs) == 8 + nc._N_EXTRA == 22
    assert fargs[:8] == [1000., -1.5, float(sc[0]), float(sc[1]), 0.8, 0.05,
                         0.75, 10.]
    # M, F, NNZ, bound on, decay on, alpha, alpha^2, full; then the plan's
    # rows staged, bytes and stacks in shared memory, path (all of WT
    # staged: not the streamed tiles), features a tile and a tile's bytes,
    # which the launch holds against the kernel's own layout
    assert fargs[8:16] == [float(v) for v in sc[2:]]
    assert fargs[16:] == [73.0, 212720.0, 1.0, 0.0, 0.0, 0.0]
    # a banana spec has no plan, and its extra slots stay zero
    dens_id = DENSITY_IDS['banana']
    assert nc._spec_plan(dens_id, (0.01, 3.0), 32, 10, 4) is None
    fb = nc._fargs(1000., 0., (0.01, 3.0), (0., 0., 0., 0.), None)
    assert fb[2:4] == [0.01, 3.0] and fb[8:] == [0.0] * nc._N_EXTRA


def test_coef_stride_puts_rows_on_distinct_bank_groups():
    # the 8 rows that one 16-byte load phase reads start in 8 distinct
    # 16-byte slots of the 128-byte bank line
    for itemsize in (4, 8):
        for rows in range(1, 200):
            rs = nc._coef_stride(rows, itemsize)
            slots = {(j * rs * itemsize // 16) % 8 for j in range(8)}
            assert len(slots) == 8, (itemsize, rows, rs)
    assert nc._coef_stride(0, 4) == 0


@pytest.mark.parametrize('itemsize', [4, 8])
def test_des_cubic_stages_part_of_wt(itemsize):
    """The cubic DES-like surrogate (linear on 27, quadratic, cubic-2 and
    cubic-3 on 9: 28 + 45 + 81 + 84 features): WT is 435 KB in float32 and
    870 KB in float64, more than a block in either, so both stage a part
    and stream the rest through two tiles (32 features in float32, 16 in
    float64), whose room comes from the staged features; without tiles
    (tile 0) each chain reads the rest from device memory. The integer
    tables count three indices a feature and three a sparse-row entry."""
    sc = _des_scalars(cubic=True)
    M, F, NNZ = (int(v) for v in sc[2:5])
    # sparse-row entries: 27 linear, 2 x 45 quadratic, 3 x (81 + 84) cubic
    assert (M, F, NNZ) == (457, 238, 27 + 90 + 495)
    n = 16 // itemsize
    ints = -(-(3 * F + DES_D + 1 + 3 * NNZ) * 4 // itemsize)
    ints = -(-ints // 4) * 4

    def own(n_phi):  # phi is padded to the last tile's end
        return (2 * 32 * (32 + n) + 64
                + 8 * (32 + 36 + n_phi + 240 + 256 + 460) + ints)

    for tile, rows, n_phi in {4: ((32, 28, 252), (0, 92, 240)),
                              8: ((16, 0, 240), (0, 30, 240))}[itemsize]:
        plan = _plan(sc, itemsize, tile=tile)
        assert plan['rows'] == rows and rows < F and rows % n == 0
        assert plan.get('tile', 0) == tile
        assert not plan['stacks_smem']
        assert plan['bytes'] == (own(n_phi) + M * plan['row_stride']
                                 + 2 * M * tile) * itemsize
        assert plan['bytes'] <= LIMIT
        # the next whole vector of features would not fit
        more = nc._poly_layout(DES_D, M, F, NNZ, False, 10, itemsize,
                               rows + n, tile)
        assert more['bytes'] > LIMIT
    assert _plan(sc, itemsize) == _plan(sc, itemsize,
                                        tile=nc._TILE[itemsize])


def test_kernel_spec_key_follows_the_surrogate_scales():
    """A new set of the surrogate's input scales, and nothing else, gives a
    new key and a new spec (its lo and diff in the packed vector)."""
    import torch
    from bayesfast_tpu_torch import Density, Module
    from bayesfast_tpu_torch.modules import Gaussian, PolyConfig, PolyModel
    from bayesfast_tpu_torch.samplers.nuts_cuda import _spec_for
    D, M = 3, 4
    rng = np.random.default_rng(2)
    su = PolyModel([PolyConfig('linear'), PolyConfig('cubic-3')],
                   input_size=D, output_size=M, input_vars='x',
                   output_vars='m',
                   input_scales=np.stack([-np.ones(D), np.ones(D)]).T)
    for c in su.configs:
        c._a = rng.normal(size=(M, c.n_features))
    like = Gaussian(mean=np.zeros(M), cov=np.ones(M), input_vars='m',
                    output_vars='logp')
    # the surrogate takes the place of the first module, the model
    model = Module(fun=lambda x: x[..., :1].expand(-1, M), input_vars='x',
                   output_vars='m')
    den = Density(density_name='logp', module_list=[model, like],
                  surrogate_list=[su], input_vars='x', input_shapes=[D],
                  use_surrogate=True)
    assert den.has_kernel_spec
    like_t = torch.zeros(2, D, dtype=torch.float64)
    key_1, packed_1 = den.kernel_spec_key(), _spec_for(den, like_t)[2]
    su.input_scales = np.stack([-2 * np.ones(D), np.ones(D)]).T
    key_2, packed_2 = den.kernel_spec_key(), _spec_for(den, like_t)[2]
    assert key_1 != key_2 and not torch.equal(packed_1, packed_2)
    spec = den.kernel_spec()
    np.testing.assert_array_equal(spec['arrays']['slo'].numpy(),
                                  -2 * np.ones(D))
    np.testing.assert_array_equal(spec['arrays']['sdiff'].numpy(),
                                  3 * np.ones(D))
    su.input_scales = None
    assert den.kernel_spec_key() not in (key_1, key_2)
    np.testing.assert_array_equal(den.kernel_spec()['arrays']['sdiff'],
                                  np.ones(D))


def test_no_spec_beyond_64_dimensions():
    # past D = 64 the spec holds up to the kernels' D = 256 (its units at
    # NE = 3..8, csrc/nuts_poly.cuh), and raises past that
    spec = poly_gaussian_spec(65, [('linear', np.arange(65), np.arange(2),
                                    np.zeros((2, 66)))], 2, np.zeros(2),
                              np.ones(2), 0.0)
    assert spec['dim'] == 65 and spec['density'] == 'poly_gaussian'
    with pytest.raises(NotImplementedError, match='D <= 256'):
        poly_gaussian_spec(257, [('linear', np.arange(257), np.arange(2),
                                  np.zeros((2, 258)))], 2, np.zeros(2),
                           np.ones(2), 0.0)
