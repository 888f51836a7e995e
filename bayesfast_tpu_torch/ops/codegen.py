"""Write a traced density (``ops/trace.py``'s ``Program``) as a CUDA
density functor, compiled against the NUTS kernels of ``csrc/``.

``cuda_source(program, dtype)`` returns one translation unit: it includes
``csrc/nuts_kernels.cuh``, defines ``struct Traced`` with the interface of
the compiled-in functors of ``csrc/nuts.cu`` (``stage``, ``bind``,
``operator()(x, g)`` returning this lane's part of the logp sum,
``finish``, ``smem_elems``), and exports ``nuts_traced_launch``, which
runs the frozen chunk, warmup chunk or block kernel with it at the one
dtype and lane width NE of the program (``_build.load_traced`` builds and
loads it). The fused bound transform stays in ``TDensity``, which wraps
this functor as it wraps the others. The kernels replace the Pallas
kernels that evaluate a traced jaxpr (``bayesfast_tpu/samplers/
nuts_pallas.py:431``, ``:462``, ``:746``; ``_trace_density``, ``:576``).

Layout: one chain a warp, lane ``l`` holding elements ``l, l + 32, ...``
of every vector (a slot each), each scalar in every lane. The design
rules of the hand-written ``Banana`` hold:

* each constant matrix of a ``mv`` node is staged in shared memory once
  per block, as read (transposed or not), one row a lane, zero-padded, 16
  bytes of padding a row (``row_stride``), and read 16 bytes at a time by
  ``tree_matvec`` through the warp's buffer;
* sums are the xor butterfly (``warp_sum``), so every lane holds the same
  bits and every branch stays warp-uniform; a sum's lane part adds its
  slots in turn, a position past a vector's length as zero, so it rounds
  as ``ops.densities.warp_sum`` pads;
* index ops (one ``gather`` node a fetch) go through ``fetch`` with each
  lane's source positions read once per launch (``bind``) from a table in
  constant memory;
* the gradient's nodes come first, the nodes that only the logp needs
  after the gradient is written; when the logp is a sum followed by
  operations with constants (the banana's ``-sum - const``), the functor
  returns the sum's lane part and ``finish`` applies those operations, so
  the sum goes through the transition's one butterfly with the
  log-Jacobian and kinetic sums.

Every node is one C++ statement (a loop over its slots), in the
program's order of operations; literals are hexadecimal, rounded to the
run dtype as torch rounds a Python number; ``pow`` is already products. A
comparison is ``(a < b) ? 1 : 0`` a slot and a select ``c != 0 ? a : b``
(selects, not branches: a comparison of scalars holds the same bits in
every lane); a scatter-add is its sums in program order, gathers of the
sources added in turn. ``check_limits`` refuses, at the trace, a program
whose staged matrices and warp buffers pass a block's shared memory or
whose gather tables pass the constant memory, so a launch never meets one.
"""

import torch

from .trace import BINARY, CMP, UNARY, TraceError

__all__ = ['cuda_source', 'check_limits']

_UN = {'neg': '-{0}', 'recip': 'Real(1) / {0}', 'exp': 'm_exp({0})',
       'log': 'm_log({0})', 'log1p': 'm_log1p({0})', 'sqrt': 'm_sqrt({0})'}
_BIN = {'add': '+', 'sub': '-', 'mul': '*', 'div': '/'}
_CMP = {'lt': '({0} < {1})', 'le': '({0} <= {1})', 'gt': '({0} > {1})',
        'ge': '({0} >= {1})', 'eq': '({0} == {1})', 'ne': '({0} != {1})',
        'and': '({0} != Real(0) && {1} != Real(0))',
        'or': '({0} != Real(0) || {1} != Real(0))'}
# what one block may hold (csrc/nuts_device.cuh kMaxSmem) and what one
# module's __constant__ data may take
MAX_SMEM = 232448
MAX_CONST = 65536


def _slots(n):
    return max(1, -(-int(n) // 32))


def _lit(attr):
    v = float.fromhex(attr)
    if v != v:
        return 'Real(NAN)'
    if v in (float('inf'), float('-inf')):
        return f'Real({"-" if v < 0 else ""}INFINITY)'
    return f'Real({attr})'


class _Layout:
    """Where the functor keeps things: staged matrices and the warp
    buffer (shared memory), gather tables (constant memory)."""

    def __init__(self, program, itemsize):
        p = program
        self.mats = []            # (idx, tr, m, n, rows, stride, offset)
        off = 0
        xb = 0
        pad = 16 // itemsize
        for nd in p.nodes:
            if nd.op == 'mv' and nd.attr not in [m[:2] for m in self.mats]:
                m, n = p.matrix(*nd.attr)
                rows, stride = 32 * _slots(m), 32 * _slots(n) + pad
                self.mats.append((*nd.attr, m, n, rows, stride, off))
                off += rows * stride
            if nd.op == 'mv':
                xb = max(xb, 32 * _slots(p.nodes[nd.args[0]].n))
        self.xbuf_off, self.xbuf = off, xb
        self.smem = off + 8 * xb   # kWarps buffers
        self.gathers, goff = {}, 0
        for i, nd in enumerate(p.nodes):
            if nd.op == 'gather':
                self.gathers[i] = goff
                goff += 32 * _slots(nd.n)
        self.table = []
        for i, nd in enumerate(p.nodes):
            if nd.op == 'gather':
                codes = [-1] * (32 * _slots(nd.n))
                for j, e in enumerate(nd.attr):
                    if e is not None:
                        codes[j] = e[0] * 1024 + max(e[1], 0)
                self.table += codes

    def mat(self, attr):
        return next(k for k, m in enumerate(self.mats) if m[:2] == attr)


def check_limits(program, itemsize):
    """Raise ``TraceError`` when the functor of ``program`` at
    ``itemsize`` bytes a value does not fit the kernels: its staged
    matrices and warp buffers past a block's shared memory, or its gather
    tables past the constant memory."""
    lay = _Layout(program, itemsize)
    smem, table = lay.smem * itemsize, 4 * len(lay.table)
    if smem > MAX_SMEM:
        raise TraceError(f'the program stages {smem} bytes of matrices in '
                         f'shared memory, past the {MAX_SMEM} a block has')
    if table > MAX_CONST:
        raise TraceError(f'the program\'s gather tables take {table} bytes '
                         f'of constant memory, past its {MAX_CONST}')


def _ancestors(p, roots):
    seen, stack = set(), list(roots)
    while stack:
        i = stack.pop()
        if i not in seen:
            seen.add(i)
            stack.extend(p.nodes[i].args)
    return seen


def _constant_scalar(p, i):
    return p.nodes[i].op in ('lit', 'cscal')


def _tail(p, need_g):
    """(sum node, the chain of nodes from it to the logp) when the logp
    is a sum followed only by operations with constant scalars, none of
    them needed by the gradient; else None."""
    chain, i = [], p.logp
    while i not in need_g:
        nd = p.nodes[i]
        if nd.op == 'sum':
            return i, chain[::-1]
        if nd.op == 'neg':
            chain.append(i)
            i = nd.args[0]
            continue
        if nd.op in BINARY:
            a, b = nd.args
            ca, cb = _constant_scalar(p, a), _constant_scalar(p, b)
            if ca != cb:
                chain.append(i)
                i = b if ca else a
                continue
        return None
    return None


def cuda_source(program, dtype):
    """The CUDA translation unit of ``program`` at ``dtype`` (float32 or
    float64)."""
    p = program
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f'unsupported dtype {dtype}.')
    f64 = dtype == torch.float64
    itemsize = 8 if f64 else 4
    if p.D > 64:
        raise ValueError(f'the CUDA NUTS kernels take D <= 64, got {p.D}.')
    NE = _slots(p.D)
    lay = _Layout(p, itemsize)
    nodes = p.nodes
    need_g = _ancestors(p, [p.grad])
    tail = _tail(p, need_g)
    if tail is None:
        need_l = _ancestors(p, [p.logp]) - need_g
    else:
        need_l = _ancestors(p, [nodes[tail[0]].args[0]]) - need_g

    def ref(i, e='e'):
        return f'v{i}[{e}]' if nodes[i].n is not None else f'v{i}'

    def c_expr(j):
        return _lit(nodes[j].attr) if nodes[j].op == 'lit' else f'c{j}'

    def lane_part(i, name):
        """The masked lane part of vector node i's sum, into ``name``."""
        n = nodes[i].n
        out = []
        for e in range(_slots(n)):
            term = (f'v{i}[{e}]' if 32 * (e + 1) <= n else
                    f'(lane + {32 * e} < {n} ? v{i}[{e}] : Real(0))')
            out.append(f'Real {name} = {term};' if e == 0 else
                       f'{name} = {name} + {term};')
        return out

    members, stage, bind = [], [], []
    if lay.mats:
        # one base pointer: each matrix at a constant offset from it
        members.append('const Real* sm;  // the staged matrices')
        bind.append('sm = smem;')
    for k, (idx, tr, m, n, rows, stride, off) in enumerate(lay.mats):
        members.append(f'// sm + {off}: constant {idx}'
                       f'{" transposed" if tr else ""}, {m} x {n}, '
                       f'{rows} rows of {stride}')
        poff = p.offsets[idx]
        src = (f'par[{poff} + c * {m} + r]' if tr
               else f'par[{poff} + r * {n} + c]')
        stage += [f'for (int i = threadIdx.x; i < {rows * stride}; '
                  f'i += blockDim.x) {{',
                  f'  const int r = i / {stride}, c = i % {stride};',
                  f'  smem[{off} + i] = r < {m} && c < {n} ? {src} : '
                  f'Real(0);', '}']
    if lay.xbuf:
        members.append(f'Real* xbuf;  // this warp\'s {lay.xbuf} values')
        bind.append(f'xbuf = smem + {lay.xbuf_off} + (threadIdx.x >> 5) * '
                    f'{lay.xbuf};')
    for i, nd in enumerate(nodes):
        if nd.op == 'cvec':
            ns, off = _slots(nd.n), p.offsets[nd.attr]
            members.append(f'Real c{i}[{ns}];  // constant {nd.attr}, '
                           f'this lane\'s elements')
            bind += ['#pragma unroll',
                     f'for (int e = 0; e < {ns}; ++e)',
                     f'  c{i}[e] = lane + 32 * e < {nd.n} ? '
                     f'par[{off} + lane + 32 * e] : Real(0);']
        elif nd.op == 'cscal':
            members.append(f'Real c{i};  // constant {nd.attr}')
            bind.append(f'c{i} = par[{p.offsets[nd.attr]}];')
        elif nd.op == 'gather':
            ns = _slots(nd.n)
            members.append(f'int g{i}[{ns}];  // source * 1024 + position, '
                           f'or -1 for a zero')
            bind += ['#pragma unroll',
                     f'for (int e = 0; e < {ns}; ++e)',
                     f'  g{i}[e] = kGather[{lay.gathers[i]} + lane + 32 * e];']
    if tail is None:
        members.append('mutable Real lp_;  // the logp of the last '
                       'evaluation')

    def emit(i):
        nd = nodes[i]
        op, ns = nd.op, _slots(nd.n) if nd.n is not None else None
        a = nd.args

        def vec(expr):
            return [f'Real v{i}[{ns}];', '#pragma unroll',
                    f'for (int e = 0; e < {ns}; ++e) v{i}[e] = {expr};']

        if op == 'x':
            return [f'const Real (&v{i})[NE] = x;']
        if op == 'lit':
            return [f'const Real v{i} = {_lit(nd.attr)};']
        if op == 'cscal':
            return [f'const Real v{i} = c{i};']
        if op == 'cvec':
            return [f'const Real (&v{i})[{ns}] = c{i};']
        if op in UNARY:
            expr = _UN[op].format(ref(a[0]))
        elif op in BINARY:
            expr = f'{ref(a[0])} {_BIN[op]} {ref(a[1])}'
        elif op in CMP:
            expr = (_CMP[op].format(ref(a[0]), ref(a[1])) +
                    ' ? Real(1) : Real(0)')
        elif op == 'not':
            expr = f'{ref(a[0])} == Real(0) ? Real(1) : Real(0)'
        elif op == 'where':
            expr = f'{ref(a[0])} != Real(0) ? {ref(a[1])} : {ref(a[2])}'
        if op in UNARY or op in BINARY or op in CMP or op in ('not',
                                                              'where'):
            return vec(expr) if ns else [f'const Real v{i} = {expr};']
        if op == 'sum':
            return ([f'Real v{i};', '{'] +
                    ['  ' + s for s in lane_part(a[0], 'p')] +
                    [f'  v{i} = warp_sum(p);', '}'])
        if op == 'mv':
            k = lay.mat(nd.attr)
            _, _, _, n_in, _, stride, off = lay.mats[k]
            full = n_in == 32 * _slots(n_in)
            return [f'Real v{i}[{ns}];',
                    f'tree_matvec<Real, {_slots(n_in)}, {ns}, {stride}'
                    f'{"" if full else f", {n_in}"}>('
                    f'sm + {off}, xbuf, v{a[0]}, {n_in}, v{i});']
        if op == 'pick':
            return [f'const Real v{i} = __shfl_sync(kFull, '
                    f'v{a[0]}[{nd.attr >> 5}], {nd.attr & 31});']
        if op == 'bcast':
            return vec(f'v{a[0]}')
        if op == 'gather':
            body = [f'  const int c = g{i}[e];', '  Real r = Real(0);']
            for k, s in enumerate(a):
                if nodes[s].n is None:
                    body.append(f'  if ((c >> 10) == {k}) r = v{s};')
                else:
                    body += [f'  const Real a{k} = fetch<Real, '
                             f'{_slots(nodes[s].n)}>(v{s}, c & 1023);',
                             f'  if ((c >> 10) == {k}) r = a{k};']
            return ([f'Real v{i}[{ns}];', '#pragma unroll',
                     f'for (int e = 0; e < {ns}; ++e) {{'] + body +
                    [f'  v{i}[e] = r;', '}'])
        raise AssertionError(op)

    body = ['const int lane = threadIdx.x & 31;', '(void)lane;',
            '// the gradient']
    for i in sorted(need_g):
        body += emit(i)
    body += ['#pragma unroll', f'for (int e = 0; e < NE; ++e) g[e] = '
             f'v{p.grad}[e];', '// the logp']
    for i in sorted(need_l):
        body += emit(i)
    if tail is None:
        body += [f'lp_ = v{p.logp};', 'return Real(0);']
        finish = ['(void)sum;', 'return lp_;']
    else:
        body += lane_part(nodes[tail[0]].args[0], 'part')
        body.append('return part;')
        finish = ['Real t = sum;']
        for i in tail[1]:
            nd = nodes[i]
            if nd.op == 'neg':
                finish.append('t = -t;')
                continue
            x, y = (c_expr(j) if _constant_scalar(p, j) else 't'
                    for j in nd.args)
            finish.append(f't = {x} {_BIN[nd.op]} {y};')
        finish.append('return t;')

    def block(lines, indent):
        return '\n'.join(' ' * indent + s if s else '' for s in lines)

    table = ', '.join(str(c) for c in lay.table) or '0'
    real = 'double' if f64 else 'float'
    head = (f'// Generated by bayesfast_tpu_torch/ops/codegen.py from a '
            f'traced density: D = {p.D},\n// {real}, {len(nodes)} nodes '
            f'({p.describe()}),\n// {p.n_ops} operations an evaluation. '
            f'Built and loaded by bayesfast_tpu_torch/_build.py.')
    return f'''{head}

#include "nuts_kernels.cuh"

namespace {{

using Real = {real};
constexpr int NE = {NE};  // slots of x: D = {p.D}
constexpr int kD = {p.D};

// each gather's source and position for every lane and slot
__constant__ int kGather[{max(1, len(lay.table))}] = {{{table}}};

struct Traced {{
  static constexpr int kSmem = {lay.smem};
  __host__ __device__ size_t smem_elems() const {{ return kSmem; }}
  const Real* par;  // the program's packed constants, device memory
{block(members, 2)}

  __device__ void stage(Real* smem) const {{
    (void)smem;
{block(stage, 4)}
  }}

  __device__ void bind(Real* smem) {{
    (void)smem;
    const int lane = threadIdx.x & 31;
    (void)lane;
{block(bind, 4)}
  }}

  __device__ Real operator()(const Real (&x)[NE], Real (&g)[NE]) const {{
{block(body, 4)}
  }}

  __device__ Real finish(Real sum) const {{
{block(finish, 4)}
  }}
}};

}}  // namespace

// K NUTS transitions (kind 0 frozen, 1 warmup) or one block transition
// (kind 2) with the traced density, as nuts_chunk_launch and
// nuts_block_launch of csrc/nuts.cu take them; cudaErrorInvalidValue for
// another dtype or D than the program's, or arguments the kernels do not
// take.
extern "C" int nuts_traced_launch(int kind, int f64, int C, int D, int K,
                                  int maxdepth, unsigned seed, unsigned i0,
                                  unsigned chain_start, int adapt_step,
                                  int adapt_metric, const double* fargs,
                                  void* const* ptrs, int n_ptrs,
                                  void* stream) {{
  if (f64 != {int(f64)} || D != kD || kind < kFrozen || kind > kBlock)
    return (int)cudaErrorInvalidValue;
  const cudaError_t bad = check_launch(kind, C, D, K, maxdepth, n_ptrs);
  if (bad != cudaSuccess) return (int)bad;
  const Args<Real> a =
      make_args<Real>(C, D, K, maxdepth, seed, i0, chain_start, adapt_step,
                      adapt_metric, fargs, ptrs, kind == kWarmup);
  Traced d = {{}};
  d.par = a.dpar;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == kBlock) return (int)launch_kernel<Real, NE, kBlock>(a, d, s);
  if (kind == kWarmup) return (int)launch_kernel<Real, NE, kWarmup>(a, d, s);
  return (int)launch_kernel<Real, NE, kFrozen>(a, d, s);
}}

extern "C" const char* nuts_traced_error_string(int err) {{
  return cudaGetErrorString((cudaError_t)err);
}}
'''
