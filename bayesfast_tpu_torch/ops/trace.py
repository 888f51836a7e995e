"""Trace a torch logp, or a ``Density`` plan, into a straight-line program,
with its gradient, and interpret that program in the CUDA NUTS kernels'
order.

Counterpart of ``_trace_density`` (``bayesfast_tpu/samplers/
nuts_pallas.py:576-607``), which traces the per-point jnp density once
into a closed jaxpr whose parameter leaves become kernel inputs. Here
``trace_density`` runs ``logp(x, *leaves)`` once on one point ``x`` of
shape (D,) under ``torch.fx.experimental.proxy_tensor.make_fx`` and lowers
the aten graph into a ``Program``: a straight-line list of nodes over
scalars and vectors of static length. The tensors the function closes
over (a rotation, a mask) and the ``leaves`` (a ``Density``'s
``current_params()``: a surrogate's coefficients and bound, the decay)
become the program's constants, read from one packed parameter vector
(``Program.pack``, which takes new leaves): a new matrix or a refit
changes the parameters, not the program. Python numbers in the function
become literals of the program.

Every value is lowered with its tensor shape, its elements in row-major
order: a plan runs on (N, .) tensors (``core/pipeline.py::_eval_vars``)
and is traced at N = 1, so its (1, n) rows are vectors of n and the unit
batch axis costs nothing (broadcasts, reductions and views see the shapes;
``torch.func.vmap`` would widen the op set by its decompositions). The op
set: elementwise ``add``, ``sub``, ``mul``, ``div``, ``neg``, ``pow`` by a
constant integer (products), ``reciprocal``, ``exp``, ``log``, ``log1p``
and ``sqrt`` with broadcasting; ``sum`` over any axes (and ``dot``);
``mm`` / ``mv`` of a value by a constant matrix either side (and of two
values, as sums of products); the comparisons ``lt``, ``le``, ``gt``,
``ge``, ``eq``, ``ne``, ``logical_and`` / ``or`` / ``not`` (1 where they
hold, else 0; no gradient) and the select ``where``, with ``clamp``,
``clamp_min``, ``clamp_max``, ``maximum`` and ``minimum`` written as
selects of comparisons; every data movement (views, ``slice``,
``select``, ``cat``, ``stack``, ``roll``, ``flip``, ``expand``,
``permute``, ``index`` and ``index_select`` / ``gather`` by a constant
integer index) as a gather; a scatter-add (``index_add``,
``index_put(accumulate=True)``) by a constant index, each output
position the sum of its sources in the program's order (after the base,
unless the base is zeros), and ``index_put`` without accumulation. An op
whose inputs are all constants is evaluated at the trace and kept as a
constant, computed again from the leaves at each ``pack`` (never a
literal: ``where(isfinite(alpha), alpha, 1)`` follows every refit of
alpha); ``zeros``, ``ones_like``, ``full`` and the like, made from
numbers alone, are literals. In-place ops on a value the function made
are lowered as their out-of-place forms. Any other aten op raises
``TraceError`` naming it; so does control flow on the data (``make_fx``
refuses to read a value), a random factory, an in-place op on a view or
on a constant the function reads, an index that depends on the
parameters, and a program whose gather tables do not fit the kernels'
constant memory, or its matrix products' x buffers their shared memory
(``ops.codegen.check_limits``).

Gradients at ties follow torch's autograd: ``clamp``'s goes to x where lo
<= x <= hi (a bound included), ``maximum``'s and ``minimum``'s split in
half; ``where``'s takes the selected branch, the other a zero (as JAX's
``where``), so an unselected branch that is finite keeps the gradient
finite. A scatter-add into zeros starts from its first source: where that
is -0, torch's ``0 + s`` is +0 and the program's -0, the only
difference.

In the kernels (``ops/codegen.py``) a comparison of per-chain scalars is
warp-uniform (every lane holds the scalar's bits, as after a ``sum``): the
bound's ``beta <= alpha``, the decay's ``clamp``; a comparison of vectors
is a per-lane select. Neither branches on a lane: a select is ``c ? a :
b`` on values both computed.

The gradient is the program's own reverse-mode adjoint, written in the
same node set (``_adjoint``), not a trace of autograd: every sum of the
gradient then has the order the program fixes, and both backends (this
module's interpreter and the CUDA functor of ``ops/codegen.py``) follow
it; a traced backward would bring ``slice_backward``, ``select_backward``
and ``expand`` into the op set. Index ops lower to one ``gather`` node
(each output position a position of a source, a scalar source, or zero),
and a gather of a gather is folded into one, so the ring's ``cat`` of
slices becomes one neighbour fetch.

A ``DensityLite`` with the user's own gradient (``grad`` or
``logp_and_grad``, as the JAX kernels trace the user's gradient through
``device_logp_and_grad``) is traced as the pair: ``trace_density(...,
with_grad=True)`` lowers ``(logp, grad)`` of one point, and the program's
gradient is the trace of the user's function, run forward in the same
node set; no adjoint is derived, so a wrong gradient stays wrong.

``Program.logp_and_grad`` is the plain version: it runs the nodes on
(C, D) tensors in the kernels' order, every sum (a ``sum`` node and each
row of a matrix product) in the warp's order of ``ops.densities.
warp_sum``, every literal a tensor of the run dtype on the device (torch
on the card divides by a Python scalar as a multiplication by its
reciprocal, the kernel divides), ``pow`` as products, and only the
elementwise functions whose rounding the compiled-in densities already
match on the card (``exp``, ``log``, ``log1p``, ``sqrt``).
"""

import math

import numpy as np
import torch

from .densities import warp_sum

__all__ = ['TraceError', 'Program', 'trace_density', 'trace_key']


class TraceError(Exception):
    """The density does not trace into the kernels' op set."""


class Node:
    """One program node: ``op``, argument node ids, ``n`` (None: a scalar;
    else a vector of length n) and an op-specific ``attr``."""
    __slots__ = ('op', 'args', 'n', 'attr')

    def __init__(self, op, args, n, attr):
        self.op, self.args, self.n, self.attr = op, tuple(args), n, attr


UNARY = ('neg', 'recip', 'exp', 'log', 'log1p', 'sqrt')
BINARY = ('add', 'sub', 'mul', 'div')
# comparisons and logical ops: 1 where they hold, else 0; no gradient
CMP = ('lt', 'le', 'gt', 'ge', 'eq', 'ne', 'and', 'or')
LOGIC = CMP + ('not',)


def _lit_key(v):
    # the literal's bits: 0.0 and -0.0 stay apart
    return float(v).hex()


class _Mat:
    """A constant matrix as a matrix product reads it: constant ``idx``
    (m0, n0), read transposed or not; ``shape`` as read."""

    def __init__(self, idx, tr, shape):
        self.idx, self.tr, self.shape = idx, tr, tuple(shape)

    def t(self):
        return _Mat(self.idx, not self.tr, self.shape[::-1])


class _Graph:
    """Builds the node list with common subexpressions shared and the
    exact literal identities folded (``x * 1``, ``x / 1``, ``-(-x)``,
    ``-literal``, ``x * -1``). Its methods take and return node ids."""

    def __init__(self):
        self.nodes = []
        self.consts = []          # (tensor at the trace, kind): 'scal',
        self.const_fns = []       # 'vec', 'mat'; its value from the leaves
        self._const_ids = {}
        self._cse = {}

    def add_node(self, op, args=(), n=None, attr=None):
        key = (op, tuple(args), n, attr)
        if key not in self._cse:
            self.nodes.append(Node(op, args, n, attr))
            self._cse[key] = len(self.nodes) - 1
        return self._cse[key]

    def n(self, i):
        return self.nodes[i].n

    def lit(self, v):
        return self.add_node('lit', attr=_lit_key(v))

    def lit_value(self, i):
        nd = self.nodes[i]
        return float.fromhex(nd.attr) if nd.op == 'lit' else None

    def const(self, key, t, fn, kind):
        """The index of constant ``t`` (``kind`` 'scal', 'vec' or 'mat'),
        registered once under ``key``; ``fn(leaves)`` gives its value for
        other leaves."""
        key = (kind, key)
        if key not in self._const_ids:
            if t.is_complex():
                raise TraceError(f'a constant tensor of type {t.dtype}: '
                                 'real tensors only')
            self.consts.append((t, kind))
            self.const_fns.append(fn)
            self._const_ids[key] = len(self.consts) - 1
        return self._const_ids[key]

    def unary(self, op, a):
        v = self.lit_value(a)
        if op == 'neg' and v is not None:
            return self.lit(-v)
        if op == 'neg' and self.nodes[a].op == 'neg':
            return self.nodes[a].args[0]
        return self.add_node(op, (a,), self.n(a))

    def _same_n(self, op, a, b):
        na, nb = self.n(a), self.n(b)
        if na is not None and nb is not None and na != nb:
            if na == 1:
                a, na = self.gather([(a, 0)] * nb), nb
            elif nb == 1:
                b, nb = self.gather([(b, 0)] * na), na
            else:
                raise TraceError(f'{op} of vectors of lengths {na} and {nb}')
        return a, b, na if na is not None else nb

    def binary(self, op, a, b):
        a, b, n = self._same_n(op, a, b)
        va, vb = self.lit_value(a), self.lit_value(b)
        if op == 'mul':
            if va == 1.0 or vb == 1.0:
                return b if va == 1.0 else a
            if va == -1.0 or vb == -1.0:
                return self.unary('neg', b if va == -1.0 else a)
        if op == 'div' and vb == 1.0:
            return a
        return self.add_node(op, (a, b), n)

    def compare(self, op, a, b):
        """A comparison or logical op (``CMP``): 1 where it holds, else
        0."""
        a, b, n = self._same_n(op, a, b)
        return self.add_node(op, (a, b), n)

    def where(self, c, a, b):
        """``c != 0 ? a : b``, elementwise."""
        ns = [self.n(i) for i in (c, a, b) if self.n(i) is not None]
        if len(set(ns)) > 1:
            raise TraceError(f'where of vectors of lengths {ns}')
        return self.add_node('where', (c, a, b), ns[0] if ns else None)

    def sum(self, a):
        return self.add_node('sum', (a,))

    def bcast(self, s, n):
        return self.add_node('bcast', (s,), n)

    def mv(self, M, v):
        """``M v`` for a constant matrix expression M (m, n)."""
        if self.n(v) != M.shape[1]:
            raise TraceError(f'a {M.shape} matrix times a vector of length '
                             f'{self.n(v)}')
        return self.add_node('mv', (v,), M.shape[0], (M.idx, M.tr))

    def _resolve(self, e):
        """A gather entry traced back through gathers and broadcasts to a
        (vector node, position), (scalar node, None) or None."""
        while e is not None:
            src, pos = e
            nd = self.nodes[src]
            if nd.n is None:
                return (src, None)
            if nd.op == 'gather':
                m = nd.attr[pos]
                e = None if m is None else (nd.args[m[0]], m[1])
            elif nd.op == 'bcast':
                e = (nd.args[0], None)
            else:
                return e
        return None

    def gather(self, entries):
        """A vector whose position i is ``entries[i]``: (node, position),
        (scalar node, None) or None (zero)."""
        ents = [self._resolve(e) for e in entries]
        n = len(ents)
        srcs = []
        for e in ents:
            if e is not None and e[0] not in srcs:
                srcs.append(e[0])
        if (len(srcs) == 1 and self.n(srcs[0]) == n
                and all(e is not None and e[1] == i
                        for i, e in enumerate(ents))):
            return srcs[0]
        amap = tuple(None if e is None else
                     (srcs.index(e[0]), -1 if e[1] is None else e[1])
                     for e in ents)
        return self.add_node('gather', tuple(srcs), n, amap)

    def pick(self, v, i):
        """Element i of vector v, a scalar."""
        e = self._resolve((v, i))
        if e is None:
            return self.lit(0.0)
        if e[1] is None:
            return e[0]
        return self.add_node('pick', (e[0],), None, e[1])


# ---------------------------------------------------------------------------
# Lowering of the aten graph. Every value the function computes from x is a
# ``_T``: a program node and the tensor's shape, its elements in row-major
# order (a scalar node for shape (), else a vector of the tensor's size), so
# a plan's (1, n) rows, traced at N = 1, are vectors of n. Every value that
# does not depend on x is a ``_C`` until an op with x needs it; an op whose
# inputs are all constants is evaluated then (``_Lower.fold``).

class _T:
    """A value of the program: node ``i``, tensor shape ``shape``."""
    __slots__ = ('i', 'shape')

    def __init__(self, i, shape):
        self.i, self.shape = i, tuple(shape)


class _C:
    """A constant tensor: its value at the trace (``val``), ``fn(leaves)``
    for its value at other leaves (the runtime parameters), the leaves it
    reads (``deps``), whether it reads a tensor the function closes over
    (``captured``), and ``key``, ``tr``: the constant a matrix product
    reads, transposed or not."""
    __slots__ = ('val', 'fn', 'deps', 'captured', 'key', 'tr', 'base')

    def __init__(self, val, fn, deps=frozenset(), captured=False, key=None,
                 tr=False, base=None):
        self.val, self.fn = val, fn
        self.deps, self.captured = frozenset(deps), captured
        self.key = ('c', id(self)) if key is None else key
        self.tr, self.base = tr, base

    @property
    def literal(self):
        """Made by the function from numbers alone (``zeros``, ``ones_like``,
        ``full``): its value is the program's, like a Python number's."""
        return not self.deps and not self.captured

    def transposed(self):
        base = self if self.base is None else self.base
        fn = self.fn
        return _C(self.val.t(), lambda L: fn(L).t(), self.deps,
                  self.captured, ('t',) + self.key, not self.tr, base)


def _numel(shape):
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _codes(shape, k=0):
    """Positions of a tensor of ``shape``, tagged with source ``k``."""
    return torch.arange(_numel(shape), dtype=torch.int64).reshape(shape) \
        + (int(k) << 32)


_NUMBER = (bool, int, float, np.number)

# data movement: the op applied to position codes says where each element
# of its output comes from
_MOVE = {
    'aten.view.default', 'aten.reshape.default', 'aten._unsafe_view.default',
    'aten.unsqueeze.default', 'aten.squeeze.dim', 'aten.squeeze.dims',
    'aten.squeeze.default', 'aten.expand.default', 'aten.permute.default',
    'aten.transpose.int', 'aten.t.default', 'aten.slice.Tensor',
    'aten.select.int', 'aten.index.Tensor', 'aten.cat.default',
    'aten.stack.default', 'aten.roll.default', 'aten.flip.default',
    'aten.alias.default', 'aten.clone.default', 'aten.detach.default',
    'aten.lift_fresh_copy.default', 'aten.repeat.default',
    'aten.narrow.default', 'aten.index_select.default',
    'aten.gather.default', 'aten.split.Tensor',
    'aten.split_with_sizes.default', 'aten.unbind.int',
}
# a constant's layout ops that keep it the same constant
_SAME = {'aten.alias.default', 'aten.clone.default', 'aten.detach.default',
         'aten.lift_fresh_copy.default', 'aten._to_copy.default',
         'aten.view.default', 'aten.reshape.default',
         'aten._unsafe_view.default', 'aten.expand.default'}
_TRANSPOSE = {'aten.t.default', 'aten.transpose.int', 'aten.permute.default'}
# ops whose value depends only on their argument's shape
_SHAPE_ONLY = {'aten.zeros_like.default', 'aten.ones_like.default',
               'aten.full_like.default', 'aten.new_zeros.default',
               'aten.new_ones.default', 'aten.new_full.default'}
_UNARY_OPS = {'aten.neg.default': 'neg', 'aten.reciprocal.default': 'recip',
              'aten.exp.default': 'exp', 'aten.log.default': 'log',
              'aten.log1p.default': 'log1p', 'aten.sqrt.default': 'sqrt'}
_BINARY_OPS = {'aten.add.Tensor': 'add', 'aten.add.Scalar': 'add',
               'aten.sub.Tensor': 'sub', 'aten.sub.Scalar': 'sub',
               'aten.mul.Tensor': 'mul', 'aten.mul.Scalar': 'mul',
               'aten.div.Tensor': 'div', 'aten.div.Scalar': 'div'}
_CMP_OPS = {f'aten.{o}.{v}': o for o in ('lt', 'le', 'gt', 'ge', 'eq', 'ne')
            for v in ('Tensor', 'Scalar')}
_CMP_OPS.update({'aten.logical_and.default': 'and',
                 'aten.logical_or.default': 'or',
                 'aten.bitwise_and.Tensor': 'and',
                 'aten.bitwise_or.Tensor': 'or'})


class _Lower:
    """The lowering of one aten graph into a ``_Graph``. With ``batch`` the
    function runs on a batch of one point: every value of one element
    ((1,), (1, 1): a per-point scalar of the plan) is a scalar node, as
    warp-uniform as a sum; a (1, n) row is a vector of n either way."""

    def __init__(self, dtype, batch=False):
        self.b = _Graph()
        self.dtype = dtype
        self.batch = batch

    def scalar(self, shape):
        """Whether a value of ``shape`` is a scalar node."""
        return shape == () or (self.batch and _numel(shape) == 1)

    # -- constants into the program ----------------------------------------
    def _uniform(self, c):
        """The one value of every element of a literal constant, or
        None."""
        if not c.literal or c.val.numel() == 0:
            return None
        flat = c.val.reshape(-1).to(torch.float64)
        v = flat[0]
        same = (torch.isnan(flat).all() if torch.isnan(v)
                else torch.equal(flat, v.expand_as(flat)))
        return float(v) if same else None

    def node_of(self, v, what='an op'):
        """(node id, shape) of an elementwise operand. A literal constant of
        one value is that literal, a scalar node whatever its shape."""
        if isinstance(v, _T):
            return v.i, v.shape
        if isinstance(v, _NUMBER):
            return self.b.lit(float(v)), ()
        if isinstance(v, _C):
            shape = tuple(v.val.shape)
            u = self._uniform(v)
            if u is not None:
                return self.b.lit(u), shape
            if not shape:
                idx = self.b.const(v.key, v.val, v.fn, 'scal')
                return self.b.add_node('cscal', attr=idx), shape
            flat = v.val.reshape(-1)
            fn = v.fn
            idx = self.b.const(v.key, flat, lambda L: fn(L).reshape(-1),
                               'vec')
            return self.b.add_node('cvec', n=flat.numel(), attr=idx), shape
        raise TraceError(f'{what} of a {type(v).__name__}')

    def mat_of(self, c):
        """A 2-d constant as a matrix product reads it."""
        if c.val.dim() != 2:
            raise TraceError(f'a matrix product with a constant of shape '
                             f'{tuple(c.val.shape)}')
        base = c if c.base is None else c.base
        idx = self.b.const(base.key, base.val, base.fn, 'mat')
        return _Mat(idx, c.tr, c.val.shape)

    def index(self, c, name):
        """The values of a constant integer index."""
        if not isinstance(c, _C) or c.deps or c.val.is_floating_point():
            raise TraceError(f'{name} by an index that is not a constant '
                             'integer tensor')
        return c.val

    # -- shapes ------------------------------------------------------------
    def bcast(self, i, shape, out):
        """Node i of ``shape`` broadcast to ``out`` (scalars stay
        scalars)."""
        b = self.b
        if b.n(i) is None or tuple(shape) == tuple(out):
            return i
        m = _codes(shape).expand(out).reshape(-1).tolist()
        return b.gather([(i, p) for p in m])

    def fit(self, i, shape):
        """Node i as a value of ``shape``."""
        b = self.b
        n = b.n(i)
        if self.scalar(shape) and n is not None:
            return _T(b.pick(i, 0), shape)
        if not self.scalar(shape) and n is None:
            k = _numel(shape)
            return _T(b.gather([(i, None)]) if k == 1 else b.bcast(i, k),
                      shape)
        return _T(i, shape)

    def ew(self, vals, out, what):
        return [self.bcast(*self.node_of(v, what), out) for v in vals]

    # -- ops -----------------------------------------------------------------
    def binary(self, op, x, y, out, swap=False, alpha=1):
        if alpha != 1:
            raise TraceError(f'aten.{op} with alpha {alpha}')
        a, c = self.ew([x, y], out, f'aten.{op}')
        if swap:
            a, c = c, a
        return self.fit(self.b.binary(op, a, c), out)

    def unary(self, op, x, out):
        (a,) = self.ew([x], out, f'aten.{op}')
        return self.fit(self.b.unary(op, a), out)

    def compare(self, op, x, y, out):
        a, c = self.ew([x, y], out, f'aten.{op}')
        return self.fit(self.b.compare(op, a, c), out)

    def where(self, c, x, y, out):
        ic, ix, iy = self.ew([c, x, y], out, 'aten.where')
        return self.fit(self.b.where(ic, ix, iy), out)

    def pow(self, x, e, out):
        if not isinstance(e, (int, float)) or float(e) != int(e) or e == 0:
            raise TraceError(f'aten.pow.Tensor_Scalar with the exponent {e}: '
                             'non-zero integer exponents only')
        (a,) = self.ew([x], out, 'aten.pow')
        e, r = int(e), a
        for _ in range(abs(e) - 1):
            r = self.b.binary('mul', r, a)
        return self.fit(r if e > 0 else self.b.unary('recip', r), out)

    def clamp(self, x, lo, hi, out):
        """``clamp`` as selects: ``x < lo ? lo : x``, then ``> hi``; its
        gradient goes to x where lo <= x <= hi, ties included (torch's
        rule), and NaN stays NaN."""
        v = x
        if lo is not None:
            v = self.where(self.compare('lt', v, lo, out), lo, v, out)
        if hi is not None:
            v = self.where(self.compare('gt', v, hi, out), hi, v, out)
        return v if isinstance(v, _T) else self.fit(self.node_of(v)[0], out)

    def extremum(self, x, y, out, op):
        """``maximum`` (op 'gt') or ``minimum`` ('lt') as selects; a tie
        takes half of each operand, so its gradient splits in half, as
        torch's does."""
        other = 'lt' if op == 'gt' else 'gt'
        half = self.binary('add', self.binary('mul', x, 0.5, out),
                           self.binary('mul', y, 0.5, out), out)
        tie = self.where(self.compare(other, x, y, out), y, half, out)
        return self.where(self.compare(op, x, y, out), x, tie, out)

    def sum(self, x, dims=None, keepdim=False, dtype=None, out=()):
        b = self.b
        i, shape = self.node_of(x, 'aten.sum')
        nd = len(shape)
        red = (list(range(nd)) if dims is None or list(dims) == []
               else sorted({d % max(nd, 1) for d in dims}))
        keep = [d for d in range(nd) if d not in red]
        n_red = _numel([shape[d] for d in red])
        if b.n(i) is None:
            return self.fit(i, out)
        rows = _codes(shape).permute(keep + red).reshape(-1, n_red).tolist()
        outs = []
        for row in rows:
            if n_red == 1:
                outs.append((i, row[0]))
            else:
                outs.append((b.sum(b.gather([(i, p) for p in row])), None))
        if len(outs) == 1:
            return self.fit(b.pick(*outs[0]) if outs[0][1] is not None
                            else outs[0][0], out)
        return _T(b.gather(outs), out)

    def mm(self, x, y, out):
        """(r, k) @ (k, c): rows of a value by a constant matrix, a
        constant matrix by columns of a value, or a value by a value (each
        output a sum of products)."""
        b = self.b
        if isinstance(y, _C) and not isinstance(x, _C):
            i, (r, k) = self.node_of(x, 'aten.mm')
            M = self.mat_of(y).t()
            rows = [b.mv(M, b.gather([(i, p) for p in range(j * k,
                                                            j * k + k)]))
                    for j in range(r)]
            return self.fit(b.gather([(rw, j) for rw in rows
                                      for j in range(M.shape[0])]), out)
        if isinstance(x, _C):
            i, (k, c) = self.node_of(y, 'aten.mm')
            M = self.mat_of(x)
            cols = [b.mv(M, b.gather([(i, p * c + j) for p in range(k)]))
                    for j in range(c)]
            return self.fit(b.gather([(cols[j], p)
                                      for p in range(M.shape[0])
                                      for j in range(c)]), out)
        i, (r, k) = self.node_of(x, 'aten.mm')
        j, (_, c) = self.node_of(y, 'aten.mm')
        ents = []
        for p in range(r):
            row = b.gather([(i, p * k + q) for q in range(k)])
            for s in range(c):
                col = b.gather([(j, q * c + s) for q in range(k)])
                ents.append((b.sum(b.binary('mul', row, col)), None))
        return self.fit(b.gather(ents), out)

    def mv(self, M, v, out):
        shape = self.shape_of(v)
        col = self.reshape(v, (shape[0], 1))
        r = self.mm(M, col, (self.shape_of(M)[0], 1))
        return self.fit(r.i, out)

    def shape_of(self, v):
        if isinstance(v, _NUMBER):
            return ()
        return tuple(v.val.shape) if isinstance(v, _C) else v.shape

    def reshape(self, v, shape):
        if isinstance(v, _C):
            fn = v.fn
            return _C(v.val.reshape(shape), lambda L: fn(L).reshape(shape),
                      v.deps, v.captured)
        return _T(v.i, shape)

    def move(self, target, name, args, kwargs):
        """A data-movement op: applied to position codes of its data
        operands, its output's codes say which element each output
        element is; a gather (a pick for one element) of them."""
        srcs = []

        def code(v):
            i, shape = self.node_of(v, name)
            srcs.append(i)
            return _codes(shape, len(srcs) - 1)

        if name in ('aten.cat.default', 'aten.stack.default'):
            cargs = [[code(v) for v in args[0]], *args[1:]]
        elif name == 'aten.index.Tensor':
            cargs = [code(args[0]), [None if a is None else
                                     self.index(a, name) for a in args[1]]]
        elif name in ('aten.index_select.default', 'aten.gather.default'):
            cargs = [code(args[0]), args[1], self.index(args[2], name),
                     *args[3:]]
        else:
            cargs = [code(args[0]), *args[1:]]
        res = target(*cargs, **kwargs)
        if isinstance(res, (list, tuple)):
            return [self.from_codes(r, srcs) for r in res]
        return self.from_codes(res, srcs)

    def from_codes(self, r, srcs):
        """The value whose elements the codes ``r`` name, of sources
        ``srcs``."""
        b = self.b
        shape = tuple(r.shape)
        if _numel(shape) == 0:
            raise TraceError('an empty tensor')
        ents = []
        for c in r.reshape(-1).tolist():
            s = srcs[c >> 32]
            ents.append((s, None if b.n(s) is None else c & 0xffffffff))
        if self.scalar(shape):
            s, p = ents[0]
            return _T(s if p is None else b.pick(s, p), shape)
        return _T(b.gather(ents), shape)

    def scatter(self, base, out_shape, pairs, accumulate):
        """``base`` with the (output position, source node, source
        position) ``pairs`` written (``accumulate``: added, each position
        the sum of its sources in order, after the base unless the base is
        zeros) or put (the last one)."""
        b = self.b
        n = _numel(out_shape)
        hits = [[] for _ in range(n)]
        for o, s, p in pairs:
            if accumulate:
                hits[o].append((s, p))
            else:
                hits[o] = [(s, p)]
        zero = isinstance(base, _C) and self._uniform(base) == 0.0
        if zero:
            c = None
        else:
            bi, bshape = self.node_of(base, 'a scatter')
            bi = self.bcast(bi, bshape, out_shape)
            c = bi if b.n(bi) is not None else b.bcast(bi, n)
        if not accumulate:
            ents = [h[0] if h else (None if c is None else (c, o))
                    for o, h in enumerate(hits)]
            return self.fit(b.gather(ents), out_shape)
        for layer in range(max(len(h) for h in hits)):
            lay = b.gather([h[layer] if len(h) > layer else None
                            for h in hits])
            c = lay if c is None else b.binary('add', c, lay)
        if c is None:
            c = b.gather([None] * n)
        return self.fit(c, out_shape)

    def index_add(self, base, dim, index, source, alpha=1, out=()):
        if alpha != 1:
            raise TraceError(f'aten.index_add with alpha {alpha}')
        idx = self.index(index, 'aten.index_add').reshape(-1).tolist()
        s, sshape = self.node_of(source, 'aten.index_add')
        oc, sc = _codes(out), _codes(sshape)
        pairs = []
        for k, j in enumerate(idx):
            for o, p in zip(oc.select(dim, j).reshape(-1).tolist(),
                            sc.select(dim, k).reshape(-1).tolist()):
                pairs.append((o, s, None if self.b.n(s) is None else p))
        return self.scatter(base, out, pairs, True)

    def index_put(self, base, indices, values, accumulate=False, out=()):
        idx = [None if a is None else self.index(a, 'aten.index_put')
               for a in indices]
        s, sshape = self.node_of(values, 'aten.index_put')
        tgt = torch.ops.aten.index.Tensor(_codes(out), idx)
        src = _codes(sshape).expand(tgt.shape)
        pairs = [(o, s, None if self.b.n(s) is None else p)
                 for o, p in zip(tgt.reshape(-1).tolist(),
                                 src.reshape(-1).tolist())]
        return self.scatter(base, out, pairs, accumulate)

    # -- constants -----------------------------------------------------------
    def fold(self, target, name, args, kwargs):
        """An op of constants alone, evaluated now and kept as a constant
        (a function of the leaves, evaluated again at each ``pack``)."""
        if (target._schema.is_mutable or 'empty' in name or any(
                'nondeterministic' in str(t) for t in target.tags)):
            raise TraceError(f'{name} is not in the op set of the CUDA NUTS '
                             'kernels (ops/trace.py): it is not a function '
                             'of its inputs')
        consts = []

        def walk(a, leaves):
            if isinstance(a, _C):
                consts.append(a)
                return a.val if leaves is None else a.fn(leaves)
            if isinstance(a, (list, tuple)):
                return type(a)(walk(x, leaves) for x in a)
            return a

        val = target(*walk(args, None), **walk(kwargs, None))
        if not torch.is_tensor(val):
            raise TraceError(f'{name} of constants gives a '
                             f'{type(val).__name__}')
        deps = frozenset().union(*[c.deps for c in consts])
        captured = any(c.captured for c in consts)
        return _C(val, lambda L: target(*walk(args, L), **walk(kwargs, L)),
                  deps, captured)

    def const_op(self, target, name, args, kwargs, meta):
        """An op with constant operands that keeps the constant (a view of
        the same shape, a cast: a constant is packed in the run dtype) or
        transposes it, else ``fold``."""
        c = args[0] if args else None
        if isinstance(c, _C):
            if name in _SAME and tuple(meta.shape) == tuple(c.val.shape):
                return c
            if (name in _TRANSPOSE and c.val.dim() == 2
                    and tuple(meta.shape) == tuple(c.val.shape)[::-1]):
                return c.transposed()
        return self.fold(target, name, args, kwargs)


def _has_value(a):
    if isinstance(a, _T):
        return True
    if isinstance(a, (list, tuple)):
        return any(_has_value(x) for x in a)
    return False


def _like(a):
    """Zeros of the shape and dtype of fx node ``a``'s value, on the CPU:
    what an op that reads only its argument's shape is evaluated on."""
    m = a.meta['val']
    return torch.zeros(tuple(m.shape), dtype=m.dtype)


def _lower_op(lw, target, name, args, kwargs, meta):
    """One aten op of a graph that reads x."""
    out = tuple(meta.shape) if torch.is_tensor(meta) else None
    if name in _BINARY_OPS:
        if torch.is_tensor(meta) and meta.dtype == torch.bool \
                and _BINARY_OPS[name] != 'mul':
            raise TraceError(f'{name} of booleans')
        return lw.binary(_BINARY_OPS[name], *args[:2], out,
                         alpha=kwargs.get('alpha', 1))
    if name in ('aten.rsub.Scalar', 'aten.rsub.Tensor'):
        return lw.binary('sub', *args[:2], out, swap=True,
                         alpha=kwargs.get('alpha', 1))
    if name in _UNARY_OPS:
        return lw.unary(_UNARY_OPS[name], args[0], out)
    if name in _CMP_OPS:
        if _CMP_OPS[name] in ('and', 'or') and meta.dtype != torch.bool:
            raise TraceError(f'{name} of integers')
        return lw.compare(_CMP_OPS[name], *args[:2], out)
    if name in ('aten.logical_not.default', 'aten.bitwise_not.default'):
        if name == 'aten.bitwise_not.default' and meta.dtype != torch.bool:
            raise TraceError(f'{name} of integers')
        (a,) = lw.ew([args[0]], out, name)
        return lw.fit(lw.b.add_node('not', (a,), lw.b.n(a)), out)
    if name in ('aten.where.self', 'aten.where.ScalarSelf',
                'aten.where.ScalarOther', 'aten.where.Scalar'):
        return lw.where(*args[:3], out)
    if name == 'aten.clamp.default' or name == 'aten.clamp.Tensor':
        lo = args[1] if len(args) > 1 else kwargs.get('min')
        hi = args[2] if len(args) > 2 else kwargs.get('max')
        return lw.clamp(args[0], lo, hi, out)
    if name in ('aten.clamp_min.default', 'aten.clamp_min.Tensor'):
        return lw.clamp(args[0], args[1], None, out)
    if name in ('aten.clamp_max.default', 'aten.clamp_max.Tensor'):
        return lw.clamp(args[0], None, args[1], out)
    if name == 'aten.maximum.default':
        return lw.extremum(args[0], args[1], out, 'gt')
    if name == 'aten.minimum.default':
        return lw.extremum(args[0], args[1], out, 'lt')
    if name == 'aten.pow.Tensor_Scalar':
        return lw.pow(args[0], args[1], out)
    if name == 'aten.square.default':
        return lw.pow(args[0], 2, out)
    if name in ('aten.sum.dim_IntList', 'aten.sum.default'):
        dims = args[1] if len(args) > 1 else kwargs.get('dim')
        keep = args[2] if len(args) > 2 else kwargs.get('keepdim', False)
        return lw.sum(args[0], dims, keep, out=out)
    if name == 'aten.dot.default':
        n = (max(_numel(lw.shape_of(v)) for v in args[:2]),)
        a, c = lw.ew(args[:2], n, name)
        return lw.fit(lw.b.sum(lw.b.binary('mul', a, c)), out)
    if name == 'aten.mm.default':
        return lw.mm(args[0], args[1], out)
    if name == 'aten.mv.default':
        return lw.mv(args[0], args[1], out)
    if name == 'aten.index_add.default':
        return lw.index_add(*args, **kwargs, out=out)
    if name == 'aten.index_put.default':
        return lw.index_put(*args[:3], *args[3:], out=out)
    if name == 'aten._to_copy.default':
        want = kwargs.get('dtype')
        if want is not None and want != lw.dtype:
            raise TraceError(f'aten._to_copy of a variable to {want}')
        return args[0]
    if name in _MOVE:
        return lw.move(target, name, args, kwargs)
    raise TraceError(f'{name} is not in the op set of the CUDA NUTS kernels '
                     '(ops/trace.py)')


_VIEWS = _MOVE - {'aten.index.Tensor', 'aten.cat.default',
                  'aten.stack.default', 'aten.roll.default',
                  'aten.flip.default', 'aten.clone.default',
                  'aten.lift_fresh_copy.default', 'aten.repeat.default',
                  'aten.index_select.default', 'aten.gather.default'}


def _lower(gm, D, dtype, leaves=(), batch=False, pair=False):
    """The aten graph of ``make_fx`` as program nodes; returns (graph,
    logp node id), or with ``pair`` (the function returns the user's
    (logp, grad)) (graph, (logp node id, grad node id)), the gradient a
    vector of length D. Its first input is x (D,), the others the leaves;
    ``batch``: see ``_Lower``."""
    lw = _Lower(dtype, batch)
    b = lw.b
    env = {}

    def arg(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(arg(x) for x in a)
        return a

    out = None
    n_ph = 0
    for node in gm.graph.nodes:
        if node.op == 'placeholder':
            if n_ph == 0:
                env[node] = _T(b.add_node('x', n=D), (D,))
            else:
                k = n_ph - 1
                env[node] = _C(leaves[k], lambda L, k=k: L[k], {k},
                               key=('leaf', k))
            n_ph += 1
        elif node.op == 'get_attr':
            t = getattr(gm, node.target)
            if not torch.is_tensor(t):
                raise TraceError(f'a constant of type {type(t).__name__}')
            env[node] = _C(t, lambda L, t=t: t, captured=True,
                           key=('t', id(t)))
        elif node.op == 'call_function':
            name = str(node.target)
            args, kwargs = arg(node.args), arg(node.kwargs)
            if name == '<built-in function getitem>':
                env[node] = args[0][args[1]]
                continue
            mutates = (hasattr(node.target, '_schema')
                       and node.target._schema.is_mutable)
            if mutates and (not isinstance(node.args[0], torch.fx.Node)
                            or str(getattr(node.args[0], 'target', ''))
                            in _VIEWS or (isinstance(args[0], _C)
                                          and not args[0].literal)):
                raise TraceError(f'{name}: an in-place op on a view or a '
                                 'constant the function reads')
            meta = node.meta.get('val')
            target = node.target
            if mutates:
                # the op out of place, its result bound to the operand
                _, packet, overload = name.split('.')
                if packet.endswith('_'):
                    target = getattr(getattr(torch.ops.aten, packet[:-1]),
                                     overload)
                    name = str(target)
            if name in _SHAPE_ONLY:
                vals = [_like(a) if isinstance(a, torch.fx.Node) else a
                        for a in node.args]
                env[node] = lw.fold(target, name, tuple(vals), node.kwargs)
            elif not _has_value(list(args) + list(kwargs.values())):
                if not hasattr(target, '_schema'):
                    raise TraceError(f'{name} is not an aten op')
                env[node] = lw.const_op(target, name, args, kwargs, meta)
            else:
                env[node] = _lower_op(lw, target, name, args, kwargs, meta)
            if mutates:
                env[node.args[0]] = env[node]
        elif node.op == 'output':
            out = arg(node.args[0])
            if not isinstance(out, (list, tuple)):
                out = [out]
            if len(out) != (2 if pair else 1):
                raise TraceError(
                    f'logp_and_grad returns {len(out)} values, not (logp, '
                    f'grad)' if pair else 'the logp returns several values')
        else:
            raise TraceError(f'an fx node of kind {node.op}')
    if not all(isinstance(v, (_T, _C)) for v in out):
        raise TraceError('the logp of one point is not a scalar')
    i, shape = lw.node_of(out[0])
    if _numel(shape) != 1:
        raise TraceError('the logp of one point is not a scalar')
    lp = i if b.n(i) is None else b.pick(i, 0)
    if not pair:
        return b, lp
    # the user's gradient as it stands: a vector of D, whatever its shape
    g, shape = lw.node_of(out[1])
    if _numel(shape) != D:
        raise TraceError(f'the gradient of one point has shape {shape}, '
                         f'not ({D},)')
    return b, (lp, b.bcast(g, D) if b.n(g) is None else g)


# ---------------------------------------------------------------------------
# The adjoint

def _adjoint(b, logp, x):
    """Append the reverse-mode gradient of node ``logp`` with respect to
    node ``x`` to the graph ``b``; returns the gradient node (a vector of x's
    length). Contributions to a node's adjoint are added in the order the
    reverse sweep meets its consumers; a vector's adjoint may stand as a
    scalar (every element the same) until an op needs its elements."""
    nodes = b.nodes
    need = [False] * len(nodes)
    for i, nd in enumerate(nodes):
        need[i] = nd.op == 'x' or any(need[a] for a in nd.args)
    adj = {logp: b.lit(1.0)}

    def acc(i, c):
        if need[i]:
            adj[i] = c if i not in adj else b.binary('add', adj[i], c)

    def vec(g, n):
        return g if b.n(g) is not None else b.bcast(g, n)

    def red(g, i, n_out):
        """g, the adjoint of an n_out output, as the contribution to
        operand i (a scalar operand of a vector op takes the sum)."""
        if b.n(i) is None and n_out is not None:
            return b.sum(vec(g, n_out))
        return g

    for i in range(logp, -1, -1):
        if i not in adj or not need[i]:
            continue
        nd = nodes[i]
        g, op, n = adj[i], nd.op, nd.n
        if op == 'x' or op in LOGIC:
            continue
        a = nd.args[0] if nd.args else None
        if op in ('add', 'sub'):
            x1, x2 = nd.args
            acc(x1, red(g, x1, n))
            if need[x2]:
                acc(x2, red(g if op == 'add' else b.unary('neg', g), x2, n))
        elif op == 'mul':
            x1, x2 = nd.args
            if need[x1]:
                acc(x1, red(b.binary('mul', g, x2), x1, n))
            if need[x2]:
                acc(x2, red(b.binary('mul', g, x1), x2, n))
        elif op == 'div':
            x1, x2 = nd.args
            t = b.binary('div', g, x2)
            if need[x1]:
                acc(x1, red(t, x1, n))
            if need[x2]:
                acc(x2, red(b.unary('neg', b.binary('mul', t, i)), x2, n))
        elif op == 'neg':
            acc(a, b.unary('neg', g))
        elif op == 'recip':
            acc(a, b.unary('neg', b.binary('mul', b.binary('mul', g, i), i)))
        elif op == 'exp':
            acc(a, b.binary('mul', g, i))
        elif op == 'log':
            acc(a, b.binary('div', g, a))
        elif op == 'log1p':
            acc(a, b.binary('div', g, b.binary('add', a, b.lit(1.0))))
        elif op == 'sqrt':
            acc(a, b.binary('div', g, b.binary('mul', b.lit(2.0), i)))
        elif op == 'sum':
            acc(a, g)
        elif op == 'where':
            # the selected branch's: the other takes a zero
            c, x1, x2 = nd.args
            z = b.lit(0.0)
            if need[x1]:
                acc(x1, red(b.where(c, g, z), x1, n))
            if need[x2]:
                acc(x2, red(b.where(c, z, g), x2, n))
        elif op == 'bcast':
            acc(a, b.sum(vec(g, n)))
        elif op == 'pick':
            acc(a, b.gather([(g, None) if j == nd.attr else None
                             for j in range(b.n(a))]))
        elif op == 'mv':
            idx, tr = nd.attr
            t = b.consts[idx][0]
            M = _Mat(idx, not tr, tuple(t.shape) if tr
                     else tuple(t.shape)[::-1])
            acc(a, b.mv(M, vec(g, n)))
        elif op == 'gather':
            gv = vec(g, n)
            for k, src in enumerate(nd.args):
                if not need[src]:
                    continue
                pos = [j for j, e in enumerate(nd.attr)
                       if e is not None and e[0] == k]
                if b.n(src) is None:
                    c = b.pick(gv, pos[0])
                    for j in pos[1:]:
                        c = b.binary('add', c, b.pick(gv, j))
                    acc(src, c)
                    continue
                # layer l holds the l-th output position of each source
                # position: one gather a layer, added in order
                hits = [[] for _ in range(b.n(src))]
                for j in pos:
                    hits[nd.attr[j][1]].append(j)
                c = None
                for layer in range(max(len(h) for h in hits)):
                    lay = b.gather([(gv, h[layer]) if len(h) > layer
                                    else None for h in hits])
                    c = lay if c is None else b.binary('add', c, lay)
                acc(src, c)
        else:
            raise AssertionError(op)
    D = nodes[x].n
    if x not in adj:
        return b.gather([None] * D)
    return vec(adj[x], D)


# ---------------------------------------------------------------------------
# The program

class Program:
    """A traced density: ``nodes`` in evaluation order (forward, then the
    adjoint; or the user's own logp and gradient as traced), the ``logp``
    (scalar) and ``grad`` (length D) node ids, and the constants
    (``consts``: (tensor, kind) with kind 'scal', 'vec' or 'mat';
    ``offsets``: each one's offset in the packed parameters)."""

    def __init__(self, D, nodes, logp, grad, consts, const_fns=None):
        self.D = int(D)
        self.nodes = nodes
        self.logp, self.grad = logp, grad
        self.consts = consts
        self.const_fns = const_fns or [None] * len(consts)
        self.offsets, off = [], 0
        for t, _ in consts:
            self.offsets.append(off)
            off += t.numel()
        self.n_params = off
        self._eval_cache = {}
        self._sources = {}

    def pack(self, dtype=torch.float64, device='cpu', leaves=None):
        """The constants, flattened (matrices row-major) into one vector:
        their values at the trace, or at other ``leaves`` (the runtime
        parameters the function was traced with), each constant computed
        from the leaves as the function computes it."""
        if not self.consts:
            return torch.zeros(1, dtype=dtype, device=device)
        vals = [t if leaves is None or fn is None else fn(leaves)
                for (t, _), fn in zip(self.consts, self.const_fns)]
        return torch.cat([t.detach().reshape(-1).to(device=device,
                                                   dtype=dtype)
                          for t in vals])

    def matrix(self, idx, tr):
        """The (m, n) shape of constant ``idx`` read transposed or not."""
        m0, n0 = self.consts[idx][0].shape
        return (n0, m0) if tr else (m0, n0)

    @property
    def n_ops(self):
        """Floating-point operations of one evaluation (logp and gradient):
        one an element of an elementwise op, n a sum of n, 2 m n a matrix
        product; gathers, picks and broadcasts move data only."""
        total = 0
        for nd in self.nodes:
            if (nd.op in UNARY or nd.op in BINARY or nd.op in LOGIC
                    or nd.op == 'where'):
                total += nd.n or 1
            elif nd.op == 'sum':
                total += self.nodes[nd.args[0]].n
            elif nd.op == 'mv':
                m, n = self.matrix(*nd.attr)
                total += 2 * m * n
        return total

    def describe(self):
        """A one-line summary: node count by op."""
        counts = {}
        for nd in self.nodes:
            counts[nd.op] = counts.get(nd.op, 0) + 1
        return ', '.join(f'{k} {v}' for k, v in sorted(counts.items()))

    def source(self, dtype):
        """The CUDA translation unit of this program in ``dtype``
        (``ops/codegen.py``), generated once."""
        key = str(dtype)
        if key not in self._sources:
            from .codegen import cuda_source
            self._sources[key] = cuda_source(self, dtype)
        return self._sources[key]

    # -- the interpreter ---------------------------------------------------
    def _prepared(self, dtype, device):
        """Literals as tensors of the run dtype on the device, and each
        gather's column index: into its one vector source when it reads
        only that one, else into its sources laid side by side with a zero
        column last (then ``direct`` is False)."""
        key = (dtype, device)
        if key not in self._eval_cache:
            lits, gidx = {}, {}
            for i, nd in enumerate(self.nodes):
                if nd.op == 'lit':
                    lits[i] = torch.tensor(float.fromhex(nd.attr),
                                           dtype=dtype, device=device)
                elif nd.op == 'gather':
                    widths = [self.nodes[s].n or 1 for s in nd.args]
                    start = np.concatenate([[0], np.cumsum(widths)])
                    zero = int(start[-1])
                    col = [zero if e is None else
                           int(start[e[0]]) + max(e[1], 0)
                           for e in nd.attr]
                    direct = (len(nd.args) == 1 and None not in nd.attr
                              and self.nodes[nd.args[0]].n is not None)
                    gidx[i] = (torch.as_tensor(col, dtype=torch.long,
                                               device=device), direct)
            self._eval_cache[key] = (lits, gidx)
        return self._eval_cache[key]

    def logp_and_grad(self, x, params, ordered=True):
        """(logp (C,), grad (C, D)) at x (C, D) with the packed constants
        ``params`` (x's dtype and device): in the kernels' order
        (``ordered``; every sum in the warp's order, ``warp_sum``), or with
        each sum one torch sum and each matrix product one matmul."""
        C = x.shape[0]
        lits, gidx = self._prepared(x.dtype, x.device)
        vals = [None] * len(self.nodes)
        for i, nd in enumerate(self.nodes):
            op, a = nd.op, [vals[j] for j in nd.args]
            if op == 'x':
                v = x
            elif op == 'lit':
                v = lits[i]
            elif op == 'cscal':
                v = params[self.offsets[nd.attr]]
            elif op == 'cvec':
                off = self.offsets[nd.attr]
                v = params[off:off + nd.n].expand(C, nd.n)
            elif op == 'add':
                v = torch.add(*a)
            elif op == 'sub':
                v = torch.sub(*a)
            elif op == 'mul':
                v = torch.mul(*a)
            elif op == 'div':
                v = torch.div(*a)
            elif op == 'neg':
                v = torch.neg(a[0])
            elif op == 'recip':
                v = torch.reciprocal(a[0])
            elif op == 'exp':
                v = torch.exp(a[0])
            elif op == 'log':
                v = torch.log(a[0])
            elif op == 'log1p':
                v = torch.log1p(a[0])
            elif op == 'sqrt':
                v = torch.sqrt(a[0])
            elif op in LOGIC:
                v = _LOGIC_FNS[op](*a)
            elif op == 'where':
                c = a[0] if a[0].dtype == torch.bool else a[0] != 0
                v = torch.where(c, a[1], a[2])
            elif op == 'sum':
                v = (warp_sum(a[0]) if ordered
                     else torch.sum(a[0], dim=-1))[:, None]
            elif op == 'mv':
                idx, tr = nd.attr
                off = self.offsets[idx]
                m0, n0 = self.consts[idx][0].shape
                M = params[off:off + m0 * n0].view(m0, n0)
                M = M.T if tr else M
                v = (warp_sum(M[None] * a[0][:, None, :]) if ordered
                     else a[0] @ M.T)
            elif op == 'gather':
                idx, direct = gidx[i]
                if direct:
                    v = a[0][:, idx]
                else:
                    parts = [s.expand(C, 1) if self.nodes[j].n is None
                             else s for j, s in zip(nd.args, a)]
                    parts.append(x.new_zeros(C, 1))
                    v = torch.cat(parts, dim=-1)[:, idx]
            elif op == 'pick':
                v = a[0][:, nd.attr:nd.attr + 1]
            elif op == 'bcast':
                v = a[0].expand(C, nd.n) if a[0].dim() else \
                    a[0].expand(C, nd.n)
            else:
                raise AssertionError(op)
            vals[i] = v
        logp = vals[self.logp]
        logp = logp.expand(C, 1)[:, 0] if logp.dim() else logp.expand(C)
        return logp.contiguous(), vals[self.grad].expand(C, self.D) \
            .contiguous()


_LOGIC_FNS = {'lt': torch.lt, 'le': torch.le, 'gt': torch.gt, 'ge': torch.ge,
              'eq': torch.eq, 'ne': torch.ne, 'and': torch.logical_and,
              'or': torch.logical_or, 'not': torch.logical_not}


def _prune(b, logp, grad):
    """The graph's nodes that ``logp`` and ``grad`` need, renumbered in
    order; returns (nodes, logp, grad)."""
    keep = set()
    stack = [logp, grad]
    while stack:
        i = stack.pop()
        if i not in keep:
            keep.add(i)
            stack.extend(b.nodes[i].args)
    order = sorted(keep)
    new = {old: k for k, old in enumerate(order)}
    nodes = [Node(b.nodes[i].op, [new[a] for a in b.nodes[i].args],
                  b.nodes[i].n, b.nodes[i].attr) for i in order]
    return nodes, new[logp], new[grad]


def trace_density(logp, D, dtype=torch.float64, device='cpu', leaves=(),
                  batch=False, with_grad=False):
    """Trace ``logp`` (batched torch, called here on one point x of shape
    (D,) of ``dtype`` on ``device``, and on ``leaves``, tensors it reads as
    runtime parameters: ``logp(x, *leaves)``) into a ``Program``; ``batch``
    when it runs the point as a batch of one (``x[None]``), so that its
    one-element values are scalars (``_Lower``). With ``with_grad`` the
    function returns the user's own ``(logp, grad)`` of the point, and the
    program's gradient is the trace of ``grad``, run forward as the user
    wrote it (no adjoint is derived). Raises ``TraceError`` naming the
    first aten op outside the op set, or what else keeps the function
    from tracing, or a program the kernels cannot hold
    (``ops.codegen.check_limits``)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from .codegen import check_limits
    x = torch.zeros(int(D), dtype=dtype, device=device)
    try:
        gm = make_fx(logp)(x, *leaves)
    except TraceError:
        raise
    except Exception as exc:
        raise TraceError(f'make_fx could not trace the logp: '
                         f'{type(exc).__name__}: {exc}'.splitlines()[0]) \
            from exc
    b, out = _lower(gm, int(D), dtype, leaves, batch, with_grad)
    if with_grad:
        out, grad = out
    else:
        x_id = next(i for i, nd in enumerate(b.nodes) if nd.op == 'x')
        grad = _adjoint(b, out, x_id)
    nodes, lp, g = _prune(b, out, grad)
    prog = Program(D, nodes, lp, g, b.consts, b.const_fns)
    check_limits(prog, torch.finfo(dtype).bits // 8)
    return prog


# ---------------------------------------------------------------------------
# The key of a trace

def _leaf_key(v, seen, depth):
    if torch.is_tensor(v):
        t = v.detach()
        return ('t', id(v), str(t.dtype), tuple(t.shape),
                t.cpu().contiguous().numpy().tobytes())
    if isinstance(v, np.ndarray):
        return ('a', str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, (bool, int, float, complex, str, type(None))):
        return ('n', v)
    if isinstance(v, (list, tuple)):
        return ('l',) + tuple(_leaf_key(x, seen, depth) for x in v)
    if callable(v) and depth < 3 and id(v) not in seen:
        return ('f', id(v)) + _state(v, seen, depth + 1)
    return ('o', id(v))


def _state(fn, seen, depth):
    """The values a callable reads besides its argument: a module's
    tensors and number attributes; a function's closure cells, defaults
    and the globals its code names; an object's attributes."""
    seen.add(id(fn))
    if isinstance(fn, torch.nn.Module):
        leaves = [t for _, t in sorted(fn.state_dict(keep_vars=True).items())]
        leaves += [v for _, v in sorted(vars(fn).items())
                   if isinstance(v, (bool, int, float))]
    elif hasattr(fn, '__code__'):
        leaves = [c.cell_contents for c in (fn.__closure__ or ())
                  if _has_contents(c)]
        leaves += list(fn.__defaults__ or ())
        g = getattr(fn, '__globals__', {})
        leaves += [g[k] for k in fn.__code__.co_names
                   if k in g and not isinstance(g[k], type(math))]
    elif hasattr(fn, '__dict__'):
        leaves = [v for _, v in sorted(vars(fn).items())]
    else:
        leaves = []
    return tuple(_leaf_key(v, seen, depth) for v in leaves)


def _has_contents(cell):
    try:
        cell.cell_contents
    except ValueError:
        return False
    return True


def trace_key(logp, *more):
    """A value equal between two calls when ``trace_density(logp, ...)``
    would give the same program and constants: the function's identity
    and the bytes of every tensor and array, and every number, that it
    closes over or names (its closure, defaults and the globals its code
    names; a module's state; one level into the functions among them). A
    tensor mutated in place or rebound, or a number changed, changes it.
    ``more``: other values the trace reads (a gradient function, the
    logp's arguments), each keyed the same way."""
    seen = set()
    key = (id(logp),) + _state(logp, seen, 0)
    for v in more:
        key += (((id(v),) + _state(v, seen, 0)) if callable(v)
                else _leaf_key(v, seen, 0),)
    return key
