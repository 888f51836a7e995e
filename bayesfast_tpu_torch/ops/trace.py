"""Trace a user's torch logp into a straight-line program, with its
gradient, and interpret that program in the CUDA NUTS kernels' order.

Counterpart of ``_trace_density`` (``bayesfast_tpu/samplers/
nuts_pallas.py:576-607``), which traces the per-point jnp density once
into a closed jaxpr whose constants become kernel inputs. Here
``trace_density`` runs the user's ``logp`` once on one point ``x`` of
shape (D,) under ``torch.fx.experimental.proxy_tensor.make_fx`` and lowers
the aten graph into a ``Program``: a straight-line list of nodes over
scalars and vectors of static length. The tensors the function closes
over (a rotation, a mask) become the program's constants, read from one
packed parameter vector (``Program.pack``): a new matrix changes the
parameters, not the program. Python numbers in the function become
literals of the program.

The op set is what ``bench.py``'s density and the JAX examples' densities
need: elementwise ``add``, ``sub``, ``mul``, ``div``, ``neg``, ``pow`` by
a constant integer (written as products), ``reciprocal``, ``exp``,
``log``, ``log1p`` and ``sqrt`` over scalars and vectors with
broadcasting; ``sum`` over the last axis (and ``dot``); ``mv`` / ``mm`` of
a vector by a constant matrix (``x @ A.T`` included); static ``slice``
with a step, ``select``, ``cat`` and ``roll``; and the layout ops around
them (views, ``unsqueeze``, ``squeeze``, transposes of a constant,
``_to_copy`` of a constant). Any other aten op raises ``TraceError``
naming it; so does control flow on the data (``make_fx`` refuses to read
a value).

The gradient is the program's own reverse-mode adjoint, written in the
same node set (``_adjoint``), not a trace of autograd: every sum of the
gradient then has the order the program fixes, and both backends (this
module's interpreter and the CUDA functor of ``ops/codegen.py``) follow
it; a traced backward would bring ``slice_backward``, ``select_backward``
and ``expand`` into the op set. Index ops lower to one ``gather`` node
(each output position a position of a source, a scalar source, or zero),
and a gather of a gather is folded into one, so the ring's ``cat`` of
slices becomes one neighbour fetch.

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


def _lit_key(v):
    # the literal's bits: 0.0 and -0.0 stay apart
    return float(v).hex()


class _V:
    """A program value during lowering (a node id): keeps node ids apart
    from the Python numbers of the aten graph."""
    __slots__ = ('i',)

    def __init__(self, i):
        self.i = i


class _Mat:
    """A constant matrix expression: constant ``idx`` (m0, n0), read
    transposed or not; ``shape`` as read."""

    def __init__(self, idx, tr, shape):
        self.idx, self.tr, self.shape = idx, tr, tuple(shape)

    def t(self):
        return _Mat(self.idx, not self.tr, self.shape[::-1])


class _Row:
    """A vector node as a (1, n) matrix (``unsqueeze(v, 0)``)."""

    def __init__(self, i):
        self.i = i


class _Col:
    """A vector node as an (n, 1) matrix (``unsqueeze(v, 1)``)."""

    def __init__(self, i):
        self.i = i


class _Graph:
    """Builds the node list with common subexpressions shared and the
    exact literal identities folded (``x * 1``, ``x / 1``, ``-(-x)``,
    ``-literal``, ``x * -1``). Its methods take and return node ids."""

    def __init__(self):
        self.nodes = []
        self.consts = []          # (tensor, kind): 'scal', 'vec', 'mat'
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

    def const(self, t):
        """A constant tensor: a scalar or vector node, or a ``_Mat``."""
        if id(t) not in self._const_ids:
            if t.dim() > 2 or t.is_complex():
                raise TraceError(f'a constant tensor of shape '
                                 f'{tuple(t.shape)} and type {t.dtype}: '
                                 'real scalars, vectors and matrices only')
            self.consts.append((t, ('scal', 'vec', 'mat')[t.dim()]))
            self._const_ids[id(t)] = len(self.consts) - 1
        idx = self._const_ids[id(t)]
        if t.dim() == 2:
            return _Mat(idx, False, t.shape)
        if t.dim() == 1:
            return _V(self.add_node('cvec', n=int(t.shape[0]), attr=idx))
        return _V(self.add_node('cscal', attr=idx))

    def val(self, v, what):
        """The node id of an operand; numbers become literals."""
        if isinstance(v, _V):
            return v.i
        if isinstance(v, (bool, int, float, np.number)):
            return self.lit(float(v))
        raise TraceError(f'{what} of a matrix: a matrix only enters a '
                         'matrix-vector product')

    def vector(self, v, what):
        """The node id of a vector operand."""
        i = self.val(v, what)
        if self.n(i) is None:
            raise TraceError(f'{what} of a scalar')
        return i

    def unary(self, op, a):
        v = self.lit_value(a)
        if op == 'neg' and v is not None:
            return self.lit(-v)
        if op == 'neg' and self.nodes[a].op == 'neg':
            return self.nodes[a].args[0]
        return self.add_node(op, (a,), self.n(a))

    def binary(self, op, a, b):
        na, nb = self.n(a), self.n(b)
        if na is not None and nb is not None and na != nb:
            if na == 1:
                a, na = self.gather([(a, 0)] * nb), nb
            elif nb == 1:
                b, nb = self.gather([(b, 0)] * na), na
            else:
                raise TraceError(f'{op} of vectors of lengths {na} and {nb}')
        va, vb = self.lit_value(a), self.lit_value(b)
        if op == 'mul':
            if va == 1.0 or vb == 1.0:
                return b if va == 1.0 else a
            if va == -1.0 or vb == -1.0:
                return self.unary('neg', b if va == -1.0 else a)
        if op == 'div' and vb == 1.0:
            return a
        return self.add_node(op, (a, b), na if na is not None else nb)

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
# Lowering of the aten graph: each function takes the program's graph and
# the aten op's arguments (``_V``, ``_Mat``, ``_Row``, ``_Col`` or Python
# values) and returns one of those

def _check_dim(dim, what):
    if dim not in (0, -1):
        raise TraceError(f'{what} over dim {dim} of a vector')


def _pow(b, a, e):
    a = b.val(a, 'aten.pow')
    if not isinstance(e, (int, float)) or float(e) != int(e) or e == 0:
        raise TraceError(f'aten.pow.Tensor_Scalar with the exponent {e}: '
                         'non-zero integer exponents only')
    e = int(e)
    out = a
    for _ in range(abs(e) - 1):
        out = b.binary('mul', out, a)
    return _V(out if e > 0 else b.unary('recip', out))


def _sum(b, a, dims=None, keepdim=False, dtype=None):
    if dims is not None and list(dims) not in ([], [0], [-1]):
        raise TraceError(f'aten.sum over dims {dims} of a vector')
    s = b.sum(b.vector(a, 'aten.sum'))
    return _V(b.gather([(s, None)]) if keepdim else s)


def _slice(b, v, dim=0, start=None, end=None, step=1):
    _check_dim(dim, 'aten.slice')
    v = b.vector(v, 'aten.slice')
    return _V(b.gather([(v, i)
                        for i in range(b.n(v))[slice(start, end, step)]]))


def _select(b, v, dim, index):
    _check_dim(dim, 'aten.select')
    v = b.vector(v, 'aten.select')
    return _V(b.pick(v, range(b.n(v))[index]))


def _cat(b, parts, dim=0):
    _check_dim(dim, 'aten.cat')
    ents = []
    for p in parts:
        p = b.vector(p, 'aten.cat')
        ents += [(p, i) for i in range(b.n(p))]
    return _V(b.gather(ents))


def _roll(b, v, shifts, dims=()):
    shifts = list(shifts) if isinstance(shifts, (list, tuple)) else [shifts]
    dims = list(dims) if isinstance(dims, (list, tuple)) else [dims]
    if len(shifts) != 1 or dims not in ([], [0], [-1]):
        raise TraceError(f'aten.roll by {shifts} over dims {dims}')
    v = b.vector(v, 'aten.roll')
    n, s = b.n(v), int(shifts[0])
    return _V(b.gather([(v, (i - s) % n) for i in range(n)]))


def _mm(b, A, B):
    if isinstance(A, _Row) and isinstance(B, _Mat):
        # (1, n) @ (n, m) is (B^T v)^T
        return _Row(b.mv(B.t(), A.i))
    if isinstance(A, _Mat) and isinstance(B, _Col):
        return _Col(b.mv(A, B.i))
    raise TraceError('aten.mm other than of a vector by a constant matrix')


def _mv(b, M, v):
    if not isinstance(M, _Mat):
        raise TraceError('aten.mv by a matrix that is not a constant')
    return _V(b.mv(M, b.vector(v, 'aten.mv')))


def _transpose(b, M, *dims):
    if isinstance(M, _Mat):
        return M.t()
    if isinstance(M, _V) and b.n(M.i) is not None:
        return M
    raise TraceError('a transpose of other than a constant matrix')


def _permute(b, M, dims):
    if isinstance(M, _Mat) and list(dims) == [1, 0]:
        return M.t()
    if isinstance(M, (_Mat, _V)) and list(dims) in ([0, 1], [0]):
        return M
    raise TraceError(f'aten.permute by {dims}')


def _unsqueeze(b, v, dim):
    if isinstance(v, _V) and b.n(v.i) is None and dim in (0, -1):
        return _V(b.gather([(v.i, None)]))
    if isinstance(v, _V) and dim in (0, -2):
        return _Row(v.i)
    if isinstance(v, _V) and dim in (1, -1):
        return _Col(v.i)
    raise TraceError(f'aten.unsqueeze at dim {dim}')


def _squeeze(b, v, *dims):
    if isinstance(v, (_Row, _Col)):
        return _V(v.i)
    if isinstance(v, _V):
        return _V(b.pick(v.i, 0)) if b.n(v.i) == 1 else v
    raise TraceError('aten.squeeze of a matrix')


def _to_shape(b, v, shape):
    shape = [int(s) for s in shape]
    if isinstance(v, (_Row, _Col)):
        n = b.n(v.i)
        if shape in ([n], [-1]):
            return _V(v.i)
        if shape in (([1, n], [1, -1]) if isinstance(v, _Row)
                     else ([n, 1], [-1, 1])):
            return v
    elif isinstance(v, _Mat):
        if shape == list(v.shape):
            return v
    elif isinstance(v, _V):
        n = b.n(v.i)
        if n is None and shape == []:
            return v
        if n is None and shape in ([1], [-1]):
            return _V(b.gather([(v.i, None)]))
        if n is not None and shape in ([n], [-1]):
            return v
        if n == 1 and shape == []:
            return _V(b.pick(v.i, 0))
        if n is not None and shape in ([1, n], [1, -1]):
            return _Row(v.i)
        if n is not None and shape in ([n, 1], [-1, 1]):
            return _Col(v.i)
    raise TraceError(f'a reshape to {shape}')


def _expand(b, v, sizes, implicit=False):
    sizes = [int(s) for s in sizes]
    if isinstance(v, _V):
        n = b.n(v.i)
        if sizes == [] and n is None:
            return v
        if len(sizes) == 1 and n is None:
            return _V(b.bcast(v.i, sizes[0]))
        if len(sizes) == 1 and sizes[0] in (n, -1):
            return v
        if len(sizes) == 1 and n == 1:
            return _V(b.gather([(v.i, 0)] * sizes[0]))
    raise TraceError(f'aten.expand to {sizes}')


def _identity(b, v, *args, **kwargs):
    return v


def _to_copy(dtype):
    def lower(b, v, *args, **kwargs):
        want = kwargs.get('dtype')
        constant = isinstance(v, _Mat) or (
            isinstance(v, _V) and b.nodes[v.i].op in ('cvec', 'cscal', 'lit'))
        # a constant is cast to the run dtype when it is packed
        if not constant and want is not None and want != dtype:
            raise TraceError(f'aten._to_copy of a variable to {want}')
        return v
    return lower


def _binary(op, swap=False):
    def lower(b, x, y, alpha=1):
        if alpha != 1:
            raise TraceError(f'aten.{op} with alpha {alpha}')
        x, y = b.val(x, f'aten.{op}'), b.val(y, f'aten.{op}')
        return _V(b.binary(op, y, x) if swap else b.binary(op, x, y))
    return lower


def _unary(op):
    def lower(b, x):
        return _V(b.unary(op, b.val(x, f'aten.{op}')))
    return lower


def _dot(b, x, y):
    return _V(b.sum(b.binary('mul', b.vector(x, 'aten.dot'),
                             b.vector(y, 'aten.dot'))))


def _lowerings(dtype):
    ident = _identity
    return {
        'aten.add.Tensor': _binary('add'), 'aten.add.Scalar': _binary('add'),
        'aten.sub.Tensor': _binary('sub'), 'aten.sub.Scalar': _binary('sub'),
        'aten.rsub.Scalar': _binary('sub', swap=True),
        'aten.rsub.Tensor': _binary('sub', swap=True),
        'aten.mul.Tensor': _binary('mul'), 'aten.mul.Scalar': _binary('mul'),
        'aten.div.Tensor': _binary('div'), 'aten.div.Scalar': _binary('div'),
        'aten.neg.default': _unary('neg'),
        'aten.reciprocal.default': _unary('recip'),
        'aten.exp.default': _unary('exp'), 'aten.log.default': _unary('log'),
        'aten.log1p.default': _unary('log1p'),
        'aten.sqrt.default': _unary('sqrt'),
        'aten.pow.Tensor_Scalar': _pow,
        'aten.square.default': lambda b, a: _pow(b, a, 2),
        'aten.sum.dim_IntList': _sum, 'aten.sum.default': _sum,
        'aten.dot.default': _dot,
        'aten.mv.default': _mv, 'aten.mm.default': _mm,
        'aten.t.default': _transpose, 'aten.transpose.int': _transpose,
        'aten.permute.default': _permute,
        'aten.unsqueeze.default': _unsqueeze,
        'aten.squeeze.dim': _squeeze, 'aten.squeeze_.dim': _squeeze,
        'aten.squeeze.dims': _squeeze, 'aten.squeeze.default': _squeeze,
        'aten.view.default': _to_shape, 'aten.reshape.default': _to_shape,
        'aten._unsafe_view.default': _to_shape,
        'aten.expand.default': _expand,
        'aten.clone.default': ident, 'aten.alias.default': ident,
        'aten.detach.default': ident, 'aten.lift_fresh_copy.default': ident,
        'aten._to_copy.default': _to_copy(dtype),
        'aten.slice.Tensor': _slice, 'aten.select.int': _select,
        'aten.cat.default': _cat, 'aten.roll.default': _roll,
    }



def _lower(gm, D, dtype):
    """The aten graph of ``make_fx`` as program nodes; returns (graph,
    logp node id)."""
    b = _Graph()
    table = _lowerings(dtype)
    env = {}

    def arg(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(arg(x) for x in a)
        return a

    out = None
    for node in gm.graph.nodes:
        if node.op == 'placeholder':
            env[node] = _V(b.add_node('x', n=D))
        elif node.op == 'get_attr':
            t = getattr(gm, node.target)
            if not torch.is_tensor(t):
                raise TraceError(f'a constant of type {type(t).__name__}')
            env[node] = b.const(t)
        elif node.op == 'call_function':
            name = str(node.target)
            fn = table.get(name)
            if fn is None:
                raise TraceError(f'{name} is not in the op set of the CUDA '
                                 'NUTS kernels (ops/trace.py)')
            env[node] = fn(b, *arg(node.args), **arg(node.kwargs))
        elif node.op == 'output':
            out = arg(node.args[0])
            if isinstance(out, (list, tuple)):
                if len(out) != 1:
                    raise TraceError('the logp returns several values')
                out = out[0]
        else:
            raise TraceError(f'an fx node of kind {node.op}')
    if isinstance(out, _V) and b.n(out.i) == 1:
        out = _V(b.pick(out.i, 0))
    if not isinstance(out, _V) or b.n(out.i) is not None:
        raise TraceError('the logp of one point is not a scalar')
    return b, out.i


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
        if op == 'x':
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
    adjoint), the ``logp`` (scalar) and ``grad`` (length D) node ids, and
    the constants (``consts``: (tensor, kind) with kind 'scal', 'vec' or
    'mat'; ``offsets``: each one's offset in the packed parameters)."""

    def __init__(self, D, nodes, logp, grad, consts):
        self.D = int(D)
        self.nodes = nodes
        self.logp, self.grad = logp, grad
        self.consts = consts
        self.offsets, off = [], 0
        for t, _ in consts:
            self.offsets.append(off)
            off += t.numel()
        self.n_params = off
        self._eval_cache = {}
        self._sources = {}

    def pack(self, dtype=torch.float64, device='cpu'):
        """The constants, flattened (matrices row-major) into one vector."""
        if not self.consts:
            return torch.zeros(1, dtype=dtype, device=device)
        return torch.cat([t.detach().reshape(-1).to(device=device,
                                                   dtype=dtype)
                          for t, _ in self.consts])

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
            if nd.op in UNARY or nd.op in BINARY:
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


def trace_density(logp, D, dtype=torch.float64, device='cpu'):
    """Trace ``logp`` (batched torch, called here on one point x of shape
    (D,) of ``dtype`` on ``device``) into a ``Program``. Raises
    ``TraceError`` naming the first aten op outside the op set, or what
    else keeps the function from tracing."""
    from torch.fx.experimental.proxy_tensor import make_fx
    x = torch.zeros(int(D), dtype=dtype, device=device)
    try:
        gm = make_fx(logp)(x)
    except TraceError:
        raise
    except Exception as exc:
        raise TraceError(f'make_fx could not trace the logp: '
                         f'{type(exc).__name__}: {exc}'.splitlines()[0]) \
            from exc
    b, out = _lower(gm, int(D), dtype)
    x_id = next(i for i, nd in enumerate(b.nodes) if nd.op == 'x')
    grad = _adjoint(b, out, x_id)
    nodes, lp, g = _prune(b, out, grad)
    return Program(D, nodes, lp, g, b.consts)


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


def trace_key(logp):
    """A value equal between two calls when ``trace_density(logp, ...)``
    would give the same program and constants: the function's identity
    and the bytes of every tensor and array, and every number, that it
    closes over or names (its closure, defaults and the globals its code
    names; a module's state; one level into the functions among them). A
    tensor mutated in place or rebound, or a number changed, changes it."""
    return (id(logp),) + _state(logp, set(), 0)
