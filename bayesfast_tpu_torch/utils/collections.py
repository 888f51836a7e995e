"""Named-variable containers used by the pipeline graph.

API parity targets: ``bayesfast/utils/collections.py`` (``VariableDict``,
``PropertyList``). The internals here are organised differently: a
``VariableDict`` keeps ONE slot table mapping each variable name to a
two-element ``[value, jacobian]`` record, and the ``fun`` / ``jac``
attributes are lightweight mapping views into slot 0 / slot 1 of that
table. This keeps value+jacobian pairs physically adjacent (they are
almost always written together by the pipeline executor) while preserving
the reference's dual-dict access pattern.

A copy of ``bayesfast_tpu/utils/collections.py``, which imports no framework: the
port keeps its own copy rather than import the JAX package.
"""

import copy
from collections.abc import MutableMapping

import numpy as np

__all__ = ['VariableDict', 'PropertyList']

_MISSING_MSG = ('variable "%s" has neither a value nor a jacobian recorded '
                'in this VariableDict.')


class _SlotView(MutableMapping):
    """Mapping view over one slot (0=value, 1=jacobian) of a slot table."""

    __slots__ = ('_table', '_slot')

    def __init__(self, table, slot):
        self._table = table
        self._slot = slot

    def __getitem__(self, name):
        # Missing names raise (matching reference dict semantics,
        # ``bayesfast/utils/collections.py``) so pipeline wiring errors
        # surface instead of propagating silently as None; use ``.get()``
        # (from MutableMapping) for the None-returning lookup.
        rec = self._table.get(name)
        if rec is None:
            raise KeyError(name)
        return rec[self._slot]

    def __setitem__(self, name, value):
        rec = self._table.get(name)
        if rec is None:
            rec = self._table[name] = [None, None]
        rec[self._slot] = value

    def __delitem__(self, name):
        rec = self._table[name]
        rec[self._slot] = None
        if rec[0] is None and rec[1] is None:
            del self._table[name]

    def __iter__(self):
        return iter(self._table)

    def __len__(self):
        return len(self._table)

    def __contains__(self, name):
        return name in self._table


class VariableDict:
    """Per-evaluation record of named pipeline variables.

    Each variable name owns a ``[value, jacobian]`` slot pair. ``vd.fun``
    and ``vd.jac`` are live views; ``vd[name]`` returns a length-2 object
    array ``(value, jacobian)`` and ``vd[name] = (value, jacobian)`` fills
    both slots, matching the reference interface
    (``bayesfast/utils/collections.py:9-77``).
    """

    __slots__ = ('_table', '_fun', '_jac')

    def __init__(self):
        self._table = {}
        self._fun = _SlotView(self._table, 0)
        self._jac = _SlotView(self._table, 1)

    @property
    def fun(self):
        return self._fun

    @property
    def jac(self):
        return self._jac

    def _pair(self, name):
        rec = self._table.get(name)
        if rec is None:
            import warnings
            warnings.warn(_MISSING_MSG % name, RuntimeWarning)
            rec = (None, None)
        out = np.empty(2, dtype=object)
        out[0], out[1] = rec[0], rec[1]
        return out

    def __getitem__(self, name):
        if isinstance(name, str):
            return self._pair(name)
        if isinstance(name, (list, tuple, np.ndarray)):
            sub = VariableDict()
            for n in name:
                pair = self._pair(n)
                sub._table[n] = [pair[0], pair[1]]
            return sub
        raise ValueError('VariableDict keys are variable names (str) or '
                         'sequences of names.')

    def __setitem__(self, name, pair):
        if not isinstance(name, str):
            raise ValueError('VariableDict keys are variable names (str).')
        try:
            value, jacobian = pair[0], pair[1]
        except (TypeError, IndexError, KeyError) as exc:
            raise ValueError('assignment expects a (value, jacobian) '
                             'pair.') from exc
        self._table[name] = [value, jacobian]

    def __contains__(self, name):
        return name in self._table

    def __repr__(self):
        names = ', '.join(self._table)
        return f'VariableDict({names})'

    @classmethod
    def get(cls, var_dicts, name, target='fun'):
        """Extract one variable across a VariableDict or a sequence of them,
        stacking to an array in the sequence case."""
        if not isinstance(name, str):
            raise ValueError('VariableDict keys are variable names (str).')
        if target not in ('fun', 'jac'):
            raise ValueError("target should be 'fun' or 'jac'.")
        slot = 0 if target == 'fun' else 1
        if isinstance(var_dicts, VariableDict):
            rec = var_dicts._table.get(name)
            return None if rec is None else rec[slot]
        if hasattr(var_dicts, '__iter__'):
            return np.asarray([cls.get(vd, name, target) for vd in var_dicts])
        raise ValueError('var_dicts should be a VariableDict or an iterable '
                         'of them.')


class PropertyList:
    """List whose contents pass through a normalising check on mutation.

    Used for module/surrogate/variable-name lists whose setters must
    re-validate after in-place edits (reference
    ``bayesfast/utils/collections.py:80-143``). Implemented by subclass-free
    delegation: every mutating list method is routed through ``_apply``,
    which runs the operation and then replaces the backing list with the
    checker's (possibly normalised) output.
    """

    _MUTATORS = frozenset(('append', 'extend', 'insert', 'remove', 'pop',
                           'clear', 'sort', 'reverse'))
    _READERS = frozenset(('index', 'count'))

    def __init__(self, iterable=(), check=None):
        if check is not None and not callable(check):
            raise ValueError('check should be callable or None.')
        if isinstance(iterable, PropertyList):
            items = list(iterable._items)
        elif isinstance(iterable, str):
            items = [iterable]
        else:
            items = list(iterable)
        self._items = items
        self._check = check
        self.check()

    def check(self):
        if self._check is not None:
            self._items = list(self._check(self._items))

    def _apply(self, method, *args, **kwargs):
        result = getattr(self._items, method)(*args, **kwargs)
        self.check()
        return result

    def __getattr__(self, name):
        if name in PropertyList._MUTATORS:
            return lambda *a, **kw: self._apply(name, *a, **kw)
        if name in PropertyList._READERS:
            return getattr(self._items, name)
        if name == 'copy':
            return lambda: copy.copy(self)
        raise AttributeError(name)

    def __getitem__(self, i):
        return self._items[i]

    def __setitem__(self, i, item):
        self._items[i] = item
        self.check()

    def __delitem__(self, i):
        del self._items[i]
        self.check()

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __eq__(self, other):
        if isinstance(other, PropertyList):
            return self._items == other._items
        return self._items == other

    def __str__(self):
        return str(self._items)

    def __repr__(self):
        return f'PropertyList({self._items!r})'
