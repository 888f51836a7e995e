"""Tiny call-counting decorator (``bayesfast/utils/_call_counter.py``).

A copy of ``bayesfast_tpu/utils/_call_counter.py``, which imports no
framework: the port keeps its own copy rather than import the JAX package.
"""

import functools

__all__ = ['call_counter']


def call_counter(f):
    @functools.wraps(f)
    def wrapped(*args, **kwargs):
        wrapped.count += 1
        return f(*args, **kwargs)
    wrapped.count = 0
    return wrapped
