"""Weighted-sum module (``bayesfast_tpu/modules/sum.py``)."""

import numpy as np
import torch

from ..core.module import ModuleBase

__all__ = ['Sum']


class Sum(ModuleBase):
    """Computes ``sum(b * x)`` of the concatenated input vars, per row."""

    _output_min_length = 1
    _output_max_length = 1

    def __init__(self, input_vars, output_vars, delete_vars=(), b=None,
                 label=None):
        super().__init__(
            input_vars=input_vars, output_vars=output_vars,
            delete_vars=delete_vars, input_shapes=-1, output_shapes=None,
            input_scales=None, label=label)
        self.b = b

    @property
    def b(self):
        return self._b

    @b.setter
    def b(self, b):
        if b is not None:
            b = np.atleast_1d(np.asarray(b, np.float64))
            if b.ndim != 1:
                raise ValueError('invalid value for b.')
        self._b = b

    def _fun(self, x):
        if self._b is None:
            return torch.sum(x, dim=-1)
        b = torch.as_tensor(self._b, dtype=x.dtype, device=x.device)
        return torch.sum(b * x, dim=-1)
