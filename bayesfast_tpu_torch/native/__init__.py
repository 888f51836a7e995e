"""The port's host library (C and OpenMP): counterpart of
``bayesfast_tpu/native``."""

from .bindings import (available, sobol_points, kde_cdf, spline_eval,
                       spline_deriv, spline_solve)

__all__ = ['available', 'sobol_points', 'kde_cdf', 'spline_eval',
           'spline_deriv', 'spline_solve']
