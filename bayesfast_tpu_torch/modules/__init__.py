from .poly import PolyConfig, PolyModel
from .gaussian import Gaussian
from .sum import Sum

__all__ = ['PolyConfig', 'PolyModel', 'Gaussian', 'Sum']
