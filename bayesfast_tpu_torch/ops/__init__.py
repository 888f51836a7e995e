from . import constraint
from . import densities
from .densities import RotatedBanana, DiagGaussian

__all__ = ['constraint', 'densities', 'RotatedBanana', 'DiagGaussian']
