from . import constraint
from . import densities
from . import ica
from . import kde
from .densities import RotatedBanana, DiagGaussian

__all__ = ['constraint', 'densities', 'ica', 'kde', 'RotatedBanana',
           'DiagGaussian']
