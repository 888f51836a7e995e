from . import random
from . import sobol
from .random import get_generator, set_generator, spawn_generator
from .acor import integrated_time, effective_sample_size, rhat
from .kde import kde

__all__ = ['random', 'sobol', 'get_generator', 'set_generator',
           'spawn_generator', 'integrated_time', 'effective_sample_size',
           'rhat', 'kde']
