from . import random
from . import sobol
from . import checkpoint
from .random import get_generator, set_generator, spawn_generator
from .acor import integrated_time, effective_sample_size, rhat
from .kde import kde

__all__ = ['random', 'sobol', 'checkpoint', 'parallel', 'get_generator', 'set_generator',
           'spawn_generator', 'integrated_time', 'effective_sample_size',
           'rhat', 'kde', 'all_isinstance', 'Laplace', 'SystematicResampler',
           'make_positive', 'VariableDict', 'PropertyList']


def all_isinstance(iterable, class_or_tuple):
    return (hasattr(iterable, '__iter__') and
            all(isinstance(i, class_or_tuple) for i in iterable))


from . import parallel  # noqa: E402
from .misc import make_positive, SystematicResampler  # noqa: E402
from .laplace import Laplace  # noqa: E402
from .collections import VariableDict, PropertyList  # noqa: E402
