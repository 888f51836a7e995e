from .density import DensityLite
from .sample import sample

__all__ = ['DensityLite', 'sample']
