from .gaussianized import GBS, GIS, GHM
from .bridge import bridge
from .importance import importance
from .harmonic import harmonic

__all__ = ['GBS', 'GIS', 'GHM', 'bridge', 'importance', 'harmonic']
