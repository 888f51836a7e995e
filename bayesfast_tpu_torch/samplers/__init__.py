from .sample_trace import SampleTrace, NTrace, TraceTuple, StatsView
from .nuts import NutsStats
from .chain import ChainDriver, ChainCarry

__all__ = ['SampleTrace', 'NTrace', 'TraceTuple', 'StatsView', 'NutsStats',
           'ChainDriver', 'ChainCarry']
