from .sample_trace import (SampleTrace, NTrace, TraceTuple, StatsView,
                           _get_step_size, _get_metric)
from .nuts import NutsStats
from .chain import ChainDriver, ChainCarry

__all__ = ['SampleTrace', 'NTrace', 'TraceTuple', 'StatsView', 'NutsStats',
           'ChainDriver', 'ChainCarry']
