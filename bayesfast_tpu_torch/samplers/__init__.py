from .sample_trace import (SampleTrace, NTrace, HTrace, TNTrace, THTrace,
                           ETrace, CTrace, TraceTuple, StatsView,
                           _get_step_size, _get_metric)
from .nuts import NutsStats
from .hmc import hmc_transition, HmcStats
from .chain import ChainDriver, ChainCarry

__all__ = ['SampleTrace', 'NTrace', 'HTrace', 'TNTrace', 'THTrace', 'ETrace',
           'CTrace', 'TraceTuple', 'StatsView', 'NutsStats',
           'hmc_transition', 'HmcStats', 'ChainDriver', 'ChainCarry']
