from .sample_trace import (SampleTrace, NTrace, HTrace, TNTrace, THTrace,
                           ETrace, CTrace, TraceTuple, StatsView,
                           _get_step_size, _get_metric)
from .nuts import nuts_transition, nuts_transition_batched, NutsStats
from .hmc import hmc_transition, HmcStats
from .chain import ChainDriver, ChainCarry

__all__ = ['SampleTrace', 'NTrace', 'HTrace', 'TNTrace', 'THTrace', 'ETrace',
           'CTrace', 'TraceTuple', 'StatsView', 'nuts_transition',
           'nuts_transition_batched', 'NutsStats',
           'hmc_transition', 'HmcStats', 'ChainDriver', 'ChainCarry']
