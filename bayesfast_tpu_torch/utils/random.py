"""Global random-generator registry.

Counterpart of ``bayesfast_tpu/utils/random.py``: a module-level generator
with ``get/set`` accessors plus ``spawn_generator``. JAX keys become
explicit ``torch.Generator`` objects seeded through numpy ``SeedSequence``s
(which also give the stream separation of ``spawn_generator``). The two
frameworks give different numbers from the same seed; tests that compare
them make their inputs with numpy.
"""

import numpy as np
import torch

__all__ = ['get_generator', 'set_generator', 'spawn_generator',
           'generator_from_seed']

_gen = None


def generator_from_seed(seed, device='cpu'):
    """A ``torch.Generator`` on ``device`` (default the CPU) seeded from an
    int or a ``SeedSequence``."""
    ss = (seed if isinstance(seed, np.random.SeedSequence)
          else np.random.SeedSequence(int(seed)))
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return g


def get_generator():
    """Return the global generator (creating an entropy-seeded one)."""
    global _gen
    if _gen is None:
        _gen = generator_from_seed(np.random.SeedSequence())
    return _gen


def set_generator(seed_or_gen):
    """Set the global generator from an int seed or a ``torch.Generator``."""
    global _gen
    if isinstance(seed_or_gen, (int, np.integer)):
        _gen = generator_from_seed(int(seed_or_gen))
    elif isinstance(seed_or_gen, torch.Generator):
        _gen = seed_or_gen
    else:
        raise ValueError('expected an int seed or a torch.Generator.')


def spawn_generator(gen, n):
    """Derive ``n`` independent generators from ``gen`` (advancing it)."""
    n = int(n)
    if n <= 0:
        raise ValueError('n should be a positive int.')
    root = int(torch.randint(0, 2 ** 62, (), generator=gen))
    return [generator_from_seed(s)
            for s in np.random.SeedSequence(root).spawn(n)]
