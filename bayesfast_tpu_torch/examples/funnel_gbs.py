"""16-d Neal funnel + GBS evidence: the twin of ``examples/funnel_gbs.py``
(fiducial logz = -63.4988; published: -63.479 +- 0.017). The sampler runs
at target_accept=0.95 for the neck.
"""

from ..interop import funnel_density
from . import run_anchor

FIDUCIAL = -63.4988


def main():
    return run_anchor(*funnel_density(), seed=16, fiducial=FIDUCIAL)


if __name__ == '__main__':
    main()
