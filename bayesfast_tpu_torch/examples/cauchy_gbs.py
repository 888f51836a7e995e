"""48-d bimodal Cauchy + GBS evidence: the twin of ``examples/cauchy_gbs.py``
(fiducial logz = -254.627; published: -254.636 +- 0.094). Heavy tails and
2^48 modes.
"""

from ..interop import cauchy_density
from . import run_anchor

FIDUCIAL = -254.627


def main():
    return run_anchor(*cauchy_density(), seed=48, fiducial=FIDUCIAL)


if __name__ == '__main__':
    main()
