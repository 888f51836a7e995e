"""64-d ring + GBS evidence: the twin of ``examples/ring_gbs.py`` (fiducial
logz = -114.492; published: -114.473 +- 0.065).
"""

from ..interop import ring_density
from . import run_anchor

FIDUCIAL = -114.492


def main():
    return run_anchor(*ring_density(), seed=64, fiducial=FIDUCIAL)


if __name__ == '__main__':
    main()
