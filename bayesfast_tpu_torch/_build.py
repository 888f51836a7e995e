"""Build and load the CUDA kernels (``csrc/*.cu``).

The kernels are compiled by ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes). The library is built at first use into
``bayesfast_tpu_torch/build/``, named by a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is reused. A failed
build raises with the compiler's output.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

__all__ = ['load_library', 'build_library', 'NVCC_FLAGS']

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, 'build')
# no --use_fast_math, and no FMA contraction: the kernels' elementwise
# arithmetic then rounds exactly as the plain torch versions' separate ops
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '--fmad=false',
              '-lineinfo']

_lib = None
last_build_seconds = None


def _sources():
    return sorted(glob.glob(os.path.join(_SRC_DIR, '*.cu'))
                  + glob.glob(os.path.join(_SRC_DIR, '*.cuh')))


def _nvcc():
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    cands = ([os.path.join(home, 'bin', 'nvcc')] if home else []) + \
        [shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc']
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA toolkit.')


def _lib_path():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for s in _sources():
        with open(s, 'rb') as f:
            h.update(os.path.basename(s).encode() + f.read())
    return os.path.join(BUILD_DIR, f'libbf_nuts_{h.hexdigest()[:16]}.so')


def build_library(verbose=False):
    """Compile the sources if the hashed library is missing; returns its
    path. Sets ``last_build_seconds`` (0.0 when the library existed)."""
    global last_build_seconds
    out = _lib_path()
    if os.path.exists(out):
        last_build_seconds = 0.0
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in _sources() if s.endswith('.cu')]
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, '-Xptxas', '-v', '-o', tmp, *cu]
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, text=True)
    last_build_seconds = time.time() - t0
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError('nvcc failed:\n' + ' '.join(cmd) + '\n'
                           + res.stdout + res.stderr)
    if verbose:
        print(res.stdout + res.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load_library(verbose=False):
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library(verbose))
    c_int, c_uint, vp = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p
    lib.nuts_chunk_launch.restype = c_int
    lib.nuts_chunk_launch.argtypes = [
        c_int, c_int, c_int,              # warmup, f64, density id
        c_int, c_int, c_int, c_int,       # C, D, K, max_treedepth
        c_uint, c_uint, c_uint,           # seed, i0, chain_start
        c_int, c_int,                     # adapt_step, adapt_metric
        ctypes.POINTER(ctypes.c_double),  # fargs[8]
        ctypes.POINTER(vp), c_int,        # pointer table, its length
        vp]                               # cudaStream_t
    lib.nuts_error_string.restype = ctypes.c_char_p
    lib.nuts_error_string.argtypes = [c_int]
    _lib = lib
    return lib
