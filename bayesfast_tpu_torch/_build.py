"""Build and load the CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library of its own with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes). The libraries are built at first use into
``bayesfast_tpu_torch/build/``, named by a hash of the source, the headers
and the flags, so an edited source is rebuilt and an unchanged one is
reused. ``build_library`` starts one ``nvcc`` for each source that needs it,
all at once. A failed build raises with the compiler's output.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

__all__ = ['load_library', 'build_library', 'build_log', 'NVCC_FLAGS',
           'LIBRARIES']

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, 'build')
# no --use_fast_math, and no FMA contraction: the kernels' elementwise
# arithmetic then rounds exactly as the plain torch versions' separate ops
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '--fmad=false',
              '-lineinfo', '--split-compile=0']
#: library name -> its source in csrc/
LIBRARIES = {'nuts': 'nuts.cu', 'kde': 'kde.cu'}

_libs = {}
last_build_seconds = None


def _nvcc():
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    cands = ([os.path.join(home, 'bin', 'nvcc')] if home else []) + \
        [shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc']
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA toolkit.')


def _lib_path(name):
    src = os.path.join(_SRC_DIR, LIBRARIES[name])
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for s in [src] + sorted(glob.glob(os.path.join(_SRC_DIR, '*.cuh'))):
        with open(s, 'rb') as f:
            h.update(os.path.basename(s).encode() + f.read())
    return src, os.path.join(BUILD_DIR,
                             f'libbf_{name}_{h.hexdigest()[:16]}.so')


def build_library(names=None, verbose=False):
    """Compile the libraries ``names`` (default: all) whose hashed file is
    missing, one ``nvcc`` each, all started together; returns
    ``{name: path}``. Sets ``last_build_seconds`` (the wall of the parallel
    build; 0.0 when every library existed). Each library's compiler output
    is kept beside it (``build_log``)."""
    global last_build_seconds
    names = list(LIBRARIES) if names is None else list(names)
    paths, jobs = {}, []
    t0 = time.time()
    for name in names:
        src, out = _lib_path(name)
        paths[name] = out
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, '-Xptxas', '-v', '-o', tmp, src]
        jobs.append((name, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, cmd, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(' '.join(cmd) + '\n' + log)
            continue
        if verbose:
            print(f'[{name}] ' + log)
        with open(out[:-3] + '.log', 'w') as f:
            f.write(log)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    last_build_seconds = time.time() - t0 if jobs else 0.0
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    return paths


def build_log(name):
    """The compiler's output (``-Xptxas -v``: each kernel's registers and
    spills) of the build of library ``name`` that the current sources
    name, or None when there is no such build."""
    path = _lib_path(name)[1][:-3] + '.log'
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def _bind(name, lib):
    c_int, c_uint, vp = ctypes.c_int, ctypes.c_uint, ctypes.c_void_p
    if name == 'nuts':
        lib.nuts_chunk_launch.restype = c_int
        lib.nuts_chunk_launch.argtypes = [
            c_int, c_int, c_int,              # warmup, f64, density id
            c_int, c_int, c_int, c_int,       # C, D, K, max_treedepth
            c_uint, c_uint, c_uint,           # seed, i0, chain_start
            c_int, c_int,                     # adapt_step, adapt_metric
            ctypes.POINTER(ctypes.c_double),  # fargs (8 + 14)
            ctypes.POINTER(vp), c_int,        # pointer table, its length
            vp]                               # cudaStream_t
        lib.nuts_block_launch.restype = c_int
        lib.nuts_block_launch.argtypes = [
            c_int, c_int,                     # f64, density id
            c_int, c_int, c_int,              # C, D, max_treedepth
            c_uint, c_uint,                   # seed, chain_start
            ctypes.POINTER(ctypes.c_double),  # fargs (8 + 14)
            ctypes.POINTER(vp), c_int,        # pointer table, its length
            vp]                               # cudaStream_t
        lib.nuts_error_string.restype = ctypes.c_char_p
        lib.nuts_error_string.argtypes = [c_int]
    elif name == 'kde':
        lib.kde_cdf_launch.restype = c_int
        lib.kde_cdf_launch.argtypes = [
            c_int, c_int,                     # f64, exact erf
            c_int, c_int, c_int,              # D, M, N
            c_int, c_int,                     # splits, points per split
            vp, vp, vp, vp,                   # x, data, w / 2, sqrt(1/2) / h
            vp, vp,                           # float64 scratch, out
            vp]                               # cudaStream_t
        lib.kde_error_string.restype = ctypes.c_char_p
        lib.kde_error_string.argtypes = [c_int]


def load_library(name, verbose=False):
    """The loaded kernel library ``name`` (built at first use)."""
    if name not in _libs:
        lib = ctypes.CDLL(build_library([name], verbose)[name])
        _bind(name, lib)
        _libs[name] = lib
    return _libs[name]
