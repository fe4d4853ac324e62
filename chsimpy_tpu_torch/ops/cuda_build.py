"""Build and load the hand-written CUDA kernels (csrc/ch_kernels.cu).

``nvcc`` compiles the source into a shared library with a plain C
interface for ``sm_90a`` (Hopper), which ``ctypes`` loads.  The build runs
at first use, on the machine with the card, into ``chsimpy_tpu_torch/build/``
(listed in .gitignore) and is cached there by a hash of the source and the
flags: a second process reuses the library, an edited source builds anew.

``nvcc`` is taken from ``$CUDA_HOME/bin``, then ``PATH``, then
``/usr/local/cuda/bin``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / 'csrc' / 'ch_kernels.cu'
BUILD_DIR = PKG_DIR / 'build'
# -fmad=false: no a*b+c contraction, so each kernel rounds every operation
# as its plain PyTorch version does (those kernels are bandwidth-bound, the
# fused multiply-add buys them nothing); the GEMM calls __fmaf_rn itself
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-shared', '-Xcompiler', '-fPIC', '-Xptxas',
              '-v')

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_BOTH = ('_f32', '_f64')
# entry -> (argument types, the field-type suffixes it is built for)
_SIGNATURES = {
    'ch_mu': ((_P, _P, _LL, _D, _D, _D, _D, _P), _BOTH),
    'ch_update': ((_P, _P, _P, _P, _P, _LL, _P), _BOTH),
    'ch_stats': ((_P, _P, _I, _D, _D, _D, _D, _D, _D, _P, _I, _P, _P), _BOTH),
    'ch_local_stats': ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _D,
                        _D, _D, _D, _D, _P, _I, _P, _P), _BOTH),
    'ch_absdev': ((_P, _LL, _P, _P, _I, _P, _P), _BOTH),
    'ch_slice': ((_P, _P, _P, _LL, _I, _P), ('_f64',)),
    'ch_matmul': ((_P, _I, _LL, _P, _I, _LL, _P, _LL, _I, _I, _I, _P),
                  ('_f32',)),
}


def find_nvcc() -> str:
    home = os.environ.get('CUDA_HOME')
    candidates = [os.path.join(home, 'bin', 'nvcc')] if home else []
    which = shutil.which('nvcc')
    if which:
        candidates.append(which)
    candidates.append('/usr/local/cuda/bin/nvcc')
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels are built "
                       "on the machine with the card")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()
                       + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'libch_kernels_{h}.so'


@functools.lru_cache(maxsize=None)
def build() -> dict:
    """Compile the library unless a build of the same source exists.
    Returns {'path', 'seconds', 'built', 'log'} (log: nvcc's register and
    spill report, empty when the cached library was reused)."""
    so = library_path()
    if so.exists():
        return {'path': str(so), 'seconds': 0.0, 'built': False, 'log': ''}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    cmd = [find_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process sees all or nothing
    return {'path': str(so), 'seconds': seconds, 'built': True,
            'log': proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library with every entry's argument types declared."""
    lib = ctypes.CDLL(build()['path'])
    for base, (argtypes, suffixes) in _SIGNATURES.items():
        for suffix in suffixes:
            fn = getattr(lib, base + suffix)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib
