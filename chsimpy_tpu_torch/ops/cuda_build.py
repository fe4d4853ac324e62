"""Build and load the hand-written CUDA kernels (every ``csrc/*.cu``).

``nvcc`` compiles each source (one process per file, all started together)
and links them into one shared library with a plain C interface for
``sm_90a`` (Hopper), which ``ctypes`` loads.  The build runs at first use,
on the machine with the card, into ``chsimpy_tpu_torch/build/`` (listed in
.gitignore) and is cached there by a hash of the sources and the flags: a
second process reuses the library, an edited source builds anew.

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
SOURCES = tuple(sorted((PKG_DIR / 'csrc').glob('*.cu')))
BUILD_DIR = PKG_DIR / 'build'
# -fmad=false: no a*b+c contraction, so each kernel rounds every operation
# as its plain PyTorch version does (those kernels are bandwidth-bound, the
# fused multiply-add buys them nothing; the GEMM's products are the tensor
# cores')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-fmad=false', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_BOTH = ('_f32', '_f64')
# entry -> (argument types, the field-type suffixes it is built for[,
# result type]); every kernel entry returns a cudaError_t as an int
_SIGNATURES = {
    'ch_mu': ((_P, _P, _LL, _D, _D, _D, _D, _P), _BOTH),
    'ch_mu_members': ((_P, _P, _LL, _I, _D, _D, _P, _P, _P), _BOTH),
    'ch_update': ((_P, _P, _P, _P, _P, _LL, _P), _BOTH),
    'ch_update_members': ((_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P), _BOTH),
    'ch_update_otf': ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _D,
                       _D, _P), _BOTH),
    'ch_stats': ((_P, _P, _I, _D, _D, _D, _D, _D, _D, _P, _I, _I, _I, _P,
                  _P, _I, _I, _P), _BOTH),
    'ch_stats_members': ((_P, _P, _I, _I, _D, _D, _D, _P, _P, _D, _P, _I,
                          _I, _I, _P, _P, _I, _I, _P), _BOTH),
    'ch_local_stats': ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _D,
                        _D, _D, _D, _D, _P, _I, _I, _I, _P, _P, _I, _P),
                       _BOTH),
    'ch_local_stats_members': ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _D, _D, _D, _P, _P, _D, _P, _I, _I,
                                _I, _P, _P, _I, _P), _BOTH),
    'ch_cdiv_check': ((_D, _P, _P), ('_f32',)),
    'ch_cdiv_check_random': ((_D, _LL, _LL, _P, _I, _P, _P), ('_f64',)),
    'ch_absdev': ((_P, _LL, _P, _P, _I, _P, _P), _BOTH),
    'ch_row_absdev_members': ((_P, _I, _LL, _LL, _I, _P, _P), _BOTH),
    'ch_absdev_members': ((_P, _LL, _I, _P, _P, _I, _P, _P), _BOTH),
    'ch_absdev_ra_members': ((_P, _LL, _I, _P, _P, _I, _P, _P, _LL, _LL, _I,
                              _P, _P), _BOTH),
    'ch_slice_scale': ((_P, _LL, _P, _I, _P, _P, _P, _P), ('_f64',)),
    'ch_slice': ((_P, _P, _P, _LL, _I, _P), ('_f64',)),
    'ch_slice_scale_members': ((_P, _LL, _I, _P, _I, _P, _P, _P, _P),
                               ('_f64',)),
    'ch_slice_members': ((_P, _P, _P, _LL, _I, _I, _P), ('_f64',)),
    'ch_slice_max': ((_P, _LL, _I, _P, _I, _P, _P, _P), ('_f64',)),
    'ch_slice_sharded': ((_P, _P, _P, _P, _LL, _I, _I, _P), ('_f64',)),
    'ch_slice_one_launch': ((_P, _LL, _I, _P, _P, _P, _P, _I, _P),
                            ('_f64',)),
    'ch_sobol_jitter': ((_P, _I, _I, _P, _P, _P, _I, _I, _D, _P), _BOTH),
    'ch_threefry_jitter': ((_P, _I, _I, _LL, _I, _I, _P, _P, _P, _D, _P),
                           _BOTH),
    'ch_matmul': ((_P, _I, _LL, _LL, _P, _I, _LL, _LL, _P, _LL, _I, _I, _I,
                   _I, _P, _P), ('_f32',)),
    'ch_matmul_workspace': ((_I, _I, _I, _I, _I), ('_f32',), _LL),
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
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode() + b'\0' + src.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'libch_kernels_{h.hexdigest()[:16]}.so'


@functools.lru_cache(maxsize=None)
def build() -> dict:
    """Compile the library unless a build of the same sources exists.
    Returns {'path', 'seconds', 'built', 'log'} (log: nvcc's register and
    spill report, empty when the cached library was reused)."""
    so = library_path()
    if so.exists():
        return {'path': str(so), 'seconds': 0.0, 'built': False, 'log': ''}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f'{so.stem}.{os.getpid()}'
    objs = [BUILD_DIR / f'{tag}.{src.stem}.o' for src in SOURCES]
    tmp = so.with_name(f'{tag}.so.tmp')
    t0 = time.perf_counter()
    try:
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, '-c', '-o', str(obj),
                              str(src)] for src, obj in zip(SOURCES, objs))]
        runs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, proc in procs]
        if all(rc == 0 for _, _, rc in runs):
            cmd = [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a',
                   '-shared', '-o', str(tmp), *map(str, objs)]
            link = subprocess.run(cmd, capture_output=True, text=True)
            runs.append((cmd, link.stdout + link.stderr, link.returncode))
        failed = [f"{' '.join(cmd)}\n{out}" for cmd, out, rc in runs if rc]
        if failed:
            raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
        os.replace(tmp, so)  # atomic: a concurrent process sees all or none
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return {'path': str(so), 'seconds': time.perf_counter() - t0,
            'built': True, 'log': ''.join(out for _, out, _ in runs)}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library with every entry's argument types declared."""
    lib = ctypes.CDLL(build()['path'])
    for base, (argtypes, suffixes, *restype) in _SIGNATURES.items():
        for suffix in suffixes:
            fn = getattr(lib, base + suffix)
            fn.argtypes = list(argtypes)
            fn.restype = restype[0] if restype else ctypes.c_int
    return lib
