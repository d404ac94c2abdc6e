"""Build and load the port's CUDA kernels.

The sources in ``pretorched_tpu_torch/csrc/*.cu`` have a plain C interface.
At first use they are compiled by ``nvcc`` for ``sm_90a`` into one shared
library under ``build/kernels/<hash>/`` beside the package (git-ignored),
keyed on a hash of the sources and the flags, and loaded with ``ctypes``.
No PyTorch header is included, so a build takes seconds, not minutes.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / 'csrc'
BUILD_ROOT = _PKG.parent / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
LIB_NAME = 'libpretorched_kernels.so'

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None    # wall time of this process's load
build_log: str = ''                      # nvcc's output (ptxas -v report)


def _sources():
    return sorted(CSRC.glob('*.cu'))


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin): the CUDA '
                       'kernels of pretorched_tpu_torch cannot be built')


def library_path() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _compile(out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *map(str, _sources())]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f'nvcc failed ({r.returncode}):\n{" ".join(cmd)}\n'
                           f'{r.stdout}{r.stderr}')
    os.replace(tmp, out)        # atomic: no process loads a half-written file
    log = r.stdout + r.stderr
    out.with_name('build.log').write_text(log)
    return log


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    path = library_path()
    if path.exists():
        log_file = path.with_name('build.log')
        build_log = log_file.read_text() if log_file.exists() else ''
    else:
        build_log = _compile(path)
    lib = ctypes.CDLL(str(path))
    lib.pt_nonlocal_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.pt_nonlocal_attention_fwd.restype = ctypes.c_int
    lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pt_cuda_error_string.restype = ctypes.c_char_p
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.pt_cuda_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
