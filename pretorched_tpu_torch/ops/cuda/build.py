"""Build and load the port's CUDA kernels.

The sources in ``pretorched_tpu_torch/csrc/*.cu`` have a plain C interface.
At first use each is compiled by its own ``nvcc`` for ``sm_90a``, all at
once, and the objects are linked into one shared library under ``build/kernels/<hash>/`` beside the package (git-ignored),
keyed on a hash of the sources, their headers (``*.cuh``) and the flags,
and loaded with ``ctypes``.
No PyTorch header is included, so a build takes seconds, not minutes.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / 'csrc'
BUILD_ROOT = _PKG.parent / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')
LIB_NAME = 'libpretorched_kernels.so'

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()     # one build per process, whichever thread asks
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
    for src in sorted(CSRC.glob('*.cu*')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _run(cmds):
    """Run the commands side by side; their output, or raise on a failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f'nvcc failed ({p.returncode}):\n'
                               f'{" ".join(cmd)}\n{log}')
    return ''.join(logs)


def _compile(out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f'{os.getpid()}.tmp'
    objs = [out.with_name(f'{src.stem}.{tag}.o') for src in _sources()]
    log = _run([[_nvcc(), *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
                for src, obj in zip(_sources(), objs)])
    tmp = out.with_name(f'{out.name}.{tag}')
    log += _run([[_nvcc(), '-shared', '-o', str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)        # atomic: no process loads a half-written file
    out.with_name('build.log').write_text(log)
    return log


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process.
    Thread-safe: a server's batcher thread may be the first caller."""
    if _lib is not None:
        return _lib
    with _lock:
        return _lib if _lib is not None else _load()


def _load() -> ctypes.CDLL:
    global _lib, build_seconds, build_log
    t0 = time.perf_counter()
    path = library_path()
    if path.exists():
        log_file = path.with_name('build.log')
        build_log = log_file.read_text() if log_file.exists() else ''
    else:
        build_log = _compile(path)
    lib = ctypes.CDLL(str(path))
    # q, k, v, out, lse; b, n, nk, c, cv; scale, dtype, stream (the wgmma
    # entry: no dtype, bf16 only)
    lib.pt_nonlocal_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.pt_nonlocal_attention_fwd_wgmma.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    # q, k, v, do, lse, delta, then dq (dk, dv); b, n, nk, c, cv; scale,
    # dtype, stream (the wgmma entry: no dtype)
    for fn, outs, ints in ((lib.pt_nonlocal_attention_bwd_dq, 1, 1),
                           (lib.pt_nonlocal_attention_bwd_dq_wgmma, 1, 0),
                           (lib.pt_nonlocal_attention_bwd_dkv, 2, 1),
                           (lib.pt_nonlocal_attention_bwd_dkv_wgmma, 2, 0)):
        fn.argtypes = ([ctypes.c_void_p] * (6 + outs) + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
    for fn in (lib.pt_nonlocal_attention_fwd,
               lib.pt_nonlocal_attention_fwd_wgmma,
               lib.pt_nonlocal_attention_bwd_dq,
               lib.pt_nonlocal_attention_bwd_dq_wgmma,
               lib.pt_nonlocal_attention_bwd_dkv,
               lib.pt_nonlocal_attention_bwd_dkv_wgmma):
        fn.restype = ctypes.c_int
    # y1, x, w2t, a2, w3t, a3, wpt, ap, out; n, t, h, w, cm, cin, cout,
    # dtype; stream
    lib.pt_fused_bottleneck_tail.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.pt_fused_bottleneck_tail.restype = ctypes.c_int
    lib.pt_fused_bottleneck_tail_cm_chunk.argtypes = [ctypes.c_int]
    lib.pt_fused_bottleneck_tail_cm_chunk.restype = ctypes.c_int
    lib.pt_fused_bottleneck_tail_cout_chunk.argtypes = []
    lib.pt_fused_bottleneck_tail_cout_chunk.restype = ctypes.c_int
    # the tensor-core paths: the same pointers, then n .. cout; stream
    lib.pt_fused_bottleneck_tail_mma.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.pt_fused_bottleneck_tail_mma.restype = ctypes.c_int
    lib.pt_fused_bottleneck_tail_mma_rows.argtypes = [ctypes.c_int] * 6
    lib.pt_fused_bottleneck_tail_mma_rows.restype = ctypes.c_int
    lib.pt_fused_bottleneck_tail_tma.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.pt_fused_bottleneck_tail_tma.restype = ctypes.c_int
    lib.pt_fused_bottleneck_tail_tma_rows.argtypes = [ctypes.c_int] * 7
    lib.pt_fused_bottleneck_tail_tma_rows.restype = ctypes.c_int
    lib.pt_fused_bottleneck_tail_mma_padded.argtypes = [ctypes.c_int]
    lib.pt_fused_bottleneck_tail_mma_padded.restype = ctypes.c_int
    lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pt_cuda_error_string.restype = ctypes.c_char_p
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.pt_cuda_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
