"""ctypes bindings for the native JPEG decoder.

Counterpart of ``pretorched_tpu/datasets/native.py``. The C++ source is the
port's own copy of the JAX package's decoder,
``pretorched_tpu_torch/native/decoder.cpp``, compiled with ``g++ -O2
-shared`` against libjpeg, at first use, into ``build/native/<hash>/``
beside the package (git-ignored). When the toolchain or libjpeg is missing, every entry
point falls back to PIL, so decoding never hard-depends on native code;
``decoder_name()`` says which one runs. The PIL fallback decodes on a pool
of ``threads`` threads (PIL releases the interpreter lock while it decodes).
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / 'pretorched_tpu_torch' / 'native' / 'decoder.cpp'
_CMD = ('g++', '-O2', '-shared', '-fPIC', '-std=c++17')
_LIBS = ('-ljpeg', '-lpthread')
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_lib() -> Optional[Path]:
    if not SRC.exists():
        return None
    h = hashlib.sha256(' '.join(_CMD + _LIBS).encode() + SRC.read_bytes())
    out = _ROOT / 'build' / 'native' / h.hexdigest()[:16] / 'libptjpeg.so'
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [*_CMD, str(SRC), '-o', str(tmp), *_LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None              # no g++ or no libjpeg: the PIL fallback
    tmp.replace(out)
    return out


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        path = _build_lib()
        try:
            lib = ctypes.CDLL(str(path)) if path is not None else None
        except OSError:          # e.g. libjpeg present at build, not at run
            lib = None
        if lib is not None:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            ip = ctypes.POINTER(ctypes.c_int)
            lib.pt_jpeg_dims.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int,
                                         ip, ip]
            lib.pt_jpeg_dims.restype = ctypes.c_int
            lib.pt_jpeg_decode_batch.argtypes = [
                ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
                ctypes.POINTER(u8p), ip, ip, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ip]
            lib.pt_jpeg_decode_batch.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def decoder_name() -> str:
    return 'native (libjpeg, C++ thread pool)' if native_available() else 'PIL'


def jpeg_short_side(buffer: bytes) -> Optional[int]:
    """Short side of a JPEG from its header alone (no pixel decode), or
    None when it does not parse. Picks a batch-wide DCT ``scale_denom``."""
    lib = _get_lib()
    if lib is not None:
        arr = np.frombuffer(buffer, np.uint8)
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = lib.pt_jpeg_dims(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              len(buffer), 1, ctypes.byref(h), ctypes.byref(w))
        return min(h.value, w.value) if rc == 0 else None
    from PIL import Image, UnidentifiedImageError
    try:
        with Image.open(io.BytesIO(buffer)) as img:   # lazy: header only
            return min(img.size)
    except (OSError, UnidentifiedImageError):
        return None


def _pil_decode_one(buffer, scale_denom):
    from PIL import Image

    img = Image.open(io.BytesIO(buffer))
    if scale_denom > 1:
        img.draft('RGB', (img.width // scale_denom,
                          img.height // scale_denom))
    return np.asarray(img.convert('RGB'))


def _pil_decode(buffers, scale_denom, threads):
    if threads <= 1 or len(buffers) <= 1:
        return [_pil_decode_one(b, scale_denom) for b in buffers]
    with ThreadPoolExecutor(min(threads, len(buffers))) as pool:
        return list(pool.map(_pil_decode_one, buffers,
                             [scale_denom] * len(buffers)))


def decode_jpeg_batch(buffers: List[bytes], threads: int = 8,
                      scale_denom: int = 1) -> List[np.ndarray]:
    """Decode JPEG byte strings to (H, W, 3) uint8 arrays, on ``threads``
    threads."""
    lib = _get_lib()
    if lib is None:
        return _pil_decode(buffers, scale_denom, threads)
    n = len(buffers)
    if n == 0:
        return []
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bufs = (u8p * n)()
    lens = (ctypes.c_size_t * n)()
    hs = (ctypes.c_int * n)()
    ws = (ctypes.c_int * n)()
    keep = []
    for i, b in enumerate(buffers):
        arr = np.frombuffer(b, np.uint8)
        keep.append(arr)
        bufs[i] = arr.ctypes.data_as(u8p)
        lens[i] = len(b)
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = lib.pt_jpeg_dims(bufs[i], lens[i], scale_denom,
                              ctypes.byref(h), ctypes.byref(w))
        if rc != 0:
            return _pil_decode(buffers, scale_denom, threads)
        hs[i], ws[i] = h.value, w.value
    outs_np = [np.empty((hs[i], ws[i], 3), np.uint8) for i in range(n)]
    outs = (u8p * n)(*[o.ctypes.data_as(u8p) for o in outs_np])
    status = (ctypes.c_int * n)()
    fails = lib.pt_jpeg_decode_batch(bufs, lens, outs, hs, ws, scale_denom,
                                     n, threads, status)
    if fails:
        return _pil_decode(buffers, scale_denom, threads)
    return outs_np


def decode_jpeg_files(paths: List[str], threads: int = 8,
                      scale_denom: int = 1) -> List[np.ndarray]:
    buffers = []
    for p in paths:
        with open(p, 'rb') as f:
            buffers.append(f.read())
    return decode_jpeg_batch(buffers, threads=threads, scale_denom=scale_denom)
