"""The fused eval bottleneck tail K2 on the card (``csrc/fused_block.cu``).

``fused_bottleneck_tail_cuda`` launches the hand-written kernel that
replaces the TPU's ``_kernel`` (``pretorched_tpu/ops/pallas/fused_block.py``),
as ``tail_kernel`` picks it: for bf16 the TMA kernel (persistent blocks,
TMA loads, 16-byte staging and stores) where its plan fits, else the
mma.sync kernel where the shape allows it (channel counts multiples of 8,
Cm <= 64, the tile within shared memory); else, and for f32, the CUDA-core
kernel. It takes CUDA tensors only and raises on anything the kernel does
not take: CPU tensors, y1 and x_res of different dtypes, and
inputs that need a gradient (K2 is eval-only and has no backward, as in the
JAX package). It never falls back to the plain version, which
``ops/fused_block.py`` holds with the dispatcher. Each launch adds one to
``fused_bottleneck_tail_cuda.launches`` and to its kernel's count in
``.by_kernel``.

A call is ``prepare_tail`` (checks, and the weights laid out for the path)
then ``launch_tail``; a caller that times the kernel alone prepares once. A
``TailLayout`` keeps one tail's laid-out weights across calls
(``fused_bottleneck_tail_laid_out_cuda``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils.profiling import span
from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_tail_inputs(y1, x_res, w2, a2, w3, a3, wp, ap):
    """Dtypes and shapes of the port's layout; raises ValueError on a
    mismatch. Returns (cm, cin, cout)."""
    if x_res.dtype != y1.dtype:
        raise ValueError(f'x_res is {x_res.dtype}, y1 is {y1.dtype}')
    if y1.dtype not in _DTYPE_CODES:
        raise ValueError(f'dtype {y1.dtype} not supported (float32, '
                         'bfloat16)')
    if y1.dim() != 5 or x_res.dim() != 5:
        raise ValueError(f'y1 and x_res must be (N, C, T, H, W), got '
                         f'{tuple(y1.shape)} and {tuple(x_res.shape)}')
    cm, cin = y1.shape[1], x_res.shape[1]
    cout = w3.shape[0]
    if (y1.shape[0], *y1.shape[2:]) != (x_res.shape[0], *x_res.shape[2:]):
        raise ValueError(f'y1 {tuple(y1.shape)} and x_res '
                         f'{tuple(x_res.shape)} differ outside dim 1')
    if w2.shape[:2] != (cm, cm) or w2.shape[-2:] != (3, 3) or w2.numel() != \
            9 * cm * cm:
        raise ValueError(f'w2 must be ({cm}, {cm}, 3, 3), got '
                         f'{tuple(w2.shape)}')
    if tuple(w3.shape) != (cout, cm):
        raise ValueError(f'w3 must be (Cout, {cm}), got {tuple(w3.shape)}')
    for name, a, c in (('a2', a2, cm), ('a3', a3, cout), ('ap', ap, cout)):
        if a is not None and tuple(a.shape) != (2, c):
            raise ValueError(f'{name} must be (2, {c}), got {tuple(a.shape)}')
    if (wp is None) != (ap is None):
        raise ValueError('wp and ap come together')
    if wp is None and cin != cout:
        raise ValueError(f'an identity residual needs Cin == Cout, got '
                         f'{cin} and {cout}')
    if wp is not None and tuple(wp.shape) != (cout, cin):
        raise ValueError(f'wp must be ({cout}, {cin}), got {tuple(wp.shape)}')
    return cm, cin, cout


def _padded_t(w, dtype, chunk):
    """(out, in) weight -> (in, out_pad) f32, rounded to ``dtype`` first,
    the out dim zero-padded to a multiple of ``chunk``."""
    w = w.to(dtype).float().t()
    return F.pad(w, (0, -w.shape[1] % chunk)).contiguous()


def kernel_weights(w2, w3, wp, dtype, cm_chunk, cout_chunk):
    """The weights as the kernel reads them, f32 after rounding to
    ``dtype``: conv2 as (Cm_in, 9, Cm_out_pad), the 9 taps row-major over
    (dy, dx) and a tap's output channels contiguous; conv3 and the
    projection as (C_in, Cout_pad). Output dims are zero-padded to their
    chunk widths (``pt_fused_bottleneck_tail_cm_chunk``, ``_cout_chunk``)."""
    cm = w2.shape[0]
    with torch.autocast(w2.device.type, enabled=False):
        w2t = w2.reshape(cm, cm, 9).to(dtype).float().permute(1, 2, 0)
        w2t = F.pad(w2t, (0, -cm % cm_chunk)).contiguous()
        w3t = _padded_t(w3, dtype, cout_chunk)
        wpt = None if wp is None else _padded_t(wp, dtype, cout_chunk)
    return w2t, w3t, wpt


def mma_weights(w2, w3, wp, padded):
    """The weights as the tensor-core path reads them, bf16: conv2 as
    (9, Cm_out, padded(Cm_in)), the taps row-major over (dy, dx); conv3 as
    (Cout, padded(Cm)); the projection as (Cout, padded(Cin)). ``padded``
    is ``pt_fused_bottleneck_tail_mma_padded``: input-channel dims
    zero-padded to a multiple of 16 plus 8."""
    cm = w2.shape[0]

    def pad(w):
        c = w.shape[-1]
        return F.pad(w.to(torch.bfloat16), (0, padded(c) - c)).contiguous()

    with torch.autocast(w2.device.type, enabled=False):
        return (pad(w2.reshape(cm, cm, 9).permute(2, 0, 1)), pad(w3),
                None if wp is None else pad(wp))


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


KERNELS = ('tma', 'mma_sync', 'cuda_cores')


def tail_kernel(lib, dtype, dims, proj: bool) -> str:
    """The K2 kernel for this dtype and (N, T, H, W, Cm, Cin, Cout): bf16
    on the TMA kernel where its plan fits (T * H * W a multiple of 8, Cout
    <= 64, two blocks an SM, the tensor-core path's channel rules), else
    on the mma.sync kernel where that fits, else (and f32 always) on CUDA
    cores. The rules live in ``csrc/fused_block.cu``."""
    n, t, h, w, cm, cin, cout = dims
    if dtype == torch.bfloat16:
        if lib.pt_fused_bottleneck_tail_tma_rows(t, h, w, cm, cin, cout,
                                                 int(proj)) > 0:
            return 'tma'
        if lib.pt_fused_bottleneck_tail_mma_rows(h, w, cm, cin, cout,
                                                 int(proj)) > 0:
            return 'mma_sync'
    return 'cuda_cores'


class TailLayout:
    """One tail's folded weights (``w2, a2, w3, a3, wp, ap`` as
    ``fused_bottleneck_tail`` takes them), laid out for a kernel family at
    its first use and kept: a module that holds one pays the layout once
    (``models/slowfast.py`` drops it when a source tensor changes)."""

    def __init__(self, w2, a2, w3, a3, wp=None, ap=None):
        self.folded = (w2, a2, w3, a3, wp, ap)
        self._laid_out = {}

    @property
    def proj(self) -> bool:
        return self.folded[4] is not None

    def for_kernel(self, lib, kernel: str, dtype):
        """(w2, a2, w3, a3, wp, ap) as ``kernel`` reads them: the
        tensor-core layout (``mma_weights``) for 'tma' and 'mma_sync',
        ``kernel_weights`` in f32 for 'cuda_cores'; the folded BN as
        contiguous f32."""
        key = (kernel == 'cuda_cores', dtype)
        if key not in self._laid_out:
            w2, a2, w3, a3, wp, ap = self.folded
            with torch.no_grad():
                if kernel == 'cuda_cores':
                    weights = kernel_weights(
                        w2, w3, wp, dtype,
                        lib.pt_fused_bottleneck_tail_cm_chunk(w2.shape[0]),
                        lib.pt_fused_bottleneck_tail_cout_chunk())
                else:
                    weights = mma_weights(
                        w2, w3, wp, lib.pt_fused_bottleneck_tail_mma_padded)
                folded = [None if a is None else a.float().contiguous()
                          for a in (a2, a3, ap)]
            self._laid_out[key] = (weights[0], folded[0], weights[1],
                                   folded[1], weights[2], folded[2])
        return self._laid_out[key]


def _check_tma(*tensors):
    """TMA reads from, and the 16-byte stores write to, 16-byte aligned
    channel planes."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f'the TMA kernel of K2 needs 16-byte aligned '
                             f'tensors; got one of {tuple(t.shape)} at '
                             f'{t.data_ptr():#x}')


def _prepare(y1, x_res, layout, kernel=None):
    """Check the inputs against ``layout`` and lay them out for ``kernel``
    (the dispatch's choice by default; 'mma_sync' also where that is
    'tma', the A/B against the kernel it replaced): the launch arguments of
    ``launch_tail``."""
    args = (y1, x_res, *layout.folded)
    cm, cin, cout = check_tail_inputs(*args)
    if needs_grad(*args):
        raise ValueError('fused_bottleneck_tail_cuda is eval-only: it has '
                         'no backward, and an input requires a gradient')
    for name, t in zip(('y1', 'x_res', 'w2', 'a2', 'w3', 'a3', 'wp', 'ap'),
                       args):
        if t is not None and not t.is_cuda:
            raise ValueError(f'fused_bottleneck_tail_cuda: {name} is on '
                             f'{t.device}, the kernel takes CUDA tensors')
        if t is not None and t.device != y1.device:
            raise ValueError(f'{name} is on {t.device}, y1 on {y1.device}')
    lib = build.load_library()
    dt, dev = y1.dtype, y1.device
    n, _, t, h, w = y1.shape
    dims = (n, t, h, w, cm, cin, cout)
    chosen = tail_kernel(lib, dt, dims, layout.proj)
    kernel = kernel or chosen
    if kernel != chosen and (kernel, chosen) != ('mma_sync', 'tma'):
        raise ValueError(f'K2 kernel {kernel!r} does not take {dt} at '
                         f'{dims} (the dispatch picks {chosen!r})')
    w2, a2, w3, a3, wp, ap = layout.for_kernel(lib, kernel, dt)
    p = dict(kernel=kernel, y1=y1.contiguous(), x=x_res.contiguous(),
             w2=w2, a2=a2, w3=w3, a3=a3, wp=wp, ap=ap,
             out=torch.empty((n, cout, t, h, w), dtype=dt, device=dev),
             dims=dims)
    if kernel == 'tma':
        _check_tma(p['y1'], p['x'], p['out'])
    return p


def prepare_tail(y1, x_res, w2, a2, w3, a3, wp=None, ap=None):
    """Check the inputs and lay them out for the kernel the dispatch picks
    (the weights as ``TailLayout`` says, the output allocated): the launch
    arguments of ``launch_tail``."""
    return _prepare(y1, x_res, TailLayout(w2, a2, w3, a3, wp, ap))


def launch_tail(prepared):
    """Launch K2 on the arguments of ``prepare_tail``; returns its out. The
    C call alone is the span ``k2.tail``."""
    lib = build.load_library()
    p = prepared
    dev = p['y1'].device
    ptrs = tuple(map(_ptr, (p['y1'], p['x'], p['w2'], p['a2'], p['w3'],
                            p['a3'], p['wp'], p['ap'], p['out'])))
    kernel = p['kernel']
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        with span('k2.tail'):
            if kernel == 'tma':
                err = lib.pt_fused_bottleneck_tail_tma(*ptrs, *p['dims'],
                                                       stream)
            elif kernel == 'mma_sync':
                err = lib.pt_fused_bottleneck_tail_mma(*ptrs, *p['dims'],
                                                       stream)
            else:
                err = lib.pt_fused_bottleneck_tail(
                    *ptrs, *p['dims'], _DTYPE_CODES[p['y1'].dtype], stream)
    build.check(lib, err, f'fused_bottleneck_tail ({kernel}) launch')
    fn = fused_bottleneck_tail_cuda
    fn.launches += 1
    fn.by_kernel[kernel] += 1
    return p['out']


def fused_bottleneck_tail_cuda(y1, x_res, w2, a2, w3, a3, wp=None, ap=None):
    """K2 on (N, C, T, H, W) tensors: the tail's output (N, Cout, T, H, W)
    in y1's dtype. Weights in torch layouts: w2 (Cm, Cm, 3, 3) (or
    (Cm, Cm, 1, 3, 3)), w3 (Cout, Cm), wp (Cout, Cin); a2, a3, ap the
    folded BN as (2, C) [scale; shift]. Each call lays the weights out
    anew (a few small launches) and launches the kernel once."""
    return launch_tail(prepare_tail(y1, x_res, w2, a2, w3, a3, wp, ap))


def fused_bottleneck_tail_laid_out_cuda(y1, x_res, layout):
    """K2 with weights already held in a ``TailLayout``: no fold and no
    layout after the layout's first call."""
    return launch_tail(_prepare(y1, x_res, layout))


fused_bottleneck_tail_cuda.launches = 0
fused_bottleneck_tail_cuda.by_kernel = dict.fromkeys(KERNELS, 0)
