#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``pretorched_tpu_torch``).

Drives the port's main path once on one CUDA card and checks it:

1. the card: its name and power limit (``nvidia-smi``);
2. the build of the CUDA kernels from ``pretorched_tpu_torch/csrc``;
3. the non-local attention forward kernels against their plain PyTorch
   version at the video slice's shapes, in f32 (TF32 off) and bf16, each
   with the kernel the dispatch picks (``attention_kernel``: bf16 with C
   and Cv multiples of 64 up to 512 on wgmma, past 256 its wide program,
   other bf16 shapes on mma.sync, f32 scalar), its time, its bound and one
   ``scaled_dot_product_attention`` call's time, the plain version's at
   layers 2 and 3, and at both layers the mma.sync kernel that wgmma
   replaced (held to the plain version at the same tolerances) and each
   one's host time per call;
4. the eval path: a fabricated hosted ``kinetics-400`` checkpoint for
   ``nonlocalresnet3d50`` (seeded init, every BN randomized, non-local
   weights included), a frame folder of JPEGs, and the 10-clip, 32-frame,
   224 px eval of ``examples/video_eval_torch.py``. It checks that every
   forward launched K1-fwd 5 times, all on wgmma (layer 3's 3 on its wide
   program), that the logits are finite, that the bf16 logits through the
   wgmma kernels match the same bf16 model with the plain attention (and
   come no further from it than twice the mma.sync kernel's), that the
   f32 logits with the kernel match those with the plain attention, and
   that the attention moves the logits; it profiles one bf16 forward by
   kernel family;
5. the backward kernels (K1-dq, K1-dkv) against the plain backward at the
   training path's shapes, in f32 and bf16, with the same times per bf16
   shape and, at layers 2 and 3, the generic K1-dq and K1-dkv that wgmma
   (at layer 3 its wide programs) replaced: time and host time per call,
   each generic kernel held to the plain backward, K1-dq's two outputs
   held together; K1-dq and K1-dkv must repeat bitwise at every bf16
   shape;
6. the training path: ``nonlocalresnet3d50`` from the same checkpoint, bf16,
   ``remat=(0,)``, SGD, 12 steps of 8 clips x 32 frames x 224 px; it checks
   15 attention launches a step (5 forward, 5 dq and 5 dkv on wgmma, 3 of
   each on the wide program) and a finite loss, prints each step's host
   time and device time (CUDA events around the step) and their medians
   over steps 2-12, clips/s and peak memory, profiles one more step
   (device time by kernel family, each K1 program's, idle share), and
   saves a checkpoint after step 3 that must restore exactly;
7. gradient agreement: each non-local block's gradients with the kernels
   against those with the plain attention, and one step's loss and
   gradients in f32 with the kernels and with the plain attention, each
   against the same step in f64;
8. the fused bottleneck tail kernel (K2) against its plain version at
   SlowFast-R50's shapes (fused_blocks 32 and 64) and an odd one, in f32
   (TF32 off) and bf16, each on the kernel the dispatch picks (bf16 on the
   TMA kernel at res2 and res3 of fused_blocks=32, on mma.sync at res4),
   with, in bf16, its
   time, the mma.sync kernel's where the TMA kernel replaced it (outputs
   equal), the host time of a call with and without the fold, the plain
   version's time, the unfused tail's (the block's own cuDNN convs, BN and
   ReLU) and the bound;
9. the SlowFast eval path: ``slowfast_resnet50(fused_blocks=32)`` (seeded
   init, every BN randomized), 2 steps of 2 videos x 10 clips x 64 frames x
   224 px from the eval CLI's ``load_video`` through
   ``multi_clip_eval_step``. It checks 11 K2 launches per forward (6 on
   the TMA kernel, 5 on mma.sync) and none of K1, finite logits, the f32
   logits with K2 against fused_blocks=0,
   and that the randomized BN moves the logits; it prints the forward A/B
   of fused_blocks 32 and 0, peak memory and a profiled forward, then runs
   ``examples/video_eval_torch.py -a slowfast_resnet50`` once;
10. the serving path, ``serving.serve_model`` on the card: (a)
    ``resnet50`` (seeded, every BN randomized) with the tensor payload,
    served f32 rows against the direct batch-1 forward (TF32 off), then in
    bf16 against the f32 rows, a load test of 8 clients x 64 single
    requests (req/s, p50 / p90 / p99, buckets), the bare forward per
    bucket 1-64 by CUDA events, the host's enqueue time and a profile of
    a bucket-8 forward, and a load test of 64 clients x 8 requests; (b) the uint8 (256, 256, 3) and JPEG
    payloads (``data/cat.jpg`` and seeded 375 x 500 JPEGs) against decode +
    ``_fit_uint8`` + ``fused_preprocess`` + forward, each load-tested in
    bf16, and the JPEG decoder that ran; (c) K1-fwd against its plain
    version at B = 1, 2, 4, 8 at both non-local layer shapes, with its
    time, SDPA's and at layer 3 the mma.sync kernel's (also held to the
    plain version), then
    ``nonlocalresnet3d50`` (bf16, every BN randomized) serving uint8 clips
    of (32, 240, 320, 3), 4 clients x 8 clips after warming buckets 1-8:
    5 K1-fwd launches, all on wgmma, per dispatched bucket,
    served logits against the same model with the plain attention, and
    that zeroing ``W.1`` moves them; (d) ``ServerOverloaded``, an expired
    request and a clean ``close()`` on the card; (e)
    ``examples/serve_torch.py`` and ``examples/imagenet_logits_torch.py``
    as subprocesses;
11. a line with each kernel's numbers and the card, then
    ``{"ok": true, "device": {...}}``. Every phase's heading names the card
    and its power limit.

Usage: ``python3 chip_smoke.py`` from the repository root. It exits nonzero,
with no result line, when a phase fails or no CUDA card is present.
"""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / 'build' / 'chip_smoke'
SLICE_SHAPES = {            # (B, N, Nk, C, Cv): 10 clips x 2 videos
    'layer2': (20, 6272, 6272, 256, 256),
    'layer3': (20, 784, 784, 512, 512),
    'sub_sample': (20, 6272, 784, 256, 256),
    'cv_ne_c': (4, 4096, 512, 64, 256),
    'ragged_n': (3, 1000, 1000, 64, 64),
}
TOL = {'float32': (2e-4, 1e-4), 'bfloat16': (2e-2, 1e-2)}    # out, lse
# bf16 out also within 2e-2 of the largest |out|: at layer 2 |out| is ~0.02
# RMS, so the absolute 2e-2 alone would pass a kernel that drops a k/v tile
TOL_REL_BF16 = 2e-2
# the bf16 eval logits through the kernels against the same bf16 model with
# the plain attention (rel L2): the random-weight network amplifies bf16
# rounding to ~2e-2 (1.8e-2 through wgmma, 2.0e-2 through mma.sync on an
# H100), so this catches gross faults; also no more than twice mma.sync's
TOL_LOGITS_BF16 = 5e-2
TRAIN_SHAPES = {            # (B, N, Nk, C, Cv): 8 clips a step
    'layer2': (8, 6272, 6272, 256, 256),
    'layer3': (8, 784, 784, 512, 512),
    'sub_sample': (8, 6272, 784, 256, 256),
    'cv_ne_c': (4, 4096, 512, 64, 256),
    'ragged_n': (3, 1000, 1000, 64, 64),
    'gaussian': (2, 1000, 125, 1024, 512),
}
# K1 launches by program a pass (the dispatch of
# ops/cuda/nonlocal_attention.py): layer 2 (C = Cv = 256, 2 blocks) on
# wgmma; layer 3 (C = Cv = 512, 3 blocks) on the wide wgmma programs of
# K1-fwd, K1-dq and K1-dkv (wgmma_wide)
EVAL_KERNELS = {'fwd wgmma': 2, 'fwd wgmma_wide': 3}
TRAIN_KERNELS = {**EVAL_KERNELS, 'dq wgmma': 2, 'dq wgmma_wide': 3,
                 'dkv wgmma': 2, 'dkv wgmma_wide': 3}
# max |grad - plain| / max |plain grad|: f32 sums in another order; bf16
# rounds p and ds for the products and stores bf16
TOL_BWD = {'float32': 1e-4, 'bfloat16': 2e-2}
# the card's dense peaks (H100 SXM at 700 W) and memory rate, for bounds
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
MEM_BYTES_PER_S = 3.35e12
# 12 steps: the first warms up, the median of steps 2-12 is read, by host
# clock and by device time (CUDA events around each step)
TRAIN_CLIPS, TRAIN_STEPS, TRAIN_LR = 8, 12, 1e-3
# K2 (the fused bottleneck tail): (N, T, H, W, Cin, Cm, Cout, projection)
# of SlowFast-R50 on 20 clips x 64 frames x 224 px (fast pathway B*T =
# 20 x 32, slow 20 x 4); the first four are fused_blocks=32's, with their
# launches per forward, the next three what fused_blocks=64 adds
K2_SHAPES = {
    'fast res2.0': (20, 32, 56, 56, 8, 8, 32, True),
    'fast res2.1-2': (20, 32, 56, 56, 32, 8, 32, False),
    'fast res3.1-3': (20, 32, 28, 28, 64, 16, 64, False),
    'fast res4.1-5': (20, 32, 14, 14, 128, 32, 128, False),
    'fast res5.1-2': (20, 32, 7, 7, 256, 64, 256, False),
    'slow res2.0': (20, 4, 56, 56, 80, 64, 256, True),
    'slow res2.1-2': (20, 4, 56, 56, 256, 64, 256, False),
    'odd': (1, 3, 7, 7, 64, 16, 64, False),
}
K2_SLICE = {'fast res2.0': 1, 'fast res2.1-2': 2, 'fast res3.1-3': 3,
            'fast res4.1-5': 5}
# the K2 kernel the dispatch gives each shape in bf16 (f32: CUDA cores):
# the TMA kernel at Cout <= 64, mma.sync (faster there) at fast res4
K2_KERNELS = {'fast res2.0': 'tma', 'fast res2.1-2': 'tma',
              'fast res3.1-3': 'tma', 'fast res4.1-5': 'mma_sync',
              'fast res5.1-2': 'mma_sync', 'slow res2.0': 'cuda_cores',
              'slow res2.1-2': 'mma_sync', 'odd': 'mma_sync'}
# max |out - plain| / max |plain|: f32 sums in another order (TF32 off);
# bf16 also rounds y2 and the output, where a sum near a rounding boundary
# lands one bf16 step (2^-8 relative) apart
TOL_K2 = {'float32': 1e-4, 'bfloat16': 2e-2}
SF_FRAMES, SF_CLIPS, SF_VIDEOS = 64, 10, 2
# the eval CLI's metadata for a model with no settings (SlowFast has none)
CLI_SETTINGS = {'input_space': 'RGB', 'input_size': [3, 224, 224],
                'input_range': [0, 1], 'mean': [0.485, 0.456, 0.406],
                'std': [0.229, 0.224, 0.225]}
# serving (phase 10): ResNet-50 load tests of 8 clients x 64 single
# requests a payload; nonlocalresnet3d50 uint8 clips at phase 4's frame
# geometry, 4 clients x 8 clips, buckets up to 8
SERVE_CLIENTS, SERVE_PER_CLIENT = 8, 64
CLIP_DECODE = (32, 240, 320, 3)
CLIP_CLIENTS, CLIP_PER_CLIENT, CLIP_MAX_BATCH = 4, 8, 8
# served rows against the direct forward of the same examples in f32, TF32
# off (max |diff| / max |direct|); bf16 rows against f32 rows (rel L2)
TOL_SERVED_F32, TOL_SERVED_BF16 = 1e-4, 5e-2


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


CARD = ''    # nvidia-smi's name and power limit, printed with every phase


def phase(title):
    print(f'\n== {title}' + (f' ({CARD})' if CARD else ''), flush=True)


def median_ms(fn, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for e0, e1 in events:
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    times = sorted(e0.elapsed_time(e1) for e0, e1 in events)
    return times[len(times) // 2]


def host_us(fn, reps=20):
    """Host microseconds a call of ``fn`` takes to queue its work (the
    wrapper, tensor maps, launch), with no synchronize inside the loop."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def bound(flops, nbytes, dtype):
    """(ms, 'operations' or 'bytes'): the least time for this work."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / MEM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def attention_bounds(b, n, nk, c, cv, dtype):
    """Bounds of K1-fwd, K1-dq and K1-dkv: each input read once, each output
    written once; the products each must do (s and p v; s, dp and dq; s,
    dp, dk and dv)."""
    e = 2 if dtype == 'bfloat16' else 4
    q, k, v, o = b * n * c * e, b * nk * c * e, b * nk * cv * e, b * n * cv * e
    rows = b * n * 4
    mm = 2 * b * n * nk
    return {'fwd': bound(mm * (c + cv), q + k + v + o + rows, dtype),
            'dq': bound(mm * (2 * c + cv), q + k + v + o + 2 * rows + q, dtype),
            'dkv': bound(mm * (2 * c + 2 * cv),
                         q + k + v + o + 2 * rows + k + v, dtype)}


def sdpa_backend(torch, q, k, v):
    from torch.nn.attention import SDPBackend
    names = {int(val): name for name, val in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(q, k, v, scale=1.0)), '?')


def sdpa_ms(torch, q, k, v, do=None):
    """(ms, backend) of one ``scaled_dot_product_attention`` call on the
    same inputs (its backward alone when ``do`` is given), or (None,
    reason) where no backend takes the shape."""
    import torch.nn.functional as F
    q4, k4, v4 = (t[:, None].detach().requires_grad_(do is not None)
                  for t in (q, k, v))
    try:
        backend = sdpa_backend(torch, q4, k4, v4)
        if do is None:
            with torch.no_grad():
                return median_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, scale=1.0)), backend
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        return median_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do[:, None], retain_graph=True)), backend
    except (RuntimeError, ValueError) as e:   # a yardstick, never the port
        return None, f'not measured: {str(e).splitlines()[0][:80]}'


def fmt_ms(ms):
    return 'n/a' if ms is None else f'{ms:.3f} ms'


def fwd_errors(out, lse, want, want_lse):
    """K1-fwd's max |out - plain|, that over max |plain|, and max |lse -
    plain|."""
    err = (out.float() - want).abs().max().item()
    return (err, err / want.abs().max().item(),
            (lse - want_lse).abs().max().item())


def kernel_vs_plain(na, torch):
    """Phase 3: every case in both dtypes, with the kernel the dispatch
    picks; bf16 cases timed with their bound and SDPA's time, layers 2 and
    3 also on the mma.sync kernel that wgmma replaced, which is held to the
    plain version at the same tolerances. Returns the bf16 rows of layers 2
    and 3."""
    g = torch.Generator(device='cuda').manual_seed(0)
    result = {}
    for name, (b, n, nk, c, cv) in SLICE_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split('.')[-1]
            # q, k ~ N(0,1)/C^(1/4): logits of unit scale, softmax not one-hot
            q = (torch.randn(b, n, c, device='cuda', generator=g)
                 / c ** 0.25).to(dt)
            k = (torch.randn(b, nk, c, device='cuda', generator=g)
                 / c ** 0.25).to(dt)
            v = torch.randn(b, nk, cv, device='cuda', generator=g).to(dt)
            kernel = na.attention_kernel(dt, c, cv, 'fwd')
            out, lse = na.nonlocal_attention_cuda(q, k, v)
            torch.cuda.synchronize()
            want, want_lse = na.nonlocal_attention_fwd_lse_reference(
                q.float(), k.float(), v.float())
            err, err_rel, err_lse = fwd_errors(out, lse, want, want_lse)
            tol, tol_lse = TOL[dname]
            tol_rel = TOL_REL_BF16 if dt == torch.bfloat16 else float('inf')
            line = (f'{name:10s} {dname:8s} B={b} N={n} Nk={nk} C={c} '
                    f'Cv={cv} [{kernel}]: max|out-plain|={err:.3e} (tol '
                    f'{tol:g}), /max|plain| {err_rel:.3e} (tol {tol_rel:g}), '
                    f'max|lse-plain|={err_lse:.3e} (tol {tol_lse:g})')
            earlier = (dt == torch.bfloat16 and name in ('layer2', 'layer3')
                       and kernel != 'mma_sync')
            errs_m = (0.0, 0.0, 0.0)
            if earlier:
                # the mma.sync kernel that wgmma replaced, at its tolerances
                out_m, lse_m = na._launch_fwd(q, k, v, 1.0, 'mma_sync')
                errs_m = fwd_errors(out_m, lse_m, want, want_lse)
                del out_m, lse_m
                line += (f'\n    the mma.sync kernel: max|out-plain|='
                         f'{errs_m[0]:.3e}, /max|plain| {errs_m[1]:.3e}, '
                         f'max|lse-plain|={errs_m[2]:.3e}')
            del want, want_lse
            if dt == torch.bfloat16 or name in ('layer2', 'layer3'):
                ms = median_ms(lambda: na.nonlocal_attention_cuda(q, k, v))
                line += f'\n    kernel {ms:.3f} ms'
            if name in ('layer2', 'layer3'):
                plain_ms = median_ms(
                    lambda: na.nonlocal_attention_fwd_lse_reference(q, k, v))
                line += f', plain {plain_ms:.3f} ms'
            if dt == torch.bfloat16:
                lib_ms, backend = sdpa_ms(torch, q, k, v)
                bound_ms, bound_by = attention_bounds(b, n, nk, c, cv,
                                                      dname)['fwd']
                line += (f', scaled_dot_product_attention {fmt_ms(lib_ms)} '
                         f'({backend}), bound {bound_ms:.4f} ms ({bound_by})')
                if earlier:
                    earlier_ms = median_ms(lambda: na._launch_fwd(
                        q, k, v, 1.0, 'mma_sync'))
                    hosts = (host_us(lambda: na.nonlocal_attention_cuda(
                                 q, k, v)),
                             host_us(lambda: na._launch_fwd(
                                 q, k, v, 1.0, 'mma_sync')))
                    line += (f'; the mma.sync kernel {earlier_ms:.3f} ms; '
                             f'host per call {hosts[0]:.1f} us ({kernel}), '
                             f'{hosts[1]:.1f} us (mma.sync)')
                    result[name] = {
                        'kernel': kernel, 'max_abs_err': err, 'ms': ms,
                        'plain_ms': plain_ms, 'library_ms': lib_ms,
                        'library': f'scaled_dot_product_attention '
                                   f'({backend})',
                        'bound_ms': bound_ms, 'bound_by': bound_by,
                        'earlier_ms': earlier_ms,
                        'earlier': 'mma.sync kernel, same run',
                        'host_us': hosts[0], 'earlier_host_us': hosts[1]}
            print(line, flush=True)
            check(err <= tol and err_rel <= tol_rel and err_lse <= tol_lse,
                  f'kernel disagrees with the plain version: {line}')
            check(errs_m[0] <= tol and errs_m[1] <= tol_rel
                  and errs_m[2] <= tol_lse,
                  f'the mma.sync kernel disagrees with the plain version: '
                  f'{line}')
            del q, k, v, out, lse
            torch.cuda.empty_cache()
    return result


def randomize_bn(model, torch, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.3, 0.3, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)


def fabricate(pretorched, torch, np):
    """Hosted-format .pth (DataParallel-wrapped, ``fc`` head) and a frame
    folder of 2 classes x 2 videos x 40 JPEG frames at 240 x 320."""
    from PIL import Image

    donor = pretorched.nonlocalresnet3d50(num_classes=400, pretrained=None)
    randomize_bn(donor, torch, seed=1)
    sd = {'module.' + ('fc' + k[len('last_linear'):]
                       if k.startswith('last_linear') else k): v
          for k, v in donor.state_dict().items()}
    url = pretorched.pretrained_settings['nonlocalresnet3d50'][
        'kinetics-400']['url']
    (WORK / 'zoo' / 'weights').mkdir(parents=True)
    torch.save({'state_dict': sd},
               WORK / 'zoo' / 'weights' / url.rsplit('/', 1)[-1])
    rng = np.random.RandomState(0)
    for cls in ('applauding', 'boxing'):
        for vid in range(2):
            d = WORK / 'val' / cls / f'v{vid}'
            d.mkdir(parents=True)
            base = rng.randint(0, 256, (240, 320, 3)).astype(np.int16)
            for f in range(40):
                frame = base + rng.randint(-20, 21, base.shape)
                Image.fromarray(np.clip(frame, 0, 255).astype(np.uint8)).save(
                    d / f'frame_{f:05d}.jpg', quality=90)


def main_path(pretorched, na, torch, np):
    """Phase 4; returns K1-fwd's launch count in the eval run, the count by
    kernel, and the eval CLI's module."""
    from pretorched_tpu_torch.datasets.native import decoder_name
    from pretorched_tpu_torch.models import nonlocalnet

    cli = load_cli('video_eval_torch')
    shutil.rmtree(WORK, ignore_errors=True)
    os.environ['PRETORCHED_HOME'] = str(WORK / 'zoo')
    os.environ['PRETORCHED_STRICT_WEIGHTS'] = '1'
    t0 = time.perf_counter()
    fabricate(pretorched, torch, np)
    print(f'fabricated checkpoint + 160 JPEG frames in '
          f'{time.perf_counter() - t0:.1f} s; JPEG decoder: {decoder_name()}')

    argv = [str(WORK / 'val'), '-a', 'nonlocalresnet3d50', '--pretrained',
            'kinetics-400', '--num-classes', '400', '--frames', '32',
            '--clips', '10', '--batch-size', '2', '--print-freq', '1',
            '--device', 'cuda']
    print('examples/video_eval_torch.py ' + ' '.join(argv), flush=True)
    torch.cuda.reset_peak_memory_stats()
    set_counts(na, 0)
    summary = cli.main(argv)
    launches, dq_dkv = counts(na)[0], counts(na)[1:]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    totals = summary['totals']
    print(f"eval run: {summary['steps']} forwards of 20 clips, {launches} "
          f'kernel launches, {summary["clips"]} clips in '
          f"{summary['seconds']:.3f} s = "
          f"{summary['clips'] / summary['seconds']:.2f} clips/s (decode + "
          'preprocess + forward, first run, cuDNN warm-up included); peak '
          f'device memory {peak_gb:.2f} GiB', flush=True)
    check(summary['steps'] == 2 and launches == 5 * summary['steps'],
          f'expected 5 launches per forward, got {launches} in '
          f"{summary['steps']} forwards")
    check(dq_dkv == (0, 0), f'the eval run launched backward kernels {dq_dkv}')
    eval_by_kernel = kernel_counts(na)
    eval_layer3 = expect_kernels(na, EVAL_KERNELS, summary['steps'],
                                 'eval run')[0]
    print(f'eval run, K1-fwd launches by program: {eval_by_kernel} (layer '
          f'3 on wgmma_wide)')
    check(totals['count'] == 4 and 0 <= totals['top1'] <= totals['top5'] <= 4
          and np.isfinite(totals['loss']), f'bad eval totals {totals}')

    # the same weights and the first batch, checked directly
    model = pretorched.nonlocalresnet3d50(num_classes=400,
                                          pretrained='kinetics-400')
    model.cuda().eval()
    videos, _ = cli.list_videos(WORK / 'val')
    batch = torch.cat([cli.load_video(frames, 10, 32, model.settings, 'cuda',
                                      dtype=torch.float32)
                       for frames, _ in videos[:2]])
    check(batch.shape == (20, 3, 32, 224, 224), f'batch {tuple(batch.shape)}')
    with torch.inference_mode():
        model.bfloat16()
        ms = median_ms(lambda: model(batch), reps=5)
        logits_bf16 = model(batch).float()
        print(f'forward, bf16, 20 clips x 32 x 224 x 224: {ms:.3f} ms = '
              f'{20 / ms * 1e3:.2f} clips/s (CUDA events, median of 5)')
        window, by_name = device_times(lambda: model(batch), torch)
        busy = sum(by_name.values()) / 1e3
        if busy:
            print(f'profiled forward (torch.profiler): {window:.1f} ms host '
                  f'window, {busy:.1f} ms of kernels, device idle '
                  f'{max(0.0, 1 - busy / window):.1%}', flush=True)
            print_families(by_name, busy, {
                'attention (K1-fwd)': ('nonlocal_attention',),
                'convolution': CONV_KEYS,
                'batch norm': ('batch_norm', 'bn_fw'), 'pooling': ('pool',),
                'elementwise': ('elementwise', 'vectorized', 'unrolled')})
        else:
            print('profiled forward: the profiler saw no device time (not '
                  'measured)')
        check(logits_bf16.shape == (20, 400)
              and bool(torch.isfinite(logits_bf16).all()),
              'bf16 logits not finite')

        def with_attention(fn):
            orig = nonlocalnet.auto_nonlocal_attention
            nonlocalnet.auto_nonlocal_attention = fn
            try:
                return model(batch).float()
            finally:
                nonlocalnet.auto_nonlocal_attention = orig

        # the bf16 model through the wgmma kernels (layers 2 and 3) against
        # the same model with the mma.sync kernel there and with the plain
        # attention
        logits_mma = with_attention(
            lambda q, k, v: na._launch_fwd(q, k, v, 1.0, 'mma_sync')[0])
        logits_pb = with_attention(na.nonlocal_attention_reference)
        rel_wp, rel_mp = rel_l2(logits_bf16, logits_pb), rel_l2(logits_mma,
                                                                logits_pb)
        print(f'bf16 logits, rel L2 to the bf16 model with plain attention: '
              f'wgmma at layers 2 and 3 {rel_wp:.3e} (tol '
              f'{TOL_LOGITS_BF16:g} and 2x mma.sync\'s), mma.sync there '
              f'{rel_mp:.3e}; wgmma vs mma.sync '
              f'{rel_l2(logits_bf16, logits_mma):.3e}', flush=True)
        check(rel_wp <= min(TOL_LOGITS_BF16, 2 * rel_mp),
              f'bf16 logits through wgmma off the plain attention: {rel_wp}')
        model.float()
        logits_k = model(batch)
        logits_p = with_attention(na.nonlocal_attention_reference)
        rel = rel_l2(logits_k, logits_p)
        rel_bf16 = rel_l2(logits_bf16, logits_p)
        print(f'f32 logits, kernel vs plain attention: rel L2 {rel:.3e} '
              f'(tol 1e-3); bf16 vs f32-plain: rel L2 {rel_bf16:.3e}')
        check(bool(torch.isfinite(logits_k).all()) and rel <= 1e-3,
              f'kernel and plain paths disagree: rel L2 {rel:.3e}')
        for m in model.modules():
            if isinstance(m, nonlocalnet.NonLocalBlock):
                m.W[1].weight.zero_()
        moved = ((model(batch) - logits_k).norm() / logits_k.norm()).item()
        print(f'zeroing the 5 W.1 scales moves the f32 logits by rel L2 '
              f'{moved:.3e}')
        check(moved > 1e-2, 'the logits do not depend on the attention')
    return launches, eval_by_kernel, eval_layer3, cli


def backward_vs_plain(na, torch):
    """Phase 5: K1-dq and K1-dkv at every case in both dtypes, with the
    kernels the dispatch picks; bf16 cases timed with their bounds and
    SDPA's backward, K1-dq and K1-dkv repeated (bitwise), layers 2 and 3
    also on the generic K1-dq and K1-dkv that wgmma (at layer 3 its wide
    programs) replaced, each held to the plain backward. Returns the bf16
    numbers of layers 2 and 3 (dq, dkv)."""
    g = torch.Generator(device='cuda').manual_seed(1)
    result = {}
    for name, (b, n, nk, c, cv) in TRAIN_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split('.')[-1]
            q = (torch.randn(b, n, c, device='cuda', generator=g)
                 / c ** 0.25).to(dt)
            k = (torch.randn(b, nk, c, device='cuda', generator=g)
                 / c ** 0.25).to(dt)
            v = torch.randn(b, nk, cv, device='cuda', generator=g).to(dt)
            do = torch.randn(b, n, cv, device='cuda', generator=g).to(dt)
            out, lse = na.nonlocal_attention_cuda(q, k, v)
            got = na.nonlocal_attention_bwd_cuda(q, k, v, out, lse, do)
            torch.cuda.synchronize()
            want = na.nonlocal_attention_bwd_reference(
                q.float(), k.float(), v.float(), out.float(), lse, do.float())
            errs, rels = [], []
            for gr, w in zip(got, want):
                errs.append((gr.float() - w).abs().max().item())
                rels.append(errs[-1] / w.abs().max().item())
            tol = TOL_BWD[dname]
            generic_rel = 0.0
            dq_kernel = na.attention_kernel(dt, c, cv, 'dq')
            kernel = na.attention_kernel(dt, c, cv, 'dkv')
            line = (f'{name:10s} {dname:8s} B={b} N={n} Nk={nk} C={c} '
                    f'Cv={cv} [dq {dq_kernel}, dkv {kernel}]: '
                    f'max|d-plain|/max|d| dq {rels[0]:.2e}, dk {rels[1]:.2e}, '
                    f'dv {rels[2]:.2e} (tol {tol:g})')
            if dt == torch.bfloat16:
                delta = (do.float() * out.float()).sum(-1)
                again = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse,
                                                           delta)
                same = (torch.equal(again[0], got[1])
                        and torch.equal(again[1], got[2]))
                del again
                same_dq = torch.equal(na.nonlocal_attention_bwd_dq_cuda(
                    q, k, v, do, lse, delta), got[0])
                line += (f'; a second run bitwise equal: dk, dv {same}, dq '
                         f'{same_dq}')
                check(same, f'K1-dkv ({kernel}) does not repeat at {name}')
                check(same_dq, f'K1-dq ({dq_kernel}) does not repeat at '
                      f'{name}')
                dq_ms = median_ms(lambda: na.nonlocal_attention_bwd_dq_cuda(
                    q, k, v, do, lse, delta))
                dkv_ms = median_ms(lambda: na.nonlocal_attention_bwd_dkv_cuda(
                    q, k, v, do, lse, delta))
                ms = median_ms(lambda: na.nonlocal_attention_bwd_cuda(
                    q, k, v, out, lse, do))
                lib_ms, backend = sdpa_ms(torch, q, k, v, do)
                bounds = attention_bounds(b, n, nk, c, cv, dname)
                whole = bound(2 * b * n * nk * (3 * c + 2 * cv),
                              2 * (3 * b * n * c + 3 * b * nk * (c + cv)
                                   + 2 * b * n * cv), dname)
                line += (f'\n    kernels {ms:.3f} ms (dq {dq_ms:.3f}, dkv '
                         f'{dkv_ms:.3f}, delta and allocation the rest), '
                         f'scaled_dot_product_attention backward '
                         f'{fmt_ms(lib_ms)} ({backend}); bound: dq '
                         f'{bounds["dq"][0]:.4f} ms, dkv '
                         f'{bounds["dkv"][0]:.4f} ms, whole backward '
                         f'{whole[0]:.4f} ms ({whole[1]})')
                if name in ('layer2', 'layer3'):
                    plain_ms = median_ms(
                        lambda: na.nonlocal_attention_bwd_reference(
                            q, k, v, out, lse, do))
                    line += f', plain {plain_ms:.3f} ms'
                    library = (f'scaled_dot_product_attention backward '
                               f'({backend}; dq, dk, dv together)')
                    plain = ('nonlocal_attention_bwd_reference (dq, dk, dv '
                             'together)')
                    # the generic K1-dkv that wgmma replaced, held to the
                    # plain backward as the kernel the dispatch picks is
                    generic = na._launch_dkv(q, k, v, do, lse, delta, 1.0,
                                             'mma_sync')
                    generic_rel = max(rel_to_max(gr, w)
                                      for gr, w in zip(generic, want[1:]))
                    del generic
                    line += (f'; the generic K1-dkv: max|d-plain|/max|d| '
                             f'{generic_rel:.2e}')
                    earlier_ms = median_ms(lambda: na._launch_dkv(
                        q, k, v, do, lse, delta, 1.0, 'mma_sync'))
                    hosts = (host_us(lambda: na.nonlocal_attention_bwd_dkv_cuda(
                                 q, k, v, do, lse, delta)),
                             host_us(lambda: na._launch_dkv(
                                 q, k, v, do, lse, delta, 1.0, 'mma_sync')))
                    line += (f'; the generic mma.sync K1-dkv {earlier_ms:.3f}'
                             f' ms; host per call dkv {hosts[0]:.1f} us '
                             f'({kernel}), {hosts[1]:.1f} us (mma.sync)')
                    result[name] = {'dkv': {
                        'kernel': kernel, 'max_abs_err': max(errs[1:]),
                        'max_rel_err': max(rels[1:]), 'ms': dkv_ms,
                        'plain_ms': plain_ms, 'plain': plain,
                        'library_ms': lib_ms, 'library': library,
                        'bound_ms': bounds['dkv'][0],
                        'bound_by': bounds['dkv'][1],
                        'earlier_ms': earlier_ms,
                        'earlier': 'generic mma.sync kernel, same run',
                        'host_us': hosts[0], 'earlier_host_us': hosts[1]}}
                    # the generic K1-dq that wgmma replaced: held to the
                    # plain backward and to the kernel the dispatch picks
                    dq_earlier_ms = median_ms(lambda: na._launch_dq(
                        q, k, v, do, lse, delta, 1.0, 'mma_sync'))
                    dq_hosts = (host_us(lambda: na.nonlocal_attention_bwd_dq_cuda(
                                    q, k, v, do, lse, delta)),
                                host_us(lambda: na._launch_dq(
                                    q, k, v, do, lse, delta, 1.0, 'mma_sync')))
                    dq_earlier = na._launch_dq(q, k, v, do, lse, delta, 1.0,
                                               'mma_sync')
                    dq_ab = ((got[0].float() - dq_earlier.float()).abs().max()
                             / dq_earlier.float().abs().max()).item()
                    dq_generic_rel = rel_to_max(dq_earlier, want[0])
                    generic_rel = max(generic_rel, dq_generic_rel)
                    del dq_earlier
                    line += (f'; the generic mma.sync K1-dq {dq_earlier_ms:.3f}'
                             f' ms (max|d-plain|/max|d| {dq_generic_rel:.2e},'
                             f' max|wgmma-generic|/max|generic| '
                             f'{dq_ab:.2e}); host per call dq '
                             f'{dq_hosts[0]:.1f} us ({dq_kernel}), '
                             f'{dq_hosts[1]:.1f} us (mma.sync)')
                    check(dq_ab <= TOL_BWD[dname],
                          f'K1-dq wgmma and generic disagree: {dq_ab}')
                    result[name]['dq'] = {
                        'kernel': dq_kernel, 'max_abs_err': errs[0],
                        'max_rel_err': rels[0], 'ms': dq_ms,
                        'plain_ms': plain_ms, 'plain': plain,
                        'library_ms': lib_ms, 'library': library,
                        'bound_ms': bounds['dq'][0],
                        'bound_by': bounds['dq'][1],
                        'earlier_ms': dq_earlier_ms,
                        'earlier': 'generic mma.sync kernel, same run',
                        'host_us': dq_hosts[0],
                        'earlier_host_us': dq_hosts[1]}
            print(line, flush=True)
            check(max(rels) <= tol,
                  f'backward kernels disagree with the plain version: {line}')
            check(generic_rel <= tol, f'the generic K1-dq or K1-dkv '
                  f'disagrees with the plain backward: {line}')
            del q, k, v, do, out, lse, got, want
            torch.cuda.empty_cache()
    return result


def counts(na):
    return (na.nonlocal_attention_cuda.launches,
            na.nonlocal_attention_bwd_dq_cuda.launches,
            na.nonlocal_attention_bwd_dkv_cuda.launches)


def set_counts(na, value):
    for fn in (na.nonlocal_attention_cuda, na.nonlocal_attention_bwd_dq_cuda,
               na.nonlocal_attention_bwd_dkv_cuda):
        fn.launches = value
        fn.by_kernel = dict.fromkeys(na.PROGRAMS, value)


def kernel_counts(na):
    """K1-fwd's, K1-dq's and K1-dkv's launches by program, e.g.
    {'fwd wgmma': 2, 'fwd wgmma_wide': 3}."""
    return {f'{name} {kernel}': n
            for name, fn in (('fwd', na.nonlocal_attention_cuda),
                             ('dq', na.nonlocal_attention_bwd_dq_cuda),
                             ('dkv', na.nonlocal_attention_bwd_dkv_cuda))
            for kernel, n in fn.by_kernel.items() if n}


def expect_kernels(na, per_pass, passes, what):
    """Each pass launched the programs of ``per_pass`` ({'fwd wgmma': 2,
    ...}) and no other K1 program. Returns the launches of the wide
    programs, layer 3's (fwd, dq, dkv)."""
    got = kernel_counts(na)
    want = {k: n * passes for k, n in per_pass.items()}
    check(got == want, f'{what}: launches by program {got}, expected {want}')
    return tuple(got.get(f'{op} wgmma_wide', 0) for op in na.OPS)


def train_batch(cli, settings, torch):
    """2 clips from each of the 4 fabricated videos, with their labels."""
    videos, _ = cli.list_videos(WORK / 'val')
    per_video = TRAIN_CLIPS // len(videos)
    x = torch.cat([cli.load_video(frames, per_video, 32, settings, 'cuda',
                                  dtype=torch.float32)
                   for frames, _ in videos])
    labels = torch.tensor([label for _, label in videos
                           for _ in range(per_video)], device='cuda')
    return x, labels


def device_times(fn, torch):
    """``fn()`` once under ``torch.profiler``: (host window ms, device time
    by kernel name in us)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():     # the profiler's note on its cycles
        warnings.simplefilter('ignore', UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    return window, by_name


def print_families(by_name, busy, groups):
    """Device time by kernel family (cuDNN's and PyTorch's kernel names),
    then the ten largest kernels."""
    sums = dict.fromkeys([*groups, 'other'], 0.0)
    for name, us in by_name.items():
        low = name.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in low for k in keys)), 'other')
        sums[group] += us / 1e3
    print('  by family: ' + ', '.join(f'{g} {ms:.1f} ms ({ms / busy:.1%})'
                                      for g, ms in sums.items()))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f'  {us / 1e3:8.2f} ms {us / 1e3 / busy:6.1%}  {name[:90]}')
    return sums


CONV_KEYS = ('conv', 'xmma', 'fprop', 'dgrad', 'wgrad', 'implicit', 'cudnn',
             'gemm')


def profile_step(step, x, labels, torch):
    """One more train step under ``torch.profiler``: device time by kernel,
    the attention's share, and the device's idle share of the step."""
    window, by_name = device_times(lambda: step(x, labels), torch)
    busy = sum(by_name.values()) / 1e3
    if not busy:
        print('profiled step: the profiler saw no device time (not measured)')
        return
    attn = {k: v / 1e3 for k, v in by_name.items()
            if 'nonlocal_attention' in k}

    def ms(key):
        return sum(v for k, v in attn.items() if key in k)

    generic = ms('bwd_bf16_kernel')
    print(f'profiled step (torch.profiler, one step after the timed ones): '
          f'{window:.1f} ms host window, {busy:.1f} ms of kernels, device '
          f'idle {max(0.0, 1 - busy / window):.1%}; attention kernels '
          f'{sum(attn.values()):.1f} ms ({sum(attn.values()) / busy:.1%}): '
          f'at layer 2 K1-fwd {ms("fwd_wgmma"):.2f} ms, K1-dq '
          f'{ms("dq_wgmma"):.2f} ms, K1-dkv {ms("dkv_wgmma"):.2f} ms (2 '
          f'launches each), at layer 3 the wide K1-fwd {ms("fwd_wide"):.2f} '
          f'ms, K1-dq {ms("dq_wide"):.2f} ms and K1-dkv {ms("dkv_wide"):.2f} '
          f'ms (3 launches each), the generic programs {generic:.2f} ms (no '
          f'launch expected)', flush=True)
    print_families(by_name, busy, {
        'attention': ('nonlocal_attention',), 'convolution': CONV_KEYS,
        'batch norm': ('batch_norm', 'bn_fw', 'bn_bw'),
        'optimizer': ('multi_tensor', 'foreach')})


def train_path(pretorched, na, torch, np, cli):
    """Phase 6; returns the launch counts of the timed steps."""
    from pretorched_tpu_torch.parallel.train import (make_train_step,
                                                     sgd_step_decay)
    from pretorched_tpu_torch.zoo.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

    model = pretorched.nonlocalresnet3d50(num_classes=400,
                                          pretrained='kinetics-400')
    model.cuda().bfloat16()
    # lr 0.001: at the non-local recipe's 0.01 these random weights on one
    # repeated batch diverge to a NaN loss by step 7 of 12 (PERF.md)
    sgd = dict(lr=TRAIN_LR, momentum=0.9, weight_decay=1e-4)
    opt, sched = sgd_step_decay(model.parameters(), **sgd)
    step = make_train_step(model, opt, sched, remat=(0,))
    x, labels = train_batch(cli, model.settings, torch)
    check(x.shape == (TRAIN_CLIPS, 3, 32, 224, 224), f'batch {tuple(x.shape)}')
    print(f'nonlocalresnet3d50, bf16 compute (f32 parameters), remat=(0,), '
          f'SGD lr {TRAIN_LR:g} momentum 0.9 wd 1e-4; {TRAIN_CLIPS} clips x 32 x '
          f'224 x 224 a step, labels {labels.tolist()}', flush=True)
    ckpt = WORK / 'train' / 'checkpoint.pth'
    ckpt.parent.mkdir(parents=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_counts(na, 0)
    times, device_ms = [], []
    for i in range(TRAIN_STEPS):
        before = counts(na)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        out = step(x, labels)
        e1.record()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        device_ms.append(e0.elapsed_time(e1))
        launched = tuple(a - b for a, b in zip(counts(na), before))
        loss = out['loss'].item()
        print(f'step {i + 1}: loss {loss:.4f} top1 {out["top1"].item():.3f} '
              f'{times[-1] * 1e3:.1f} ms host, {device_ms[-1]:.1f} ms CUDA '
              f'events, launches fwd/dq/dkv {launched}', flush=True)
        check(launched == (5, 5, 5), f'step {i + 1} launched {launched}, '
              'expected 5 of each attention kernel')
        expect_kernels(na, TRAIN_KERNELS, i + 1, f'step {i + 1}')
        check(np.isfinite(loss), f'step {i + 1}: loss {loss}')
        if i == 2:
            save_checkpoint(str(ckpt), {'model': model.state_dict(),
                                        'optimizer': opt.state_dict(),
                                        'scheduler': sched.state_dict(),
                                        'step': i + 1})
            at_save = ([p.detach().clone() for p in model.parameters()],
                       [opt.state[p]['momentum_buffer'].clone()
                        for p in model.parameters()])
    launches = counts(na)
    layer3 = expect_kernels(na, TRAIN_KERNELS, TRAIN_STEPS, 'train run')
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    step_dev = sorted(device_ms[1:])[len(device_ms[1:]) // 2]
    by_kernel = kernel_counts(na)
    print(f'train step: {step_s * 1e3:.1f} ms host clock around synchronize '
          f'= {TRAIN_CLIPS / step_s:.2f} train clips/s; {step_dev:.2f} ms '
          f'between CUDA events recorded around the step (steps '
          f'{min(device_ms[1:]):.2f}-{max(device_ms[1:]):.2f}) = '
          f'{TRAIN_CLIPS / step_dev * 1e3:.2f} train clips/s; medians of '
          f'steps 2-{TRAIN_STEPS}; peak device memory {peak_gb:.2f} GiB; '
          f'launches fwd/dq/dkv {launches} in {TRAIN_STEPS} steps, by kernel '
          f'{by_kernel}, K1-fwd, K1-dq and K1-dkv at layer 3 (the wide '
          f'programs) {layer3}', flush=True)

    profile_step(step, x, labels, torch)

    # the checkpoint of step 3 restores into a fresh model and optimizer
    state = load_checkpoint(str(ckpt), map_location='cuda')
    fresh = pretorched.nonlocalresnet3d50(num_classes=400, pretrained=None)
    fresh.cuda().load_state_dict(state['model'])
    opt2, sched2 = sgd_step_decay(fresh.parameters(), **sgd)
    opt2.load_state_dict(state['optimizer'])
    sched2.load_state_dict(state['scheduler'])
    params, bufs = at_save
    same = all(torch.equal(p, w) for p, w in zip(fresh.parameters(), params))
    same_m = all(torch.equal(opt2.state[p]['momentum_buffer'], w)
                 for p, w in zip(fresh.parameters(), bufs))
    print(f'checkpoint after step 3: {ckpt.stat().st_size / 2 ** 20:.1f} MiB;'
          f' parameters restored exactly: {same}; momentum buffers restored '
          f'exactly: {same_m} ({len(bufs)} buffers); lr '
          f'{sched2.get_last_lr()[0]:g}', flush=True)
    check(same and same_m and len(bufs) == len(list(fresh.parameters())),
          'the checkpoint did not restore exactly')
    del fresh, opt2, sched2, state, at_save, params, bufs, model, opt, x
    torch.cuda.empty_cache()
    return launches, by_kernel, layer3


def attention_f64(q, k, v, scale=1.0):
    """The plain attention in the inputs' dtype (f64 for the exact step)."""
    import torch
    return torch.bmm(torch.softmax(torch.bmm(q, k.transpose(1, 2)) * scale,
                                   -1), v)


def block_agreement(na, torch, nonlocalnet, blocks, inputs):
    """Each non-local block alone, on the input it had in the f32 step and
    a random cotangent: the gradients of its input and of its parameters
    with the kernels against those with the plain attention, rel L2 <= 1e-3.
    One attention amplifies rounding only by its logits' spread, so here
    the two agree as f32 sums in another order do. A tensor whose gradient
    is zero but for rounding (``phi``'s bias shifts a softmax row by a
    constant; ``W.0``'s bias feeds a BN) is measured against 1e-2 of the
    block's largest gradient norm instead of its own."""
    g = torch.Generator(device='cuda').manual_seed(7)
    worst = (0.0, '')
    for name, blk in blocks:
        x = inputs[name]
        ct = torch.randn(x.shape, device='cuda', generator=g)

        def grads(attention=None):
            orig = nonlocalnet.auto_nonlocal_attention
            nonlocalnet.auto_nonlocal_attention = attention or orig
            try:
                xi = x.clone().requires_grad_()
                blk.zero_grad(set_to_none=True)
                (blk(xi) * ct).sum().backward()
            finally:
                nonlocalnet.auto_nonlocal_attention = orig
            return {'input': xi.grad, **{n: p.grad for n, p in
                                         blk.named_parameters()}}

        gk, gp = grads(), grads(na.nonlocal_attention_reference)
        top = max(t.norm().item() for t in gp.values())
        for n in gp:
            rel = ((gk[n] - gp[n]).norm().item()
                   / max(gp[n].norm().item(), 1e-2 * top))
            worst = max(worst, (rel, f'{name}: {n}'))
        blk.zero_grad(set_to_none=True)
    print(f'each of the {len(blocks)} non-local blocks alone, input and '
          f'parameter gradients, kernels vs plain: worst rel L2 '
          f'{worst[0]:.3e} ({worst[1]}; tol 1e-3)', flush=True)
    check(len(blocks) == 5 and worst[0] <= 1e-3,
          f'block gradients disagree: {worst}')


def gradient_agreement(pretorched, na, torch, cli):
    """Phase 7: one training step's loss and gradients in f32 with the
    kernels (K) and with the plain attention (P), each against the same step
    in f64 with the attention in f64 (D).

    With random weights and train-mode BN the model amplifies rounding: a
    last-bit change of the attention's output moves the gradients of the
    early BN parameters by percents. So K is not held to P at 1e-3; it is
    held to D as closely as P is: each error within 1e-3, or within 4x the
    plain f32 step's own error. Each non-local block alone is well
    conditioned, and there the kernels are held to the plain attention at
    1e-3 (``block_agreement``)."""
    from pretorched_tpu_torch.models import nonlocalnet
    from pretorched_tpu_torch.parallel.train import cross_entropy

    torch.backends.cudnn.deterministic = True
    model = pretorched.nonlocalresnet3d50(num_classes=400,
                                          pretrained='kinetics-400')
    model.cuda().train()
    x, labels = train_batch(cli, model.settings, torch)
    x, labels = x[:2], labels[:2]

    def grads(attention=None):
        model.zero_grad(set_to_none=True)
        orig = nonlocalnet.auto_nonlocal_attention
        nonlocalnet.auto_nonlocal_attention = attention or orig
        t0 = time.perf_counter()
        try:
            xd = x.to(next(model.parameters()).dtype)
            loss = cross_entropy(model(xd), labels)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            nonlocalnet.auto_nonlocal_attention = orig
        return (loss.item(), {n: p.grad.double()
                              for n, p in model.named_parameters()},
                time.perf_counter() - t0)

    blocks = [(n, m) for n, m in model.named_modules()
              if isinstance(m, nonlocalnet.NonLocalBlock)]
    inputs = {}
    def keep_input(name):
        def hook(module, args):
            inputs.setdefault(name, args[0].detach().clone())
        return hook

    hooks = [m.register_forward_pre_hook(keep_input(n)) for n, m in blocks]
    before = counts(na)
    try:
        loss_k, gk, _ = grads()
    finally:
        for h in hooks:
            h.remove()
    launched = tuple(a - b for a, b in zip(counts(na), before))
    loss_p, gp, _ = grads(na.nonlocal_attention_reference)
    check(counts(na) == tuple(c + l for c, l in zip(before, launched)),
          'the plain step launched a kernel')
    block_agreement(na, torch, nonlocalnet, blocks, inputs)
    model.double()
    loss_d, gd, f64_s = grads(attention_f64)

    # biases that feed a BN or a softmax have no gradient but rounding: the
    # error of each tensor is taken relative to at least 1e-4 of the
    # largest gradient norm
    floor = 1e-4 * max(g.norm().item() for g in gd.values())

    def errs(g):
        per = {n: (g[n] - gd[n]).norm().item() / max(gd[n].norm().item(), floor)
               for n in gd}
        diff = sum((g[n] - gd[n]).norm().item() ** 2 for n in gd) ** 0.5
        whole = sum(gd[n].norm().item() ** 2 for n in gd) ** 0.5
        return per, diff / whole

    ek, ek_all = errs(gk)
    ep, ep_all = errs(gp)
    worst = max(ek, key=lambda n: ek[n] / max(1e-3, 4 * ep[n]))
    kp = {n: (gk[n] - gp[n]).norm().item() / max(gp[n].norm().item(), floor)
          for n in gd}
    worst_kp = max(kp, key=kp.get)
    nl = [n for n in gk if '.nonlocalblock.' in n
          and n.rsplit('.', 2)[-2] in ('theta', 'phi', 'g')
          and n.endswith('weight')]
    nl_norms = {n: gk[n].norm().item() for n in nl}
    lk, lp = abs(loss_k - loss_d) / loss_d, abs(loss_p - loss_d) / loss_d
    print(f'2 clips x 32 x 224, TF32 off, cudnn.deterministic; launches '
          f'fwd/dq/dkv {launched} in the kernels step; f64 step '
          f'{f64_s:.1f} s', flush=True)
    print(f'loss: f64 {loss_d:.8f}, f32 kernels {loss_k:.8f} (rel '
          f'{lk:.2e}), f32 plain {loss_p:.8f} (rel {lp:.2e})')
    print(f'all {len(gd)} gradients together, rel L2 to f64: kernels '
          f'{ek_all:.3e}, plain {ep_all:.3e}')
    print(f'worst tensor against its bound max(1e-3, 4 x plain): {worst} '
          f'kernels {ek[worst]:.3e}, plain {ep[worst]:.3e}; largest '
          f'tensor error to f64: kernels {max(ek.values()):.3e}, plain '
          f'{max(ep.values()):.3e}; kernels vs f32 plain directly: '
          f'{kp[worst_kp]:.3e} ({worst_kp})')
    nl_err = max(ek[n] for n in gd if '.nonlocalblock.' in n)
    print(f'non-local blocks\' {sum(".nonlocalblock." in n for n in gd)} '
          f'tensors, largest error to f64: kernels {nl_err:.3e}, plain '
          f'{max(ep[n] for n in gd if ".nonlocalblock." in n):.3e}; '
          f'smallest theta/phi/g weight gradient norm '
          f'{min(nl_norms.values()):.3e} over {len(nl)} tensors', flush=True)
    check(launched == (5, 5, 5), f'f32 step launched {launched}')
    check(lk <= max(1e-5, 4 * lp), f'loss: kernels {loss_k}, plain {loss_p}, '
          f'f64 {loss_d}')
    check(ek_all <= max(1e-3, 4 * ep_all),
          f'gradients: kernels {ek_all:.3e} from f64, plain {ep_all:.3e}')
    check(ek[worst] <= max(1e-3, 4 * ep[worst]),
          f'{worst}: kernels {ek[worst]:.3e} from f64, plain {ep[worst]:.3e}')
    check(len(nl) == 15 and min(nl_norms.values()) > 0,
          f'theta/phi/g gradients {nl_norms}')
    torch.backends.cudnn.deterministic = False
    del model, gk, gp, gd
    torch.cuda.empty_cache()


def k2_block(torch, slowfast, shape, g):
    """A SlowFast bottleneck of this shape (stride 1) on the card in eval
    mode: conv weights normal with std sqrt(2 / fan_in), every BN
    randomized, all from the CPU generator ``g``."""
    n, t, h, w, cin, cm, cout, proj = shape
    blk = slowfast.Bottleneck(cin, cm, 1, proj, 3)
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, torch.nn.Conv3d):
                m.weight.normal_(0.0, (2 / m.weight[0].numel()) ** 0.5,
                                 generator=g)
    randomize_bn(blk, torch, seed=int(torch.randint(1 << 30, (1,),
                                                    generator=g)))
    return blk.cuda().eval()


def k2_bound(shape, dtype):
    """K2's bound: y1, x and out once each, the weights and folded BN once
    (f32, as the kernel reads them); the products conv2, conv3 and the
    projection must do."""
    n, t, h, w, cin, cm, cout, proj = shape
    e = 2 if dtype == 'bfloat16' else 4
    pixels = n * t * h * w
    macs = 9 * cm * cm + cm * cout + (cin * cout if proj else 0)
    nbytes = pixels * (cm + cin + cout) * e + 4 * (macs + 2 * (cm + cout)
                                                   + 2 * cout * proj)
    return bound(2 * pixels * macs, nbytes, dtype)


def k2_vs_plain(torch, fb, fb_cuda, slowfast):
    """Phase 8: K2 at every shape, in f32 and bf16, against the plain
    version on the same inputs, each on the kernel ``tail_kernel`` picks
    (``K2_KERNELS``); in bf16 also the kernel's time, the mma.sync kernel's
    where the TMA kernel replaced it (and that the two outputs are equal),
    the host time of a wrapper call that folds and lays out the weights and
    of one with the block's kept layout, the plain version's time, the
    unfused tail's (the block's own conv2 -> BN -> ReLU -> conv3 -> BN ->
    add -> ReLU under bf16 autocast: several cuDNN and PyTorch calls, as the
    model runs at fused_blocks=0) and the bound. Returns the bf16 rows."""
    g = torch.Generator().manual_seed(2)
    gc = torch.Generator(device='cuda').manual_seed(3)
    rows = {}
    for name, shape in K2_SHAPES.items():
        n, t, h, w, cin, cm, cout, proj = shape
        blk = k2_block(torch, slowfast, shape, g)
        y1f = torch.randn((n, cm, t, h, w), device='cuda',
                          generator=gc).relu_()
        xf = torch.randn((n, cin, t, h, w), device='cuda',
                         generator=gc).relu_()
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split('.')[-1]
            y1, x = y1f.to(dt), xf.to(dt)
            with torch.inference_mode():
                weights = blk.tail_weights()
                prepared = fb_cuda.prepare_tail(y1, x, *weights)
                out = fb_cuda.launch_tail(prepared)
                torch.cuda.synchronize()
                want = fb.fused_bottleneck_tail_reference(y1, x, *weights)
                err = (out.float() - want.float()).abs().max().item()
                rel = err / want.float().abs().max().item()
            tol = TOL_K2[dname]
            kernel = prepared['kernel']
            expected = (K2_KERNELS[name] if dt == torch.bfloat16
                        else 'cuda_cores')
            line = (f'{name:14s} {dname:8s} N={n} T={t} {h}x{w} {cin}->{cm}'
                    f'->{cout}{" (projection)" if proj else ""} [{kernel}]: '
                    f'max|out-plain|/max|plain| {rel:.2e} (tol {tol:g})')
            check(kernel == expected,
                  f'K2 {name} {dname} took {kernel}, expected {expected}')
            if dt == torch.bfloat16:
                with torch.inference_mode():
                    ms = median_ms(lambda: fb_cuda.launch_tail(prepared))
                    earlier_ms = None
                    if kernel == 'tma':
                        layout = fb_cuda.TailLayout(*weights)
                        old = fb_cuda._prepare(y1, x, layout, 'mma_sync')
                        earlier_ms = median_ms(
                            lambda: fb_cuda.launch_tail(old))
                        same = torch.equal(fb_cuda.launch_tail(old), out)
                        check(same, f'K2 {name}: the TMA and mma.sync '
                              'kernels differ')
                        del old
                    call_ms = median_ms(
                        lambda: fb_cuda.fused_bottleneck_tail_cuda(
                            y1, x, *blk.tail_weights()))
                    host_fold = host_us(
                        lambda: fb_cuda.fused_bottleneck_tail_cuda(
                            y1, x, *blk.tail_weights()))
                    host_kept = host_us(lambda: fb.fused_tail_with_layout(
                        y1, x, blk.tail_layout()))
                    plain_ms = median_ms(
                        lambda: fb.fused_bottleneck_tail_reference(
                            y1, x, *weights))
                    with torch.autocast('cuda', dtype=torch.bfloat16):
                        lib_ms = median_ms(lambda: blk.tail(y1, x))
                        unfused = blk.tail(y1, x)
                    lib_err = ((unfused.float() - want.float()).abs().max()
                               / want.float().abs().max()).item()
                    del unfused
                bound_ms, bound_by = k2_bound(shape, dname)
                line += (f'\n    kernel {ms:.4f} ms'
                         + (f', the mma.sync kernel {earlier_ms:.4f} ms '
                            '(outputs equal)' if earlier_ms else '')
                         + f'; wrapper call with BN fold and weight layout '
                         f'{call_ms:.4f} ms, host {host_fold:.1f} us a call '
                         f'(with the block\'s kept layout {host_kept:.1f} '
                         f'us); plain {plain_ms:.4f} ms, unfused tail '
                         f'(several cuDNN and PyTorch calls) {lib_ms:.4f} ms '
                         f'(max|unfused-plain|/max|plain| {lib_err:.2e}), '
                         f'bound {bound_ms:.4f} ms ({bound_by})'
                         + (f'; {K2_SLICE[name]} launches a forward'
                            if name in K2_SLICE else ''))
                rows[name] = {
                    'kernel': kernel, 'max_abs_err': err, 'max_rel_err': rel,
                    'ms': ms, 'earlier_ms': earlier_ms, 'call_ms': call_ms,
                    'host_us': host_kept, 'host_us_with_fold': host_fold,
                    'plain_ms': plain_ms, 'library_ms': lib_ms,
                    'bound_ms': bound_ms, 'bound_by': bound_by}
            print(line, flush=True)
            check(rel <= tol, f'K2 disagrees with the plain version: {line}')
            del y1, x, out, want, weights, prepared
        del blk, y1f, xf
        torch.cuda.empty_cache()
    return rows


def fabricate_videos(np, root, frames=80):
    """2 classes x 2 videos x ``frames`` JPEG frames at 240 x 320 (numpy
    seed 0): enough for 10 distinct 64-frame clips a video."""
    from PIL import Image

    rng = np.random.RandomState(0)
    for cls in ('applauding', 'boxing'):
        for vid in range(2):
            d = root / cls / f'v{vid}'
            d.mkdir(parents=True)
            base = rng.randint(0, 256, (240, 320, 3)).astype(np.int16)
            for f in range(frames):
                frame = base + rng.randint(-20, 21, base.shape)
                Image.fromarray(np.clip(frame, 0, 255).astype(np.uint8)).save(
                    d / f'frame_{f:05d}.jpg', quality=90)


def k_counts(na, fb_cuda):
    """Launches of K1-fwd, K1-dq, K1-dkv and K2."""
    return (*counts(na), fb_cuda.fused_bottleneck_tail_cuda.launches)


def forward_ab(model, batch, torch):
    """Median forward ms (CUDA events, 5 each) with fused_blocks 32 and 0,
    in turns: fused, unfused, unfused, fused."""
    times = {32: [], 0: []}
    for n in (32, 0, 0, 32):
        model.fused_blocks = n
        times[n].append(median_ms(lambda: model(batch), reps=5))
    model.fused_blocks = 32
    return times


def slowfast_path(pretorched, torch, np, cli, na, fb_cuda):
    """Phase 9: ``slowfast_resnet50(fused_blocks=32)`` from seed 0 with
    every BN randomized, 2 steps of 2 videos x 10 clips x 64 frames x 224
    px from the CLI's ``load_video`` through ``multi_clip_eval_step``;
    then, on the first batch, the forward A/B against fused_blocks=0, peak
    memory, a profiled forward, the f32 agreement of the fused and unfused
    paths, and the effect of the randomized BN; last the eval CLI on the
    same videos. Returns K2's launches in the two steps, in all and by
    kernel."""
    from pretorched_tpu_torch.parallel.evaluate import multi_clip_eval_step

    root = WORK / 'val64'
    t0 = time.perf_counter()
    fabricate_videos(np, root)
    print(f'fabricated 4 videos x 80 JPEG frames in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    model = pretorched.slowfast_resnet50(num_classes=400, pretrained=None,
                                         fused_blocks=32)
    randomize_bn(model, torch, seed=1)
    model.cuda().eval().bfloat16()
    step = multi_clip_eval_step(model)
    videos, _ = cli.list_videos(root)
    check(len(videos) == 4, f'{len(videos)} videos')

    def batch_of(pair):
        return torch.stack([cli.load_video(frames, SF_CLIPS, SF_FRAMES,
                                           CLI_SETTINGS, 'cuda')
                            for frames, _ in pair])

    torch.cuda.synchronize()
    set_counts(na, 0)
    fb_cuda.fused_bottleneck_tail_cuda.launches = 0
    fb_cuda.fused_bottleneck_tail_cuda.by_kernel = dict.fromkeys(
        fb_cuda.KERNELS, 0)
    t0 = time.perf_counter()
    totals = {}
    for i in range(0, len(videos), SF_VIDEOS):
        pair = videos[i:i + SF_VIDEOS]
        labels = torch.tensor([label for _, label in pair], device='cuda')
        for k, v in step(batch_of(pair), labels).items():
            totals[k] = totals.get(k, 0) + v.item()
    seconds = time.perf_counter() - t0
    launched = k_counts(na, fb_cuda)
    steps = len(videos) // SF_VIDEOS
    print(f'eval path: {steps} steps of {SF_VIDEOS} videos x {SF_CLIPS} clips '
          f'x {SF_FRAMES} frames, {len(videos) * SF_CLIPS} clips in '
          f'{seconds:.3f} s = {len(videos) * SF_CLIPS / seconds:.2f} clips/s '
          f'(decode + preprocess + forward, first run); launches K1-fwd/dq/'
          f'dkv/K2 {launched}; totals {totals}', flush=True)
    k2_by_kernel = dict(fb_cuda.fused_bottleneck_tail_cuda.by_kernel)
    print(f'K2 launches by kernel: {k2_by_kernel}', flush=True)
    check(launched == (0, 0, 0, 11 * steps),
          f'expected 11 K2 launches per forward and no K1, got {launched}')
    want = {'tma': 6 * steps, 'mma_sync': 5 * steps, 'cuda_cores': 0}
    check(k2_by_kernel == want, f'K2 launches by kernel {k2_by_kernel}, '
          f'expected {want} (res2 and res3 on the TMA kernel, res4 on '
          'mma.sync)')
    check(totals['count'] == 4 and 0 <= totals['top1'] <= totals['top5'] <= 4
          and np.isfinite(totals['loss']), f'bad eval totals {totals}')

    batch = batch_of(videos[:SF_VIDEOS]).flatten(0, 1)
    check(batch.shape == (SF_VIDEOS * SF_CLIPS, 3, SF_FRAMES, 224, 224)
          and batch.dtype == torch.bfloat16, f'batch {tuple(batch.shape)}')
    nclips = batch.shape[0]
    with torch.inference_mode():
        logits_bf16 = model(batch).float()
        check(logits_bf16.shape == (nclips, 400)
              and bool(torch.isfinite(logits_bf16).all()),
              'bf16 logits not finite')
        times = forward_ab(model, batch, torch)
        for n in (32, 0):
            ms = sum(times[n]) / 2
            print(f'forward, bf16, {nclips} clips x {SF_FRAMES} x 224 x 224, '
                  f'fused_blocks={n}: {times[n][0]:.3f} / {times[n][1]:.3f} '
                  f'ms (CUDA events, median of 5, two turns) = '
                  f'{nclips / ms * 1e3:.2f} clips/s', flush=True)
        peak = {}
        for n in (32, 0):
            model.fused_blocks = n
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            model(batch)
            torch.cuda.synchronize()
            peak[n] = torch.cuda.max_memory_allocated() / 2 ** 30
        model.fused_blocks = 32
        print(f'peak device memory of one forward: fused_blocks=32 '
              f'{peak[32]:.2f} GiB, fused_blocks=0 {peak[0]:.2f} GiB')
        window, by_name = device_times(lambda: model(batch), torch)
        busy = sum(by_name.values()) / 1e3
        if busy:
            k2 = sum(v for k, v in by_name.items()
                     if 'fused_bottleneck_tail' in k) / 1e3
            print(f'profiled forward (torch.profiler, fused_blocks=32): '
                  f'{window:.1f} ms host window, {busy:.1f} ms of kernels, '
                  f'device idle {max(0.0, 1 - busy / window):.1%}; K2 '
                  f'{k2:.2f} ms ({k2 / busy:.1%})', flush=True)
            print_families(by_name, busy, {
                'fused tail (K2)': ('fused_bottleneck_tail',),
                'convolution': CONV_KEYS,
                'batch norm': ('batch_norm', 'bn_fw'),
                'pooling': ('pool',),
                'elementwise': ('elementwise', 'vectorized', 'unrolled')})
        else:
            print('profiled forward: the profiler saw no device time (not '
                  'measured)')

        model.float()
        batch32 = batch.float()
        logits_k = model(batch32)
        model.fused_blocks = 0
        logits_u = model(batch32)
        model.fused_blocks = 32
        rel = ((logits_k - logits_u).norm() / logits_u.norm()).item()
        rel_bf16 = ((logits_bf16 - logits_u).norm() / logits_u.norm()).item()
        print(f'f32 logits, fused_blocks=32 vs 0: rel L2 {rel:.3e} (tol '
              f'1e-3); bf16 fused vs f32 unfused: rel L2 {rel_bf16:.3e}')
        check(bool(torch.isfinite(logits_k).all()) and rel <= 1e-3,
              f'fused and unfused paths disagree: rel L2 {rel:.3e}')
        del model
        plain_bn = pretorched.slowfast_resnet50(num_classes=400,
                                                pretrained=None,
                                                fused_blocks=32)
        plain_bn.cuda().eval()
        moved = ((plain_bn(batch32) - logits_k).norm()
                 / logits_k.norm()).item()
        print(f'the same weights with BN at its init (the fold an identity) '
              f'move the f32 logits by rel L2 {moved:.3e}')
        check(moved > 1e-2, 'the randomized BN does not reach the logits')
        del plain_bn, batch, batch32
    torch.cuda.empty_cache()

    argv = [str(root), '-a', 'slowfast_resnet50', '--pretrained', 'none',
            '--frames', str(SF_FRAMES), '--clips', str(SF_CLIPS), '-b',
            str(SF_VIDEOS), '--print-freq', '1', '--device', 'cuda']
    print('examples/video_eval_torch.py ' + ' '.join(argv), flush=True)
    before = k_counts(na, fb_cuda)
    summary = cli.main(argv)
    print(f"CLI: {summary['steps']} steps, {summary['clips']} clips in "
          f"{summary['seconds']:.3f} s (fused_blocks at its default 0: K2 "
          f'launches {k_counts(na, fb_cuda)[3] - before[3]})', flush=True)
    check(summary['steps'] == 2 and summary['totals']['count'] == 4,
          f'CLI summary {summary}')
    torch.cuda.empty_cache()
    return launched[3], k2_by_kernel


def load_cli(name):
    """The module of ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        name, REPO / 'examples' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel_to_max(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def report_load(what, lat_ms, wall, srv, unit='req'):
    n = len(lat_ms)
    p = {'p50': float(lat_ms[n // 2]), 'p90': float(lat_ms[int(n * 0.9)]),
         'p99': float(lat_ms[int(n * 0.99)])}
    print(f'{what}: {n} {unit}s in {wall:.3f} s = {n / wall:.2f} {unit}/s; '
          f"latency ms p50 {p['p50']:.2f} p90 {p['p90']:.2f} p99 "
          f"{p['p99']:.2f}; buckets dispatched {sorted(srv.bucket_compiles)}",
          flush=True)
    return {f'{unit}_per_s': n / wall, **p,
            'buckets': sorted(srv.bucket_compiles)}


def served_rows_vs_direct(srv, model, requests, direct_input, torch):
    """Serve ``requests`` (single examples submitted together, then one
    batch), and hold every served row to ``model(direct_input(request))``
    at batch 1; returns the worst max |diff| / max |direct|."""
    singles, batch = requests
    futs = [srv.submit(r) for r in singles]
    rows = [f.result(timeout=300) for f in futs] + list(
        srv.submit(batch).result(timeout=300))
    worst = 0.0
    with torch.inference_mode():
        for req, row in zip(list(singles) + list(batch), rows):
            want = model(direct_input(req))[0].float().cpu()
            worst = max(worst, rel_to_max(row, want))
    return worst, torch.stack(rows)


def serving_path(pretorched, na, torch, np):
    """Phase 10: the serving path (``serving.serve_model``) on the card.
    Returns K1-fwd's serving launches, by kernel, and the per-bucket K1-fwd
    times."""
    from pretorched_tpu_torch import serving
    from pretorched_tpu_torch.datasets.native import decoder_name
    from pretorched_tpu_torch.models import nonlocalnet
    from pretorched_tpu_torch.transforms.fused import fused_preprocess

    cli = load_cli('serve_torch')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(7)
    out = {}

    print('(a) resnet50, 1000 classes, seeded, every BN randomized, tensor '
          'payload (3, 224, 224)', flush=True)
    model = pretorched.resnet50(num_classes=1000, pretrained=None)
    randomize_bn(model, torch, seed=5)
    x = rng.randn(67, 3, 224, 224).astype(np.float32)
    with serving.serve_model(model, max_batch=64, max_wait_ms=20.0,
                             example_shape=(3, 224, 224),
                             example_dtype=np.float32) as srv:
        err, rows_f32 = served_rows_vs_direct(
            srv, model, (x[:3], x[3:]),
            lambda r: torch.from_numpy(r[None]).cuda(), torch)
    print(f'f32 served rows vs the direct batch-1 forward, 3 single '
          f'requests + one batch of 64 (buckets '
          f'{sorted(srv.bucket_compiles)}): max|diff|/max|direct| '
          f'{err:.3e} (tol {TOL_SERVED_F32:g}, TF32 off)', flush=True)
    check(err <= TOL_SERVED_F32 and 64 in srv.bucket_compiles,
          f'served f32 rows off the direct forward: {err}')
    model.bfloat16()
    with serving.serve_model(model, max_batch=64, max_wait_ms=2.0,
                             example_shape=(3, 224, 224),
                             example_dtype=np.float32) as srv:
        rows_bf16 = srv(x[3:]).float()
        for b in (1, 2, 4, 8, 16, 32, 64):       # warm every bucket
            srv(x[:b])
        srv.bucket_compiles.clear()
        lat, wall = cli.load_test(srv, SERVE_CLIENTS * SERVE_PER_CLIENT,
                                  SERVE_CLIENTS,
                                  lambda i, j: x[(i * 7 + j) % 67])
    rel = rel_l2(rows_bf16, rows_f32[3:])
    print(f'bf16 served rows vs f32 served rows: rel L2 {rel:.3e} (tol '
          f'{TOL_SERVED_BF16:g})')
    check(rel <= TOL_SERVED_BF16, f'bf16 served rows off f32: {rel}')
    out['tensor'] = report_load(
        f'resnet50 bf16 tensor payload, {SERVE_CLIENTS} clients x '
        f'{SERVE_PER_CLIENT} single requests', lat, wall, srv)
    fwd = cli.bucket_forward_ms(model, (3, 224, 224), 64, srv.device)
    out['bucket_forward_ms'] = fwd
    print('bare bf16 forward per bucket (CUDA events, median of 10): '
          + ', '.join(f'{b}: {ms:.3f} ms' for b, ms in fwd.items())
          + f'; bucket 64 = {64 / fwd[64] * 1e3:.1f} images/s, '
          f"{64 / fwd[64] * 1e3 / out['tensor']['req_per_s']:.2f}x the "
          'served req/s', flush=True)
    x8 = torch.from_numpy(x[:8]).cuda()
    with torch.inference_mode():
        enqueue_ms = host_us(lambda: model(x8), reps=10) / 1e3
        window, by_name = device_times(lambda: model(x8), torch)
    busy = sum(by_name.values()) / 1e3
    out['bucket8'] = {'enqueue_ms': enqueue_ms, 'window_ms': window,
                      'kernels_ms': busy}
    print(f'bucket 8: the host takes {enqueue_ms:.3f} ms to enqueue one '
          f'forward (no synchronize); profiled: {window:.2f} ms window, '
          f'{busy:.3f} ms of kernels, device idle '
          f'{max(0.0, 1 - busy / window) if busy else float("nan"):.1%}',
          flush=True)
    if busy:
        print_families(by_name, busy, {
            'convolution': CONV_KEYS, 'batch norm': ('batch_norm', 'bn_fw'),
            'pooling': ('pool',),
            'elementwise': ('elementwise', 'vectorized', 'unrolled')})
    with serving.serve_model(model, max_batch=64, max_wait_ms=2.0,
                             example_shape=(3, 224, 224),
                             example_dtype=np.float32) as srv:
        srv(x[:1])
        srv.bucket_compiles.clear()
        lat, wall = cli.load_test(srv, 512, 64,
                                  lambda i, j: x[(i * 7 + j) % 67])
    out['tensor_64_clients'] = report_load(
        'resnet50 bf16 tensor payload, 64 clients x 8 single requests',
        lat, wall, srv)

    print('\n(b) resnet50, uint8 (256, 256, 3) and JPEG payloads; JPEG '
          f'decoder: {decoder_name()}', flush=True)
    model.float()
    settings = model.settings or model
    raw = rng.randint(0, 256, (9, 256, 256, 3)).astype(np.uint8)

    def via_uint8(u8):
        return fused_preprocess(torch.from_numpy(u8[None]).cuda(), settings,
                                channels_last=False)

    with serving.serve_model(model, max_batch=64, max_wait_ms=20.0,
                             payload='uint8') as srv:
        check(srv._example_shape == (256, 256, 3),
              f'uint8 decode shape {srv._example_shape}')
        err, _ = served_rows_vs_direct(srv, model, (raw[:3], raw[3:]),
                                       via_uint8, torch)
    print(f'uint8 f32 served rows vs fused_preprocess + forward: '
          f'{err:.3e} (tol {TOL_SERVED_F32:g})', flush=True)
    check(err <= TOL_SERVED_F32, f'uint8 rows off: {err}')
    jpegs = [(REPO / 'data' / 'cat.jpg').read_bytes()] + cli.synthetic_jpegs(7)
    fit = serving._jpeg_transform((256, 256, 3), 4)
    with serving.serve_model(model, max_batch=64, max_wait_ms=20.0,
                             payload='jpeg') as srv:
        err, _ = served_rows_vs_direct(srv, model, (jpegs[:3], jpegs[3:]),
                                       lambda b: via_uint8(fit(b)), torch)
    print(f'JPEG f32 served rows (cat.jpg 384 x 480 and 7 synthetic 375 x '
          f'500) vs decode + _fit_uint8 + the uint8 path: {err:.3e} (tol '
          f'{TOL_SERVED_F32:g})', flush=True)
    check(err <= TOL_SERVED_F32, f'JPEG rows off: {err}')
    model.bfloat16()
    for payload, pool in (('uint8', raw), ('jpeg', jpegs)):
        with serving.serve_model(model, max_batch=64, max_wait_ms=2.0,
                                 payload=payload,
                                 preprocess_dtype='bfloat16') as srv:
            srv(pool[0])
            srv.bucket_compiles.clear()
            lat, wall = cli.load_test(
                srv, SERVE_CLIENTS * SERVE_PER_CLIENT, SERVE_CLIENTS,
                lambda i, j: pool[(i + j) % len(pool)])
        out[payload] = report_load(
            f'resnet50 bf16 {payload} payload, {SERVE_CLIENTS} clients x '
            f'{SERVE_PER_CLIENT} single requests', lat, wall, srv)
    out['decoder'] = decoder_name()
    del model, srv
    torch.cuda.empty_cache()

    print(f'\n(c) nonlocalresnet3d50, 400 classes, bf16, every BN '
          f'randomized, uint8 clips {CLIP_DECODE}, max_batch '
          f'{CLIP_MAX_BATCH}', flush=True)
    k1_batches = {}
    g = torch.Generator(device='cuda').manual_seed(3)
    for b in (1, 2, 4, 8):
        for layer, (_, n, nk, c, cv) in (('layer2', SLICE_SHAPES['layer2']),
                                         ('layer3', SLICE_SHAPES['layer3'])):
            q = (torch.randn(b, n, c, device='cuda', generator=g)
                 / c ** 0.25).bfloat16()
            k = (torch.randn(b, nk, c, device='cuda', generator=g)
                 / c ** 0.25).bfloat16()
            v = torch.randn(b, nk, cv, device='cuda',
                            generator=g).bfloat16()
            got, lse = na.nonlocal_attention_cuda(q, k, v)
            want, want_lse = na.nonlocal_attention_fwd_lse_reference(
                q.float(), k.float(), v.float())
            err, err_rel, err_lse = fwd_errors(got, lse, want, want_lse)
            ms = median_ms(lambda: na.nonlocal_attention_cuda(q, k, v))
            bound_ms, bound_by = attention_bounds(b, n, nk, c, cv,
                                                  'bfloat16')['fwd']
            lib_ms, backend = sdpa_ms(torch, q, k, v)
            kernel = na.attention_kernel(torch.bfloat16, c, cv, 'fwd')
            row = {'kernel': kernel, 'ms': ms, 'bound_ms': bound_ms,
                   'max_abs_err': err, 'library_ms': lib_ms,
                   'library': f'scaled_dot_product_attention ({backend})'}
            line = (f'{ms:.3f} ms, scaled_dot_product_attention '
                    f'{fmt_ms(lib_ms)} ({backend}), bound {bound_ms:.4f} ms '
                    f'({bound_by})')
            errs_m = (0.0, 0.0, 0.0)
            if layer == 'layer3':
                out_m, lse_m = na._launch_fwd(q, k, v, 1.0, 'mma_sync')
                errs_m = fwd_errors(out_m, lse_m, want, want_lse)
                del out_m, lse_m
                row['earlier_ms'] = median_ms(lambda: na._launch_fwd(
                    q, k, v, 1.0, 'mma_sync'))
                line += (f', the mma.sync kernel {row["earlier_ms"]:.3f} ms '
                         f'(max|out-plain| {errs_m[0]:.3e}, /max|plain| '
                         f'{errs_m[1]:.3e}, max|lse-plain| {errs_m[2]:.3e})')
            k1_batches[f'{layer} B={b}'] = row
            tol, tol_lse = TOL['bfloat16']
            print(f'K1-fwd {layer} B={b} [{kernel}]: max|out-plain| '
                  f'{err:.3e} (tol {tol:g}), /max|plain| {err_rel:.3e} (tol '
                  f'{TOL_REL_BF16:g}), max|lse-plain| {err_lse:.3e} (tol '
                  f'{tol_lse:g}); {line}', flush=True)
            check(err <= tol and err_rel <= TOL_REL_BF16
                  and err_lse <= tol_lse,
                  f'K1-fwd off its plain version at {layer} B={b}')
            check(errs_m[0] <= tol and errs_m[1] <= TOL_REL_BF16
                  and errs_m[2] <= tol_lse, f'the mma.sync K1-fwd off its '
                  f'plain version at {layer} B={b}')
            del q, k, v, got, lse, want, want_lse
    torch.cuda.empty_cache()
    out['k1_batches'] = k1_batches

    model = pretorched.nonlocalresnet3d50(num_classes=400, pretrained=None)
    randomize_bn(model, torch, seed=6)
    model.bfloat16()
    clips = rng.randint(0, 256, (CLIP_MAX_BATCH,) + CLIP_DECODE
                        ).astype(np.uint8)
    dispatches = [0]
    hook = model.register_forward_pre_hook(
        lambda *_: dispatches.__setitem__(0, dispatches[0] + 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_counts(na, 0)
    with serving.serve_model(model, max_batch=CLIP_MAX_BATCH,
                             max_wait_ms=2.0, payload='uint8',
                             decode_shape=CLIP_DECODE,
                             preprocess_dtype='bfloat16') as srv:
        for b in (1, 2, 4, 8):                  # warm every bucket
            srv(clips[:b])
        warmed = sorted(srv.bucket_compiles)
        srv.bucket_compiles.clear()
        lat, wall = cli.load_test(srv, CLIP_CLIENTS * CLIP_PER_CLIENT,
                                  CLIP_CLIENTS,
                                  lambda i, j: clips[(i + j) % len(clips)])
        served = srv(clips[:4]).float()
    hook.remove()
    launches = counts(na)
    by_kernel = kernel_counts(na)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    out['clips'] = report_load(
        f'nonlocalresnet3d50 bf16 uint8 clips, {CLIP_CLIENTS} clients x '
        f'{CLIP_PER_CLIENT} clips (warmed buckets {warmed})', lat, wall, srv,
        unit='clip')
    out['clips']['peak_gib'] = peak_gb
    print(f'{dispatches[0]} buckets dispatched in all, K1-fwd launches '
          f'{launches[0]} ({by_kernel}); peak device memory {peak_gb:.2f} '
          'GiB', flush=True)
    check(launches[0] == 5 * dispatches[0] and launches[1:] == (0, 0),
          f'expected 5 K1-fwd launches per bucket, got {launches} for '
          f'{dispatches[0]} buckets')
    out['launches_layer3'] = expect_kernels(na, EVAL_KERNELS, dispatches[0],
                                            'video server')[0]
    out['launches'], out['by_kernel'] = launches[0], by_kernel
    check(served.shape == (4, 400) and bool(torch.isfinite(served).all()),
          'served clip logits not finite')

    def plain_logits():
        x = torch.from_numpy(clips[:4]).cuda()
        with torch.inference_mode():
            f = fused_preprocess(x.flatten(0, 1), model.settings or model,
                                 dtype=torch.bfloat16)
            f = f.reshape((4, 32) + f.shape[1:]).permute(0, 4, 1, 2, 3)
            orig = nonlocalnet.auto_nonlocal_attention
            nonlocalnet.auto_nonlocal_attention = \
                na.nonlocal_attention_reference
            try:
                return model(f.contiguous()).float().cpu()
            finally:
                nonlocalnet.auto_nonlocal_attention = orig

    rel = rel_l2(served, plain_logits())
    print(f'served clip logits vs the same bf16 model with the plain '
          f'attention: rel L2 {rel:.3e} (tol {TOL_LOGITS_BF16:g})')
    check(rel <= TOL_LOGITS_BF16, f'served clips off plain attention: {rel}')
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nonlocalnet.NonLocalBlock):
                m.W[1].weight.zero_()
    with serving.serve_model(model, max_batch=CLIP_MAX_BATCH,
                             payload='uint8', decode_shape=CLIP_DECODE,
                             preprocess_dtype='bfloat16') as srv:
        moved = rel_l2(srv(clips[:4]), served)
    print(f'zeroing the 5 W.1 scales moves the served logits by rel L2 '
          f'{moved:.3e}')
    check(moved > 1e-2, 'the served logits do not depend on the attention')
    del model, srv
    torch.cuda.empty_cache()

    print('\n(d) admission on the card', flush=True)
    import threading
    gate = threading.Event()

    def gated(_, batch):
        gate.wait(60)
        return batch.float().sum(dim=(1, 2))

    one = np.ones((4, 4), np.float32)
    srv = serving.InferenceServer(gated, None, device='cuda', max_batch=1,
                                  max_wait_ms=0.0, example_ndim=2,
                                  max_queue=2, request_timeout_ms=100.0)
    first = srv.submit(one)
    time.sleep(0.05)                 # the batcher now waits at the gate
    stale = srv.submit(one)
    try:
        srv.submit(one)
        overloaded = False
    except serving.ServerOverloaded:
        overloaded = True
    time.sleep(0.3)                  # stale passes request_timeout_ms
    gate.set()
    try:
        stale.result(timeout=60)
        expired = False
    except TimeoutError:
        expired = True
    ok = float(first.result(timeout=60)) == 16.0
    fresh = float(srv.submit(one).result(timeout=60)) == 16.0
    srv.close()
    alive = srv._thread.is_alive() or any(r.is_alive()
                                          for r in srv._resolvers)
    print(f'max_queue=2: third request refused with ServerOverloaded: '
          f'{overloaded}; request_timeout_ms=100: the queued request '
          f'expired: {expired}; served rows right: {ok and fresh}; close() '
          f'clean: {not alive}')
    check(overloaded and expired and ok and fresh and not alive,
          'admission semantics failed on the card')

    print('\n(e) the CLIs as subprocesses', flush=True)
    cmds = [[sys.executable, 'examples/serve_torch.py', '--requests', '64',
             '--clients', '8', '--bf16'],
            [sys.executable, 'examples/imagenet_logits_torch.py',
             'data/cat.jpg', '-a', 'resnet50', '--pretrained', 'none']]
    env = dict(os.environ)
    env.pop('PRETORCHED_STRICT_WEIGHTS', None)
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for cmd, proc in zip(cmds, procs):
        try:
            text = proc.communicate(timeout=300)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        print(f"$ {' '.join(cmd[1:])}  (exit {proc.returncode})")
        print('  ' + '\n  '.join(text.strip().splitlines()[-6:]), flush=True)
        check(proc.returncode == 0, f'{cmd[1]} exited {proc.returncode}')
    return out


def kernel_label(line):
    """A readable name for a kernel of ptxas's 'Function properties for'
    line: its template arguments spelled out."""
    m = re.search(r'nonlocal_attention_(?:fwd|bwd_dq|bwd_dkv)_wgmma_kernel',
                  line)
    if m:
        return (f'{m.group(0)} (bf16, wgmma + TMA ring, 2 consumer '
                'warpgroups at 240 registers, 1 producer at 24)')
    m = re.search(r'(nonlocal_attention_(?:fwd|bwd_dq|bwd_dkv)_wide_kernel)'
                  r'ILi(\d)E', line)
    if m:
        return (f'{m.group(1)} (bf16, wgmma + TMA, C, Cv <= 512, {m.group(2)} '
                '64-column chunks a consumer, 2 consumer warpgroups at 240 '
                'registers, 1 producer at 24)')
    m = re.search(r'nonlocal_attention_(?:fwd|bwd)_(?:bf16|f32)_kernel'
                  r'(?:ILi(\d+)ELb([01])E)?', line)
    if m:
        name = m.group(0).split('I')[0]
        if m.group(1):
            rows = 'resident' if m.group(2) == '1' else 'streamed'
            name += f' ({m.group(1)} warps, rows {rows})'
        return name
    shortcut = {'0': 'identity', '1': 'projection'}
    m = re.search(r'fused_bottleneck_tail_kernelI(f|\d+__nv_bfloat16)'
                  r'Li(\d+)ELb([01])E', line)
    if m:
        dtype = 'f32' if m.group(1) == 'f' else 'bf16'
        return (f'fused_bottleneck_tail_kernel ({dtype}, {m.group(2)} conv2 '
                f'channels a pass, {shortcut[m.group(3)]})')
    m = re.search(r'fused_bottleneck_tail_(mma|tma)_kernelILi(\d+)ELb([01])E',
                  line)
    if m:
        how = ('TMA, persistent, ' if m.group(1) == 'tma' else '')
        return (f'fused_bottleneck_tail_{m.group(1)}_kernel (bf16 {how}'
                f'mma.sync, Cm <= {m.group(2)}, {shortcut[m.group(3)]})')
    return line.split()[-1]


def main():
    import numpy as np
    import torch

    phase('1. card')
    check(torch.cuda.is_available(), 'torch.cuda.is_available() is false')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f'nvidia-smi failed: {smi.stderr}')
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)')
    global CARD
    card = CARD = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    sys.path.insert(0, str(REPO))
    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.ops.cuda import build
    from pretorched_tpu_torch.models import slowfast
    from pretorched_tpu_torch.ops import fused_block as fb
    from pretorched_tpu_torch.ops.cuda import fused_block as fb_cuda
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na

    phase('2. build')
    build.load_library()
    print(f'kernel library {build.library_path().relative_to(REPO)}: '
          f'{build.build_seconds:.2f} s')
    for line in build.build_log.splitlines():
        if 'Function properties for' in line:
            print('  ' + kernel_label(line))
        elif 'Used' in line and 'registers' in line or 'spill' in line:
            print('    ' + line.strip())
        elif 'Potential Performance Loss' in line:
            print(f'  ptxas on {kernel_label(line)}: '
                  + line.split('Potential Performance Loss: ')[1]
                  .split(' in the function')[0])

    phase('3. non-local attention forward kernel vs plain PyTorch')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print('TF32 off (torch.backends.cuda.matmul.allow_tf32 = '
          'torch.backends.cudnn.allow_tf32 = False); bf16 rows compare the '
          'bf16 kernel with the plain version in f32 on the same bf16 '
          'inputs; times are CUDA-event medians of 20', flush=True)
    k1 = kernel_vs_plain(na, torch)

    phase('4. eval path: nonlocalresnet3d50, 10 clips x 32 frames x 224 px')
    eval_launches, eval_by_kernel, eval_layer3, cli = main_path(
        pretorched, na, torch, np)

    phase('5. non-local attention backward kernels vs plain PyTorch')
    k1b = backward_vs_plain(na, torch)

    phase(f'6. training path: nonlocalresnet3d50, {TRAIN_STEPS} steps of '
          f'{TRAIN_CLIPS} clips x 32 frames x 224 px')
    train_launches, train_by_kernel, train_layer3 = train_path(
        pretorched, na, torch, np, cli)

    phase('7. gradient agreement: f32 step with the kernels, with the plain '
          'attention, and in f64')
    gradient_agreement(pretorched, na, torch, cli)

    phase('8. fused bottleneck tail kernel (K2) vs plain PyTorch')
    k2 = k2_vs_plain(torch, fb, fb_cuda, slowfast)

    phase(f'9. eval path: slowfast_resnet50, fused_blocks=32, {SF_CLIPS} '
          f'clips x {SF_FRAMES} frames x 224 px')
    k2_launches, k2_by_kernel = slowfast_path(pretorched, torch, np, cli, na,
                                              fb_cuda)

    phase('10. serving: resnet50 images and nonlocalresnet3d50 clips '
          'through serving.serve_model')
    served = serving_path(pretorched, na, torch, np)

    phase('11. result')
    src = 'pretorched_tpu_torch/csrc/'
    forward = {k: sum(k2[s][k] * n for s, n in K2_SLICE.items())
               for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms')}
    # the mma.sync kernel at every slice shape (res4 runs it already)
    forward['earlier_ms'] = sum((k2[s]['earlier_ms'] or k2[s]['ms']) * n
                                for s, n in K2_SLICE.items())
    pallas = 'pretorched_tpu/ops/pallas/nonlocal_attention.py:'
    fwd_by_kernel = {
        'train': {k[4:]: n for k, n in train_by_kernel.items()
                  if k.startswith('fwd')},
        'eval': {k[4:]: n for k, n in eval_by_kernel.items()},
        'serving': {k[4:]: n for k, n in served['by_kernel'].items()}}
    dkv_by_kernel = {k[4:]: n for k, n in train_by_kernel.items()
                     if k.startswith('dkv')}
    # the layer-3 entries: the wide wgmma programs, launched 3 times a pass
    # ('launches': the train run's, as for the other entries; the wrapper's
    # launches by program stand in its layer-2 entry)
    layer3 = (' at layer 3: the wide wgmma program (wgmma_wide in the '
              'launches_by_kernel of the wrapper\'s entry)')
    print(json.dumps({'kernels': [
        {'name': 'nonlocal_attention_fwd', 'route': 'cuda',
         'source': src + 'nonlocal_attention_fwd.cu', 'replaces': pallas + '33',
         'launches': train_launches[0], 'launches_eval': eval_launches,
         'launches_serving': served['launches'],
         'launches_by_kernel': fwd_by_kernel,
         'serving_batches': served['k1_batches'],
         **k1['layer2'], 'shape': list(SLICE_SHAPES['layer2']),
         'dtype': 'bfloat16'},
        {'name': 'nonlocal_attention_fwd_wide', 'route': 'cuda',
         'source': src + 'nonlocal_attention_fwd.cu', 'replaces': pallas + '33',
         'note': 'K1-fwd' + layer3,
         'launches': train_layer3[0], 'launches_eval': eval_layer3,
         'launches_serving': served['launches_layer3'],
         'serving_batches': {k: v for k, v in served['k1_batches'].items()
                             if k.startswith('layer3')},
         **k1['layer3'], 'shape': list(SLICE_SHAPES['layer3']),
         'dtype': 'bfloat16'},
        {'name': 'nonlocal_attention_bwd_dq', 'route': 'cuda',
         'source': src + 'nonlocal_attention_bwd.cu', 'replaces': pallas + '141',
         'launches': train_launches[1], **k1b['layer2']['dq'],
         'launches_by_kernel': {k[3:]: n for k, n in train_by_kernel.items()
                                if k.startswith('dq')},
         'shape': list(TRAIN_SHAPES['layer2']), 'dtype': 'bfloat16'},
        {'name': 'nonlocal_attention_bwd_dq_wide', 'route': 'cuda',
         'source': src + 'nonlocal_attention_bwd.cu', 'replaces': pallas + '141',
         'note': 'K1-dq' + layer3,
         'launches': train_layer3[1], **k1b['layer3']['dq'],
         'shape': list(TRAIN_SHAPES['layer3']), 'dtype': 'bfloat16'},
        {'name': 'nonlocal_attention_bwd_dkv', 'route': 'cuda',
         'source': src + 'nonlocal_attention_bwd.cu', 'replaces': pallas + '172',
         'launches': train_launches[2], **k1b['layer2']['dkv'],
         'launches_by_kernel': dkv_by_kernel,
         'shape': list(TRAIN_SHAPES['layer2']), 'dtype': 'bfloat16'},
        {'name': 'nonlocal_attention_bwd_dkv_wide', 'route': 'cuda',
         'source': src + 'nonlocal_attention_bwd.cu', 'replaces': pallas + '172',
         'note': 'K1-dkv' + layer3,
         'launches': train_layer3[2], **k1b['layer3']['dkv'],
         'shape': list(TRAIN_SHAPES['layer3']), 'dtype': 'bfloat16'},
        {'name': 'fused_bottleneck_tail', 'route': 'cuda',
         'source': src + 'fused_block.cu',
         'replaces': 'pretorched_tpu/ops/pallas/fused_block.py:69',
         'launches': k2_launches, 'launches_by_kernel': k2_by_kernel,
         **k2['fast res2.1-2'], 'earlier': 'mma.sync kernel, same run',
         'plain': 'fused_bottleneck_tail_reference',
         'library': 'the unfused tail: cuDNN conv2, BN, ReLU, cuDNN conv3, '
                    'BN, add, ReLU (several calls; no one PyTorch call '
                    'computes the function)',
         'shape': list(K2_SHAPES['fast res2.1-2'][:7]), 'dtype': 'bfloat16',
         'per_forward': {**forward, 'launches': sum(K2_SLICE.values()),
                         'shapes': list(K2_SLICE)}}],
        'serving': {k: served[k] for k in ('tensor', 'tensor_64_clients',
                                           'uint8', 'jpeg', 'clips',
                                           'bucket_forward_ms', 'bucket8',
                                           'decoder')},
        'card': card}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        main()
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
