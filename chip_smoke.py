#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``pretorched_tpu_torch``).

Drives the port's main path once on one CUDA card and checks it:

1. the card: its name and power limit (``nvidia-smi``);
2. the build of the CUDA kernels from ``pretorched_tpu_torch/csrc``;
3. the non-local attention forward kernel against its plain PyTorch version
   at the video slice's shapes, in f32 (TF32 off) and bf16, with both times;
4. the main path: a fabricated hosted ``kinetics-400`` checkpoint for
   ``nonlocalresnet3d50`` (seeded init, every BN randomized, non-local
   weights included), a frame folder of JPEGs, and the 10-clip, 32-frame,
   224 px eval of ``examples/video_eval_torch.py``. It checks that every
   forward launched the kernel 5 times, that the logits are finite, that the
   f32 logits with the kernel match those with the plain attention, and that
   the attention moves the logits;
5. a last line ``{"ok": true, "device": {...}}``.

Usage: ``python3 chip_smoke.py`` from the repository root. It exits nonzero,
with no result line, when a phase fails or no CUDA card is present.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
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


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(title):
    print(f'\n== {title}', flush=True)


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


def kernel_vs_plain(na, torch):
    """Phase 3: every case in both dtypes; returns the layer-2 bf16 row."""
    g = torch.Generator(device='cuda').manual_seed(0)
    result = None
    for name, (b, n, nk, c, cv) in SLICE_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split('.')[-1]
            # q, k ~ N(0,1)/C^(1/4): logits of unit scale, softmax not one-hot
            q = (torch.randn(b, n, c, device='cuda', generator=g)
                 / c ** 0.25).to(dt)
            k = (torch.randn(b, nk, c, device='cuda', generator=g)
                 / c ** 0.25).to(dt)
            v = torch.randn(b, nk, cv, device='cuda', generator=g).to(dt)
            out, lse = na.nonlocal_attention_cuda(q, k, v)
            torch.cuda.synchronize()
            want, want_lse = na.nonlocal_attention_fwd_lse_reference(
                q.float(), k.float(), v.float())
            err = (out.float() - want).abs().max().item()
            err_lse = (lse - want_lse).abs().max().item()
            tol, tol_lse = TOL[dname]
            line = (f'{name:10s} {dname:8s} B={b} N={n} Nk={nk} C={c} '
                    f'Cv={cv}: max|out-plain|={err:.3e} (tol {tol:g}) '
                    f'max|lse-plain|={err_lse:.3e} (tol {tol_lse:g})')
            del want, want_lse
            if name in ('layer2', 'layer3'):
                ms = median_ms(lambda: na.nonlocal_attention_cuda(q, k, v))
                plain_ms = median_ms(
                    lambda: na.nonlocal_attention_fwd_lse_reference(q, k, v))
                line += f' kernel {ms:.3f} ms, plain {plain_ms:.3f} ms'
                if name == 'layer2' and dt == torch.bfloat16:
                    result = {'max_abs_err': err, 'ms': ms,
                              'plain_ms': plain_ms}
            print(line, flush=True)
            check(err <= tol and err_lse <= tol_lse,
                  f'kernel disagrees with the plain version: {line}')
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
    """Phase 4; returns the kernel's launch count in the eval run."""
    from pretorched_tpu_torch.datasets.native import decoder_name
    from pretorched_tpu_torch.models import nonlocalnet

    spec = importlib.util.spec_from_file_location(
        'video_eval_torch', REPO / 'examples' / 'video_eval_torch.py')
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)

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
    na.nonlocal_attention_cuda.launches = 0
    summary = cli.main(argv)
    launches = na.nonlocal_attention_cuda.launches
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
        check(logits_bf16.shape == (20, 400)
              and bool(torch.isfinite(logits_bf16).all()),
              'bf16 logits not finite')
        model.float()
        logits_k = model(batch)
        orig = nonlocalnet.auto_nonlocal_attention
        nonlocalnet.auto_nonlocal_attention = na.nonlocal_attention_reference
        try:
            logits_p = model(batch)
        finally:
            nonlocalnet.auto_nonlocal_attention = orig
        rel = ((logits_k - logits_p).norm() / logits_p.norm()).item()
        rel_bf16 = ((logits_bf16 - logits_p).norm() / logits_p.norm()).item()
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
    return launches


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
    print(smi.stdout.strip().splitlines()[0], flush=True)

    sys.path.insert(0, str(REPO))
    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.ops.cuda import build
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na

    phase('2. build')
    build.load_library()
    print(f'kernel library {build.library_path().relative_to(REPO)}: '
          f'{build.build_seconds:.2f} s')
    for line in build.build_log.splitlines():
        if 'registers' in line or 'spill' in line:
            print('  ' + line.strip())

    phase('3. non-local attention forward kernel vs plain PyTorch')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print('TF32 off (torch.backends.cuda.matmul.allow_tf32 = '
          'torch.backends.cudnn.allow_tf32 = False); bf16 rows compare the '
          'bf16 kernel with the plain version in f32 on the same bf16 '
          'inputs; times are CUDA-event medians of 20', flush=True)
    k1 = kernel_vs_plain(na, torch)

    phase('4. main path: nonlocalresnet3d50, 10 clips x 32 frames x 224 px')
    launches = main_path(pretorched, na, torch, np)

    phase('5. result')
    print(json.dumps({'kernels': [{
        'name': 'nonlocal_attention_fwd', 'route': 'cuda',
        'source': 'pretorched_tpu_torch/csrc/nonlocal_attention_fwd.cu',
        'replaces': 'pretorched_tpu/ops/pallas/nonlocal_attention.py:33',
        'launches': launches, 'max_abs_err': k1['max_abs_err'],
        'ms': k1['ms'], 'plain_ms': k1['plain_ms'],
        'shape': list(SLICE_SHAPES['layer2']), 'dtype': 'bfloat16'}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        main()
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
