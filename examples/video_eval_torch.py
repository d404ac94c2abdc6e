#!/usr/bin/env python
"""Multi-clip video evaluation CLI on the PyTorch port (Kinetics/Moments-style).

The same protocol and meter lines as ``examples/video_eval.py``, on one CUDA
device. Expects the common frame-folder layout:

    root/<class_name>/<video_id>/{frame_00001.jpg, ...}

Each video is sampled as ``--clips`` clips of ``--frames`` frames (uniform
temporal stride), decoded with the native JPEG decoder, preprocessed on the
device in bf16, run through the model in bf16 and scored by softmax
consensus over clips. ``--frames native`` takes each video's own length
(capped by ``--max-frames``), re-sampled up to a multiple of
``--frame-multiple`` (``utils.bucketing``); each such temporal bucket
gathers its own batch of ``--batch-size`` videos, and what is left of each
bucket runs at the end, in bucket order. Launched as several processes
(torchrun), every process loads each batch and runs its share of the
videos on its own card, and the metric sums are added over the processes.

Usage:
    python examples/video_eval_torch.py /data/kinetics/val \
        -a nonlocalresnet3d50 --pretrained kinetics-400 --frames 32 --clips 10
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Multi-clip video eval (PyTorch)')
    p.add_argument('data', help='root with class/video/frame.jpg layout')
    p.add_argument('--arch', '-a', default='resnet3d50')
    p.add_argument('--pretrained', default='kinetics-400')
    p.add_argument('--num-classes', default=400, type=int)
    p.add_argument('--frames', default='16',
                   help="frames per clip (int), or 'native': each video's "
                        'own length (capped by --max-frames), bucketed up '
                        'to a multiple of --frame-multiple')
    p.add_argument('--max-frames', default=64, type=int,
                   help='native-mode cap on frames per clip')
    p.add_argument('--frame-multiple', default=8, type=int,
                   help='native-mode temporal bucket size')
    p.add_argument('--clips', default=10, type=int)
    p.add_argument('--batch-size', '-b', default=4, type=int,
                   help='videos per step (x clips = clip batch)')
    p.add_argument('--size', default=224, type=int)
    p.add_argument('--workers', '-j', default=8, type=int)
    p.add_argument('--print-freq', default=10, type=int)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default), 'cuda:N' or 'cpu'")
    return p.parse_args(argv)


def list_videos(root):
    classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
    class_to_idx = {c: i for i, c in enumerate(classes)}
    videos = []
    for c in classes:
        cdir = os.path.join(root, c)
        for v in sorted(os.scandir(cdir), key=lambda d: d.name):
            if v.is_dir():
                frames = sorted(
                    os.path.join(v.path, f) for f in os.listdir(v.path)
                    if f.lower().endswith(('.jpg', '.jpeg', '.png')))
                if frames:
                    videos.append((frames, class_to_idx[c]))
    return videos, classes


def sample_clips(frames, num_clips, clip_len):
    """Uniformly-spaced clip starts, frames within a clip are consecutive
    (looped when the video is short)."""
    n = len(frames)
    starts = np.linspace(0, max(n - clip_len, 0), num_clips).astype(int)
    return [[frames[min(s + t, n - 1)] for t in range(clip_len)]
            for s in starts]


def load_video(frames, num_clips, clip_len, settings, device, workers=8,
               dtype=torch.bfloat16):
    """Decode one video's clips and preprocess them on ``device``:
    (num_clips, 3, clip_len, S, S) in ``dtype``."""
    from pretorched_tpu_torch.datasets.native import decode_jpeg_files
    from pretorched_tpu_torch.transforms.fused import preprocess_clip

    flat = [p for clip in sample_clips(frames, num_clips, clip_len)
            for p in clip]
    arrays = decode_jpeg_files(flat, threads=workers)
    return torch.cat([
        preprocess_clip(np.stack(arrays[c * clip_len:(c + 1) * clip_len]),
                        settings, channels_last=False, dtype=dtype,
                        device=device)
        for c in range(num_clips)])


def eval_batches(videos, args, settings, device):
    """(clips (B, N_clips, 3, T, S, S), labels) on ``device``, in the CLI's
    order: with a fixed ``--frames``, ``--batch-size`` videos at a time
    and the rest at the end; with ``--frames native``, one accumulator per
    temporal bucket, each run when it holds ``--batch-size`` videos, then
    what is left of each bucket in bucket order (as
    ``examples/video_eval.py`` flushes them)."""
    from pretorched_tpu_torch.utils.bucketing import \
        resample_frames_to_bucket

    native = args.frames == 'native'
    buckets = {}        # frames a clip -> (clips list, labels list)
    for frames, label in videos:
        clip_len = (min(len(frames), args.max_frames) if native
                    else int(args.frames))
        video = load_video(frames, args.clips, clip_len, settings, device,
                           args.workers)
        if native:
            video = resample_frames_to_bucket(video, args.frame_multiple,
                                              time_axis=2)
        clips, labels = buckets.setdefault(video.shape[2], ([], []))
        clips.append(video)
        labels.append(label)
        if len(clips) == args.batch_size:
            yield torch.stack(clips), torch.as_tensor(labels, device=device)
            del buckets[video.shape[2]]
    for tb in sorted(buckets):
        clips, labels = buckets[tb]
        yield torch.stack(clips), torch.as_tensor(labels, device=device)


def main(argv=None):
    """Runs the eval; returns a summary dict (videos, steps, clips, the
    eval loop's seconds and the metric totals). A process group the run
    starts (several processes) ends with it."""
    args = parse_args(argv)
    owned = not torch.distributed.is_initialized()
    try:
        return _run(args)
    finally:
        if owned and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _run(args):
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass --device cpu to run '
                           'on the CPU')

    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.datasets.native import decoder_name
    from pretorched_tpu_torch.parallel import dist, mesh as meshes
    from pretorched_tpu_torch.parallel.evaluate import (multi_clip_eval_step,
                                                        pad_batch)
    from pretorched_tpu_torch.utils import AverageMeter, DeviceRunningSums

    pretrained = None if args.pretrained in ('none', '') else args.pretrained
    print(f"=> creating '{args.arch}' (pretrained={pretrained})")
    model = pretorched.__dict__[args.arch](
        num_classes=args.num_classes, pretrained=pretrained)
    model.to(device).eval().bfloat16()
    settings = (model.settings or
                {'input_space': 'RGB', 'input_size': [3, args.size, args.size],
                 'input_range': [0, 1], 'mean': [0.485, 0.456, 0.406],
                 'std': [0.229, 0.224, 0.225]})

    # several processes (torchrun): every one loads each batch and runs its
    # share of the videos, as the JAX CLI shards the clips over 'data'
    if not torch.distributed.is_initialized():
        dist.initialize(backend='nccl' if device.type == 'cuda' else 'gloo')
    mesh = None
    if torch.distributed.is_initialized():
        mesh = meshes.make_mesh(device_type=device.type)
        meshes.place_model(model, mesh)
        if device.type == 'cuda':
            device = torch.device('cuda', torch.cuda.current_device())
    n_data = meshes.data_size(mesh)
    step = multi_clip_eval_step(model, mesh=mesh)
    videos, classes = list_videos(args.data)
    print(f'=> {len(videos)} videos, {len(classes)} classes, '
          f'{args.clips}x{args.frames}f clips, device {device}, '
          f'JPEG decoder {decoder_name()}')

    batch_time = AverageMeter()
    t_start = t_last = time.time()
    batch_idx = 0
    # per-batch metric sums stay ON THE DEVICE between prints: a host copy
    # per step would make the host wait for every step to finish
    meters = DeviceRunningSums()
    n_batches = -(-len(videos) // args.batch_size)

    buckets = {}        # frames a clip -> videos
    for clips, labels in eval_batches(videos, args, settings, device):
        if mesh is not None:
            rows, labels = pad_batch(clips, labels.cpu().numpy(), n_data)
            meters.update(step(meshes.global_batch(mesh, rows),
                               meshes.global_batch(mesh, labels)))
        else:
            meters.update(step(clips, labels))
        buckets[clips.shape[3]] = buckets.get(clips.shape[3], 0) + len(labels)
        batch_time.update(time.time() - t_last)
        t_last = time.time()
        if batch_idx % args.print_freq == 0:
            o, s = meters.snapshot()
            n, nt = max(o['count'], 1), max(s['count'], 1)
            # same meter-line format as the reference validate()
            # (imagenet_eval.py:241-251)
            print(f'Test: [{batch_idx}/{n_batches}]\t'
                  f'Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t'
                  f"Loss {o['loss'] / n:.4f} ({s['loss'] / nt:.4f})\t"
                  f"Acc@1 {100 * o['top1'] / n:.3f} "
                  f"({100 * s['top1'] / nt:.3f})\t"
                  f"Acc@5 {100 * o['top5'] / n:.3f} "
                  f"({100 * s['top5'] / nt:.3f})")
        batch_idx += 1
    if not meters:                             # no videos found
        print(' * Acc@1 0.000 Acc@5 0.000')
        return {'videos': 0, 'steps': 0, 'clips': 0,
                'seconds': time.time() - t_start, 'totals': {}}
    s = meters.totals()
    seconds = time.time() - t_start
    nt = max(s['count'], 1)
    print(f" * Acc@1 {100.0 * s['top1'] / nt:.3f} "
          f"Acc@5 {100.0 * s['top5'] / nt:.3f}")
    return {'videos': len(videos), 'steps': batch_idx,
            'clips': len(videos) * args.clips, 'seconds': seconds,
            'totals': s, 'buckets': buckets}


if __name__ == '__main__':
    main()
