#!/usr/bin/env python
"""ImageNet train/evaluate CLI on the PyTorch port.

The same argparse surface and the same ``Test: [...]`` / ``Epoch: [...]``
/ `` * Acc@1 ... Acc@5 ...`` lines as ``examples/imagenet_eval.py`` (the
reference's examples/imagenet_eval.py:200-251), on one CUDA device:

* ``-e``: evaluate ``DATA/val`` (one center crop, or ``--ten-crop``: the 4
  corners and the center, each mirrored, softmax-averaged);
* ``--fast-pipeline``: threaded JPEG decode at a reduced DCT scale and the
  resize, crop and normalize on the device (``datasets.folder.
  fast_eval_batches``); otherwise the PIL transform of the model's
  metadata on ``--workers`` threads;
* ``--bf16``: the model computes in bf16 (parameters stay f32), and the
  fast pipeline preprocesses in bf16;
* without ``-e``: train on ``DATA/train`` (random crop and flip, SGD with
  momentum and the reference's 0.1x every 30 epochs), validate after each
  epoch, write ``checkpoint.pth`` (model and optimizer state) with
  ``checkpoint.pth.meta`` (``epoch``, ``arch``, ``best_prec1``) and copy it
  to ``model_best.pth`` when it is the best so far; ``--resume`` restores
  them. SIGTERM checkpoints mid-epoch and exits;
* ``--zero``: the optimizer state ZeRO-sharded over the 'data' axis of a
  mesh of every process (``--zero fsdp``: the parameters too), each
  process on its own card.

Several processes (``torchrun --nproc-per-node N``, or ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` set) join one mesh through
``parallel.dist.initialize``: each trains on its own shard of the train
set (``-b`` is the batch of one process) with batch norm over the batch of
every process and the gradients averaged; validation splits every batch
over the processes and sums the metrics; only rank 0 writes checkpoints.

Dropout draws from torch's global generator, which the train mode seeds
once (``torch.manual_seed(0)``): torch's dropout takes no generator.

Usage:
    python examples/imagenet_eval_torch.py /path/to/imagenet \
        -a se_resnext101_32x4d -b 256 -e --bf16
"""

import argparse
import ast
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import torch  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='ImageNet training/eval (PyTorch)')
    p.add_argument('data', help='path to dataset (train/ and val/ subdirs)')
    p.add_argument('--arch', '-a', default='resnet18')
    p.add_argument('--workers', '-j', default=8, type=int)
    p.add_argument('--epochs', default=90, type=int)
    p.add_argument('--start-epoch', default=0, type=int)
    p.add_argument('-b', '--batch-size', default=256, type=int)
    p.add_argument('--lr', '--learning-rate', default=0.1, type=float)
    p.add_argument('--momentum', default=0.9, type=float)
    p.add_argument('--weight-decay', '--wd', default=1e-4, type=float)
    p.add_argument('--print-freq', '-p', default=10, type=int)
    p.add_argument('--resume', default='', type=str)
    p.add_argument('-e', '--evaluate', action='store_true')
    p.add_argument('--pretrained', default='imagenet',
                   help="pretrained dataset tag or 'none'")
    p.add_argument('--scale', default=None, type=float,
                   help='resize scale; default: model metadata, else 0.875')
    p.add_argument('--fast-pipeline', action='store_true',
                   help='threaded JPEG decode + preprocessing on the device')
    p.add_argument('--bf16', action='store_true',
                   help='bf16 compute (params stay f32) + bf16 fast pipeline')
    p.add_argument('--ten-crop', action='store_true',
                   help='10-crop eval: 4 corners + center, each hflipped, '
                        'softmax-averaged (README.md:198-199 style)')
    p.add_argument('--no-preserve-aspect-ratio', action='store_true',
                   help='square resize before crop (polynet eval, README.md:276)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default), 'cuda:N' or 'cpu'")
    p.add_argument('--remat', action='store_true',
                   help='recompute each residual block (or the whole '
                        'forward) in the backward: less activation memory')
    p.add_argument('--accum-steps', default=1, type=int,
                   help='gradient accumulation over N microbatches a step')
    p.add_argument('--zero', nargs='?', const='1', default=None,
                   choices=['1', 'fsdp'],
                   help='ZeRO-shard the optimizer state over the data axis '
                        '(--zero fsdp also shards the params); per-process '
                        'optimizer memory drops to 1/n_processes')
    return p.parse_args(argv)


def read_meta(path):
    """The ``.meta`` beside a checkpoint: {'epoch', 'arch', 'best_prec1'}."""
    with open(path) as f:
        return ast.literal_eval(f.read())


def save_checkpoint(state, arch, epoch, best_prec1, is_best,
                    filename='checkpoint.pth'):
    """``state`` to ``filename``, its ``.meta`` beside it, and a copy to
    ``model_best.pth`` when ``is_best`` (reference: imagenet_eval.py:256-259).
    A ``state`` of None (a process other than rank 0) writes nothing."""
    from pretorched_tpu_torch.zoo.checkpoint import \
        save_checkpoint as save_state
    if state is None:
        return
    save_state(filename, state, is_best=is_best)
    with open(filename + '.meta', 'w') as f:
        f.write(repr({'epoch': epoch, 'arch': arch, 'best_prec1': best_prec1}))


def main(argv=None):
    """Runs the CLI; returns a summary dict: the last validation's metric
    totals and time, the train steps taken, the epochs and best_prec1. A
    process group the run starts (several processes, or a mesh of its
    own) ends with it."""
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
    from pretorched_tpu_torch.datasets.folder import (ImageFolder,
                                                      batch_iterator,
                                                      fast_eval_batches)
    from pretorched_tpu_torch.parallel import dist, mesh as meshes
    from pretorched_tpu_torch.parallel.evaluate import (make_eval_step,
                                                        multi_clip_eval_step,
                                                        pad_batch)
    from pretorched_tpu_torch.transforms import TransformImage
    from pretorched_tpu_torch.transforms.fused import ten_crop
    from pretorched_tpu_torch.utils import (AverageMeter, DeviceRunningSums,
                                            PreemptionGuard)
    from pretorched_tpu_torch.zoo.checkpoint import load_checkpoint

    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if not torch.distributed.is_initialized():
        dist.initialize(backend=backend)
    if device.type == 'cuda' and torch.distributed.is_initialized():
        device = torch.device('cuda', torch.cuda.current_device())
    # a mesh of every process, when there are several or --zero asks
    mesh = (meshes.make_mesh(device_type=device.type)
            if torch.distributed.is_initialized() or args.zero else None)
    rank, nproc = meshes.batch_sharding(mesh)

    pretrained = None if args.pretrained in ('none', 'None', '') else args.pretrained
    print(f"=> creating model '{args.arch}' (pretrained={pretrained})")
    model = pretorched.__dict__[args.arch](
        num_classes=1000, pretrained=pretrained)
    model.to(device).eval()
    if args.bf16:
        model.bfloat16()

    # the loaded dataset's settings, else the factory's default dataset's
    # (dpn68b has only 'imagenet+5k'; vggm is not in pretrained_settings)
    settings = model.metadata
    # explicit --scale wins; otherwise the model's own metadata, else 0.875
    scale = (args.scale if args.scale is not None
             else settings.get('scale', 0.875))
    print(f'=> device {device}' + ('' if mesh is None else
                                   f', mesh {mesh.shape} process {rank}'))

    best_prec1 = 0.0
    opt_state = None
    if args.resume and os.path.isfile(args.resume):
        print(f"=> loading checkpoint '{args.resume}'")
        state = load_checkpoint(args.resume)
        model.load_state_dict(state['model'])
        opt_state = state.get('optimizer')
        # the reference resumes epoch and best_prec1 too
        # (imagenet_eval.py:78-88)
        meta_path = args.resume + '.meta'
        if os.path.isfile(meta_path):
            meta = read_meta(meta_path)
            if not args.start_epoch:
                args.start_epoch = int(meta.get('epoch', -1)) + 1
            best_prec1 = float(meta.get('best_prec1', 0.0))
            print(f"=> resumed epoch {args.start_epoch} "
                  f"(best_prec1 {best_prec1:.3f})")

    if args.fast_pipeline and args.ten_crop:
        raise SystemExit('--ten-crop needs uncropped resized frames; the '
                         'fast pipeline emits center-cropped batches — use '
                         'one or the other')
    if args.fast_pipeline and args.no_preserve_aspect_ratio:
        print('warning: --no-preserve-aspect-ratio is ignored by '
              '--fast-pipeline (fused path resizes short-side)')

    # 10-crop: square resize only (the 10 crops are taken on the device)
    val_tf = TransformImage(
        settings, scale=scale, crop=not args.ten_crop,
        preserve_aspect_ratio=(not args.no_preserve_aspect_ratio
                               and not args.ten_crop))
    valdir = os.path.join(args.data, 'val')
    val_set = ImageFolder(valdir, transform=val_tf)
    print(f'=> {len(val_set)} val images')

    if mesh is not None:
        meshes.place_model(model, mesh)
    if args.ten_crop:
        crop_size = max(settings['input_size'])
        crop_step = multi_clip_eval_step(model, mesh=mesh)

        def eval_step(x, labels):
            return crop_step(ten_crop(x, crop_size, channels_last=False),
                             labels)
    else:
        eval_step = make_eval_step(model, mesh=mesh)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    def val_batches():
        if args.fast_pipeline:
            yield from fast_eval_batches(
                valdir, settings, args.batch_size, num_threads=args.workers,
                channels_last=False, dtype=dtype, device=device)
        else:
            for images, labels in batch_iterator(
                    val_set, args.batch_size, num_workers=args.workers):
                yield torch.from_numpy(images).to(device, dtype), labels

    def validate():
        model.eval()
        batch_time = AverageMeter()
        t_start = end = time.time()
        # per-batch metric sums stay ON THE DEVICE between prints; the step
        # returns masked sums and a count, so the totals are exact
        meters = DeviceRunningSums()
        for i, (x, labels) in enumerate(val_batches()):
            # every process holds the batch: each runs its rows of it,
            # padded to the process count (label -1 rows are masked)
            x, labels = pad_batch(x, labels, nproc)
            labels = torch.as_tensor(meshes.global_batch(mesh, labels),
                                     device=device)
            meters.update(eval_step(meshes.global_batch(mesh, x), labels))
            batch_time.update(time.time() - end)
            end = time.time()
            if i % args.print_freq == 0:
                o, s = meters.snapshot()
                n, nt = max(o['count'], 1), max(s['count'], 1)
                print(f'Test: [{i}]\t'
                      f'Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t'
                      f"Loss {o['loss'] / n:.4f} ({s['loss'] / nt:.4f})\t"
                      f"Acc@1 {100 * o['top1'] / n:.3f} "
                      f"({100 * s['top1'] / nt:.3f})\t"
                      f"Acc@5 {100 * o['top5'] / n:.3f} "
                      f"({100 * s['top5'] / nt:.3f})")
        if not meters:                         # empty val dir
            print(' * Acc@1 0.000 Acc@5 0.000')
            return 0.0, {}, time.time() - t_start
        s = meters.totals()
        seconds = time.time() - t_start
        nt = max(s['count'], 1)
        top1_avg = 100.0 * s['top1'] / nt
        print(f" * Acc@1 {top1_avg:.3f} Acc@5 {100.0 * s['top5'] / nt:.3f}")
        return top1_avg, s, seconds

    summary = {'train_steps': 0, 'epochs': 0, 'best_prec1': best_prec1}
    if args.evaluate:
        prec1, totals, seconds = validate()
        summary.update(prec1=prec1, totals=totals, seconds=seconds)
        return summary

    # ------------------------------------------------------------- training
    from pretorched_tpu_torch.parallel.train import (make_train_step,
                                                     sgd_step_decay,
                                                     step_decay)
    from pretorched_tpu_torch.parallel.zero import (full_state_dicts,
                                                    load_optimizer_state,
                                                    zero_init)

    traindir = os.path.join(args.data, 'train')
    train_tf = TransformImage(settings, scale=scale, random_crop=True,
                              random_hflip=True)
    train_set = ImageFolder(traindir, transform=train_tf)
    # per-process steps: each process loads its 1/nproc of the train set
    steps_per_epoch = max(len(train_set) // (args.batch_size * nproc), 1)
    step_idx = args.start_epoch * steps_per_epoch
    if args.zero:
        model, optimizer = zero_init(
            model, torch.optim.SGD, mesh, shard_params=args.zero == 'fsdp',
            lr=args.lr, momentum=args.momentum,
            weight_decay=args.weight_decay)
        scheduler = step_decay(optimizer, 30, steps_per_epoch, step_idx)
    else:
        optimizer, scheduler = sgd_step_decay(
            model.parameters(), args.lr, args.momentum, args.weight_decay,
            decay_epochs=30, steps_per_epoch=steps_per_epoch,
            start_step=step_idx)
    if opt_state is not None:
        load_optimizer_state(model, optimizer, opt_state)
    train_step = make_train_step(model, optimizer, scheduler,
                                 accum_steps=args.accum_steps,
                                 remat=args.remat, mesh=mesh,
                                 zero_axis='data' if args.zero else None,
                                 zero_params=args.zero == 'fsdp')
    torch.manual_seed(0)

    def state():
        """The checkpoint's dict on rank 0 (None elsewhere); every
        process must call it (a sharded state is gathered)."""
        model_sd, opt_sd = full_state_dicts(model, optimizer)
        if torch.distributed.is_initialized() and \
                torch.distributed.get_rank() != 0:
            return None
        return {'model': model_sd, 'optimizer': opt_sd}

    # preemption: SIGTERM latches a flag; the step loop checkpoints
    # mid-epoch and exits cleanly (utils/preemption.py)
    with PreemptionGuard() as guard:
        for epoch in range(args.start_epoch, args.epochs):
            batch_time = AverageMeter()
            end = time.time()
            # per-step metrics accumulate on the device between prints;
            # drop_last makes the batches equal, so the mean of the step
            # means is the epoch mean
            meters = DeviceRunningSums()
            for i, (images, labels) in enumerate(batch_iterator(
                    train_set, args.batch_size, shuffle=True, drop_last=True,
                    num_workers=args.workers, seed=epoch, shard_id=rank,
                    num_shards=nproc)):
                x = torch.from_numpy(images).to(device)
                lab = torch.from_numpy(labels).to(device)
                meters.update(train_step(x, lab))
                step_idx += 1
                summary['train_steps'] += 1
                batch_time.update(time.time() - end)
                end = time.time()
                if i % args.print_freq == 0:
                    m, s = meters.snapshot()
                    print(f'Epoch: [{epoch}][{i}]\t'
                          f'Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t'
                          f"Loss {m['loss']:.4f} ({s['loss'] / (i + 1):.4f})\t"
                          f"Acc@1 {100 * m['top1']:.3f} "
                          f"({100 * s['top1'] / (i + 1):.3f})")
                if guard.requested:
                    # epoch - 1, so --resume restarts THIS epoch (the
                    # per-epoch shuffle replays it identically)
                    save_checkpoint(state(), args.arch, epoch - 1,
                                    best_prec1, is_best=False)
                    print(f'=> preemption signal: checkpointed at epoch '
                          f'{epoch} step {i}; --resume restarts epoch {epoch}')
                    return summary
            if meters:
                summary['last_train'] = meters.totals()
            prec1, totals, seconds = validate()
            is_best = prec1 > best_prec1
            best_prec1 = max(prec1, best_prec1)
            save_checkpoint(state(), args.arch, epoch, best_prec1, is_best)
            summary.update(prec1=prec1, totals=totals, seconds=seconds,
                           epochs=summary['epochs'] + 1,
                           best_prec1=best_prec1)
    return summary


if __name__ == '__main__':
    main()
