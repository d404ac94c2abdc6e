#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``pretorched_tpu_torch``).

Drives the port's main path once on one CUDA card and checks it:

1. the card: its name and power limit (``nvidia-smi``);
2. the build of the CUDA kernels from ``pretorched_tpu_torch/csrc``;
3. the non-local attention forward kernels against their plain PyTorch
   version at the video slice's shapes, in f32 (TF32 off) and bf16, each
   with the kernel the dispatch picks (``attention_kernel``: bf16 with C
   and Cv multiples of 8 up to 512 on K1-fwd's wgmma programs, which pad
   them to 64 through TMA, past 256 the wide program, other bf16 shapes on
   mma.sync; f32 K1-fwd, K1-dq and K1-dkv on TF32 wgmma (tf32_wgmma) up
   to 512, scalar past it), f32 repeated bitwise and held to tf32x3, its
   time, its bound (f32: at the TF32 rate over 3 and on the CUDA cores)
   and one ``scaled_dot_product_attention`` call's time, the plain
   version's at layers 2 and 3, and at both layers the kernels that the
   dispatch's choice replaced (bf16: mma.sync, f32: tf32x3 and scalar;
   held to the plain version at the same tolerances) and the first one's
   host time per call;
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
   kernel family. Then the same weights with the space-to-depth stem
   (``s2d_stem=True``): the bf16 forward of both in turns, each stem's
   kernels from the profiler, the stem conv alone at 3 and 8 channels
   (plain) and 12 and 16 (folded), 5 K1-fwd launches in the folded
   forward, and in f32 the stem's output held to the plain stem's, the
   logits with the non-local blocks off (``W.1`` zeroed) too, and with
   them on as the kernel is held to the plain attention (these random
   weights amplify any rounding there);
5. the backward kernels (K1-dq, K1-dkv) against the plain backward at the
   training path's shapes, in f32 and bf16, with the same times per bf16
   shape and, at layers 2 and 3, the generic K1-dq and K1-dkv that wgmma
   (at layer 3 its wide programs) replaced: time and host time per call,
   each generic kernel held to the plain backward, K1-dq's two outputs
   held together; K1-dq and K1-dkv must repeat bitwise at every shape. In
   f32 every shape runs the program the dispatch picks (tf32_wgmma, scalar
   at gaussian mode's C = 1024), and at layers 2 and 3 the programs
   tf32_wgmma replaced (mma.sync tf32x3 and scalar) are held to the plain
   backward too (tf32x3 also to tf32_wgmma) and timed beside it with their
   host times, SDPA's f32 backward, and the bounds at the tensor cores'
   TF32 rate over 3 and at the CUDA cores'. Then K1's done
   line: K1-fwd, K1-dq and K1-dkv in bf16 at N = Nk
   = 65,536, C = Cv = 256 (the narrow wgmma programs) against the plain
   version computed in chunks of queries in f32 (the kernel's own out and
   lse for the backward, dk and dv summed over the chunks), at this
   phase's and phase 3's tolerances, timed beside SDPA; and the f32
   kernels timed at the train shapes of layers 2 and 3 beside SDPA in f32
   (K1-fwd, K1-dq and K1-dkv beside the tf32x3 and scalar programs, each
   program held to the plain version, K1-fwd's to tf32x3 too);
6. the training path: ``nonlocalresnet3d50`` from the same checkpoint, bf16,
   ``remat=(0,)``, SGD, 12 steps of 8 clips x 32 frames x 224 px; it checks
   15 attention launches a step (5 forward, 5 dq and 5 dkv on wgmma, 3 of
   each on the wide program) and a finite loss, prints each step's host
   time and device time (CUDA events around the step) and their medians
   over steps 2-12, clips/s and peak memory, profiles one more step
   (device time by kernel family, each K1 program's, idle share), and
   saves a checkpoint after step 3 that must restore exactly;
6b. the f32 fine-tuning step: the same model, batch and SGD in f32 with
   TF32 off, steps in turns with the f32 attention on the dispatch's
   choice (all three on tf32_wgmma), with K1-fwd forced onto tf32x3, with
   all three forced onto tf32x3 and onto the scalar programs (the
   dispatch patched in this script): 15 K1 launches
   a step by program (5 K1-fwd, 5 K1-dq and 5 K1-dkv on the programs of
   the turn), finite losses, device and host time a step
   (median and spread), peak memory, and one profiled step of each with
   K1's share and the device's idle share;
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
   of fused_blocks 32 and 0, peak memory and a profiled forward, the same
   weights with both stems folded (fast: fold 4, slow: fold 2) in turns
   with the plain ones (clips/s, each stem's kernels, 11 K2 launches, the
   f32 logits held together), then runs
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
11. BASELINE config 4's video backbones: ``r2plus1d50`` at the JAX
    bench's row-5 geometry (20 clips x 16 frames x 112 px, bf16) with the
    plain and the folded factored stem on the same weights in turns
    (clips/s, peak memory, the stems' kernels, f32 logits held together),
    then one bf16 forward each of ``resnext3d101``, ``preact_resnet3d50``,
    ``wideresnet3d50`` and ``resneti3d50``, held to its f32 forward;
12. ``trn`` (MSTRN over ``resnet50``, 8 videos x 8 segments x 224 px,
    bf16): videos/s, the backbone computing in bf16, the logits held to the
    f32 forward, the generator path repeating from its seed;
13. ``MNISTNonLocalNet`` on 64 images: K1-fwd on wgmma in bf16 (C = 16
    and 32, padded to 64) and on tf32_wgmma in f32, 2 launches a
    forward, each held to the plain version (f32: and to tf32x3, both
    timed queued), the f32 logits against the
    plain attention, ``W.1`` moving them, and the bf16 launches timed
    beside the mma.sync program that wgmma replaced there (also held to
    the plain version);
14. BASELINE config 2 through ``examples/imagenet_eval_torch.py`` in
    this process, on fabricated hosted ``imagenet`` files (seeded, every
    BN randomized; ``nasnetalarge``'s with its 1001st class) and 512 JPEGs
    around 500 x 375 px in 8 classes: ``se_resnext101_32x4d`` with ``-e
    --bf16 -b 256`` (the PIL pipeline, ``--fast-pipeline``,
    ``--ten-crop``) and ``nasnetamobile``; each bf16 forward of 256 images
    timed, profiled by family, with the kernels of a grouped and a
    depthwise conv; the eval step's f32 logits against a direct forward,
    bf16 against f32; ``ten_crop``'s shape and center crop;
    ``nasnetalarge`` with the background row dropped, at 331 px; 4 train
    steps at ``-b 64``, the checkpoint and ``.meta``, the checkpoint
    evaluated again, 8 steps more from it (``--resume``), and the train
    step by CUDA events and host clock; no K1 or K2 launch;
15. ``examples/video_eval_torch.py --frames native`` on phase 4's weights
    and videos of 20, 32, 40, 56 and 80 frames (buckets 24 to 64): 5
    K1-fwd launches a forward on wgmma (3 wide), each bucket's forward
    timed, the 32-frame video as with ``--frames 32``, and K1-fwd against
    its plain version at every bucket's layer-2 and layer-3 shapes in f32
    and bf16, with its time, the plain version's, SDPA's and the bound;
16. BASELINE config 5: ``biggan256(num_classes=1000, ch=96)`` (seeded,
    every BN's statistics randomized, SAGAN's ``gamma`` 0.5) sampling 32
    seeded labels through ``gan.biggan.sample`` in bf16: (32, 256, 256, 3)
    images, finite, in [-1, 1], one K1-fwd launch a forward on the wide
    wgmma program (C = 96, Cv = 384 padded to 128 and 384; tf32_wgmma in
    f32, held to tf32x3 too), each launch held to the plain version, the
    bf16 images against
    the f32 images of the same
    weights and z; at batch 4 in f32 the images with the kernel against the
    plain attention, and ``gamma`` 0 moving them; images/s, peak memory, a
    profiled forward by family with K1-fwd's share and the idle share; one
    bf16 ``biggan128(ch=96)`` forward, its launch on wgmma held to the
    plain version; K1-fwd alone at (32, 4096, 1024, 96, 384), (32, 4096,
    1024, 48, 192) and (2, 4096, 1024, 16, 64), f32 and bf16, against its
    plain version with its time, the plain version's, SDPA's and the bound,
    and in bf16 the mma.sync program that wgmma replaced there (held to the
    plain version, timed);
17. the 2D families on phase 14's JPEGs: ``resnext101_32x4d``,
    ``resnext101_64x4d``, ``fbresnet152``, ``cafferesnet101``,
    ``densenet121``, ``vgg16_bn``, ``alexnet`` and ``squeezenet1_1`` (seeded,
    every BN randomized), one bf16 forward of 256 images each at its
    ``input_size``, timed, profiled and held to its f32 forward; then
    ``examples/imagenet_eval_torch.py -e --bf16 -b 256 -a
    resnext101_64x4d`` on a hosted file fabricated in Lambda order, which
    the ordered loader restores exactly; no K1 or K2 launch;
18. the rest of the 2D zoo on phase 14's JPEGs: the Inception family
    (``inceptionv3``, ``inceptionv4``, ``inceptionresnetv2``,
    ``bninception``), ``xception``, the six DPNs, ``mobilenetv2``,
    ``pnasnet5large``, ``polynet``, ``vggm`` and ``wideresnet50`` (seeded,
    every BN randomized), one bf16 forward each at its ``input_size`` (64
    images at 299 and 331 px, 256 below), timed and held to its f32
    forward, ``inceptionv4`` and ``dpn92`` profiled by family with cuDNN's
    layout copies apart; ``examples/imagenet_eval_torch.py -e --bf16 -a
    inceptionv4`` on a fabricated 1001-class hosted file, whose
    ``imagenet`` load keeps the donor's 1000 classes exactly; one CLI train
    step of ``dpn68b`` at ``-b 64``; ``wideresnet50`` from an ``.npz`` in
    the hosted export's keys, every tensor the donor's; no K1 or K2 launch;
19. the video and audio families and VOC transfer: ``densenet3d121``,
    ``densenet3d169``, ``densenet3d201``, ``densenet3d264``, ``mvresnet10``,
    ``mvresnet18``, ``mvresnet34`` and ``mvresnet50`` (seeded, every BN
    randomized, 400 classes) on 32 clips x 16 frames x 112 px, and
    ``soundnet8`` (1000 classes) and ``BranchedSoundNet`` on 8 seeded
    16-bit WAVs of 67,724 samples read back through
    ``datasets.audio.soundnet_input``: one bf16 forward each, timed, with
    its peak memory, held to its f32 forward; the multi-window head on a
    WAV of twice that length; per family at reduced depth the card's f32
    features and logits against the CPU's (TF32 off); zeroing the stem's
    ``MultiViewConv.linear`` moving the logits; then
    ``examples/voc2007_extract_torch.py -a resnet50 -b 64`` on a
    fabricated VOC2007 folder of 128 train and 128 val JPEGs and a hosted
    file (images/s, the cache read back, the SVM fit where sklearn
    imports) and ``examples/visu_arch_torch.py -a resnet18`` writing both
    PNGs; no K1 or K2 launch;
20. serving export and the mesh: ``zoo.export.export_model`` on the card
    of phase 4's ``nonlocalresnet3d50`` (20 clips x 32 x 224 px, bf16 at a
    fixed batch of 20, f32 with a symbolic batch at 2 and 20),
    ``slowfast_resnet50(fused_blocks=32)`` (20 clips x 64 frames, bf16)
    and ``resnet50`` (f32, symbolic batch at 1, 8 and 64), reloaded in a
    fresh process that builds no model (``tools/port_export_reload.py``):
    5 K1-fwd launches a non-local forward (bf16: 2 wgmma + 3 wgmma_wide;
    f32: tf32_wgmma), 11 K2 (6 TMA + 5 mma.sync) a SlowFast forward, the
    logits against the eager forward's (bf16 rel L2 5e-3; f32, TF32 off,
    1e-4), each forward timed in both; ``tools/convert_weights_torch.py
    --eval`` on phase 14's val folder with a fabricated hosted
    ``resnet18`` (the table line, its FAIL on random weights, images/s);
    the mesh at world size 1 on NCCL (``make_mesh()`` is (1, 1)): one
    train step of ``se_resnext101_32x4d`` at ``-b 64`` through
    ``examples/imagenet_eval_torch.py`` plain, with ``--zero`` and with
    ``--zero fsdp`` (same crops; each loss against the plain step's; the
    FSDP checkpoint loads strict into a plain model), and 3 ZeRO train
    steps of ``nonlocalresnet3d50`` (15 attention launches each, finite
    loss);
21. pipeline and expert parallelism (``parallel.pipeline``,
    ``parallel.moe``): phase 4's ``nonlocalresnet3d50`` pipelined over its
    four resolution stages on the card (``pipeline_apply_stages`` of
    ``pipeline_stage_fns``, ``devices=['cuda:0'] * 4``): the bf16 forward
    of 20 clips x 32 x 224 px in 4 microbatches, 20 K1-fwd launches (8
    wgmma, 12 wgmma_wide), its logits held to the unpipelined forward, both
    timed with their peak memory; the backward of 8 clips in 4 microbatches
    (eval BN), 20 launches each of K1-dq and K1-dkv, every parameter's
    gradient held to the unpipelined backward's; K1-fwd at the forward's
    microbatch shapes and K1-dq, K1-dkv at the backward's against their
    plain versions; ``pipeline_apply`` over blocks 1-32 of
    ``resnet3d152``'s layer3 (bf16, 4 stages) against ``sequential_apply``;
    ``trn_expert_forward`` on phase 12's TRN against the dense forward (f32
    with TF32 off, and bf16), the head alone timed both ways;
    ``moe_apply`` on 1024 pooled ``resnet50`` features (standardized), 8
    experts, a skewed router at capacity factor 1.0, against
    ``moe_reference``, with the dropped fraction; the mesh paths of ``pipeline_apply`` and
    ``moe_apply`` at world size 1 on NCCL against the in-process results;
22. the seq axis (``parallel.seq``): phase 4's ``nonlocalresnet3d50``,
    every BN randomized (zeroing the blocks' ``W.1`` moves the logits),
    time-sharded over 2 shards in the one-process stacked form
    (``seq_parallel(model, shards=2)``): K1-fwd, K1-dq and K1-dkv at the
    stacked seq shapes (16 x 16 frames: layer 2 (16, 3136, 6272, 256,
    256), layer 3 (16, 392, 784, 512, 512)) against their plain versions,
    timed with SDPA and the bound; 12 bf16 train steps of phase 6's batch
    (8 clips x 32 x 224 px, SGD as phase 6), each with 5 launches of each
    K1 kernel (2 wgmma + 3 wgmma_wide) at those shapes, the median of
    steps 2-12 by CUDA events beside phase 6's unsharded step (the same
    statistic), with the peak memory; the seq step of 2 clips against the
    unsharded step from the same weights: in f64 (train-mode BN, the
    attention plain, in f64) to rounding, and in f32 with the kernels
    (TF32 off; eval BN and a loss linear in the logits, where f32 is well
    conditioned) each parameter's gradient held to the f64 step's, with a
    planted fault (the halos send no gradient back) that must fail that
    check; and the whole-batch backward (eval BN, TF32 off) of 8 clips
    against the sum of its 4 microbatches' backwards, in f32 with cuDNN on
    and off on the weights as they are and with the attention tempered
    (printed), and in f64 (held to rounding);
23. a line with each kernel's numbers and the card, then
    ``{"ok": true, "device": {...}}``. Every phase's heading names the card
    and its power limit.

Usage: ``python3 chip_smoke.py`` from the repository root. It exits nonzero,
with no result line, when a phase fails or no CUDA card is present.
"""

import contextlib
import importlib.util
import io
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
# K1's done line (phase 5): one sequence of N = Nk = 65,536 at layer 2's
# widths in bf16, (B, N, Nk, C, Cv), held to the plain version computed
# DONE_CHUNK queries at a time (the whole N x N matrix would take 16 GiB in
# f32); the f32 kernels timed at TRAIN_SHAPES' layer2 and layer3
DONE_LINE_SHAPE = (1, 65536, 65536, 256, 256)
DONE_CHUNK = 4096
# the card's dense peaks (H100 SXM at 700 W) and memory rate, for bounds:
# bf16 on the tensor cores, f32 on the CUDA cores, and f32 as the tf32x3
# programs of K1-dq and K1-dkv form it, 3 TF32 products on the tensor
# cores' 495 TFLOP/s for each f32 product
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12, 'tf32x3': 495e12 / 3}
# the f32 programs on the tensor cores (three TF32 products per f32 product)
TF32_PROGRAMS = ('tf32x3', 'tf32_wgmma')
MEM_BYTES_PER_S = 3.35e12
# 12 steps: the first warms up, the median of steps 2-12 is read, by host
# clock and by device time (CUDA events around each step)
TRAIN_CLIPS, TRAIN_STEPS, TRAIN_LR = 8, 12, 1e-3
# phase 6b: phase 6's step in f32 (TF32 off), the f32 fine-tuning a user of
# the f32 zoo runs: a warm step on each program, then turns of
# F32_TRAIN_STEPS steps with K1-fwd, K1-dq and K1-dkv on tf32_wgmma (the
# dispatch's choice, w), K1-fwd forced onto tf32x3 (f), all three onto
# tf32x3 (t) and onto the scalar programs (s), w f t s s t f w, and one
# profiled step of each; K1 launches a step by program
F32_TRAIN_STEPS = 3
F32_TRAIN_KERNELS = {
    'tf32_wgmma': {'fwd tf32_wgmma': 5, 'dq tf32_wgmma': 5,
                   'dkv tf32_wgmma': 5},
    'fwd_tf32x3': {'fwd tf32x3': 5, 'dq tf32_wgmma': 5, 'dkv tf32_wgmma': 5},
    'tf32x3': {'fwd tf32x3': 5, 'dq tf32x3': 5, 'dkv tf32x3': 5},
    'scalar': {'fwd scalar': 5, 'dq scalar': 5, 'dkv scalar': 5}}
F32_TRAIN_TURNS = ('tf32_wgmma', 'fwd_tf32x3', 'tf32x3', 'scalar', 'scalar',
                   'tf32x3', 'fwd_tf32x3', 'tf32_wgmma')
# the f32 K1 launches a pass (phase 21's pipelined microbatches, phase 22's
# f32 steps): K1-fwd, K1-dq and K1-dkv on tf32_wgmma
F32_PASS_KERNELS = F32_TRAIN_KERNELS['tf32_wgmma']
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
# the f32 output of the space-to-depth stem, and the logits, against the
# plain stem on the same weights (rel L2, TF32 off): the fold only sums the
# stem's products in another order. The non-local model's logits with its
# attention on are held as its kernel is held to the plain attention
# (1e-3): those random weights amplify a 1e-6 change at the stem to 1e-4
TOL_S2D = 1e-5
# phase 11: the JAX bench's row-5 geometry, 20 clips x 16 frames x 112 px;
# phase 12: its row 10 (MSTRN over resnet50, 8 segments x 224 px) at 8
# videos, 64 backbone frames
R2P1D_CLIPS = (20, 3, 16, 112, 112)
# K1-fwd at MNISTNonLocalNet's blocks on 64 images: (B, N, Nk, C, Cv)
MNIST_SHAPES = ((64, 196, 196, 16, 16), (64, 49, 49, 32, 32))
TRN_VIDEOS = (8, 3, 8, 224, 224)
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

# phase 14: BASELINE config 2 through examples/imagenet_eval_torch.py, on
# an image folder of 8 classes x (32 train + 32 val) JPEGs at sizes around
# 500 x 375: eval at -b 256 in bf16, then 4 train steps at -b 64 and, from
# the checkpoint, 8 more (--resume); nasnetalarge's hosted file has the
# 1001st (background) class
IMAGENET_MODELS = {'se_resnext101_32x4d': 1000, 'nasnetamobile': 1000,
                   'nasnetalarge': 1001}
IMAGENET_CLASSES, IMAGENET_PER_CLASS = 8, 32
IMAGENET_SIZES = ((375, 500), (500, 375), (333, 500), (400, 500),
                  (375, 499), (480, 360))
IMAGENET_BATCH, IMAGENET_TRAIN_BATCH, TRAIN_TIMED_STEPS = 256, 64, 6
LARGE_BATCH = 32
# phase 15: native-length eval of phase 4's weights; videos of these
# lengths fall into the buckets 24, 32, 40, 56 and 64 (80 is capped at
# --max-frames 64), one video a bucket, so every forward is 10 clips
NATIVE_LENGTHS = (20, 32, 40, 56, 80)
NATIVE_BUCKETS = {24: 1, 32: 1, 40: 1, 56: 1, 64: 1}
NATIVE_CLIPS = 10
# phase 16: BASELINE config 5 as the JAX bench's row 12 runs it (biggan256,
# ch 96, 1000 classes, batch 32, bf16); K1-fwd at SAGAN's shapes (keys
# pooled 2x2, Cv = 4 C): (B, N, Nk, C, Cv) at 64 px
BIGGAN_BATCH = 32
BIGGAN_SHAPES = {'biggan256 ch96': (32, 4096, 1024, 96, 384),
                 'biggan128 ch96': (32, 4096, 1024, 48, 192),
                 'golden lock ch16': (2, 4096, 1024, 16, 64)}
# phase 17: the 2D families, each at its input_size on phase 14's JPEGs
FAMILY_MODELS = ('resnext101_32x4d', 'resnext101_64x4d', 'fbresnet152',
                 'cafferesnet101', 'densenet121', 'vgg16_bn', 'alexnet',
                 'squeezenet1_1')

# phase 18: the rest of the 2D zoo, each at its input_size on phase 14's
# JPEGs (64 images at 299 and 331 px, all 256 at 221 and 224), two of them
# profiled; a 1001-class hosted inceptionv4 through the eval CLI, one CLI
# train step of dpn68b at -b 64, wideresnet50 from an .npz in the hosted
# export's keys
ZOO_MODELS = ('inceptionv3', 'inceptionv4', 'inceptionresnetv2',
              'bninception', 'xception', 'dpn68', 'dpn68b', 'dpn92', 'dpn98',
              'dpn107', 'dpn131', 'mobilenetv2', 'pnasnet5large', 'polynet',
              'vggm', 'wideresnet50')
ZOO_PROFILED = ('inceptionv4', 'dpn92')
ZOO_LARGE_BATCH = 64

# phase 19: the video and audio families at the 3D-ResNets geometry (32
# clips x 16 frames x 112 px, 400 classes); soundnet8 on 8 seeded 16-bit
# WAVs of 67,724 samples at 22,050 Hz (one more of twice that length runs
# the multi-window head); VOC2007 transfer on a fabricated folder of 128
# train and 128 val JPEGs through examples/voc2007_extract_torch.py
# (resnet50, -b 64); the card's f32 logits held to the CPU's (TF32 off)
VIDEO_FAMILIES = ('densenet3d121', 'densenet3d169', 'densenet3d201',
                  'densenet3d264', 'mvresnet10', 'mvresnet18', 'mvresnet34',
                  'mvresnet50')
FAMILY_CLIPS = (32, 3, 16, 112, 112)
SOUND_CLIPS, SOUND_SAMPLES, SOUND_RATE = 8, 67724, 22050
VOC_PER_SPLIT, VOC_BATCH = 128, 64
TOL_CARD_CPU = 1e-3

# phase 20: serving export (zoo/export.py) at phase 4's and phase 9's
# geometry (20 clips a program call), resnet50 with a symbolic batch; the
# reloaded program's logits against the eager forward's (rel L2): bf16
# through the same kernels, f32 with TF32 off; the mesh at world size 1
EXPORT_CLIPS = 20
EXPORT_NL_SHAPE, EXPORT_SF_SHAPE = (3, 32, 224, 224), (3, 64, 224, 224)
EXPORT_R50_BATCHES = (1, 8, 64)
TOL_EXPORT = {'bfloat16': 5e-3, 'float32': 1e-4}
# one CLI train step of se_resnext101_32x4d at -b 64 (8 of phase 14's
# train JPEGs a class), plain, --zero and --zero fsdp, each loss against the
# plain step's; 3 ZeRO train steps of nonlocalresnet3d50 at phase 6's batch
ZERO_PER_CLASS, ZERO_VAL_PER_CLASS, ZERO_STEPS = 8, 2, 3
TOL_ZERO_LOSS = 2e-2

# phase 21: nonlocalresnet3d50 (phase 4's weights) pipelined over its four
# stages on one card (devices=['cuda:0'] * 4): a bf16 forward of 20 clips x
# 32 x 224 px in 4 microbatches (K1-fwd at B = 5), a backward of 8 clips in
# 4 (K1-dq and K1-dkv at B = 2); blocks 1-32 of resnet3d152's layer3 as a
# homogeneous 4-stage trunk; phase 12's TRN with its MSTRN head as experts;
# moe_apply over pooled resnet50 features
PIPE_STAGES, PIPE_MICRO, PIPE_CLIPS, PIPE_TRAIN_CLIPS = 4, 4, 20, 8
PIPE_SHAPES = {'layer2': (5, 6272, 6272, 256, 256),
               'layer3': (5, 784, 784, 512, 512)}
PIPE_TRAIN_SHAPES = {'layer2': (2, 6272, 6272, 256, 256),
                     'layer3': (2, 784, 784, 512, 512)}
TRUNK_BLOCKS = (1, 33)
# phase 22: 2 time shards stacked on the batch (parallel.seq's one-process
# form): each non-local block attends with its shard's queries to every
# key, K1 at (2 x 8 clips, N, 2 N) a pass
SEQ_SHARDS, SEQ_F32_CLIPS, WHOLE_MICRO = 2, 2, 4
SEQ_SHAPES = {'layer2': (16, 3136, 6272, 256, 256),
              'layer3': (16, 392, 784, 512, 512)}
# the seq step against the unsharded one (2 clips): in f64 (train-mode
# BN, cross-entropy) the loss and each gradient within TOL_SEQ_F64
# (grad_spread's units; 0 and 1.7e-10 read on an H100 80GB HBM3 at 700
# W). In f32 with the kernels (TF32 off) on eval BN, a loss linear in the
# logits and the attention logits tempered to a spread of 1, the seq and
# the unsharded step each within TOL_SEQ_F32 of the f64 step (each
# gradient, grad_spread; 2.6e-03 and 1.9e-03 read there at worst, 1.2e-04
# and 9.2e-05 at the median) and TOL_SEQ_LOSS (the loss; 2.4e-07), and the
# seq step with its halo gradients dropped beyond TOL_SEQ_F32 (1.05 read,
# 8.2e-02 at the median). Untempered, f32 is no yardstick on these random
# weights: the logits spread by up to 2e4, and the unsharded f32 step with
# the plain attention sits 2.4 (all gradients together, rel L2) from f64
# (tools/port_seq_f32_probe.py). The whole
# batch's backward against its microbatches' is held in f64 at
# TOL_SEQ_F64 too (2.7e-13 read there); in f32 it is printed (5e-4 to
# 1e-3 at the median, with cuDNN on and off)
TOL_SEQ_F64, TOL_SEQ_LOSS, TOL_SEQ_F32 = 1e-6, 1e-5, 1e-2
MOE_TOKENS, MOE_EXPERTS, MOE_HIDDEN, MOE_SKEW = 1024, 8, 1024, 3.0
# each parameter's gradient through the pipeline against the unpipelined
# backward of the same microbatches, |diff| over the sum of the
# microbatches' gradient norms: the same kernels at the same shapes, their
# f32 gradients summed in another order, and the stem's max-pool backward
# adds overlapping windows atomically, in an order that changes from run
# to run and rounds to bf16 there (bn1.bias, the sum of that gradient, read
# 4.1e-3 to 6.0e-3 in bf16 on an H100, the other parameters 2e-8 at the
# median); f32 with TF32 off
TOL_PIPE_GRAD = {'bfloat16': 5e-2, 'float32': 1e-4}
# the expert-parallel TRN against the dense one in f32, TF32 off (max |diff|
# / max |dense|), moe_apply against the per-token oracle, and the mesh paths
# at world size 1 against the in-process ones
TOL_TRN_EXPERT, TOL_MOE, TOL_PIPE_MESH = 1e-4, 1e-4, 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


CARD = ''    # nvidia-smi's name and power limit, printed with every phase
PHASE_START = []    # when the running phase began (host clock)


def phase(title):
    now = time.perf_counter()
    if PHASE_START:
        print(f'(the phase took {now - PHASE_START[0]:.1f} s)')
        PHASE_START.clear()
    PHASE_START.append(now)
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
    dp, dk and dv). ``dtype`` names the rate (``PEAK_FLOPS``): 'tf32x3'
    is f32 data at the tensor cores' rate over 3."""
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
    picks, f32 repeated bitwise; each timed with its bound (f32: at the
    TF32 rate over 3 and on the CUDA cores, beside the multiply-adds a
    pair) and SDPA's time; layers 2 and 3 also on the kernels that the
    dispatch's choice replaced (bf16: mma.sync; f32: tf32x3 and scalar),
    which are held to the plain version at the same tolerances and timed
    with the first one's host time; f32 also held to tf32x3 at every
    shape.
    Returns the rows of layers 2 and 3 (bf16 under the layer's name, f32
    under '<layer> float32')."""
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
            repeats = True
            if dt == torch.float32:
                again = na.nonlocal_attention_cuda(q, k, v)
                repeats = (torch.equal(out, again[0])
                           and torch.equal(lse, again[1]))
                line += f', a second call bitwise the same: {repeats}'
                del again
            layer = name in ('layer2', 'layer3')
            # the kernels the dispatch's choice replaced, at its
            # tolerances: bf16 mma.sync and f32 scalar at the layers, f32
            # tf32x3 at every shape (held to the new program too)
            olders = ([] if kernel in ('mma_sync', 'scalar') else
                      ['mma_sync'] if dt == torch.bfloat16
                      else ['tf32x3', 'scalar'])
            olders = [o for o in olders if layer or o == 'tf32x3']
            older = olders[0] if olders else None
            earlier = layer and older is not None
            errs_m, ab = {}, (0.0, 0.0)
            for o in olders:
                out_m, lse_m = na._launch_fwd(q, k, v, 1.0, o)
                errs_m[o] = fwd_errors(out_m, lse_m, want, want_lse)
                line += (f'\n    the {o} kernel: max|out-plain|='
                         f'{errs_m[o][0]:.3e}, /max|plain| '
                         f'{errs_m[o][1]:.3e}, max|lse-plain|='
                         f'{errs_m[o][2]:.3e}')
                if o == 'tf32x3':
                    ab = ((out_m - out).abs().max().item(),
                          (lse_m - lse).abs().max().item())
                    line += (f'; max|{kernel}-{o}| out {ab[0]:.3e}, lse '
                             f'{ab[1]:.3e}')
                del out_m, lse_m
            del want, want_lse
            ms = median_ms(lambda: na.nonlocal_attention_cuda(q, k, v))
            line += f'\n    kernel {ms:.3f} ms'
            if layer:
                plain_ms = median_ms(
                    lambda: na.nonlocal_attention_fwd_lse_reference(q, k, v))
                line += f', plain {plain_ms:.3f} ms'
            lib_ms, backend = sdpa_ms(torch, q, k, v)
            rate = 'tf32x3' if kernel in TF32_PROGRAMS else dname
            bound_ms, bound_by = attention_bounds(b, n, nk, c, cv,
                                                  rate)['fwd']
            line += (f', scaled_dot_product_attention {fmt_ms(lib_ms)} '
                     f'({backend}), bound {bound_ms:.4f} ms ({bound_by}'
                     + (' at the TF32 rate over 3' if rate == 'tf32x3'
                        else '') + ')')
            cores_ms = None
            if dt == torch.float32:
                cores_ms = attention_bounds(b, n, nk, c, cv,
                                            'float32')['fwd'][0]
                line += (f', {cores_ms:.4f} ms on the CUDA cores; '
                         f'{c + cv} multiply-adds a (query, key) pair')
            if earlier:
                older_ms = {o: median_ms(lambda: na._launch_fwd(
                    q, k, v, 1.0, o)) for o in olders}
                earlier_ms = older_ms[older]
                hosts = (host_us(lambda: na.nonlocal_attention_cuda(
                             q, k, v)),
                         host_us(lambda: na._launch_fwd(
                             q, k, v, 1.0, older)),
                         host_us(lambda: na.nonlocal_attention_fwd_lse(
                             q, k, v)))
                line += ('; ' + ', '.join(f'the {o} kernel {t:.3f} ms'
                                          for o, t in older_ms.items())
                         + f'; host per call {hosts[0]:.1f} us ({kernel}, '
                         f'the wrapper), {hosts[2]:.1f} us (the same '
                         f'through the operator pretorched::'
                         f'nonlocal_attention_fwd), {hosts[1]:.1f} us '
                         f'({older})')
                row = {
                    'kernel': kernel, 'max_abs_err': err, 'ms': ms,
                    'plain_ms': plain_ms, 'library_ms': lib_ms,
                    'library': f'scaled_dot_product_attention '
                               f'({backend})',
                    'bound_ms': bound_ms, 'bound_by': bound_by,
                    'earlier_ms': earlier_ms,
                    'earlier': f'{older} kernel, same run',
                    'host_us': hosts[0], 'earlier_host_us': hosts[1],
                    'host_us_operator': hosts[2]}
                if dt == torch.float32:
                    row.update({'bound_ms_cuda_cores': cores_ms,
                                'scalar_ms': older_ms['scalar'],
                                'max_abs_diff_to_tf32x3': ab[0],
                                'macs_per_pair': c + cv,
                                'shape': [b, n, nk, c, cv],
                                'dtype': dname})
                    result[f'{name} float32'] = row
                else:
                    result[name] = row
            print(line, flush=True)
            check(err <= tol and err_rel <= tol_rel and err_lse <= tol_lse
                  and repeats,
                  f'kernel disagrees with the plain version or itself: '
                  f'{line}')
            for o, e in errs_m.items():
                check(e[0] <= tol and e[1] <= tol_rel and e[2] <= tol_lse,
                      f'the {o} kernel disagrees with the plain version: '
                      f'{line}')
            check(ab[0] <= tol and ab[1] <= tol_lse,
                  f'K1-fwd {kernel} and tf32x3 disagree: {line}')
            del q, k, v, out, lse
            torch.cuda.empty_cache()
    return result


def randomize_bn(model, torch, seed):
    g = torch.Generator().manual_seed(seed)

    def draw(t, low, high):     # on the host, for a model on either device
        t.copy_(torch.empty(t.shape).uniform_(low, high, generator=g))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                draw(m.running_mean, -0.3, 0.3)
                draw(m.running_var, 0.5, 1.5)
                if m.affine:    # BigGAN's conditional BNs have no affine
                    draw(m.weight, 0.5, 1.5)
                    draw(m.bias, -0.2, 0.2)


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
    # the same weights with the space-to-depth stem (``conv1.weight`` is
    # the plain stem's)
    folded = nonlocalnet.NonLocalResNet3D(
        'bottleneck', (3, 4, 6, 3), num_classes=400,
        shortcut_type=model.shortcut_type, s2d_stem=True).cuda().eval()
    folded.load_state_dict(model.state_dict(), strict=True)
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
        s2d = stem_ab(model, folded, batch, na, torch, 'eval forward',
                      EVAL_KERNELS)

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
        before = kernel_counts(na)
        logits_k = model(batch)
        f32_by_kernel = {key: n - before.get(key, 0)
                         for key, n in kernel_counts(na).items()
                         if n != before.get(key, 0)}
        logits_p = with_attention(na.nonlocal_attention_reference)
        rel = rel_l2(logits_k, logits_p)
        rel_bf16 = rel_l2(logits_bf16, logits_p)
        print(f'f32 logits, kernel ({f32_by_kernel}) vs plain attention: '
              f'rel L2 {rel:.3e} (tol 1e-3); bf16 vs f32-plain: rel L2 '
              f'{rel_bf16:.3e}')
        check(f32_by_kernel == {'fwd tf32_wgmma': 5},
              f'the f32 forward launched {f32_by_kernel}, expected 5 '
              'K1-fwd on tf32_wgmma')
        check(bool(torch.isfinite(logits_k).all()) and rel <= 1e-3,
              f'kernel and plain paths disagree: rel L2 {rel:.3e}')
        folded.float()
        stem = rel_l2(folded.conv1(batch), model.conv1(batch))
        s2d['rel_l2_f32'] = rel_l2(folded(batch), logits_k)
        print(f'f32, s2d stem vs plain stem: the stem\'s output rel L2 '
              f'{stem:.3e} (tol {TOL_S2D:g}, TF32 off); the logits rel L2 '
              f'{s2d["rel_l2_f32"]:.3e} (tol 1e-3: with these random '
              'weights the non-local blocks amplify any f32 rounding, as '
              'the kernel against the plain attention shows)')
        check(stem <= TOL_S2D and s2d['rel_l2_f32'] <= 1e-3,
              'the folded stem changes the f32 output')
        for m in (*model.modules(), *folded.modules()):
            if isinstance(m, nonlocalnet.NonLocalBlock):
                m.W[1].weight.zero_()
        backbone = model(batch)
        moved = ((backbone - logits_k).norm() / logits_k.norm()).item()
        print(f'zeroing the 5 W.1 scales moves the f32 logits by rel L2 '
              f'{moved:.3e}')
        check(moved > 1e-2, 'the logits do not depend on the attention')
        s2d['rel_l2_f32_no_attention'] = rel_l2(folded(batch), backbone)
        print(f'with the 5 W.1 scales zeroed, the s2d stem vs the plain '
              f'stem: f32 logits rel L2 '
              f'{s2d["rel_l2_f32_no_attention"]:.3e} (tol {TOL_S2D:g})')
        check(s2d['rel_l2_f32_no_attention'] <= TOL_S2D,
              'the folded stem changes the f32 logits of the backbone')
        del folded
    return launches, eval_by_kernel, eval_layer3, cli, s2d


def stem_ab(model, folded, batch, na, torch, what, k1_per_pass):
    """The bf16 forward of ``model`` (plain stem) and ``folded`` (the same
    weights, space-to-depth stem) in turns, each stem's kernels from the
    profiler, and the folded stem at 12 input channels against the same
    conv with zero channels to 16 (and the plain stem with zero channels
    to 8); the folded forward launches the K1 programs of
    ``k1_per_pass`` once each. Returns the numbers for the result line."""
    nclips = batch.shape[0]
    folded.bfloat16()
    times = forward_turns({'s2d_stem=False': model, 's2d_stem=True': folded},
                          batch, torch)
    print_turns(times, nclips, f'{what}, {nclips} clips')
    set_counts(na, 0)
    folded(batch)
    torch.cuda.synchronize()
    expect_kernels(na, k1_per_pass, 1, f'{what} with s2d_stem')
    launches = na.nonlocal_attention_cuda.launches
    print(f'K1-fwd launches by program, s2d_stem=True: {kernel_counts(na)}')
    x = batch.bfloat16()
    prof = stem_profile({'plain': lambda: model.conv1(x),
                         'folded': lambda: folded.conv1(x)}, torch)
    print_stems(prof)
    variants = stem_variants(model.conv1.weight, x, torch)
    return {'forward_ms': {k: sum(v) / len(v) for k, v in times.items()},
            'stem_ms': {k: v[0] for k, v in prof.items()},
            'stem_kernels': stem_kernels(prof),
            'stem_conv_variants_ms': variants, 'k1_launches': launches}


def stem_variants(weight, x, torch):
    """The stem conv alone in bf16 (CUDA events, median of 10) on inputs
    folded beforehand: plain (3 channels), plain with zero channels to 8,
    fold 2 (12 channels) and fold 2 with zero channels to 16: the same
    function each, what cuDNN makes of the channel count."""
    import torch.nn.functional as F

    from pretorched_tpu_torch.ops import space_to_depth as s2d

    w = weight.detach().bfloat16()
    kt = w.shape[2]
    xf, wf = s2d.space_to_depth_2d(x), s2d.fold_stem_kernel_3d(w)

    def pad_c(t, c):
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, c - t.shape[1]))

    cases = {
        'plain 3 ch': (x, w, (1, 2, 2), (kt // 2, 3, 3)),
        'plain 8 ch': (pad_c(x, 8), pad_c(w, 8), (1, 2, 2), (kt // 2, 3, 3)),
        'fold2 12 ch': (xf, wf, 1, (kt // 2, 0, 0)),
        'fold2 16 ch': (pad_c(xf, 16), pad_c(wf, 16), 1, (kt // 2, 0, 0)),
    }
    out = {}
    want = None
    for label, (xi, wi, stride, pad) in cases.items():
        y = F.conv3d(xi, wi, stride=stride, padding=pad)
        want = y.float() if want is None else want
        err = (y.float() - want).abs().max().item() / want.abs().max().item()
        out[label] = median_ms(lambda: F.conv3d(xi, wi, stride=stride,
                                                padding=pad), reps=10)
        print(f'  stem conv alone, {label}: {out[label]:.3f} ms (max error '
              f'{err:.1e} of the largest |out|)', flush=True)
        check(err <= TOL_K2['bfloat16'], f'stem variant {label} is off')
        del y
    return out


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
            if dt == torch.float32:
                line, generic_rel = f32_backward_rows(
                    na, torch, name, (q, k, v, do, out, lse), got, want,
                    (dq_kernel, kernel), errs, rels, line, result)
            print(line, flush=True)
            check(max(rels) <= tol,
                  f'backward kernels disagree with the plain version: {line}')
            check(generic_rel <= tol, f'the generic K1-dq or K1-dkv '
                  f'disagrees with the plain backward: {line}')
            del q, k, v, do, out, lse, got, want
            torch.cuda.empty_cache()
    return result


def f32_backward_rows(na, torch, name, inputs, got, want, kernels, errs,
                      rels, line, result):
    """Phase 5 in f32: K1-dq and K1-dkv repeated (bitwise); at layers 2 and
    3 the programs that tf32_wgmma replaced (the mma.sync tf32x3 programs
    and the scalar ones) held to the plain backward too, tf32x3 also to
    tf32_wgmma, all three timed with their host time per call, beside
    SDPA's f32 backward and the bounds at the tensor cores' TF32 rate over
    3 and at the CUDA cores'. Returns the line and the older programs'
    largest error (0 where not run); keeps the layers' numbers in
    ``result`` under '<name> float32'."""
    q, k, v, do, out, lse = inputs
    dq_kernel, kernel = kernels
    b, n, c = q.shape
    nk, cv = v.shape[1:]
    delta = (do * out).sum(-1)
    dq_again = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
    dk_again, dv_again = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse,
                                                             delta)
    same = (torch.equal(dk_again, got[1]) and torch.equal(dv_again, got[2]))
    same_dq = torch.equal(dq_again, got[0])
    del dq_again, dk_again, dv_again
    line += (f'; a second run bitwise equal: dk, dv {same}, dq {same_dq}')
    check(same, f'f32 K1-dkv ({kernel}) does not repeat at {name}')
    check(same_dq, f'f32 K1-dq ({dq_kernel}) does not repeat at {name}')
    if name not in ('layer2', 'layer3') or kernel != 'tf32_wgmma':
        return line, 0.0
    older_rel, ab = {}, 0.0
    for older in ('tf32x3', 'scalar'):
        grads = (na._launch_dq(q, k, v, do, lse, delta, 1.0, older),
                 *na._launch_dkv(q, k, v, do, lse, delta, 1.0, older))
        older_rel[older] = max(rel_to_max(gr, w) for gr, w in zip(grads, want))
        if older == 'tf32x3':
            ab = max(rel_to_max(x, y) for x, y in zip(got, grads))
        del grads
    check(ab <= TOL_BWD['float32'], f'f32 K1-dq / K1-dkv: tf32_wgmma and '
          f'tf32x3 disagree at {name}: {ab}')

    def calls(op, program):
        launch = na._launch_dq if op == 'dq' else na._launch_dkv
        if program == kernel:
            wrapper = (na.nonlocal_attention_bwd_dq_cuda if op == 'dq'
                       else na.nonlocal_attention_bwd_dkv_cuda)
            return lambda: wrapper(q, k, v, do, lse, delta)
        return lambda: launch(q, k, v, do, lse, delta, 1.0, program)
    programs = (kernel, 'tf32x3', 'scalar')
    ms = {op: tuple(median_ms(calls(op, pr), reps=5 if pr != 'scalar' else 3)
                    for pr in programs) for op in ('dq', 'dkv')}
    hosts = {op: tuple(host_us(calls(op, pr), reps=10 if pr != 'scalar'
                               else 3) for pr in programs)
             for op in ('dq', 'dkv')}
    plain_ms = median_ms(lambda: na.nonlocal_attention_bwd_reference(
        q, k, v, out, lse, do), reps=3)
    lib_ms, backend = sdpa_ms(torch, q, k, v, do)
    tc = attention_bounds(b, n, nk, c, cv, 'tf32x3')
    cores = attention_bounds(b, n, nk, c, cv, 'float32')
    # multiply-adds per (query, key) pair: K1-dq's s, dp and dq once; K1-dkv's
    # dk blocks s, dp and dk, its dv blocks s again and dv (tf32_wgmma at
    # 512: two column chunks a part, each forming s and dp)
    chunks = -(-max(c, cv) // 256)
    pair = {'dq': (chunks * (c + cv) + c, 2 * c + cv),
            'dkv': (chunks * (2 * c + cv) + c + cv, 2 * c + 2 * cv)}
    line += (f'; the programs it replaced: max|d-plain|/max|d| tf32x3 '
             f'{older_rel["tf32x3"]:.2e}, scalar {older_rel["scalar"]:.2e};'
             f' max|tf32_wgmma-tf32x3|/max|tf32x3| {ab:.2e}\n    f32 '
             + ', '.join(
                 f'{op} {ms[op][0]:.3f} ms (tf32x3 {ms[op][1]:.3f}, scalar '
                 f'{ms[op][2]:.3f}; host per call {hosts[op][0]:.1f} us, '
                 f'tf32x3 {hosts[op][1]:.1f}, scalar {hosts[op][2]:.1f}; '
                 f'bound {tc[op][0]:.4f} ms at the TF32 rate over 3, '
                 f'{cores[op][0]:.4f} on the CUDA cores; {pair[op][0]} '
                 f'multiply-adds a pair, minimum {pair[op][1]})'
                 for op in ms)
             + f'; plain {plain_ms:.3f} ms, scaled_dot_product_attention '
             f'backward {fmt_ms(lib_ms)} ({backend})')
    library = (f'scaled_dot_product_attention backward ({backend}; f32; '
               f'dq, dk, dv together)')
    plain = 'nonlocal_attention_bwd_reference (dq, dk, dv together)'
    result[f'{name} float32'] = {
        op: {'kernel': kernel, 'program': kernel,
             'max_abs_err': errs[0] if op == 'dq' else max(errs[1:]),
             'max_rel_err': rels[0] if op == 'dq' else max(rels[1:]),
             'ms': ms[op][0], 'plain_ms': plain_ms, 'plain': plain,
             'library_ms': lib_ms, 'library': library,
             'bound_ms': tc[op][0], 'bound_by': tc[op][1],
             'bound_rate': 'TF32 dense 495 TFLOP/s over 3 products',
             'bound_ms_cuda_cores': cores[op][0],
             'earlier_ms': ms[op][1],
             'earlier': 'mma.sync tf32x3 program, same run',
             'scalar_ms': ms[op][2], 'host_us': hosts[op][0],
             'earlier_host_us': hosts[op][1],
             'scalar_host_us': hosts[op][2],
             'max_rel_err_to_tf32x3': ab,
             'multiply_adds_per_pair': pair[op][0],
             'minimal_multiply_adds_per_pair': pair[op][1]}
        for op in ms}
    return line, max(older_rel.values())


def k1_done_line(na, torch):
    """K1's done line: K1-fwd, K1-dq and K1-dkv in bf16 at DONE_LINE_SHAPE
    on the narrow wgmma programs, held to the plain version computed in
    chunks of DONE_CHUNK queries in f32 (the backward's from the kernel's
    own out and lse; dk and dv summed over the chunks) at phase 3's and
    phase 5's tolerances, each timed beside SDPA; then the f32 kernels
    timed at the train shapes of layers 2 and 3 beside SDPA in f32, K1-fwd,
    K1-dq and K1-dkv (tf32_wgmma) beside the tf32x3 and scalar programs,
    each of the three forward programs held to the plain forward (and
    tf32_wgmma to tf32x3), each of the three backward programs to the
    plain backward. Returns the numbers."""
    b, n, nk, c, cv = DONE_LINE_SHAPE
    dt = torch.bfloat16
    g = torch.Generator(device='cuda').manual_seed(6)
    q = (torch.randn(b, n, c, device='cuda', generator=g) / c ** 0.25).to(dt)
    k = (torch.randn(b, nk, c, device='cuda', generator=g) / c ** 0.25).to(dt)
    v = torch.randn(b, nk, cv, device='cuda', generator=g).to(dt)
    do = torch.randn(b, n, cv, device='cuda', generator=g).to(dt)
    programs = {op: na._program(na.attention_kernel(dt, c, cv, op), c, cv)
                for op in na.OPS}
    check(set(programs.values()) == {'wgmma'},
          f'done line: K1 programs {programs}, expected wgmma')
    out, lse = na.nonlocal_attention_cuda(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    dq = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
    dk, dv = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    # the plain version, DONE_CHUNK queries at a time
    kf, vf = k.float(), v.float()
    want_dk = torch.zeros(b, nk, c, device='cuda')
    want_dv = torch.zeros(b, nk, cv, device='cuda')
    err = dict.fromkeys(('out', 'lse', 'dq'), 0.0)
    top = dict.fromkeys(('out', 'dq'), 0.0)
    for i in range(0, n, DONE_CHUNK):
        rows = slice(i, i + DONE_CHUNK)
        qc = q[:, rows].float()
        want, want_lse = na.nonlocal_attention_fwd_lse_reference(qc, kf, vf)
        err['out'] = max(err['out'],
                         (out[:, rows].float() - want).abs().max().item())
        err['lse'] = max(err['lse'],
                         (lse[:, rows] - want_lse).abs().max().item())
        top['out'] = max(top['out'], want.abs().max().item())
        del want, want_lse
        want_dq, dkc, dvc = na.nonlocal_attention_bwd_reference(
            qc, kf, vf, out[:, rows].float(), lse[:, rows],
            do[:, rows].float())
        err['dq'] = max(err['dq'],
                        (dq[:, rows].float() - want_dq).abs().max().item())
        top['dq'] = max(top['dq'], want_dq.abs().max().item())
        want_dk += dkc
        want_dv += dvc
        del want_dq, dkc, dvc
    rel = {'out': err['out'] / top['out'], 'dq': err['dq'] / top['dq'],
           'dk': rel_to_max(dk, want_dk), 'dv': rel_to_max(dv, want_dv)}
    del want_dk, want_dv
    tol, tol_lse = TOL['bfloat16']
    line = (f'done line bf16 B={b} N={n} Nk={nk} C={c} Cv={cv} [fwd, dq, dkv'
            f' {programs["fwd"]}], the plain version in chunks of '
            f'{DONE_CHUNK} queries: max|out-plain|={err["out"]:.3e} (tol '
            f'{tol:g}), /max|plain| {rel["out"]:.3e} (tol {TOL_REL_BF16:g}),'
            f' max|lse-plain|={err["lse"]:.3e} (tol {tol_lse:g}); '
            f'max|d-plain|/max|d| dq {rel["dq"]:.2e}, dk {rel["dk"]:.2e}, dv '
            f'{rel["dv"]:.2e} (tol {TOL_BWD["bfloat16"]:g})')
    print(line, flush=True)
    check(err['out'] <= tol and rel['out'] <= TOL_REL_BF16
          and err['lse'] <= tol_lse,
          f'done line: K1-fwd disagrees with the plain version: {line}')
    check(max(rel['dq'], rel['dk'], rel['dv']) <= TOL_BWD['bfloat16'],
          f'done line: K1-dq or K1-dkv disagrees with the plain backward: '
          f'{line}')
    result = {'shape': list(DONE_LINE_SHAPE), 'dtype': 'bfloat16',
              'programs': programs, 'chunk': DONE_CHUNK,
              'max_abs_err': err, 'max_rel_err': rel}
    bounds = attention_bounds(b, n, nk, c, cv, 'bfloat16')
    times = {
        'fwd': median_ms(lambda: na.nonlocal_attention_cuda(q, k, v), reps=5),
        'dq': median_ms(lambda: na.nonlocal_attention_bwd_dq_cuda(
            q, k, v, do, lse, delta), reps=5),
        'dkv': median_ms(lambda: na.nonlocal_attention_bwd_dkv_cuda(
            q, k, v, do, lse, delta), reps=5)}
    sdpa = {'fwd': sdpa_ms(torch, q, k, v), 'bwd': sdpa_ms(torch, q, k, v, do)}
    print('    ' + ', '.join(f'{op} {ms:.3f} ms (bound {bounds[op][0]:.3f}, '
                             f'{bounds[op][1]})' for op, ms in times.items())
          + f'; scaled_dot_product_attention {fmt_ms(sdpa["fwd"][0])} '
          f'({sdpa["fwd"][1]}), its backward {fmt_ms(sdpa["bwd"][0])} '
          f'({sdpa["bwd"][1]})', flush=True)
    result.update({'ms': times, 'bound_ms': {op: bd[0] for op, bd in
                                              bounds.items()},
                   'library_ms': {key: ms for key, (ms, _) in sdpa.items()},
                   'library': {key: f'scaled_dot_product_attention '
                                    f'({backend})'
                               for key, (_, backend) in sdpa.items()}})
    del q, k, v, do, out, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()

    # the f32 kernels at the train shapes
    result['float32'] = {}
    g = torch.Generator(device='cuda').manual_seed(7)
    for name in ('layer2', 'layer3'):
        b, n, nk, c, cv = TRAIN_SHAPES[name]
        q = torch.randn(b, n, c, device='cuda', generator=g) / c ** 0.25
        k = torch.randn(b, nk, c, device='cuda', generator=g) / c ** 0.25
        v = torch.randn(b, nk, cv, device='cuda', generator=g)
        do = torch.randn(b, n, cv, device='cuda', generator=g)
        out, lse = na.nonlocal_attention_cuda(q, k, v)
        delta = (do * out).sum(-1)
        programs = {op: na.attention_kernel(torch.float32, c, cv, op)
                    for op in na.OPS}
        times = {
            'fwd': median_ms(lambda: na.nonlocal_attention_cuda(q, k, v),
                             reps=3),
            'dq': median_ms(lambda: na.nonlocal_attention_bwd_dq_cuda(
                q, k, v, do, lse, delta), reps=3),
            'dkv': median_ms(lambda: na.nonlocal_attention_bwd_dkv_cuda(
                q, k, v, do, lse, delta), reps=3)}
        # each backward program held to the plain backward
        want = na.nonlocal_attention_bwd_reference(q, k, v, out, lse, do)
        rels = {}
        for program in (programs['dq'], 'tf32x3', 'scalar'):
            grads = (na._launch_dq(q, k, v, do, lse, delta, 1.0, program),
                     *na._launch_dkv(q, k, v, do, lse, delta, 1.0, program))
            rels[program] = max(rel_to_max(gr, w)
                                for gr, w in zip(grads, want))
            del grads
        del want
        check(max(rels.values()) <= TOL_BWD['float32'],
              f'done line f32 {name}: a backward program disagrees with the '
              f'plain backward: {rels}')
        # each forward program held to the plain forward, the dispatch's
        # also to tf32x3: max |out - ref|, max |lse - ref|
        want, want_lse = na.nonlocal_attention_fwd_lse_reference(q, k, v)
        fwd_errs = {}
        for program in (programs['fwd'], 'tf32x3', 'scalar'):
            o, lo = na._launch_fwd(q, k, v, 1.0, program)
            fwd_errs[program] = ((o - want).abs().max().item(),
                                 (lo - want_lse).abs().max().item())
            if program == 'tf32x3':
                fwd_errs[f'{programs["fwd"]} to tf32x3'] = (
                    (out - o).abs().max().item(),
                    (lse - lo).abs().max().item())
            del o, lo
        del want, want_lse
        tol, tol_lse = TOL['float32']
        check(all(e <= tol and el <= tol_lse
                  for e, el in fwd_errs.values()),
              f'done line f32 {name}: a forward program disagrees with the '
              f'plain forward or tf32x3: {fwd_errs}')
        # the older programs, same inputs: tf32x3 and scalar, which
        # tf32_wgmma replaced
        tf32x3 = {
            'fwd': median_ms(lambda: na._launch_fwd(q, k, v, 1.0, 'tf32x3'),
                             reps=3),
            'dq': median_ms(lambda: na._launch_dq(
                q, k, v, do, lse, delta, 1.0, 'tf32x3'), reps=3),
            'dkv': median_ms(lambda: na._launch_dkv(
                q, k, v, do, lse, delta, 1.0, 'tf32x3'), reps=3)}
        scalar = {
            'fwd': median_ms(lambda: na._launch_fwd(q, k, v, 1.0, 'scalar'),
                             reps=3),
            'dq': median_ms(lambda: na._launch_dq(
                q, k, v, do, lse, delta, 1.0, 'scalar'), reps=3),
            'dkv': median_ms(lambda: na._launch_dkv(
                q, k, v, do, lse, delta, 1.0, 'scalar'), reps=3)}
        plain = {
            'fwd': median_ms(lambda: na.nonlocal_attention_fwd_lse_reference(
                q, k, v), reps=3),
            'bwd': median_ms(lambda: na.nonlocal_attention_bwd_reference(
                q, k, v, out, lse, do), reps=3)}
        sdpa = {'fwd': sdpa_ms(torch, q, k, v),
                'bwd': sdpa_ms(torch, q, k, v, do)}
        # the tensor-core programs at the TF32 rate over 3 (the CUDA cores'
        # beside it), a scalar one on the CUDA cores
        cores = attention_bounds(b, n, nk, c, cv, 'float32')
        tc = attention_bounds(b, n, nk, c, cv, 'tf32x3')
        bounds = {op: tc[op] if programs[op] in TF32_PROGRAMS else cores[op]
                  for op in na.OPS}
        print(f'{name:10s} float32 B={b} N={n} Nk={nk} C={c} Cv={cv}: '
              + ', '.join(
                  f'{op} [{programs[op]}] {ms:.3f} ms (bound '
                  f'{bounds[op][0]:.3f}'
                  + (f' at the TF32 rate over 3, {cores[op][0]:.3f} on the '
                     f'CUDA cores; '
                     + (f'tf32x3 {tf32x3[op]:.3f} ms, ' if op in tf32x3
                        else '')
                     + f'scalar {scalar[op]:.3f} ms)'
                     if op in scalar else ' on the CUDA cores)')
                  for op, ms in times.items())
              + '; max|d-plain|/max|d| ' + ', '.join(
                  f'{pr} {r:.2e}' for pr, r in rels.items())
              + '; K1-fwd max|out-ref|, max|lse-ref| ' + ', '.join(
                  f'{pr} {e:.2e} / {el:.2e}'
                  for pr, (e, el) in fwd_errs.items())
              + f'; plain {plain["fwd"]:.3f} ms, its backward '
              f'{plain["bwd"]:.3f} ms; scaled_dot_product_attention '
              f'{fmt_ms(sdpa["fwd"][0])} ({sdpa["fwd"][1]}), its backward '
              f'{fmt_ms(sdpa["bwd"][0])} ({sdpa["bwd"][1]})', flush=True)
        result['float32'][name] = {
            'shape': [b, n, nk, c, cv], 'programs': programs, 'ms': times,
            'tf32x3_ms': tf32x3, 'scalar_ms': scalar, 'plain_ms': plain,
            'max_rel_err': rels, 'fwd_max_abs_err': fwd_errs,
            'bound_ms': {op: bd[0] for op, bd in bounds.items()},
            'bound_ms_cuda_cores': {op: bd[0] for op, bd in cores.items()},
            'library_ms': {key: ms for key, (ms, _) in sdpa.items()},
            'library': {key: f'scaled_dot_product_attention ({backend})'
                        for key, (_, backend) in sdpa.items()}}
        del q, k, v, do, out, lse, delta
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


def queued_ms(fn, torch, reps=20):
    """Device ms of one call of ``fn`` without its host time: ``reps``
    calls queued behind a sleep kernel of ~25 ms (longer than the host
    takes to queue them), one CUDA-event pair around them all. A pair
    around each call (``median_ms``) measures the wrapper's host time
    wherever the kernel is shorter than it."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)       # clock cycles
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


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


def forward_turns(models, x, torch, reps=5):
    """Median forward ms (CUDA events, ``reps`` each) of the models of
    ``models`` ({label: model}) on ``x``, in turns: a, b, b, a."""
    labels = list(models)
    times = {k: [] for k in labels}
    for k in labels + labels[::-1]:
        times[k].append(median_ms(lambda: models[k](x), reps=reps))
    return times


FORWARD_FAMILIES = {
    'convolution': CONV_KEYS, 'batch norm': ('batch_norm', 'bn_fw'),
    'pooling': ('pool',),
    'elementwise': ('elementwise', 'vectorized', 'unrolled')}
# phase 18 also splits cuDNN's NCHW <-> NHWC copies from the convolutions
ZOO_FAMILIES = {'layout copies': ('nchwtonhwc', 'nhwctonchw'),
                **FORWARD_FAMILIES}


def profile_forward(fn, torch, groups=None):
    """One forward under ``torch.profiler``: kernel ms, the device's idle
    share of the host window, and device time by family (``groups``, the
    first family whose keys a kernel's name holds; default
    ``FORWARD_FAMILIES``)."""
    window, by_name = device_times(fn, torch)
    busy = sum(by_name.values()) / 1e3
    if not busy:
        print('profiled forward: the profiler saw no device time (not '
              'measured)')
        return None
    idle = max(0.0, 1 - busy / window)
    print(f'profiled forward (torch.profiler): {window:.1f} ms host window, '
          f'{busy:.1f} ms of kernels, device idle {idle:.1%}', flush=True)
    families = print_families(by_name, busy, groups or FORWARD_FAMILIES)
    return {'window_ms': window, 'kernel_ms': busy, 'idle': idle,
            'families_ms': families}


def stem_profile(stems, torch):
    """Each stem of ``stems`` ({label: fn}) once under ``torch.profiler``
    in bf16 autocast: {label: (device ms, [(kernel, ms), ...] largest
    first)}, the stem's kernel time and what cuDNN picked for it."""
    out = {}
    for label, fn in stems.items():
        with torch.autocast('cuda', dtype=torch.bfloat16):
            fn()                                          # warm
            _, by_name = device_times(fn, torch)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        # None: the profiler saw no device time for it (not measured)
        out[label] = (sum(by_name.values()) / 1e3 or None,
                      [(name, us / 1e3) for name, us in top[:3]])
    return out


def stem_kernels(profiles):
    """The largest kernel of each stem's profile, or 'not measured' where
    the profiler saw no device time for it."""
    return {label: top[0][0] if top else 'not measured'
            for label, (_, top) in profiles.items()}


def print_stems(profiles):
    for label, (ms, top) in profiles.items():
        if ms is None:
            print(f'  stem {label}: the profiler saw no device time (not '
                  'measured)', flush=True)
            continue
        print(f'  stem {label}: {ms:.3f} ms of kernels (torch.profiler); '
              'largest: ' + '; '.join(f'{n[:70]} {t:.3f} ms'
                                      for n, t in top), flush=True)


def print_turns(times, nclips, what, unit='clips', reps=5):
    for k, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f'forward, bf16, {what}, {k}: '
              + ' / '.join(f'{t:.3f}' for t in ts)
              + f' ms (CUDA events, median of {reps}, two turns) = '
              f'{nclips / ms * 1e3:.2f} {unit}/s', flush=True)


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
    """Phase 6; returns the launch counts of the timed steps and the step's
    median ms by CUDA events."""
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
    return launches, by_kernel, layer3, step_dev


def train_f32_path(pretorched, na, torch, np, cli):
    """Phase 6b: phase 6's model, batch, SGD and ``remat=(0,)`` in f32 with
    TF32 off, through ``make_train_step``: steps in turns with the f32
    attention on the dispatch's choice (K1-fwd, K1-dq and K1-dkv on
    tf32_wgmma), with K1-fwd forced onto tf32x3, with all three forced onto
    tf32x3 and onto the scalar programs (the dispatch patched here,
    nothing in the package), each
    step's loss finite and its K1 launches by program checked; device time
    (CUDA events) and host time a step, median and spread of each program;
    peak memory; one profiled step of each, by kernel family, with K1's
    share and the device's idle share. Returns the numbers."""
    from pretorched_tpu_torch.parallel.train import (make_train_step,
                                                     sgd_step_decay)

    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, 'TF32 is on')
    model = pretorched.nonlocalresnet3d50(num_classes=400,
                                          pretrained='kinetics-400').cuda()
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          'the f32 model holds other parameters')
    opt, sched = sgd_step_decay(model.parameters(), lr=TRAIN_LR,
                                momentum=0.9, weight_decay=1e-4)
    step = make_train_step(model, opt, sched, remat=(0,))
    x, labels = train_batch(cli, model.settings, torch)
    check(x.dtype == torch.float32, f'batch {x.dtype}')
    dispatch = na.attention_kernel

    def forced(program):
        """The dispatch with the f32 attention on ``program`` ('fwd_tf32x3':
        K1-fwd on tf32x3, K1-dq and K1-dkv on the dispatch's choice)."""
        if program == 'tf32_wgmma':
            return dispatch

        def choose(dtype, c, cv, op):
            if dtype != torch.float32 or (program == 'fwd_tf32x3'
                                          and op != 'fwd'):
                return dispatch(dtype, c, cv, op)
            return 'tf32x3' if program == 'fwd_tf32x3' else program
        return choose

    times = {p: ([], []) for p in F32_TRAIN_KERNELS}   # (host s, device ms)

    def run(program, steps, timed=True):
        na.attention_kernel = forced(program)
        try:
            for _ in range(steps):
                before = kernel_counts(na)
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0 = time.perf_counter()
                e0.record()
                out = step(x, labels)
                e1.record()
                torch.cuda.synchronize()
                host = time.perf_counter() - t0
                after = kernel_counts(na)
                launched = {k: n - before.get(k, 0) for k, n in after.items()
                            if n - before.get(k, 0)}
                loss = out['loss'].item()
                check(np.isfinite(loss), f'f32 step ({program}): loss {loss}')
                check(launched == F32_TRAIN_KERNELS[program],
                      f'f32 step ({program}) launched {launched}, expected '
                      f'{F32_TRAIN_KERNELS[program]}')
                if timed:
                    times[program][0].append(host)
                    times[program][1].append(e0.elapsed_time(e1))
        finally:
            na.attention_kernel = dispatch
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_counts(na, 0)
    for program in F32_TRAIN_KERNELS:
        run(program, 1, timed=False)
    losses = [run(p, F32_TRAIN_STEPS) for p in F32_TRAIN_TURNS]
    launches = kernel_counts(na)
    steps = len(F32_TRAIN_KERNELS) + len(F32_TRAIN_TURNS) * F32_TRAIN_STEPS
    want = {}
    for program, per_step in F32_TRAIN_KERNELS.items():
        n_steps = 1 + F32_TRAIN_TURNS.count(program) * F32_TRAIN_STEPS
        for key, n in per_step.items():
            want[key] = want.get(key, 0) + n * n_steps
    check(launches == want, f'f32 train run: launches by program {launches}, '
          f'expected {want}')
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {'clips': TRAIN_CLIPS, 'steps_per_turn': F32_TRAIN_STEPS,
           'launches_by_kernel': launches, 'peak_gib': peak_gb,
           'losses': losses}
    print(f'nonlocalresnet3d50 in f32 (TF32 off), remat=(0,), SGD lr '
          f'{TRAIN_LR:g}; {TRAIN_CLIPS} clips x 32 x 224 x 224 a step; '
          f'turns {", ".join(F32_TRAIN_TURNS)} of {F32_TRAIN_STEPS} steps '
          f'after a warm step of each (fwd_tf32x3: K1-fwd forced onto '
          f'tf32x3); launches by program in {steps} steps '
          f'{launches}; peak device memory {peak_gb:.2f} GiB; losses at the '
          f'turns\' ends {", ".join(f"{v:.4f}" for v in losses)}',
          flush=True)
    for program, (host, dev) in times.items():
        med = lambda v: sorted(v)[len(v) // 2]   # noqa: E731
        out[program] = {'device_ms': med(dev), 'device_ms_range':
                        [min(dev), max(dev)], 'host_ms': med(host) * 1e3,
                        'host_ms_range': [min(host) * 1e3, max(host) * 1e3],
                        'clips_per_s': TRAIN_CLIPS / med(dev) * 1e3}
        print(f'f32 step, K1 on {program}: {med(dev):.1f} ms '
              f'CUDA events (steps {min(dev):.1f}-{max(dev):.1f}), '
              f'{med(host) * 1e3:.1f} ms host clock around synchronize '
              f'({min(host) * 1e3:.1f}-{max(host) * 1e3:.1f}), medians of '
              f'{len(dev)} = {TRAIN_CLIPS / med(dev) * 1e3:.2f} train '
              f'clips/s', flush=True)
    for program in F32_TRAIN_KERNELS:
        na.attention_kernel = forced(program)
        try:
            window, by_name = device_times(lambda: step(x, labels), torch)
        finally:
            na.attention_kernel = dispatch
        busy = sum(by_name.values()) / 1e3
        if not busy:
            print(f'profiled f32 step ({program}): the profiler saw no '
                  'device time (not measured)')
            continue
        k1 = {key: sum(us for name, us in by_name.items() if key in name)
              / 1e3 for key in ('nonlocal_attention_fwd',
                                'nonlocal_attention_bwd', 'tf32_split')}
        idle = max(0.0, 1 - busy / window)
        ran = {key.split()[0]: key.split()[1]
               for key in F32_TRAIN_KERNELS[program]}
        print(f'profiled f32 step ({program}; torch.profiler): {window:.1f} '
              f'ms host window, {busy:.1f} ms of kernels, device idle '
              f'{idle:.1%}; K1 {sum(k1.values()):.1f} ms '
              f'({sum(k1.values()) / busy:.1%}): K1-fwd ({ran["fwd"]}) '
              f'{k1["nonlocal_attention_fwd"]:.1f} ms, K1-dq + K1-dkv '
              f'({ran["dq"]}) {k1["nonlocal_attention_bwd"]:.1f} ms, the '
              f'tf32_wgmma programs\' pre-passes (tf32_split_kernel, both '
              f'directions) {k1["tf32_split"]:.1f} ms', flush=True)
        families = print_families(by_name, busy, {
            'attention': ('nonlocal_attention', 'tf32_split'),
            'convolution': CONV_KEYS,
            'batch norm': ('batch_norm', 'bn_fw', 'bn_bw'),
            'optimizer': ('multi_tensor', 'foreach')})
        out[program].update({
            'profile': {'window_ms': window, 'kernel_ms': busy, 'idle': idle,
                        'k1_fwd_ms': k1['nonlocal_attention_fwd'],
                        'k1_bwd_ms': k1['nonlocal_attention_bwd'],
                        'k1_split_ms': k1['tf32_split'],
                        'k1_share': sum(k1.values()) / busy,
                        'families_ms': families}})
    del model, opt, sched, step, x
    torch.cuda.empty_cache()
    return out


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
                    host_op = host_us(lambda: fb.fused_bottleneck_tail(
                        y1, x, *blk.tail_weights()))
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
                         f'(through the operator pretorched::fused_'
                         f'bottleneck_tail {host_op:.1f} us; with the '
                         f'block\'s kept layout {host_kept:.1f} us); plain '
                         f'{plain_ms:.4f} ms, unfused tail '
                         f'(several cuDNN and PyTorch calls) {lib_ms:.4f} ms '
                         f'(max|unfused-plain|/max|plain| {lib_err:.2e}), '
                         f'bound {bound_ms:.4f} ms ({bound_by})'
                         + (f'; {K2_SLICE[name]} launches a forward'
                            if name in K2_SLICE else ''))
                rows[name] = {
                    'kernel': kernel, 'max_abs_err': err, 'max_rel_err': rel,
                    'ms': ms, 'earlier_ms': earlier_ms, 'call_ms': call_ms,
                    'host_us': host_kept, 'host_us_with_fold': host_fold,
                    'host_us_operator': host_op,
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
    from pretorched_tpu_torch.models import slowfast
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
    # the same weights with both stems folded (fast: fold 4, slow: fold 2)
    folded = slowfast.SlowFast(num_classes=400, s2d_stem=True,
                               fused_blocks=32).cuda().eval().bfloat16()
    folded.load_state_dict(model.state_dict(), strict=True)
    step = multi_clip_eval_step(model)
    videos, _ = cli.list_videos(root)
    check(len(videos) == 4, f'{len(videos)} videos')

    def batch_of(pair):
        return torch.stack([cli.load_video(frames, SF_CLIPS, SF_FRAMES,
                                           CLI_SETTINGS, 'cuda')
                            for frames, _ in pair])

    torch.cuda.synchronize()
    set_counts(na, 0)
    reset_k2(fb_cuda)
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
        s2d_times = forward_turns({'s2d_stem=False': model,
                                   's2d_stem=True': folded}, batch, torch)
        print_turns(s2d_times, nclips, f'fused_blocks=32, {nclips} clips')
        reset_k2(fb_cuda)
        folded(batch)
        torch.cuda.synchronize()
        k2_s2d = dict(fb_cuda.fused_bottleneck_tail_cuda.by_kernel)
        print(f'K2 launches by kernel, s2d_stem=True: {k2_s2d}', flush=True)
        check(k2_s2d == {'tma': 6, 'mma_sync': 5, 'cuda_cores': 0},
              f'the s2d forward launched K2 {k2_s2d}')
        fast_x, slow_x = batch[:, :, ::2], batch[:, :, ::16]
        check(folded.fast.conv1.fold == 4 and fast_x.shape[-1] % 4 == 0,
              'the fast stem is not on fold 4')
        prof = stem_profile({
            'fast plain': lambda: model.fast.conv1(fast_x),
            'fast folded (fold 4)': lambda: folded.fast.conv1(fast_x),
            'slow plain': lambda: model.slow.conv1(slow_x),
            'slow folded (fold 2)': lambda: folded.slow.conv1(slow_x)},
            torch)
        print_stems(prof)
        s2d = {'forward_ms': {k: sum(v) / len(v)
                              for k, v in s2d_times.items()},
               'stem_ms': {k: v[0] for k, v in prof.items()},
               'stem_kernels': stem_kernels(prof),
               'k2_launches': sum(k2_s2d.values())}
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
        s2d['rel_l2_f32'] = rel_l2(folded.float()(batch32), logits_k)
        print(f'f32 logits, s2d stems vs plain stems (fused_blocks=32 '
              f'both): rel L2 {s2d["rel_l2_f32"]:.3e} (tol {TOL_S2D:g}, '
              'TF32 off)')
        check(s2d['rel_l2_f32'] <= TOL_S2D, 'the folded stems change the '
              f'f32 logits: rel L2 {s2d["rel_l2_f32"]:.3e}')
        del model, folded
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
    return launched[3], k2_by_kernel, s2d


def reset_k2(fb_cuda):
    fb_cuda.fused_bottleneck_tail_cuda.launches = 0
    fb_cuda.fused_bottleneck_tail_cuda.by_kernel = dict.fromkeys(
        fb_cuda.KERNELS, 0)


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


def video_models_path(pretorched, torch, na, fb_cuda):
    """Phase 11: ``r2plus1d50`` (the JAX bench's row 5: 20 clips x 16
    frames x 112 px, 400 classes, seeded, every BN randomized) with the
    plain and the folded factored stem on the same weights in turns: bf16
    clips/s, peak memory, the stems' kernels, f32 logits held together;
    then one bf16 forward of each of BASELINE config 4's other new
    backbones on the same clips, held to its f32 forward. None launches K1
    or K2. Returns the numbers for the result line."""
    from pretorched_tpu_torch.models.resnet3d import VideoResNet

    g = torch.Generator(device='cuda').manual_seed(0)
    x = torch.randn(*R2P1D_CLIPS, device='cuda', generator=g)
    model = pretorched.r2plus1d50(num_classes=400, pretrained=None)
    randomize_bn(model, torch, seed=1)
    folded = VideoResNet('bottleneck', (3, 4, 6, 3), num_classes=400,
                         factored=True, s2d_stem=True)
    folded.load_state_dict(model.state_dict(), strict=True)
    out = {}
    set_counts(na, 0)
    reset_k2(fb_cuda)
    with torch.inference_mode():
        for m in (model, folded):
            m.cuda().eval().bfloat16()
        nclips = x.shape[0]
        times = forward_turns({'s2d_stem=False': model,
                               's2d_stem=True': folded}, x, torch, reps=10)
        print_turns(times, nclips, f'r2plus1d50, {nclips} clips x 16 x 112',
                    reps=10)
        out['r2plus1d50_profile'] = profile_forward(lambda: model(x), torch)
        peak = {}
        for label, m in (('s2d_stem=False', model), ('s2d_stem=True',
                                                     folded)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            logits = m(x)
            torch.cuda.synchronize()
            peak[label] = torch.cuda.max_memory_allocated() / 2 ** 30
            check(logits.shape == (nclips, 400)
                  and bool(torch.isfinite(logits).all()),
                  f'r2plus1d50 {label}: bf16 logits not finite')
        print(f'peak device memory of one forward: {peak}', flush=True)
        prof = stem_profile({
            'factored plain': lambda: model.conv1(x),
            'factored folded': lambda: folded.conv1(x),
            'spatial half plain': lambda: model.conv1.spatial_conv(x),
            'spatial half folded': lambda: folded.conv1.spatial_conv(x)},
            torch)
        print_stems(prof)
        rel = rel_l2(folded.float()(x), model.float()(x))
        print(f'f32 logits, s2d stem vs plain stem: rel L2 {rel:.3e} (tol '
              f'{TOL_S2D:g}, TF32 off)', flush=True)
        check(rel <= TOL_S2D, f'r2plus1d50: the folded stem changes the f32 '
              f'logits: rel L2 {rel:.3e}')
        out['r2plus1d50'] = {
            'forward_ms': {k: sum(v) / len(v) for k, v in times.items()},
            'clips_per_s': {k: nclips / (sum(v) / len(v)) * 1e3
                            for k, v in times.items()},
            'peak_gib': peak, 'rel_l2_f32': rel,
            'stem_ms': {k: v[0] for k, v in prof.items()},
            'stem_kernels': stem_kernels(prof)}
        del model, folded
        torch.cuda.empty_cache()
        for name in ('resnext3d101', 'preact_resnet3d50', 'wideresnet3d50',
                     'resneti3d50'):
            m = pretorched.__dict__[name](num_classes=400, pretrained=None)
            randomize_bn(m, torch, seed=2)
            m.cuda().eval().bfloat16()
            ms = median_ms(lambda: m(x), reps=3)
            got = m(x).float()
            want = m.float()(x)
            rel = rel_l2(got, want)
            print(f'{name}: bf16 forward of {nclips} clips x 16 x 112 '
                  f'{ms:.3f} ms (CUDA events, median of 3) = '
                  f'{nclips / ms * 1e3:.2f} clips/s; bf16 vs f32 logits rel '
                  f'L2 {rel:.3e} (tol {TOL_LOGITS_BF16:g})', flush=True)
            check(bool(torch.isfinite(got).all()) and rel <= TOL_LOGITS_BF16,
                  f'{name}: bf16 logits off the f32 ones: rel L2 {rel:.3e}')
            out[name] = {'forward_ms': ms, 'rel_l2_bf16_f32': rel}
            del m, got, want
            torch.cuda.empty_cache()
    launched = k_counts(na, fb_cuda)
    check(launched == (0, 0, 0, 0), f'phase 11 launched K1 / K2 {launched}')
    return out


def trn_path(pretorched, torch):
    """Phase 12: ``trn`` (MSTRN over ``resnet50``, 8 segments x 224 px, the
    JAX bench's row 10 at 8 videos = 64 backbone frames), seeded, every BN
    randomized, bf16: videos/s by CUDA events, the backbone's first conv
    seen computing in bf16, the logits held to the f32 forward, and the
    generator path's draw repeated from its seed."""
    model = pretorched.trn(num_classes=400, num_segments=8,
                           consensus='MSTRN', arch='resnet50')
    randomize_bn(model, torch, seed=3)
    model.cuda().eval().bfloat16()
    g = torch.Generator(device='cuda').manual_seed(0)
    x = torch.randn(*TRN_VIDEOS, device='cuda', generator=g)
    seen = []
    hook = model.base_module.conv1.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    with torch.inference_mode():
        logits = model(x).float()
        hook.remove()
        check(seen == [torch.bfloat16], f'the backbone computed in {seen}')
        ms = median_ms(lambda: model(x), reps=10)
        videos = x.shape[0]
        print(f'trn (MSTRN, resnet50), bf16, {videos} videos x 8 segments x '
              f'224 px: {ms:.3f} ms (CUDA events, median of 10) = '
              f'{videos / ms * 1e3:.2f} videos/s; the backbone conv1 ran in '
              f'{seen[0]}', flush=True)
        draws = [model(x, torch.Generator(device='cuda').manual_seed(5))
                 for _ in range(2)]
        check(torch.equal(draws[0], draws[1]),
              'MSTRN draws differ from one seed')
        prof = profile_forward(lambda: model(x), torch)
        want = model.float()(x)
        rel = rel_l2(logits, want)
        print(f'bf16 vs f32 logits: rel L2 {rel:.3e} (tol '
              f'{TOL_LOGITS_BF16:g}); the generator path repeats from its '
              'seed', flush=True)
        check(logits.shape == (videos, 400)
              and bool(torch.isfinite(logits).all())
              and rel <= TOL_LOGITS_BF16,
              f'trn: bf16 logits off the f32 ones: rel L2 {rel:.3e}')
    return {'forward_ms': ms, 'videos_per_s': videos / ms * 1e3,
            'rel_l2_bf16_f32': rel, 'profile': prof}


def mnist_path(na, torch):
    """Phase 13: ``MNISTNonLocalNet`` on 64 seeded 28 x 28 images, every BN
    randomized (its blocks' ``W.1`` included): a bf16 forward (K1-fwd on
    wgmma, C = 16 and 32 padded to 64) and an f32 one (tf32_wgmma, padded to
    32 by its pre-pass), each with the counts set to 0 just before it: 2
    K1-fwd launches, each launch's out and lse held to the plain version at
    phase 3's tolerances (the f32 ones also to tf32x3 on the same inputs,
    both timed queued); the f32 logits with the kernels against the plain
    attention; zeroing each
    ``W.1`` moves them; the bf16 launches timed against the plain version,
    SDPA, the bound and the mma.sync program that wgmma replaced there (held
    to the plain version too). Returns the numbers for the result line."""
    from pretorched_tpu_torch.models import nonlocalnet

    model = nonlocalnet.MNISTNonLocalNet()
    randomize_bn(model, torch, seed=4)
    model.cuda().eval()
    g = torch.Generator(device='cuda').manual_seed(0)
    x = torch.randn(64, 1, 28, 28, device='cuda', generator=g)
    orig = nonlocalnet.auto_nonlocal_attention
    runs = {}
    with torch.inference_mode():
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split('.')[-1]
            calls = []

            def recording(q, k, v, scale=1.0):
                out, lse = na.nonlocal_attention_fwd_lse(q, k, v, scale)
                calls.append((q, k, v, out, lse))
                return out

            nonlocalnet.auto_nonlocal_attention = recording
            set_counts(na, 0)
            try:
                with torch.autocast('cuda', dtype=torch.bfloat16,
                                    enabled=dt == torch.bfloat16):
                    logits = model(x).float()
                torch.cuda.synchronize()
            finally:
                nonlocalnet.auto_nonlocal_attention = orig
            by_kernel = kernel_counts(na)
            kernel = na.attention_kernel(dt, 16, 16, 'fwd')
            check(kernel == ('wgmma' if dt == torch.bfloat16
                             else 'tf32_wgmma'),
                  f'MNIST {dname}: K1-fwd on {kernel}')
            check(na.nonlocal_attention_cuda.launches == 2
                  and by_kernel == {f'fwd {kernel}': 2},
                  f'MNIST {dname}: K1-fwd launches {by_kernel}, expected 2 '
                  f'on {kernel}')
            check(bool(torch.isfinite(logits).all()),
                  f'MNIST {dname}: logits not finite')
            rows = []
            for q, k, v, out, lse in calls:
                check(q.dtype == dt, f'MNIST {dname}: q is {q.dtype}')
                want, want_lse = na.nonlocal_attention_fwd_lse_reference(
                    q.float(), k.float(), v.float())
                err, err_rel, err_lse = fwd_errors(out, lse, want, want_lse)
                tol, tol_lse = TOL[dname]
                tol_rel = (TOL_REL_BF16 if dt == torch.bfloat16
                           else float('inf'))
                shape = (q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                         v.shape[2])
                line = (f'MNIST {dname} K1-fwd {shape} [{kernel}]: '
                        f'max|out-plain|={err:.3e} (tol {tol:g}), /max|plain| '
                        f'{err_rel:.3e} (tol {tol_rel:g}), max|lse-plain|='
                        f'{err_lse:.3e} (tol {tol_lse:g})')
                ab = (0.0, 0.0)
                if dt == torch.float32:
                    # the program it replaced, same inputs
                    out_x, lse_x = na._launch_fwd(q, k, v, 1.0, 'tf32x3')
                    errs_x = fwd_errors(out_x, lse_x, want, want_lse)
                    ab = ((out_x - out).abs().max().item(),
                          (lse_x - lse).abs().max().item())
                    device = (queued_ms(lambda: na.nonlocal_attention_cuda(
                                  q, k, v), torch),
                              queued_ms(lambda: na._launch_fwd(
                                  q, k, v, 1.0, 'tf32x3'), torch))
                    line += (f'; tf32x3 max|out-plain|={errs_x[0]:.3e}, '
                             f'max|lse-plain|={errs_x[2]:.3e}, max|{kernel}-'
                             f'tf32x3| out {ab[0]:.3e}, lse {ab[1]:.3e}; '
                             f'queued (device time) {device[0]:.4f} ms '
                             f'({kernel}), {device[1]:.4f} ms (tf32x3)')
                    ab = (max(ab[0], errs_x[0]), max(ab[1], errs_x[2]))
                    del out_x, lse_x
                print(line, flush=True)
                check(err <= tol and err_rel <= tol_rel
                      and err_lse <= tol_lse and ab[0] <= tol
                      and ab[1] <= tol_lse,
                      f'kernel disagrees with the plain version or '
                      f'tf32x3: {line}')
                rows.append((shape, q, k, v, err))
            runs[dname] = {'logits': logits, 'rows': rows,
                           'by_kernel': {kernel: 2}}
        nonlocalnet.auto_nonlocal_attention = na.nonlocal_attention_reference
        try:
            plain = model(x)
        finally:
            nonlocalnet.auto_nonlocal_attention = orig
        rel = rel_l2(runs['float32']['logits'], plain)
        print(f'f32 logits, kernels vs plain attention: rel L2 {rel:.3e} '
              f'(tol 1e-3); bf16 vs f32-plain: rel L2 '
              f'{rel_l2(runs["bfloat16"]["logits"], plain):.3e}', flush=True)
        check(rel <= 1e-3, f'MNIST: kernel and plain paths disagree: {rel}')
        for name in ('nonlocal1', 'nonlocal2'):
            block = getattr(model, name)
            scale = block.W[1].weight.clone()
            block.W[1].weight.zero_()
            moved = rel_l2(model(x), plain)
            block.W[1].weight.copy_(scale)
            print(f'zeroing {name}.W.1 moves the f32 logits by rel L2 '
                  f'{moved:.3e}')
            check(moved > 1e-3, f'the logits do not depend on {name}')
        timed = {}
        for shape, q, k, v, err in runs['bfloat16']['rows']:
            want, want_lse = na.nonlocal_attention_fwd_lse_reference(
                q.float(), k.float(), v.float())
            out_m, lse_m = na._launch_fwd(q, k, v, 1.0, 'mma_sync')
            errs_m = fwd_errors(out_m, lse_m, want, want_lse)
            print(f'MNIST bf16 K1-fwd {shape}, the mma.sync program wgmma '
                  f'replaced: max|out-plain|={errs_m[0]:.3e}, /max|plain| '
                  f'{errs_m[1]:.3e}, max|lse-plain|={errs_m[2]:.3e}',
                  flush=True)
            check(errs_m[0] <= TOL['bfloat16'][0] and errs_m[1] <= TOL_REL_BF16
                  and errs_m[2] <= TOL['bfloat16'][1],
                  f'MNIST: the mma.sync program disagrees at {shape}: '
                  f'{errs_m}')
            del want, want_lse, out_m, lse_m
            earlier_ms = median_ms(lambda: na._launch_fwd(q, k, v, 1.0,
                                                          'mma_sync'))
            ms = median_ms(lambda: na.nonlocal_attention_cuda(q, k, v))
            device = (queued_ms(
                          lambda: na.nonlocal_attention_cuda(q, k, v), torch),
                      queued_ms(
                          lambda: na._launch_fwd(q, k, v, 1.0, 'mma_sync'),
                          torch))
            plain_ms = median_ms(
                lambda: na.nonlocal_attention_fwd_lse_reference(q, k, v))
            lib_ms, backend = sdpa_ms(torch, q, k, v)
            bound_ms, bound_by = attention_bounds(*shape, 'bfloat16')['fwd']
            print(f'MNIST bf16 K1-fwd {shape}: kernel {ms:.4f} ms, the '
                  f'mma.sync program {earlier_ms:.4f} ms, plain '
                  f'{plain_ms:.4f} ms, scaled_dot_product_attention '
                  f'{fmt_ms(lib_ms)} ({backend}), bound {bound_ms:.5f} ms '
                  f'({bound_by}); queued (device time) {device[0]:.4f} ms '
                  f'(wgmma), {device[1]:.4f} ms (mma.sync)', flush=True)
            timed[shape] = {'max_abs_err': err, 'ms': ms,
                            'plain_ms': plain_ms, 'library_ms': lib_ms,
                            'library': f'scaled_dot_product_attention '
                                       f'({backend})',
                            'bound_ms': bound_ms, 'bound_by': bound_by,
                            'earlier_ms': earlier_ms,
                            'earlier': 'mma.sync program, same run',
                            'earlier_max_abs_err': errs_m[0],
                            'device_ms': device[0],
                            'earlier_device_ms': device[1]}
    check(set(timed) == set(MNIST_SHAPES), f'MNIST shapes {list(timed)}')
    return {'timed': timed,
            'launches_by_kernel': {k: v['by_kernel'] for k, v in runs.items()}}


def fabricate_imagenet(pretorched, torch, np):
    """Phase 14's hosted ``imagenet`` files (seeded init, every BN
    randomized, the reference key layout; ``nasnetalarge``'s with its 1001
    classes) and an image folder of smooth random JPEGs at sizes around
    500 x 375: 8 classes x 32 in ``train/`` and in ``val/``."""
    from PIL import Image

    for seed, (name, classes) in enumerate(IMAGENET_MODELS.items()):
        donor = pretorched.__dict__[name](num_classes=classes,
                                          pretrained=None)
        randomize_bn(donor, torch, seed=10 + seed)
        url = pretorched.pretrained_settings[name]['imagenet']['url']
        torch.save(donor.state_dict(),
                   WORK / 'zoo' / 'weights' / url.rsplit('/', 1)[-1])
        del donor
    rng = np.random.RandomState(1)
    for split in ('train', 'val'):
        for c in range(IMAGENET_CLASSES):
            d = WORK / 'imagenet' / split / f'n{c:08d}'
            d.mkdir(parents=True)
            for i in range(IMAGENET_PER_CLASS):
                h, w = IMAGENET_SIZES[(c + i) % len(IMAGENET_SIZES)]
                small = rng.randint(0, 256, (h // 25, w // 25, 3))
                Image.fromarray(small.astype(np.uint8)).resize(
                    (w, h), Image.BILINEAR).save(d / f'{i:04d}.jpg',
                                                 quality=90)


def val_batch(settings, torch, np):
    """Every val image through the fast pipeline at ``settings``' size,
    f32, NCHW on the card, with the labels."""
    from pretorched_tpu_torch.datasets.folder import fast_eval_batches

    batches = list(fast_eval_batches(str(WORK / 'imagenet' / 'val'),
                                     settings, IMAGENET_BATCH,
                                     channels_last=False, device='cuda'))
    return (torch.cat([b for b, _ in batches]),
            torch.from_numpy(np.concatenate([lab for _, lab in batches]))
            .cuda())


def captured_input(model, module, x):
    """The input ``module`` sees in ``model(x)``."""
    seen = []
    hook = module.register_forward_hook(lambda m, i, o: seen.append(i[0]))
    try:
        model(x)
    finally:
        hook.remove()
    return seen[0]


def conv_kernels(convs, torch, reps=5):
    """Each conv of ``convs`` ({label: fn}) in bf16 autocast: its time by
    CUDA events (median of 20) and, from ``reps`` calls under
    ``torch.profiler``, each kernel it launched with its time a call."""
    out = {}
    for label, fn in convs.items():
        with torch.autocast('cuda', dtype=torch.bfloat16):
            ms = median_ms(fn)
            _, by_name = device_times(lambda: [fn() for _ in range(reps)],
                                      torch)
        kernels = sorted(((name, us / 1e3 / reps)
                          for name, us in by_name.items()),
                         key=lambda kv: -kv[1])
        print(f'  {label}: {ms:.3f} ms (CUDA events); kernels a call '
              '(torch.profiler): ' + ('; '.join(
                  f'{n[:100]} {t:.3f} ms' for n, t in kernels)
                  or 'none seen (not measured)'), flush=True)
        out[label] = {'ms': ms, 'kernels': kernels}
    return out


def imagenet_forward(model, x, torch, what, profile=True, groups=None):
    """bf16 forward of ``model`` on ``x``: images/s by CUDA events (median
    of 5), peak memory, with ``profile`` the profiled forward by family
    (``groups``: profile_forward's); returns the bf16 logits and the
    numbers."""
    model.bfloat16()
    ms = median_ms(lambda: model(x), reps=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits = model(x).float()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = x.shape[0]
    print(f'{what}: bf16 forward of {n} images x {x.shape[-1]} px '
          f'{ms:.3f} ms (CUDA events, median of 5) = {n / ms * 1e3:.2f} '
          f'images/s; peak device memory {peak:.2f} GiB', flush=True)
    check(bool(torch.isfinite(logits).all()), f'{what}: logits not finite')
    return logits, {'forward_ms': ms, 'images_per_s': n / ms * 1e3,
                    'peak_gib': peak,
                    'profile': profile_forward(lambda: model(x), torch,
                                               groups) if profile else None}


def imagenet_path(pretorched, torch, np, na, fb_cuda):
    """Phase 14: BASELINE config 2 (``se_resnext101_32x4d``,
    ``nasnetamobile``) through ``examples/imagenet_eval_torch.py`` in this
    process, on fabricated hosted files and JPEGs: ``-e --bf16 -b 256``
    with the PIL pipeline, ``--fast-pipeline`` and ``--ten-crop``; the bf16
    forwards timed and profiled, with the kernels cuDNN takes for a grouped
    and a depthwise conv; the CLI's f32 eval step against a direct forward,
    bf16 against f32, ``ten_crop``'s shape and center crop;
    ``nasnetalarge`` loaded with its background row dropped and run at 331
    px; 4 train steps at ``-b 64``, the checkpoint and its ``.meta``, an
    eval of the checkpoint, 8 more steps from it (``--resume``), and the
    train step timed by CUDA events and host clock. No K1 or K2 launch.
    Returns the numbers for the result line."""
    from pretorched_tpu_torch.parallel.evaluate import make_eval_step
    from pretorched_tpu_torch.parallel.train import (make_train_step,
                                                     sgd_step_decay)
    from pretorched_tpu_torch.transforms.fused import ten_crop

    cli = load_cli('imagenet_eval_torch')
    t0 = time.perf_counter()
    fabricate_imagenet(pretorched, torch, np)
    n_val = IMAGENET_CLASSES * IMAGENET_PER_CLASS
    print(f'fabricated {len(IMAGENET_MODELS)} hosted checkpoints and '
          f'{2 * n_val} JPEGs in {time.perf_counter() - t0:.1f} s', flush=True)
    data = str(WORK / 'imagenet')
    out = {'cli': {}}
    set_counts(na, 0)
    reset_k2(fb_cuda)
    for arch, extra in (('se_resnext101_32x4d', []),
                        ('se_resnext101_32x4d', ['--fast-pipeline']),
                        ('se_resnext101_32x4d', ['--ten-crop']),
                        ('nasnetamobile', [])):
        argv = [data, '-a', arch, '-e', '--bf16', '-b', str(IMAGENET_BATCH),
                '-p', '1', '--device', 'cuda'] + extra
        print('examples/imagenet_eval_torch.py ' + ' '.join(argv[1:]),
              flush=True)
        summary = cli.main(argv)
        label = ' '.join([arch] + extra)
        totals = summary['totals']
        rate = totals['count'] / summary['seconds']
        print(f'{label}: {totals["count"]:.0f} images in '
              f'{summary["seconds"]:.3f} s = {rate:.2f} images/s (JPEG '
              'decode + preprocess + forward, host clock, the first run)',
              flush=True)
        check(totals['count'] == n_val and np.isfinite(totals['loss']),
              f'{label}: bad totals {totals}')
        out['cli'][label] = {'images_per_s_path': rate,
                             'seconds': summary['seconds']}

    with torch.inference_mode():
        model = pretorched.se_resnext101_32x4d().cuda().eval()
        x, labels = val_batch(model.settings, torch, np)
        check(x.shape == (n_val, 3, 224, 224), f'val batch {tuple(x.shape)}')
        logits_bf16, out['se_resnext101_32x4d'] = imagenet_forward(
            model, x, torch, 'se_resnext101_32x4d')
        grouped = model.layer3[0].conv2
        grouped_in = captured_input(model, grouped, x)
        model.float()
        seen = []
        hook = model.register_forward_hook(lambda m, i, o: seen.append(o))
        metrics = make_eval_step(model)(x, labels)
        hook.remove()
        direct = model(x)
        step_err = (seen[0] - direct).abs().max().item()
        rel = rel_l2(logits_bf16, direct)
        print(f'f32 logits of the eval step vs a direct forward: max |diff| '
              f'{step_err:.3e} (tol 0); bf16 vs f32 logits rel L2 {rel:.3e} '
              f'(tol {TOL_LOGITS_BF16:g}); step {float(metrics["count"]):.0f} '
              'images', flush=True)
        check(step_err == 0 and float(metrics['count']) == n_val,
              "the eval step's logits differ from the direct forward")
        check(bool(torch.isfinite(direct).all()) and rel <= TOL_LOGITS_BF16,
              f'se_resnext101_32x4d: bf16 logits off the f32 ones: {rel}')
        out['se_resnext101_32x4d']['rel_l2_bf16_f32'] = rel
        del model, direct, logits_bf16, seen

        mobile = pretorched.nasnetamobile().cuda().eval()
        logits_m, out['nasnetamobile'] = imagenet_forward(
            mobile, x, torch, 'nasnetamobile')
        depthwise = mobile.cell_0.comb_iter_0_left.separable_1.depthwise_conv2d
        depthwise_in = captured_input(mobile, depthwise, x)
        rel = rel_l2(logits_m, mobile.float()(x))
        print(f'nasnetamobile: bf16 vs f32 logits rel L2 {rel:.3e} (tol '
              f'{TOL_LOGITS_BF16:g})', flush=True)
        check(rel <= TOL_LOGITS_BF16, f'nasnetamobile: bf16 logits off: {rel}')
        out['nasnetamobile']['rel_l2_bf16_f32'] = rel
        out['conv_kernels'] = conv_kernels({
            'grouped 3x3 conv, 32 groups, 512 channels, stride 2 (se_resnext'
            '101 layer3.0.conv2)': lambda: grouped(grouped_in),
            'depthwise 5x5 conv, 44 channels (nasnetamobile cell_0)':
                lambda: depthwise(depthwise_in)}, torch)
        del mobile, grouped_in, depthwise_in

        # the CLI's 10-crop input: the 256 px square resize, channels last
        square = torch.randn(8, 256, 256, 3, device='cuda')
        crops = ten_crop(square, 224)
        check(crops.shape == (8, 10, 224, 224, 3) and torch.equal(
            crops[:, 4], square[:, 16:240, 16:240]),
            f'ten_crop: shape {tuple(crops.shape)} or its center crop')
        del x, labels, crops, square

        large = pretorched.nasnetalarge().cuda().eval()
        url = pretorched.pretrained_settings['nasnetalarge']['imagenet']['url']
        hosted = torch.load(WORK / 'zoo' / 'weights' / url.rsplit('/', 1)[-1],
                            map_location='cuda', weights_only=True)
        check(large.last_linear.weight.shape[0] == 1000 and torch.equal(
            large.last_linear.weight, hosted['last_linear.weight'][1:]),
            'nasnetalarge: the background row was not dropped')
        del hosted
        x331, _ = val_batch(large.settings, torch, np)
        x331 = x331[:LARGE_BATCH]
        check(x331.shape[-1] == 331, f'nasnetalarge input {tuple(x331.shape)}')
        logits_l, out['nasnetalarge'] = imagenet_forward(
            large, x331, torch, 'nasnetalarge (imagenet, background row '
            'dropped)')
        rel = rel_l2(logits_l, large.float()(x331))
        print(f'nasnetalarge: bf16 vs f32 logits rel L2 {rel:.3e} (tol '
              f'{TOL_LOGITS_BF16:g})', flush=True)
        check(rel <= TOL_LOGITS_BF16, f'nasnetalarge: bf16 logits off: {rel}')
        out['nasnetalarge']['rel_l2_bf16_f32'] = rel
        del large, x331
    torch.cuda.empty_cache()

    run_dir = WORK / 'imagenet_run'
    run_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        base = [data, '-a', 'se_resnext101_32x4d', '--bf16', '-b',
                str(IMAGENET_TRAIN_BATCH), '-p', '1', '--lr', '0.001',
                '--device', 'cuda']
        print('examples/imagenet_eval_torch.py ' + ' '.join(base[1:])
              + ' --epochs 1, then -e --resume, then --epochs 3 --resume',
              flush=True)
        first = cli.main(base + ['--epochs', '1'])
        meta = cli.read_meta('checkpoint.pth.meta')
        again = cli.main(base + ['-e', '--resume', 'checkpoint.pth'])
        resumed = cli.main(base + ['--epochs', '3', '--resume',
                                   'checkpoint.pth'])
        final_meta = cli.read_meta('checkpoint.pth.meta')
    finally:
        os.chdir(cwd)
    losses = [first['last_train']['loss'], resumed['last_train']['loss']]
    print(f'train: {first["train_steps"]} + {resumed["train_steps"]} steps, '
          f'loss sums {losses}; .meta {meta} then {final_meta}; the '
          f'checkpoint re-evaluated: {again["totals"]} vs {first["totals"]}',
          flush=True)
    per_epoch = n_val // IMAGENET_TRAIN_BATCH
    check(first['train_steps'] == per_epoch
          and resumed['train_steps'] == 2 * per_epoch
          and all(np.isfinite(v) for v in losses),
          f'train: steps or loss {first} {resumed}')
    check(meta == {'epoch': 0, 'arch': 'se_resnext101_32x4d',
                   'best_prec1': first['best_prec1']}
          and final_meta['epoch'] == 2, f'.meta {meta} {final_meta}')
    check(all(again['totals'][k] == first['totals'][k]
              for k in ('top1', 'top5', 'count'))
          and abs(again['totals']['loss'] - first['totals']['loss'])
          <= 1e-5 * abs(first['totals']['loss']),
          'the checkpoint does not evaluate as the model it saved')

    model = pretorched.se_resnext101_32x4d().cuda().bfloat16()
    x, labels = val_batch(model.settings, torch, np)
    x, labels = x[:IMAGENET_TRAIN_BATCH], labels[:IMAGENET_TRAIN_BATCH]
    optimizer, scheduler = sgd_step_decay(model.parameters(), lr=1e-3)
    step = make_train_step(model, optimizer, scheduler)
    torch.manual_seed(0)
    host, dev = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_TIMED_STEPS):
        e0, e1 = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        metrics = step(x, labels)
        e1.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(e0.elapsed_time(e1))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host_ms = sorted(host[1:])[len(host[1:]) // 2]
    dev_ms = sorted(dev[1:])[len(dev[1:]) // 2]
    print(f'train step, bf16, {IMAGENET_TRAIN_BATCH} images x 224 px: '
          f'{dev_ms:.3f} ms by CUDA events, {host_ms:.3f} ms by host clock '
          f'(medians of steps 2-{TRAIN_TIMED_STEPS}) = '
          f'{IMAGENET_TRAIN_BATCH / dev_ms * 1e3:.2f} train images/s; peak '
          f'{peak:.2f} GiB; loss {float(metrics["loss"]):.4f}', flush=True)
    check(np.isfinite(float(metrics['loss'])), 'train step loss not finite')
    out['train_step'] = {'device_ms': dev_ms, 'host_ms': host_ms,
                         'images_per_s': IMAGENET_TRAIN_BATCH / dev_ms * 1e3,
                         'peak_gib': peak, 'steps_device_ms': dev,
                         'steps_host_ms': host}
    del model, optimizer, step, x
    torch.cuda.empty_cache()
    launched = k_counts(na, fb_cuda)
    check(launched == (0, 0, 0, 0), f'phase 14 launched K1 / K2 {launched}')
    return out


def fabricate_native(np):
    """One video a length of ``NATIVE_LENGTHS``, 240 x 320 JPEG frames
    (numpy seed 2), alternating between 2 classes."""
    from PIL import Image

    rng = np.random.RandomState(2)
    for i, n in enumerate(NATIVE_LENGTHS):
        d = WORK / 'native' / ('applauding', 'boxing')[i % 2] / f'v{i}'
        d.mkdir(parents=True)
        base = rng.randint(0, 256, (240, 320, 3)).astype(np.int16)
        for f in range(n):
            frame = base + rng.randint(-20, 21, base.shape)
            Image.fromarray(np.clip(frame, 0, 255).astype(np.uint8)).save(
                d / f'frame_{f:05d}.jpg', quality=90)


def native_kernel_rows(na, torch, frames):
    """K1-fwd against its plain version at each bucket's layer-2 and
    layer-3 shapes (10 clips), f32 and bf16, at phase 3's tolerances; the
    bf16 kernel's time beside the plain version's, SDPA's and the bound."""
    g = torch.Generator(device='cuda').manual_seed(3)
    rows = {}
    for t in frames:
        for layer, (n, c) in (('layer2', (t // 4 * 784, 256)),
                              ('layer3', (t // 8 * 196, 512))):
            b = NATIVE_CLIPS
            for dt in (torch.float32, torch.bfloat16):
                dname = str(dt).split('.')[-1]
                q = (torch.randn(b, n, c, device='cuda', generator=g)
                     / c ** 0.25).to(dt)
                k = (torch.randn(b, n, c, device='cuda', generator=g)
                     / c ** 0.25).to(dt)
                v = torch.randn(b, n, c, device='cuda', generator=g).to(dt)
                program = na._program(na.attention_kernel(dt, c, c, 'fwd'),
                                      c, c)
                out, lse = na.nonlocal_attention_cuda(q, k, v)
                torch.cuda.synchronize()
                want, want_lse = na.nonlocal_attention_fwd_lse_reference(
                    q.float(), k.float(), v.float())
                err, err_rel, err_lse = fwd_errors(out, lse, want, want_lse)
                del out, lse, want, want_lse
                tol, tol_lse = TOL[dname]
                tol_rel = TOL_REL_BF16 if dt == torch.bfloat16 else float(
                    'inf')
                line = (f'T={t} {layer} {dname} B={b} N=Nk={n} C=Cv={c} '
                        f'[{program}]: max|out-plain|={err:.3e} (tol '
                        f'{tol:g}), /max|plain| {err_rel:.3e} (tol '
                        f'{tol_rel:g}), max|lse-plain|={err_lse:.3e} (tol '
                        f'{tol_lse:g})')
                if dt == torch.bfloat16:
                    ms = median_ms(lambda: na.nonlocal_attention_cuda(q, k, v))
                    plain_ms = median_ms(
                        lambda: na.nonlocal_attention_fwd_lse_reference(
                            q, k, v), reps=5)
                    lib_ms, backend = sdpa_ms(torch, q, k, v)
                    bound_ms, bound_by = attention_bounds(b, n, n, c, c,
                                                          dname)['fwd']
                    line += (f'\n    kernel {ms:.3f} ms, plain {plain_ms:.3f} '
                             f'ms, scaled_dot_product_attention '
                             f'{fmt_ms(lib_ms)} ({backend}), bound '
                             f'{bound_ms:.4f} ms ({bound_by})')
                    rows[f'T={t} {layer}'] = {
                        'shape': [b, n, n, c, c], 'program': program,
                        'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                        'library_ms': lib_ms, 'bound_ms': bound_ms,
                        'bound_by': bound_by}
                print(line, flush=True)
                check(err <= tol and err_rel <= tol_rel and err_lse <= tol_lse,
                      f'kernel disagrees with the plain version: {line}')
                del q, k, v
                torch.cuda.empty_cache()
    return rows


def native_path(pretorched, na, torch, np, cli):
    """Phase 15: ``examples/video_eval_torch.py --frames native -b 4
    --clips 10`` on phase 4's hosted ``nonlocalresnet3d50`` weights (bf16)
    and videos of 20, 32, 40, 56 and 80 frames: one forward a bucket, each
    with 5 K1-fwd launches (2 wgmma, 3 wgmma_wide), finite totals; each
    bucket's forward timed by CUDA events; the 32-frame video's clips and
    logits the same as with ``--frames 32``; K1-fwd against its plain
    version at every bucket's shapes. Returns the numbers for the result
    line."""
    fabricate_native(np)
    argv = [str(WORK / 'native'), '-a', 'nonlocalresnet3d50', '--pretrained',
            'kinetics-400', '--num-classes', '400', '--frames', 'native',
            '--batch-size', '4', '--clips', str(NATIVE_CLIPS),
            '--print-freq', '1', '--device', 'cuda']
    print('examples/video_eval_torch.py ' + ' '.join(argv), flush=True)
    set_counts(na, 0)
    summary = cli.main(argv)
    launches = counts(na)
    totals = summary['totals']
    print(f"native-length eval: {summary['steps']} forwards, buckets "
          f"{summary['buckets']}, K1 launches {launches}, "
          f"{summary['clips']} clips in {summary['seconds']:.3f} s = "
          f"{summary['clips'] / summary['seconds']:.2f} clips/s (decode + "
          'preprocess + forward, host clock)', flush=True)
    check(summary['buckets'] == NATIVE_BUCKETS and summary['steps'] == 5
          and launches == (5 * summary['steps'], 0, 0),
          f'native-length eval: buckets {summary["buckets"]}, launches '
          f'{launches}')
    by_kernel = kernel_counts(na)
    expect_kernels(na, EVAL_KERNELS, summary['steps'], 'native-length eval')
    check(totals['count'] == len(NATIVE_LENGTHS)
          and np.isfinite(totals['loss']), f'bad totals {totals}')

    model = pretorched.nonlocalresnet3d50(num_classes=400,
                                          pretrained='kinetics-400')
    model.cuda().eval().bfloat16()
    args = cli.parse_args(argv)
    videos, _ = cli.list_videos(args.data)
    buckets = {}
    with torch.inference_mode():
        for clips, _ in cli.eval_batches(videos, args, model.settings,
                                         'cuda'):
            t = clips.shape[3]
            flat = clips.flatten(0, 1)
            ms = median_ms(lambda: model(flat), reps=3)
            logits = model(flat).float()
            check(bool(torch.isfinite(logits).all()),
                  f'bucket {t}: logits not finite')
            buckets[t] = {'clips': flat.shape[0], 'forward_ms': ms,
                          'clips_per_s': flat.shape[0] / ms * 1e3}
            print(f'bucket T={t}: bf16 forward of {flat.shape[0]} clips x '
                  f'{t} x 224 px {ms:.3f} ms (CUDA events, median of 3) = '
                  f'{flat.shape[0] / ms * 1e3:.2f} clips/s', flush=True)
            if t == 32:
                frames32 = next(f for f, _ in videos if len(f) == 32)
                fixed = cli.load_video(frames32, NATIVE_CLIPS, 32,
                                       model.settings, 'cuda')
                same = torch.equal(fixed, clips[0])
                diff = (model(fixed).float() - logits).abs().max().item()
                print(f'bucket 32 against --frames 32: clips equal {same}, '
                      f'logits max |diff| {diff:.3e} (tol 0)', flush=True)
                check(same and diff == 0,
                      'the 32-frame video scores differently in native mode')
            del clips, flat, logits
    del model
    torch.cuda.empty_cache()
    rows = native_kernel_rows(na, torch, sorted(buckets))
    return {'launches': launches[0], 'launches_by_kernel': by_kernel,
            'buckets': buckets, 'kernel_rows': rows,
            'path_clips_per_s': summary['clips'] / summary['seconds']}


def sagan_kernel_rows(na, torch):
    """K1-fwd alone at SAGAN's shapes, f32 and bf16, against its plain
    version at phase 3's tolerances; each with its time, the plain
    version's, one SDPA call's and the bound (f32: at the TF32 rate over 3
    and on the CUDA cores); also the program the dispatch's choice
    replaced there (bf16: mma.sync, f32: tf32x3), held to the plain
    version at the same tolerances (f32: and to the new program's out and
    lse) and timed; f32 repeats bitwise."""
    g = torch.Generator(device='cuda').manual_seed(5)
    rows = {}
    for name, (b, n, nk, c, cv) in BIGGAN_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split('.')[-1]
            q = (torch.randn(b, n, c, device='cuda', generator=g)
                 / c ** 0.25).to(dt)
            k = (torch.randn(b, nk, c, device='cuda', generator=g)
                 / c ** 0.25).to(dt)
            v = torch.randn(b, nk, cv, device='cuda', generator=g).to(dt)
            kernel = na._program(na.attention_kernel(dt, c, cv, 'fwd'), c,
                                 cv)
            out, lse = na.nonlocal_attention_cuda(q, k, v)
            torch.cuda.synchronize()
            want, want_lse = na.nonlocal_attention_fwd_lse_reference(
                q.float(), k.float(), v.float())
            err, err_rel, err_lse = fwd_errors(out, lse, want, want_lse)
            repeats = True
            if dt == torch.float32:
                again = na.nonlocal_attention_cuda(q, k, v)
                repeats = (torch.equal(out, again[0])
                           and torch.equal(lse, again[1]))
                del again
            earlier = 'mma_sync' if dt == torch.bfloat16 else 'tf32x3'
            out_m, lse_m = na._launch_fwd(q, k, v, 1.0, earlier)
            errs_m = fwd_errors(out_m, lse_m, want, want_lse)
            ab = (((out_m - out).abs().max().item(),
                   (lse_m - lse).abs().max().item())
                  if dt == torch.float32 else (0.0, 0.0))
            del out_m, lse_m
            del out, lse, want, want_lse
            tol, tol_lse = TOL[dname]
            tol_rel = TOL_REL_BF16 if dt == torch.bfloat16 else float('inf')
            ms = median_ms(lambda: na.nonlocal_attention_cuda(q, k, v))
            plain_ms = median_ms(
                lambda: na.nonlocal_attention_fwd_lse_reference(q, k, v),
                reps=5)
            lib_ms, backend = sdpa_ms(torch, q, k, v)
            rate = 'tf32x3' if kernel in TF32_PROGRAMS else dname
            bound_ms, bound_by = attention_bounds(b, n, nk, c, cv,
                                                  rate)['fwd']
            line = (f'{name} {dname} B={b} N={n} Nk={nk} C={c} Cv={cv} '
                    f'[{kernel}]: max|out-plain|={err:.3e} (tol {tol:g}), '
                    f'/max|plain| {err_rel:.3e} (tol {tol_rel:g}), '
                    f'max|lse-plain|={err_lse:.3e} (tol {tol_lse:g})'
                    + ('' if dt == torch.bfloat16 else
                       f', a second call bitwise the same: {repeats}')
                    + f'\n    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
                    f'scaled_dot_product_attention {fmt_ms(lib_ms)} '
                    f'({backend}), bound {bound_ms:.4f} ms ({bound_by}'
                    + (' at the TF32 rate over 3' if rate == 'tf32x3' else '')
                    + ')')
            row = {'shape': [b, n, nk, c, cv], 'dtype': dname,
                   'program': kernel, 'max_abs_err': err, 'ms': ms,
                   'plain_ms': plain_ms, 'library_ms': lib_ms,
                   'library': f'scaled_dot_product_attention ({backend})',
                   'bound_ms': bound_ms, 'bound_by': bound_by}
            if dt == torch.float32:
                row['bound_ms_cuda_cores'] = attention_bounds(
                    b, n, nk, c, cv, 'float32')['fwd'][0]
                row['macs_per_pair'] = c + cv
                line += (f', {row["bound_ms_cuda_cores"]:.4f} ms on the '
                         f'CUDA cores; {c + cv} multiply-adds a (query, '
                         f'key) pair')
            row['earlier_ms'] = median_ms(lambda: na._launch_fwd(
                q, k, v, 1.0, earlier))
            row['earlier'] = f'{earlier} program, same run'
            row['earlier_max_abs_err'] = errs_m[0]
            row['device_ms'] = queued_ms(
                lambda: na.nonlocal_attention_cuda(q, k, v), torch)
            row['earlier_device_ms'] = queued_ms(
                lambda: na._launch_fwd(q, k, v, 1.0, earlier), torch)
            line += (f'\n    the {earlier} program it replaced: '
                     f'{row["earlier_ms"]:.4f} ms, max|out-plain|='
                     f'{errs_m[0]:.3e}, /max|plain| {errs_m[1]:.3e}, '
                     f'max|lse-plain|={errs_m[2]:.3e}; queued (device '
                     f'time) {row["device_ms"]:.4f} ms ({kernel}), '
                     f'{row["earlier_device_ms"]:.4f} ms ({earlier})'
                     + (f'; max|{kernel}-{earlier}| out {ab[0]:.3e}, lse '
                        f'{ab[1]:.3e}' if dt == torch.float32 else ''))
            if dt == torch.float32:
                row['max_abs_diff_to_tf32x3'] = ab[0]
            print(line, flush=True)
            check(err <= tol and err_rel <= tol_rel and err_lse <= tol_lse
                  and repeats,
                  f'kernel disagrees with the plain version or itself: '
                  f'{line}')
            check(errs_m[0] <= tol and errs_m[1] <= tol_rel
                  and errs_m[2] <= tol_lse and ab[0] <= tol
                  and ab[1] <= tol_lse,
                  f'the {earlier} program disagrees with the plain version '
                  f'or the new one: {line}')
            rows[f'{name} {dname}'] = row
            del q, k, v
            torch.cuda.empty_cache()
    return rows


def biggan_path(na, torch):
    """Phase 16: BASELINE config 5, ``biggan256(num_classes=1000, ch=96)``
    (seeded, every BN's statistics randomized, ``gamma`` 0.5) sampling
    32 seeded labels in bf16 through ``gan.biggan.sample``: (32, 256, 256,
    3) images, finite, in [-1, 1], one K1-fwd launch a forward on the wide
    wgmma program (C = 96 padded to 128), held to the plain version at
    phase 3's tolerances (the f32 sample's launch on tf32_wgmma too, and
    held to tf32x3); the bf16 images against the f32 images of the same
    weights and z; at batch 4 in f32 (TF32 off) the images with the kernel
    (tf32_wgmma) against the plain attention, and ``gamma`` 0 moving
    them; images/s by CUDA events, peak memory and a profiled forward by
    family with K1-fwd's share; one bf16 ``biggan128(ch=96)`` forward, its
    launch on wgmma (C = 48 padded to 64) held to the plain version;
    K1-fwd alone at SAGAN's shapes. Returns the numbers for the result
    line."""
    from pretorched_tpu_torch.gan import biggan

    model = biggan.biggan256(num_classes=1000, ch=96)
    randomize_bn(model, torch, seed=20)
    with torch.no_grad():
        model.attention.gamma.fill_(0.5)
    model.cuda()
    labels = torch.randint(0, 1000, (BIGGAN_BATCH,), device='cuda',
                           generator=torch.Generator(
                               device='cuda').manual_seed(1))

    def draw(m, n, dtype):
        gz = torch.Generator(device='cuda').manual_seed(2)
        with torch.autocast('cuda', dtype=torch.bfloat16,
                            enabled=dtype == torch.bfloat16):
            return biggan.sample(m, gz, labels[:n], truncation=1.0)

    orig = biggan.auto_nonlocal_attention

    def recorded(m, n, dtype):
        """draw, keeping each K1-fwd launch's inputs and outputs"""
        calls = []

        def recording(q, k, v, scale=1.0):
            got, lse = na.nonlocal_attention_fwd_lse(q, k, v, scale)
            calls.append((q, k, v, got, lse, scale))
            return got

        biggan.auto_nonlocal_attention = recording
        try:
            return draw(m, n, dtype), calls
        finally:
            biggan.auto_nonlocal_attention = orig

    def hold(calls, program, what):
        """each launch against the plain version at phase 3's tolerances
        for its dtype; an f32 one also against tf32x3 on its inputs"""
        for q, k, v, got, lse, scale in calls:
            want, want_lse = na.nonlocal_attention_fwd_lse_reference(
                q.float(), k.float(), v.float(), scale)
            err, err_rel, err_lse = fwd_errors(got, lse, want, want_lse)
            dname = str(q.dtype).split('.')[-1]
            tol, tol_lse = TOL[dname]
            tol_rel = (TOL_REL_BF16 if q.dtype == torch.bfloat16
                       else float('inf'))
            line = (f'{what} {dname} K1-fwd {tuple(q.shape)} x '
                    f'{tuple(v.shape)} [{program}]: max|out-plain|='
                    f'{err:.3e} (tol {tol:g}), /max|plain| {err_rel:.3e} '
                    f'(tol {tol_rel:g}), max|lse-plain|={err_lse:.3e} '
                    f'(tol {tol_lse:g})')
            ab = (0.0, 0.0)
            if q.dtype == torch.float32:
                out_x, lse_x = na._launch_fwd(q, k, v, scale, 'tf32x3')
                ab = ((out_x - got).abs().max().item(),
                      (lse_x - lse).abs().max().item())
                line += (f'; max|{program}-tf32x3| out {ab[0]:.3e}, lse '
                         f'{ab[1]:.3e}')
                del out_x, lse_x
            print(line, flush=True)
            check(err <= tol and err_rel <= tol_rel and err_lse <= tol_lse
                  and ab[0] <= tol and ab[1] <= tol_lse,
                  f'kernel disagrees with the plain version or tf32x3: '
                  f'{line}')
        calls.clear()

    out = {}
    runs = {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split('.')[-1]
        set_counts(na, 0)
        img, calls = recorded(model, BIGGAN_BATCH, dt)
        torch.cuda.synchronize()
        program = na._program(na.attention_kernel(dt, 96, 384, 'fwd'), 96,
                              384)
        by_kernel = kernel_counts(na)
        if dt == torch.bfloat16:
            out['launches'] = na.nonlocal_attention_cuda.launches
            out['launches_by_kernel'] = by_kernel
        print(f'biggan256 {dname}: images {tuple(img.shape)} {img.dtype}, '
              f'range [{img.min().item():.4f}, {img.max().item():.4f}], '
              f'K1 launches {by_kernel}', flush=True)
        check(tuple(img.shape) == (BIGGAN_BATCH, 256, 256, 3)
              and bool(torch.isfinite(img).all())
              and img.abs().max().item() <= 1.0,
              f'biggan256 {dname}: bad images')
        check(by_kernel == {f'fwd {program}': 1} and len(calls) == 1,
              f'biggan256 {dname}: K1 launches {by_kernel}, expected one '
              f'on {program}')
        check(program == ('wgmma_wide' if dt == torch.bfloat16 else
                          'tf32_wgmma'), f'biggan256 {dname} on {program}')
        if dt == torch.float32:
            out['launches_by_kernel_f32'] = by_kernel
        hold(calls, program, 'biggan256')
        del calls
        runs[dname] = img.float()
    rel = rel_l2(runs['bfloat16'], runs['float32'])
    print(f'bf16 images vs f32 images (same weights and z): rel L2 '
          f'{rel:.3e} (tol {TOL_LOGITS_BF16:g})', flush=True)
    check(rel <= TOL_LOGITS_BF16, f'biggan256: bf16 images off f32: {rel}')
    out['rel_l2_bf16_f32'] = rel
    del runs

    # f32 at batch 4: the kernel (tf32_wgmma) against the plain attention
    kernel_img = draw(model, 4, torch.float32)
    biggan.auto_nonlocal_attention = na.nonlocal_attention_reference
    try:
        plain_img = draw(model, 4, torch.float32)
    finally:
        biggan.auto_nonlocal_attention = orig
    rel = rel_l2(kernel_img, plain_img)
    with torch.no_grad():
        model.attention.gamma.zero_()
        moved = rel_l2(draw(model, 4, torch.float32), plain_img)
        model.attention.gamma.fill_(0.5)
    print(f'f32 images at batch 4, kernel vs plain attention: rel L2 '
          f'{rel:.3e} (tol 1e-3); gamma 0 moves them by rel L2 {moved:.3e}',
          flush=True)
    check(rel <= 1e-3, f'biggan256: kernel and plain attention disagree: '
          f'{rel}')
    check(moved > 1e-3, 'biggan256: the images do not depend on the '
          'attention')
    out['rel_l2_kernel_plain_f32'], out['gamma0_moves'] = rel, moved

    ms = median_ms(lambda: draw(model, BIGGAN_BATCH, torch.bfloat16),
                   reps=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    draw(model, BIGGAN_BATCH, torch.bfloat16)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = BIGGAN_BATCH / ms * 1e3
    print(f'biggan256 bf16 sample of {BIGGAN_BATCH}: {ms:.3f} ms (CUDA '
          f'events, median of 5) = {rate:.2f} images/s; peak device memory '
          f'{peak:.2f} GiB', flush=True)
    window, by_name = device_times(
        lambda: draw(model, BIGGAN_BATCH, torch.bfloat16), torch)
    busy = sum(by_name.values()) / 1e3
    profile = None
    if busy:
        idle = max(0.0, 1 - busy / window)
        print(f'profiled sample (torch.profiler): {window:.1f} ms host '
              f'window, {busy:.1f} ms of kernels, device idle {idle:.1%}',
              flush=True)
        families = print_families(by_name, busy, {
            'K1-fwd': ('nonlocal_attention',),
            'convolution': CONV_KEYS,
            'batch norm': ('batch_norm', 'bn_fw'),
            'upsample': ('upsample',), 'pooling': ('pool',),
            'elementwise': ('elementwise', 'vectorized', 'unrolled')})
        profile = {'window_ms': window, 'kernel_ms': busy, 'idle': idle,
                   'families_ms': families,
                   'k1_share': families['K1-fwd'] / busy}
    else:
        print('profiled sample: the profiler saw no device time (not '
              'measured)')
    out.update({'batch': BIGGAN_BATCH, 'sample_ms': ms, 'images_per_s': rate,
                'peak_gib': peak, 'profile': profile})
    del model
    torch.cuda.empty_cache()

    small = biggan.biggan128(num_classes=1000, ch=96)
    randomize_bn(small, torch, seed=21)
    with torch.no_grad():
        small.attention.gamma.fill_(0.5)
    small.cuda()
    set_counts(na, 0)
    img, calls = recorded(small, BIGGAN_BATCH, torch.bfloat16)
    torch.cuda.synchronize()
    by_kernel = kernel_counts(na)
    program = na._program(na.attention_kernel(torch.bfloat16, 48, 192,
                                              'fwd'), 48, 192)
    check(program == 'wgmma' and len(calls) == 1,
          f'biggan128: {len(calls)} launches on {program}')
    hold(calls, program, 'biggan128')
    ms128 = median_ms(lambda: draw(small, BIGGAN_BATCH, torch.bfloat16),
                      reps=5)
    print(f'biggan128 bf16 sample of {BIGGAN_BATCH}: {tuple(img.shape)}, '
          f'K1 launches {by_kernel}, {ms128:.3f} ms (CUDA events, median of '
          f'5) = {BIGGAN_BATCH / ms128 * 1e3:.2f} images/s', flush=True)
    check(tuple(img.shape) == (BIGGAN_BATCH, 128, 128, 3)
          and bool(torch.isfinite(img).all())
          and by_kernel == {f'fwd {program}': 1},
          f'biggan128: images {tuple(img.shape)} or launches {by_kernel}')
    out['biggan128'] = {'sample_ms': ms128,
                        'images_per_s': BIGGAN_BATCH / ms128 * 1e3,
                        'launches_by_kernel': by_kernel}
    del small, img
    torch.cuda.empty_cache()
    out['kernel_rows'] = sagan_kernel_rows(na, torch)
    return out


def lambda_ordered(state_dict, leaves):
    """``state_dict`` re-keyed as the reference's Lambda-graph files are:
    auto-index names (``features.{i}``) in the graph's creation order, the
    classifier last as ``last_linear``."""
    out = {}
    for i, prefix in enumerate(leaves):
        name = 'last_linear' if prefix == 'last_linear' else f'features.{i}'
        for key, value in state_dict.items():
            if key.rsplit('.', 1)[0] == prefix:
                out[f'{name}.{key.rsplit(".", 1)[1]}'] = value
    return out


def families_path(pretorched, torch, np, na, fb_cuda):
    """Phase 17: the 2D families on phase 14's JPEGs. Each of
    ``FAMILY_MODELS`` seeded, every BN randomized: one bf16 forward of the
    256 val images at its ``input_size``, timed, held to its f32 forward.
    Then ``examples/imagenet_eval_torch.py -e --bf16 -b 256 -a
    resnext101_64x4d`` on a hosted file fabricated in Lambda order (the
    ordered loader runs), which loads the donor's weights exactly. No K1
    or K2 launch. Returns the numbers for the result line."""
    from pretorched_tpu_torch.models.resnext import ordered_leaves

    set_counts(na, 0)
    reset_k2(fb_cuda)
    out = {}
    with torch.inference_mode():
        for seed, name in enumerate(FAMILY_MODELS):
            t0 = time.perf_counter()
            model = pretorched.__dict__[name](pretrained=None)
            randomize_bn(model, torch, seed=30 + seed)
            model.cuda().eval()
            built = time.perf_counter() - t0
            settings = pretorched.pretrained_settings[name]['imagenet']
            x, _ = val_batch(settings, torch, np)
            check(x.shape[-1] == settings['input_size'][-1],
                  f'{name}: input {tuple(x.shape)}')
            logits, row = imagenet_forward(model, x, torch, name)
            rel = rel_l2(logits, model.float()(x))
            print(f'{name}: built in {built:.1f} s (host); bf16 vs f32 '
                  f'logits rel L2 {rel:.3e} (tol {TOL_LOGITS_BF16:g})',
                  flush=True)
            check(rel <= TOL_LOGITS_BF16, f'{name}: bf16 logits off: {rel}')
            out[name] = {**row, 'rel_l2_bf16_f32': rel}
            del model, x, logits
            torch.cuda.empty_cache()

    name = 'resnext101_64x4d'
    donor = pretorched.__dict__[name](pretrained=None)
    randomize_bn(donor, torch, seed=40)
    url = pretorched.pretrained_settings[name]['imagenet']['url']
    hosted = lambda_ordered(donor.state_dict(), ordered_leaves())
    check(not any(k.startswith('layer') for k in hosted),
          'the fabricated file is not in Lambda order')
    torch.save(hosted, WORK / 'zoo' / 'weights' / url.rsplit('/', 1)[-1])
    loaded = pretorched.__dict__[name]()
    same = all(torch.equal(v, donor.state_dict()[k])
               for k, v in loaded.state_dict().items())
    print(f'{name}: a Lambda-ordered file of {len(hosted)} tensors loads by '
          f'position: every tensor equal to the donor\'s: {same}', flush=True)
    check(same, f'{name}: the ordered loader did not restore the donor')
    del donor, loaded, hosted
    cli = load_cli('imagenet_eval_torch')
    argv = [str(WORK / 'imagenet'), '-a', name, '-e', '--bf16', '-b',
            str(IMAGENET_BATCH), '-p', '1', '--device', 'cuda']
    print('examples/imagenet_eval_torch.py ' + ' '.join(argv[1:]),
          flush=True)
    summary = cli.main(argv)
    totals = summary['totals']
    rate = totals['count'] / summary['seconds']
    print(f'{name} CLI: {totals["count"]:.0f} images in '
          f'{summary["seconds"]:.3f} s = {rate:.2f} images/s (JPEG decode + '
          'preprocess + forward, host clock, the first run)', flush=True)
    check(totals['count'] == IMAGENET_CLASSES * IMAGENET_PER_CLASS
          and np.isfinite(totals['loss']), f'{name} CLI: totals {totals}')
    out['cli'] = {'arch': name, 'images_per_s_path': rate,
                  'seconds': summary['seconds']}
    torch.cuda.empty_cache()
    launched = k_counts(na, fb_cuda)
    check(launched == (0, 0, 0, 0), f'phase 17 launched K1 / K2 {launched}')
    return out


def rescaled(model, torch, factor=1.01):
    """Every parameter of ``model`` times ``factor``, in place: a donor
    that differs from the factory's seeded init (a BN-free net has no
    statistics to randomize), so a load that did nothing shows."""
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(factor)
    return model


def zoo_path(pretorched, torch, np, na, fb_cuda):
    """Phase 18: the rest of the 2D zoo on phase 14's JPEGs. Each of
    ``ZOO_MODELS`` seeded, every BN randomized: one bf16 forward at its
    ``input_size`` (``ZOO_LARGE_BATCH`` images at 299 and 331 px, the 256
    val images below), timed, held to its f32 forward; ``ZOO_PROFILED``
    profiled by family with the layout copies apart. Then
    ``examples/imagenet_eval_torch.py -e --bf16 -a inceptionv4`` on a
    fabricated 1001-class hosted file, whose ``imagenet`` load keeps the
    donor's 1000 classes exactly; one CLI train step of ``dpn68b`` at
    ``-b 64`` in bf16 (DPN's train-mode head); ``wideresnet50`` from an
    ``.npz`` in the hosted export's keys through the loader with
    ``hkl_renames``, every tensor the donor's. No K1 or K2 launch. Returns
    the numbers for the result line."""
    from pretorched_tpu_torch.models.wideresnet import hkl_renames
    from pretorched_tpu_torch.zoo import io as zoo_io

    set_counts(na, 0)
    reset_k2(fb_cuda)
    out, batches = {}, {}
    with torch.inference_mode():
        for seed, name in enumerate(ZOO_MODELS):
            t0 = time.perf_counter()
            model = pretorched.__dict__[name](pretrained=None)
            randomize_bn(model, torch, seed=50 + seed)
            model.cuda().eval()
            built = time.perf_counter() - t0
            settings = model.metadata
            key = json.dumps({k: settings.get(k) for k in (
                'input_space', 'input_size', 'input_range', 'mean', 'std',
                'scale')})
            if key not in batches:
                batches[key] = val_batch(settings, torch, np)[0]
            x = batches[key]
            if settings['input_size'][-1] >= 299:
                x = x[:ZOO_LARGE_BATCH]
            check(x.shape[-1] == settings['input_size'][-1],
                  f'{name}: input {tuple(x.shape)}')
            logits, row = imagenet_forward(model, x, torch, name,
                                           profile=name in ZOO_PROFILED,
                                           groups=ZOO_FAMILIES)
            rel = rel_l2(logits, model.float()(x))
            print(f'{name}: built in {built:.1f} s (host); bf16 vs f32 '
                  f'logits rel L2 {rel:.3e} (tol {TOL_LOGITS_BF16:g})',
                  flush=True)
            check(logits.shape == (x.shape[0], 1000)
                  and rel <= TOL_LOGITS_BF16,
                  f'{name}: logits {tuple(logits.shape)}, bf16 off: {rel}')
            out[name] = {**row, 'rel_l2_bf16_f32': rel,
                         'images': x.shape[0], 'px': x.shape[-1]}
            del model, x, logits
            torch.cuda.empty_cache()
    del batches

    name = 'inceptionv4'
    donor = pretorched.inceptionv4(num_classes=1001, pretrained=None)
    randomize_bn(donor, torch, seed=70)
    url = pretorched.pretrained_settings[name]['imagenet']['url']
    torch.save(donor.state_dict(),
               WORK / 'zoo' / 'weights' / url.rsplit('/', 1)[-1])
    loaded = pretorched.inceptionv4().state_dict()
    want = donor.state_dict()
    same = all(torch.equal(v, want[k][1:] if k.startswith('last_linear')
                           else want[k]) for k, v in loaded.items())
    print(f'{name}: a 1001-class hosted file loads as imagenet with its '
          f'background row dropped, every tensor the donor\'s: {same}',
          flush=True)
    check(same and loaded['last_linear.weight'].shape[0] == 1000,
          f'{name}: the background row was not dropped as expected')
    del donor, loaded, want
    cli = load_cli('imagenet_eval_torch')
    argv = [str(WORK / 'imagenet'), '-a', name, '-e', '--bf16', '-b',
            str(ZOO_LARGE_BATCH), '-p', '1', '--device', 'cuda']
    print('examples/imagenet_eval_torch.py ' + ' '.join(argv[1:]),
          flush=True)
    summary = cli.main(argv)
    totals = summary['totals']
    rate = totals['count'] / summary['seconds']
    print(f'{name} CLI: {totals["count"]:.0f} images in '
          f'{summary["seconds"]:.3f} s = {rate:.2f} images/s (JPEG decode + '
          'preprocess + forward, host clock, the first run)', flush=True)
    check(totals['count'] == IMAGENET_CLASSES * IMAGENET_PER_CLASS
          and np.isfinite(totals['loss']), f'{name} CLI: totals {totals}')
    out['cli'] = {'arch': name, 'images_per_s_path': rate,
                  'seconds': summary['seconds']}

    # one train step: 8 JPEGs a class of phase 14's train split
    data = WORK / 'zoo_train'
    for split in ('train', 'val'):
        for d in sorted((WORK / 'imagenet' / split).iterdir()):
            (data / split / d.name).mkdir(parents=True)
            for f in sorted(d.iterdir())[:ZOO_LARGE_BATCH // IMAGENET_CLASSES]:
                (data / split / d.name / f.name).symlink_to(f)
    run_dir = WORK / 'zoo_run'
    run_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        argv = [str(data), '-a', 'dpn68b', '--pretrained', 'none', '--bf16',
                '-b', str(ZOO_LARGE_BATCH), '-p', '1', '--lr', '0.001',
                '--epochs', '1', '--device', 'cuda']
        print('examples/imagenet_eval_torch.py ' + ' '.join(argv[1:]),
              flush=True)
        t0 = time.perf_counter()
        summary = cli.main(argv)
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    loss = summary['last_train']['loss']
    print(f'dpn68b: {summary["train_steps"]} train step of '
          f'{ZOO_LARGE_BATCH} images, loss {loss:.4f}, then eval of '
          f'{summary["totals"]["count"]:.0f}; {seconds:.1f} s (host clock, '
          'the first run)', flush=True)
    check(summary['train_steps'] == 1 and np.isfinite(loss)
          and summary['totals']['count'] == ZOO_LARGE_BATCH,
          f'dpn68b train: {summary}')
    out['train_step'] = {'arch': 'dpn68b', 'loss': loss, 'seconds': seconds}

    donor = rescaled(pretorched.wideresnet50(num_classes=1000), torch)
    renames = hkl_renames()
    npz = WORK / 'zoo' / 'wide-resnet-50-2-export.npz'
    np.savez(npz, **{f'{renames[k.rsplit(".", 1)[0]]}.{k.rsplit(".", 1)[1]}':
                     v.numpy() for k, v in donor.state_dict().items()})
    model = pretorched.wideresnet50(num_classes=1000)
    result = zoo_io.load_state_dict_into(
        model, zoo_io.load_torch_state_dict(npz), torch_renames=renames)
    same = all(torch.equal(v, donor.state_dict()[k])
               for k, v in model.state_dict().items())
    print(f'wideresnet50: an .npz of {len(renames)} modules in the hosted '
          f'export\'s keys (conv0, group0.block0.conv_dim, fc, ...) loads '
          f'with hkl_renames: every tensor the donor\'s: {same}', flush=True)
    check(result == ([], []) and same, 'wideresnet50: the .npz load differs')
    del donor, model
    torch.cuda.empty_cache()
    launched = k_counts(na, fb_cuda)
    check(launched == (0, 0, 0, 0), f'phase 18 launched K1 / K2 {launched}')
    return out


def timed_bf16(fn, x, torch, what, unit):
    """``fn(x)`` in bf16 autocast by CUDA events (median of 5) and its peak
    memory, then in f32: each output finite, bf16 within TOL_LOGITS_BF16
    of f32 (rel L2). Returns the f32 outputs (a tuple) and the numbers."""
    with torch.autocast('cuda', dtype=torch.bfloat16):
        ms = median_ms(lambda: fn(x), reps=5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn(x)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = out if isinstance(out, tuple) else (out,)
    want = fn(x)
    want = want if isinstance(want, tuple) else (want,)
    rels = [rel_l2(o, w) for o, w in zip(out, want)]
    n = x.shape[0]
    print(f'{what}: bf16 forward of {n} {unit} {ms:.3f} ms (CUDA events, '
          f'median of 5) = {n / ms * 1e3:.2f} {unit}/s; peak device memory '
          f'{peak:.2f} GiB; bf16 vs f32 rel L2 '
          + ', '.join(f'{r:.3e}' for r in rels)
          + f' (tol {TOL_LOGITS_BF16:g})', flush=True)
    check(all(bool(torch.isfinite(o).all()) for o in out + want)
          and max(rels) <= TOL_LOGITS_BF16,
          f'{what}: bf16 outputs off or not finite: {rels}')
    return want, {'forward_ms': ms, f'{unit}_per_s': n / ms * 1e3,
                  'peak_gib': peak, 'rel_l2_bf16_f32': max(rels)}


def card_vs_cpu(model, x, torch):
    """rel L2 of the card's f32 features and logits against the CPU's, on
    the same weights and input (TF32 off); the model ends on the CPU."""
    model.float().eval()
    with torch.inference_mode():
        feats = model.cuda().features(x.cuda())
        logits = model.logits(feats)
        feats, logits = feats.cpu(), logits.cpu()
        model.cpu()
        want_f = model.features(x)
        want = model.logits(want_f)
    return rel_l2(feats, want_f), rel_l2(logits, want)


def write_wavs(np, root):
    """``SOUND_CLIPS`` seeded 16-bit mono WAVs of ``SOUND_SAMPLES`` at
    ``SOUND_RATE`` and one of twice that length: a tone each plus noise.
    Returns [(path, int16 samples)]."""
    import wave

    rng = np.random.RandomState(19)
    root.mkdir(parents=True)
    out = []
    for i, n in enumerate([SOUND_SAMPLES] * SOUND_CLIPS
                          + [2 * SOUND_SAMPLES]):
        t = np.arange(n) / SOUND_RATE
        x = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
             + 0.1 * rng.randn(n))
        pcm = np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)
        path = root / f'{i:02d}.wav'
        with wave.open(str(path), 'wb') as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SOUND_RATE)
            w.writeframes(pcm.tobytes())
        out.append((path, pcm))
    return out


def fabricate_voc(pretorched, torch, np):
    """A VOC2007 folder under ``WORK / 'voc'``: ``VOC_PER_SPLIT`` train and
    val JPEGs cut from ``data/*.jpg`` at seeded crops and sizes, seeded
    labels in {-1, 0, 1} (each class a positive and a negative train row),
    the four download sentinels; and a hosted ``resnet50`` imagenet .pth
    (seeded, every BN randomized, the torchvision keys)."""
    from PIL import Image

    from pretorched_tpu_torch.datasets.voc import object_categories

    root = WORK / 'voc' / 'VOC2007'
    dev = root / 'VOCdevkit' / 'VOC2007'
    (dev / 'JPEGImages').mkdir(parents=True)
    (dev / 'ImageSets' / 'Main').mkdir(parents=True)
    sources = [Image.open(REPO / 'data' / f).convert('RGB')
               for f in ('cat.jpg', 'croco.jpg', 'cat_224.jpg')]
    rng = np.random.RandomState(20)
    names = {}
    for s, split in enumerate(('train', 'val')):
        names[split] = [f'{1 + s * VOC_PER_SPLIT + i:06d}'
                        for i in range(VOC_PER_SPLIT)]
        for name in names[split]:
            src = sources[rng.randint(len(sources))]
            w = rng.randint(96, src.width + 1)
            h = rng.randint(96, src.height + 1)
            x0 = rng.randint(0, src.width - w + 1)
            y0 = rng.randint(0, src.height - h + 1)
            size = (rng.randint(160, 500), rng.randint(160, 500))
            src.crop((x0, y0, x0 + w, y0 + h)).resize(size).save(
                dev / 'JPEGImages' / f'{name}.jpg', quality=90)
    for c in object_categories:
        for split in ('train', 'val'):
            labels = rng.choice([-1, 0, 1], VOC_PER_SPLIT, p=[0.7, 0.1, 0.2])
            if split == 'train':
                labels[:2] = (1, -1)
            (dev / 'ImageSets' / 'Main' / f'{c}_{split}.txt').write_text(
                ''.join(f'{n} {v:2d}\n' for n, v in zip(names[split],
                                                        labels)))
    (dev / 'ImageSets' / 'Main' / 'aeroplane_test.txt').touch()
    check((dev / 'JPEGImages' / '000001.jpg').exists(), 'VOC sentinel')
    donor = pretorched.resnet50(num_classes=1000, pretrained=None)
    randomize_bn(donor, torch, seed=90)
    url = pretorched.pretrained_settings['resnet50']['imagenet']['url']
    torch.save({('fc' + k[len('last_linear'):] if k.startswith('last_linear')
                 else k): v for k, v in donor.state_dict().items()},
               WORK / 'zoo' / 'weights' / url.rsplit('/', 1)[-1])


def video_audio_path(pretorched, torch, np, na, fb_cuda):
    """Phase 19: the video and audio families and VOC transfer. Each of
    ``VIDEO_FAMILIES`` (seeded, every BN randomized, 400 classes) on
    ``FAMILY_CLIPS``, and ``soundnet8`` (1000 classes) on ``SOUND_CLIPS``
    WAVs read back through ``datasets.audio.soundnet_input``, one bf16
    forward each, timed, held to its f32 forward; the multi-window head on
    a WAV of twice the length, against its windows' mean;
    ``BranchedSoundNet`` on the same batch. Per family (reduced depth) the
    card's f32 features and logits against the CPU's; zeroing the stem's
    ``MultiViewConv.linear`` moves the logits. Then
    ``examples/voc2007_extract_torch.py -a resnet50 -b 64`` on a fabricated
    VOC2007 folder and a hosted file: features on the card (images/s by
    host clock), reloaded from the cache, the SVM fit where sklearn
    imports; and ``examples/visu_arch_torch.py -a resnet18``'s two PNGs.
    No K1 or K2 launch. Returns the numbers for the result line."""
    from pretorched_tpu_torch.datasets.audio import soundnet_input
    from pretorched_tpu_torch.models.densenet3d import DenseNet3D
    from pretorched_tpu_torch.models.layers import init_parameters
    from pretorched_tpu_torch.models.multiview import MVResNet
    from pretorched_tpu_torch.models.soundnet import BranchedSoundNet

    set_counts(na, 0)
    reset_k2(fb_cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {'models': {}}
    g = torch.Generator(device='cuda').manual_seed(19)
    clips = torch.randn(FAMILY_CLIPS, generator=g, device='cuda')
    with torch.inference_mode():
        for seed, name in enumerate(VIDEO_FAMILIES):
            t0 = time.perf_counter()
            model = pretorched.__dict__[name](num_classes=400)
            randomize_bn(model, torch, seed=80 + seed)
            model.cuda().eval()
            built = time.perf_counter() - t0
            (logits,), row = timed_bf16(model, clips, torch,
                                        f'{name} (built in {built:.1f} s)',
                                        'clips')
            check(logits.shape == (FAMILY_CLIPS[0], 400),
                  f'{name}: logits {tuple(logits.shape)}')
            if name == 'mvresnet10':
                model.conv1.linear.weight.zero_()
                moved = rel_l2(model(clips), logits)
                print(f'{name}: zeroing the stem\'s MultiViewConv.linear '
                      f'moves the f32 logits by rel L2 {moved:.3e}',
                      flush=True)
                check(moved > TOL_CARD_CPU, f'{name}: the mixer is not live')
                out['mixer_moves_rel_l2'] = moved
            out['models'][name] = row
            del model, logits
            torch.cuda.empty_cache()
    del clips

    # the multi-view conv and the dense layers on the card against the CPU
    x = torch.randn(2, 3, 16, 112, 112, generator=torch.Generator()
                    .manual_seed(21))
    wave_x = torch.randn(1, 1, SOUND_SAMPLES,
                         generator=torch.Generator().manual_seed(22))
    reduced = {
        'DenseNet3D blocks (2, 2, 2, 2)': (DenseNet3D(
            block_config=(2, 2, 2, 2), num_classes=400), x),
        'MVResNet basic (1, 1, 1, 1)': (MVResNet(
            'basic', (1, 1, 1, 1), num_classes=400), x),
        'MVResNet bottleneck (1, 1, 1, 1)': (MVResNet(
            'bottleneck', (1, 1, 1, 1), num_classes=400), x),
        'soundnet8': (pretorched.soundnet8(num_classes=1000), wave_x)}
    out['card_vs_cpu'] = {}
    for seed, (what, (model, inp)) in enumerate(reduced.items()):
        if what != 'soundnet8':       # built here, not by a factory
            init_parameters(model, torch.Generator().manual_seed(seed))
        randomize_bn(model, torch, seed=85 + seed)
        rf, rl = card_vs_cpu(model, inp, torch)
        print(f'{what}: the card\'s f32 features / logits against the '
              f'CPU\'s, rel L2 {rf:.3e} / {rl:.3e} (tol {TOL_CARD_CPU:g}, '
              'TF32 off)', flush=True)
        check(max(rf, rl) <= TOL_CARD_CPU, f'{what}: card vs CPU {rf} {rl}')
        out['card_vs_cpu'][what] = {'features': rf, 'logits': rl}
        del model

    wavs = write_wavs(np, WORK / 'audio')
    batches = []
    for path, pcm in wavs:
        b = soundnet_input(str(path), sample_rate=SOUND_RATE)
        check(b.shape == (1, 1, len(pcm)) and torch.equal(
            b[0, 0], torch.from_numpy(pcm.astype(np.float32) / 32768.0)),
            f'{path.name}: the WAV read back differs')
        batches.append(b)
    audio = torch.cat(batches[:SOUND_CLIPS]).cuda()
    print(f'{len(wavs)} WAVs (16-bit, {SOUND_RATE} Hz) read back through '
          f'datasets.audio.soundnet_input: batch {tuple(audio.shape)}, '
          'samples equal to the written ones', flush=True)
    with torch.inference_mode():
        model = pretorched.soundnet8(num_classes=1000)
        randomize_bn(model, torch, seed=88)
        model.cuda().eval()
        _, out['soundnet8'] = timed_bf16(model, audio, torch, 'soundnet8',
                                         'waveforms')
        two = batches[SOUND_CLIPS].cuda()
        feats = model.features(two)
        # the reference's windows: every full one but the last, and one
        # right-aligned (soundnet.py:73-77)
        fd = model.feature_dim
        windows = feats.split(fd, -1)[:-1] + (feats[:, -fd:],)
        want = torch.stack([model.last_linear(w) for w in windows]).mean(0)
        got = model(two)
        rel = rel_l2(got, want)
        print(f'soundnet8: {two.shape[-1]} samples, {feats.shape[-1]} '
              f'features, the multi-window logits against the mean of its '
              f'{len(windows)} windows\' rel L2 {rel:.3e} (tol 1e-6)',
              flush=True)
        check(got.shape == (1, 1000) and rel <= 1e-6,
              f'soundnet8 multi-window head: {rel}')
        out['soundnet8']['windows_rel_l2'] = rel
        del model
        with torch.device('cuda'):
            branched = BranchedSoundNet()
        randomize_bn(branched, torch, seed=89)
        (obj, plc), out['branched_soundnet'] = timed_bf16(
            branched.eval(), audio, torch, 'BranchedSoundNet', 'waveforms')
        check(obj.shape == (SOUND_CLIPS, 1000)
              and plc.shape == (SOUND_CLIPS, 365),
              f'BranchedSoundNet: {tuple(obj.shape)} {tuple(plc.shape)}')
        del branched, audio
    torch.cuda.empty_cache()

    fabricate_voc(pretorched, torch, np)
    cli = load_cli('voc2007_extract_torch')
    argv = ['--dir_datasets', str(WORK / 'voc'), '--dir_outputs',
            str(WORK / 'voc_out'), '-a', 'resnet50', '--pretrained',
            'imagenet', '-b', str(VOC_BATCH), '--device', 'cuda']
    print('examples/voc2007_extract_torch.py ' + ' '.join(argv), flush=True)
    args = cli.parse_args(argv)
    features, targets, classes, seconds = cli.extract(args)
    n = sum(len(f) for f in features.values())
    rate = n / sum(seconds.values())
    print(f'VOC2007 extraction: {n} images in '
          f'{sum(seconds.values()):.3f} s = {rate:.2f} images/s (PIL decode '
          'and transform + f32 forward, host clock, the first run)',
          flush=True)
    check(all(f.shape == (VOC_PER_SPLIT, 2048) and np.isfinite(f).all()
              for f in features.values())
          and set(np.unique(targets['train'])) <= {-1.0, 0.0, 1.0},
          'VOC features or targets off')
    again = cli.extract(args)
    same = all(np.array_equal(again[0][s], features[s])
               and np.array_equal(again[1][s], targets[s])
               for s in features)
    print(f'VOC2007: the second run read the cached .npz files: equal '
          f'{same}, {sum(again[3].values()):.3f} s', flush=True)
    check(same, 'VOC: the cached features differ')
    out['voc'] = {'images': n, 'images_per_s_path': rate,
                  'seconds': seconds, 'cached_seconds': again[3]}
    if importlib.util.find_spec('sklearn') is None:
        print('VOC2007: the SVM fit was not run: sklearn is absent on this '
              'machine (the fit runs on the host in every version of the '
              'example)', flush=True)
        out['voc']['mAP'] = None
    else:
        t0 = time.perf_counter()
        m_ap = float(cli.train_multilabel(features, targets, classes,
                                          'train', 'val'))
        print(f'VOC2007: 20 LinearSVC fits in {time.perf_counter() - t0:.1f}'
              ' s (host)', flush=True)
        check(0.0 <= m_ap <= 1.0, f'VOC mAP {m_ap}')
        out['voc']['mAP'] = m_ap
    torch.cuda.empty_cache()

    cli = load_cli('visu_arch_torch')
    pngs = cli.main(['-a', 'resnet18', '--image', str(REPO / 'data' /
                                                      'cat.jpg'),
                     '--outdir', str(WORK / 'visu'), '--device', 'cuda'])
    check(all(os.path.getsize(p) > 0 for p in pngs),
          f'visu_arch_torch.py: {pngs}')
    out['visu_pngs'] = [os.path.relpath(p, REPO) for p in pngs]
    launched = k_counts(na, fb_cuda)
    check(launched == (0, 0, 0, 0), f'phase 19 launched K1 / K2 {launched}')
    return out


def load_tool(name):
    """The module of ``tools/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        name, REPO / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def export_programs(pretorched, torch, np, na, fb_cuda, root):
    """Phase 20's exports: each model's program saved under ``root``, its
    eager forward on the seeded inputs of ``tools/port_export_reload.py``
    (logits, CUDA-event median of 5, launches); then the programs reloaded
    in a fresh process that builds no model, held to the eager logits.
    Returns the rows by program and batch, and K1-fwd's and K2's launches
    in the reloaded programs."""
    from pretorched_tpu_torch.zoo.export import export_model

    reload = load_tool('port_export_reload')
    programs, rows = [], {}

    def export(name, model, shape, dtype, batch, batches, seed, compute,
               expect):
        path = root / f'{name}.pt2'
        t0 = time.perf_counter()
        export_model(model, str(path), shape, batch=batch,
                     dtype=getattr(torch, dtype))
        seconds = time.perf_counter() - t0
        programs.append({'name': name, 'path': str(path),
                         'shape': list(shape), 'dtype': dtype,
                         'batches': list(batches), 'seed': seed})
        for b in batches:
            x = reload.seeded_input(shape, b, dtype, seed)
            with torch.inference_mode():
                before = (dict(na.nonlocal_attention_cuda.by_kernel),
                          dict(fb_cuda.fused_bottleneck_tail_cuda.by_kernel))
                logits = model(x).float()
                torch.cuda.synchronize()
                launched = {
                    op: {k: after[k] - was[k] for k in after
                         if after[k] != was[k]}
                    for op, after, was in (
                        ('fwd', na.nonlocal_attention_cuda.by_kernel,
                         before[0]),
                        ('k2', fb_cuda.fused_bottleneck_tail_cuda.by_kernel,
                         before[1]))}
                ms = median_ms(lambda: model(x), reps=5)
            check(launched == expect, f'{name} B={b}: the eager forward '
                  f'launched {launched}, expected {expect}')
            rows[f'{name}-B{b}'] = {
                'logits': logits.cpu(), 'eager_ms': ms, 'compute': compute,
                'expect': expect, 'export_seconds': seconds,
                'program_mib': path.stat().st_size / 2 ** 20}
            del x, logits
        print(f'{name}: exported ({compute} compute, {dtype} input, batch '
              f'{batch}) in {seconds:.1f} s, '
              f'{path.stat().st_size / 2 ** 20:.1f} MiB', flush=True)

    wide = {'fwd': {'wgmma': 2, 'wgmma_wide': 3}, 'k2': {}}
    nl = pretorched.nonlocalresnet3d50(num_classes=400,
                                       pretrained='kinetics-400')
    nl.cuda().eval().bfloat16()
    export('nonlocalresnet3d50_bf16', nl, EXPORT_NL_SHAPE, 'float32',
           str(EXPORT_CLIPS), (EXPORT_CLIPS,), 0, 'bfloat16', wide)
    nl.float()
    export('nonlocalresnet3d50_f32', nl, EXPORT_NL_SHAPE, 'float32', 'b',
           (2, EXPORT_CLIPS), 1, 'float32',
           {'fwd': {'tf32_wgmma': 5}, 'k2': {}})
    del nl
    torch.cuda.empty_cache()
    sf = pretorched.slowfast_resnet50(num_classes=400, pretrained=None,
                                      fused_blocks=32)
    randomize_bn(sf, torch, seed=1)
    sf.cuda().eval().bfloat16()
    export('slowfast_resnet50_bf16', sf, EXPORT_SF_SHAPE, 'bfloat16',
           str(EXPORT_CLIPS), (EXPORT_CLIPS,), 2, 'bfloat16',
           {'fwd': {}, 'k2': {'tma': 6, 'mma_sync': 5}})
    del sf
    torch.cuda.empty_cache()
    r50 = pretorched.resnet50(num_classes=1000, pretrained=None)
    randomize_bn(r50, torch, seed=3)
    r50.cuda().eval()
    export('resnet50_f32', r50, (3, 224, 224), 'float32', 'b',
           EXPORT_R50_BATCHES, 3, 'float32', {'fwd': {}, 'k2': {}})
    del r50
    torch.cuda.empty_cache()

    spec = root / 'spec.json'
    spec.write_text(json.dumps({'programs': programs, 'out': str(root)}))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, str(REPO / 'tools' /
                                              'port_export_reload.py'),
                          str(spec)], capture_output=True, text=True,
                         timeout=600)
    check(run.returncode == 0, f'the reload process failed:\n'
          f'{run.stdout[-2000:]}\n{run.stderr[-3000:]}')
    line = next(ln for ln in run.stdout.splitlines()
                if ln.startswith('RELOAD '))
    reloaded = json.loads(line[len('RELOAD '):])
    print(f'reload process (tools/port_export_reload.py: imports the '
          f'operators, builds no model): {time.perf_counter() - t0:.1f} s',
          flush=True)
    for key, row in rows.items():
        got = torch.from_numpy(np.load(root / f'{key}.npy'))
        rel = rel_l2(got, row.pop('logits'))
        tol = TOL_EXPORT[row['compute']]
        row.update(reloaded_ms=reloaded[key]['ms'], rel_l2=rel,
                   launches=reloaded[key]['launches'])
        print(f'{key}: reloaded program vs eager forward rel L2 {rel:.3e} '
              f'(tol {tol:g}); launches {row["launches"]}; '
              f'{row["reloaded_ms"]:.3f} ms reloaded, {row["eager_ms"]:.3f}'
              f' ms eager (CUDA-event medians of 5, two processes)',
              flush=True)
        check(bool(torch.isfinite(got).all()) and rel <= tol,
              f'{key}: the reloaded program\'s logits are off: {rel}')
        check(row['launches'] == row.pop('expect'),
              f'{key}: the reloaded program launched {row["launches"]}')
    k1 = {k: r['launches']['fwd'] for k, r in rows.items()
          if k.startswith('nonlocal')}
    k2 = {k: r['launches']['k2'] for k, r in rows.items()
          if k.startswith('slowfast')}
    return rows, k1, k2


def zero_cli_runs(pretorched, torch, np):
    """Phase 20's ImageNet CLI runs: one train step of
    ``se_resnext101_32x4d`` at -b 64 in bf16, plain, then ``--zero`` and
    ``--zero fsdp`` on a mesh of this process; the train transform seeded
    and one loader thread, so the three see the same crops. Returns each
    run's loss; checks the step count, the losses against the plain one and
    that the FSDP run's checkpoint loads strict into a plain model."""
    import pretorched_tpu_torch.transforms as transforms
    from pretorched_tpu_torch.parallel import mesh as meshes

    data = WORK / 'zero_data'
    for split, per in (('train', ZERO_PER_CLASS),
                       ('val', ZERO_VAL_PER_CLASS)):
        for c in range(IMAGENET_CLASSES):
            src = WORK / 'imagenet' / split / f'n{c:08d}'
            dst = data / split / src.name
            dst.mkdir(parents=True)
            for i in range(per):
                os.symlink(src / f'{i:04d}.jpg', dst / f'{i:04d}.jpg')
    cli = load_cli('imagenet_eval_torch')
    base = [str(data), '-a', 'se_resnext101_32x4d', '--bf16', '-b',
            str(IMAGENET_TRAIN_BATCH), '-p', '1', '--lr', '0.001',
            '--device', 'cuda', '--epochs', '1', '-j', '1']
    plain_transform = transforms.TransformImage

    class Seeded(plain_transform):
        def __init__(self, *args, **kw):
            kw.setdefault('seed', 0)
            super().__init__(*args, **kw)

    losses, cwd = {}, os.getcwd()
    transforms.TransformImage = Seeded
    try:
        for label, extra in (('plain', []), ('zero', ['--zero']),
                             ('fsdp', ['--zero', 'fsdp'])):
            if label == 'zero':
                mesh = meshes.make_mesh()
                print(f'make_mesh(): {mesh}, backend '
                      f'{torch.distributed.get_backend()}', flush=True)
                check(tuple(mesh.shape) == (1, 1)
                      and torch.distributed.get_backend() == 'nccl',
                      f'the mesh at world size 1 is {mesh}')
            run_dir = WORK / f'zero_run_{label}'
            run_dir.mkdir()
            os.chdir(run_dir)
            print('examples/imagenet_eval_torch.py ' + ' '.join(base[1:]
                                                                 + extra),
                  flush=True)
            summary = cli.main(base + extra)
            os.chdir(cwd)
            check(summary['train_steps'] == 1,
                  f'{label}: {summary["train_steps"]} train steps')
            losses[label] = summary['last_train']['loss']
    finally:
        transforms.TransformImage = plain_transform
        os.chdir(cwd)
    for label in ('zero', 'fsdp'):
        rel = abs(losses[label] - losses['plain']) / abs(losses['plain'])
        print(f'--zero{" fsdp" if label == "fsdp" else ""}: loss '
              f'{losses[label]:.5f} against the plain step\'s '
              f'{losses["plain"]:.5f}: rel {rel:.2e} (tol {TOL_ZERO_LOSS:g})',
              flush=True)
        check(np.isfinite(losses[label]) and rel <= TOL_ZERO_LOSS,
              f'{label}: the loss is off the plain step\'s')
    state = torch.load(WORK / 'zero_run_fsdp' / 'checkpoint.pth',
                       map_location='cpu', weights_only=True)
    pretorched.se_resnext101_32x4d(pretrained=None).load_state_dict(
        state['model'], strict=True)
    print('the --zero fsdp checkpoint (rank 0, a full state dict) loads '
          'strict into a plain se_resnext101_32x4d', flush=True)
    return losses


def export_mesh_path(pretorched, torch, np, na, fb_cuda, video_cli):
    """Phase 20: the serving export, the golden-accuracy tool and the mesh
    at world size 1 (see the module docstring)."""
    from pretorched_tpu_torch.parallel import mesh as meshes
    from pretorched_tpu_torch.parallel.train import make_train_step
    from pretorched_tpu_torch.parallel.zero import zero_init

    out = {}
    root = WORK / 'export'
    root.mkdir()
    t0 = time.perf_counter()
    out['programs'], k1, k2 = export_programs(pretorched, torch, np, na,
                                              fb_cuda, root)
    out['export_seconds'] = time.perf_counter() - t0

    # the golden-accuracy tool on phase 14's val folder and a hosted resnet18
    donor = pretorched.resnet18(num_classes=1000, pretrained=None)
    randomize_bn(donor, torch, seed=20)
    url = pretorched.pretrained_settings['resnet18']['imagenet']['url']
    torch.save({('fc' + k[len('last_linear'):]
                 if k.startswith('last_linear') else k): v
                for k, v in donor.state_dict().items()},
               WORK / 'zoo' / 'weights' / url.rsplit('/', 1)[-1])
    del donor
    argv = ['--eval', str(WORK / 'imagenet' / 'val'), '-b', '64',
            '--device', 'cuda', '--golden-dir', str(WORK / 'golden'),
            '--image', str(REPO / 'data' / 'cat.jpg'), 'resnet18']
    print('tools/convert_weights_torch.py ' + ' '.join(argv), flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = load_tool('convert_weights_torch').main(argv)
    text = buf.getvalue()
    print(text, flush=True)
    rows = [ln for ln in text.splitlines()
            if ln.startswith('* resnet18/imagenet:')]
    rate = re.search(r'= ([\d.]+) images/s', text)
    n_val = IMAGENET_CLASSES * IMAGENET_PER_CLASS
    check(rc == 1 and len(rows) == 1 and rows[0].endswith('FAIL')
          and f'(n={n_val})' in rows[0] and rate is not None
          and (WORK / 'golden' / 'resnet18-imagenet.npy').exists(),
          f'the golden tool: rc {rc}, rows {rows}')
    out['golden'] = {'row': rows[0], 'images_per_s': float(rate.group(1)),
                     'rc': rc}

    out['zero_cli_losses'] = zero_cli_runs(pretorched, torch, np)

    # ZeRO train steps of the non-local model on the mesh of this process
    mesh = meshes.make_mesh()
    model = pretorched.nonlocalresnet3d50(num_classes=400,
                                          pretrained='kinetics-400')
    model.cuda().bfloat16()
    model, opt = zero_init(model, torch.optim.SGD, mesh, lr=TRAIN_LR,
                           momentum=0.9, weight_decay=1e-4)
    step = make_train_step(model, opt, remat=(0,), mesh=mesh,
                           zero_axis='data')
    x, labels = train_batch(video_cli, model.settings, torch)
    set_counts(na, 0)
    losses, device_ms = [], []
    for i in range(ZERO_STEPS):
        before = counts(na)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        loss = step(x, labels)['loss']
        e1.record()
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(counts(na), before))
        losses.append(loss.item())
        device_ms.append(e0.elapsed_time(e1))
        print(f'ZeRO step {i + 1}: loss {losses[-1]:.4f}, '
              f'{device_ms[-1]:.1f} ms CUDA events, launches fwd/dq/dkv '
              f'{launched}', flush=True)
        check(launched == (5, 5, 5) and np.isfinite(losses[-1]),
              f'ZeRO step {i + 1}: launches {launched}, loss {losses[-1]}')
    expect_kernels(na, TRAIN_KERNELS, ZERO_STEPS, 'ZeRO steps')
    out['zero_steps'] = {'losses': losses, 'device_ms': device_ms,
                         'launches_by_kernel': kernel_counts(na)}
    del model, opt, step, x
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    out['k1_launches'], out['k2_launches'] = k1, k2
    return out


def k1_rows(na, torch, fwd_shapes, bwd_shapes, what, seed):
    """K1-fwd at ``fwd_shapes`` and K1-dq, K1-dkv at ``bwd_shapes`` ({name:
    (B, N, Nk, C, Cv)}), bf16, each held to its plain version at phase 3's
    and phase 5's tolerances, with its time, the plain version's, SDPA's
    and the bound."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    rows = {}
    for (name, (b, n, nk, c, cv)), op in (
            *((item, 'fwd') for item in fwd_shapes.items()),
            *((item, 'bwd') for item in bwd_shapes.items())):
        q = (torch.randn(b, n, c, device='cuda', generator=g)
             / c ** 0.25).bfloat16()
        k = (torch.randn(b, nk, c, device='cuda', generator=g)
             / c ** 0.25).bfloat16()
        v = torch.randn(b, nk, cv, device='cuda', generator=g).bfloat16()
        out, lse = na.nonlocal_attention_cuda(q, k, v)
        bounds = attention_bounds(b, n, nk, c, cv, 'bfloat16')
        shape = f'B={b} N={n} Nk={nk} C={c} Cv={cv}'
        if op == 'fwd':
            want, want_lse = na.nonlocal_attention_fwd_lse_reference(
                q.float(), k.float(), v.float())
            err, err_rel, err_lse = fwd_errors(out, lse, want, want_lse)
            del want, want_lse
            tol, tol_lse = TOL['bfloat16']
            ms = median_ms(lambda: na.nonlocal_attention_cuda(q, k, v))
            plain_ms = median_ms(
                lambda: na.nonlocal_attention_fwd_lse_reference(q, k, v))
            lib_ms, backend = sdpa_ms(torch, q, k, v)
            kernel = na.attention_kernel(torch.bfloat16, c, cv, 'fwd')
            rows[f'fwd {name}'] = {
                'kernel': kernel, 'shape': [b, n, nk, c, cv],
                'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                'library_ms': lib_ms, 'bound_ms': bounds['fwd'][0],
                'bound_by': bounds['fwd'][1]}
            print(f'K1-fwd {name} {what} {shape} bf16 [{kernel}]: '
                  f'max|out-plain|={err:.3e} (tol {tol:g}), /max|plain| '
                  f'{err_rel:.3e} (tol {TOL_REL_BF16:g}), max|lse-plain|='
                  f'{err_lse:.3e} (tol {tol_lse:g}); kernel {ms:.3f} ms, '
                  f'plain {plain_ms:.3f} ms, scaled_dot_product_attention '
                  f'{fmt_ms(lib_ms)} ({backend}), bound '
                  f'{bounds["fwd"][0]:.4f} ms ({bounds["fwd"][1]})',
                  flush=True)
            check(err <= tol and err_rel <= TOL_REL_BF16
                  and err_lse <= tol_lse,
                  f'K1-fwd disagrees with the plain version at {shape}')
        else:
            do = torch.randn(b, n, cv, device='cuda', generator=g).bfloat16()
            delta = (do.float() * out.float()).sum(-1)
            dq = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
            dk, dv = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse,
                                                        delta)
            want = na.nonlocal_attention_bwd_reference(
                q.float(), k.float(), v.float(), out.float(), lse, do.float())
            rels = [rel_to_max(gr, w) for gr, w in zip((dq, dk, dv), want)]
            errs = [(gr.float() - w).abs().max().item()
                    for gr, w in zip((dq, dk, dv), want)]
            del want
            dq_ms = median_ms(lambda: na.nonlocal_attention_bwd_dq_cuda(
                q, k, v, do, lse, delta))
            dkv_ms = median_ms(lambda: na.nonlocal_attention_bwd_dkv_cuda(
                q, k, v, do, lse, delta))
            plain_ms = median_ms(lambda: na.nonlocal_attention_bwd_reference(
                q, k, v, out, lse, do))
            lib_ms, backend = sdpa_ms(torch, q, k, v, do)
            for op_name, ms, err in (('dq', dq_ms, errs[0]),
                                     ('dkv', dkv_ms, max(errs[1:]))):
                rows[f'{op_name} {name}'] = {
                    'kernel': na.attention_kernel(torch.bfloat16, c, cv,
                                                  op_name),
                    'shape': [b, n, nk, c, cv], 'max_abs_err': err,
                    'ms': ms, 'plain_ms': plain_ms,
                    'plain': 'nonlocal_attention_bwd_reference (dq, dk, dv '
                             'together)',
                    'library_ms': lib_ms,
                    'library': 'scaled_dot_product_attention backward (dq, '
                               'dk, dv together)',
                    'bound_ms': bounds[op_name][0],
                    'bound_by': bounds[op_name][1]}
            print(f'K1-dq, K1-dkv {name} {what} {shape} bf16: '
                  f'max|d-plain|/max|d| dq {rels[0]:.2e}, dk {rels[1]:.2e}, '
                  f'dv {rels[2]:.2e} (tol {TOL_BWD["bfloat16"]:g}); dq '
                  f'{dq_ms:.3f} ms (bound {bounds["dq"][0]:.4f}), dkv '
                  f'{dkv_ms:.3f} ms (bound {bounds["dkv"][0]:.4f}), plain '
                  f'backward {plain_ms:.3f} ms, scaled_dot_product_attention '
                  f'backward {fmt_ms(lib_ms)} ({backend})', flush=True)
            check(max(rels) <= TOL_BWD['bfloat16'],
                  f'K1-dq / K1-dkv disagree with the plain backward at '
                  f'{shape}')
            del do, delta, dq, dk, dv
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return rows


def grad_rel(got, want, scale):
    """|got - want| over ``scale``; 0 where both are zero, inf where only
    the difference is not."""
    diff = (got - want).norm().item()
    return diff / scale if scale else (0.0 if diff == 0 else float('inf'))


def timed_peak(fn, torch, reps=3):
    """(median ms by CUDA events of ``reps`` calls after one warm-up, peak
    device memory GiB of one call above what was allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    return median_ms(fn, reps=reps), peak


def pipeline_moe_path(pretorched, na, torch, np):
    """Phase 21: pipeline and expert parallelism (see the module
    docstring). Returns the phase's numbers and K1's launches by program
    in the pipelined forward and backward."""
    import torch.nn.functional as F

    from pretorched_tpu_torch.models.resnet3d import (pipeline_stage_fns,
                                                      split_stage_variables)
    from pretorched_tpu_torch.parallel import mesh as meshes
    from pretorched_tpu_torch.parallel.moe import (moe_apply, moe_reference,
                                                   mstrn_expert_params,
                                                   trn_expert_forward)
    from pretorched_tpu_torch.parallel.pipeline import (
        pipeline_apply, pipeline_apply_stages, sequential_apply,
        stack_block_params)
    out = {'kernel_rows': k1_rows(na, torch, PIPE_SHAPES, PIPE_TRAIN_SHAPES,
                                  'microbatch', 21)}
    devices = ['cuda:0'] * PIPE_STAGES
    g = torch.Generator(device='cuda').manual_seed(21)

    # (a) the pipelined bf16 forward against the whole one
    model = pretorched.nonlocalresnet3d50(num_classes=400,
                                          pretrained='kinetics-400')
    model.cuda().eval().bfloat16()
    fns = pipeline_stage_fns(model)
    x = torch.randn(PIPE_CLIPS, 3, 32, 224, 224, device='cuda', generator=g)
    with torch.inference_mode():
        def piped():
            return pipeline_apply_stages(
                fns, split_stage_variables(model.state_dict()), x,
                devices=devices, n_micro=PIPE_MICRO)

        set_counts(na, 0)
        logits_pp = piped().float()
        torch.cuda.synchronize()
        fwd_launches = counts(na)
        fwd_by_kernel = kernel_counts(na)
        print(f'pipeline_apply_stages(pipeline_stage_fns(nonlocalresnet3d50),'
              f' devices=[cuda:0] x {PIPE_STAGES}, n_micro={PIPE_MICRO}), '
              f'bf16, {PIPE_CLIPS} clips x 32 x 224 px: launches fwd/dq/dkv '
              f'{fwd_launches}, by program {fwd_by_kernel}', flush=True)
        check(fwd_launches == (5 * PIPE_MICRO, 0, 0),
              f'the pipelined forward launched {fwd_launches}')
        expect_kernels(na, EVAL_KERNELS, PIPE_MICRO, 'pipelined forward')
        logits = model(x).float()
        rel = rel_l2(logits_pp, logits)
        pp_ms, pp_gb = timed_peak(piped, torch)
        whole_ms, whole_gb = timed_peak(lambda: model(x), torch)
    print(f'pipelined logits vs the unpipelined bf16 forward: rel L2 '
          f'{rel:.3e} (tol {TOL_LOGITS_BF16:g}); forward {pp_ms:.3f} ms '
          f'pipelined (4 stages one after another on one card) vs '
          f'{whole_ms:.3f} ms whole = {PIPE_CLIPS / pp_ms * 1e3:.2f} vs '
          f'{PIPE_CLIPS / whole_ms * 1e3:.2f} clips/s (CUDA events, median '
          f'of 3); peak device memory above the input {pp_gb:.2f} vs '
          f'{whole_gb:.2f} GiB', flush=True)
    check(logits_pp.shape == (PIPE_CLIPS, 400)
          and bool(torch.isfinite(logits_pp).all())
          and rel <= TOL_LOGITS_BF16,
          f'the pipelined logits are off the whole forward: rel L2 {rel}')
    out['forward'] = {'clips': PIPE_CLIPS, 'n_micro': PIPE_MICRO,
                      'stages': PIPE_STAGES, 'rel_l2': rel,
                      'pipelined_ms': pp_ms, 'whole_ms': whole_ms,
                      'pipelined_peak_gib': pp_gb, 'whole_peak_gib': whole_gb,
                      'launches_by_kernel': fwd_by_kernel}
    del x, logits, logits_pp

    # (b) the pipelined backward: eval BN, a loss linear in the logits
    # (these random weights saturate the softmax of the logits, a
    # cross-entropy of ~400). Held to the unpipelined model's backward of
    # the same 4 microbatches, the gradients summed (cuDNN deterministic;
    # see TOL_PIPE_GRAD for what still differs); the unpipelined backward
    # of the whole batch is printed beside it: with these weights other
    # batch sizes' kernels move the gradients far (PERF.md §6)
    x = torch.randn(PIPE_TRAIN_CLIPS, 3, 32, 224, 224, device='cuda',
                    generator=g)
    weights = torch.randn(PIPE_TRAIN_CLIPS, 400, device='cuda', generator=g)
    params = dict(model.named_parameters())

    def grads(run, parts=1):
        """(loss, each parameter's gradient summed over the parts, the sum
        of its parts' gradient norms)."""
        loss, total, scale = 0.0, {}, dict.fromkeys(params, 0.0)
        for xs, ws in zip(x.chunk(parts), weights.chunk(parts)):
            model.zero_grad(set_to_none=True)
            part = (run(xs).float() * ws).sum() / weights.numel()
            part.backward()
            loss += part.item()
            for k, p in params.items():
                g = p.grad.float()
                total[k] = total[k] + g if k in total else g.clone()
                scale[k] += g.norm().item()
        return loss, total, scale

    def worst(got, want, scale):
        """The largest and the median over the parameters of |got - want|
        over ``scale`` (0 where both are zero)."""
        r = sorted(((grad_rel(got[k], want[k], scale[k]), k)
                    for k in params), reverse=True)
        return {'worst': r[0][0], 'worst_param': r[0][1],
                'median': r[len(r) // 2][0]}

    def pipelined_vs_unpipelined(dtype):
        set_counts(na, 0)
        loss_pp, g_pp, _ = grads(lambda xs: pipeline_apply_stages(
            fns, split_stage_variables(model.state_dict(keep_vars=True)), xs,
            devices=devices, n_micro=PIPE_MICRO))
        launches, by_kernel = counts(na), kernel_counts(na)
        check(launches == (5 * PIPE_MICRO,) * 3,
              f'the pipelined backward launched {launches}')
        expect_kernels(na, TRAIN_KERNELS if dtype == 'bfloat16'
                       else F32_PASS_KERNELS, PIPE_MICRO,
                       f'pipelined backward ({dtype})')
        loss_mb, g_mb, scale_mb = grads(model, PIPE_MICRO)
        loss_whole, g_whole, norm_whole = grads(model)
        res = {'loss': loss_pp, 'loss_microbatches': loss_mb,
               'loss_whole': loss_whole, 'launches_by_kernel': by_kernel,
               'vs_microbatches': worst(g_pp, g_mb, scale_mb),
               'vs_whole_batch': worst(g_pp, g_whole, norm_whole)}
        print(f'pipelined backward, {dtype}, {PIPE_TRAIN_CLIPS} clips in '
              f'{PIPE_MICRO} microbatches, eval BN: launches fwd/dq/dkv '
              f'{launches}, by program {by_kernel}; loss {loss_pp:.6f}, '
              f'unpipelined {loss_mb:.6f} (the same microbatches), '
              f'{loss_whole:.6f} (the whole batch); each of the '
              f'{len(params)} parameters\' gradients against the '
              f'unpipelined backward of the same microbatches, |diff| over '
              f'the sum of the microbatches\' gradient norms: largest '
              f'{res["vs_microbatches"]["worst"]:.2e} '
              f'({res["vs_microbatches"]["worst_param"]}), median '
              f'{res["vs_microbatches"]["median"]:.2e} (tol '
              f'{TOL_PIPE_GRAD[dtype]:g}); rel L2 to the whole batch\'s: '
              f'largest '
              f'{res["vs_whole_batch"]["worst"]:.2e} '
              f'({res["vs_whole_batch"]["worst_param"]}), median '
              f'{res["vs_whole_batch"]["median"]:.2e}', flush=True)
        check(res['vs_microbatches']['worst'] <= TOL_PIPE_GRAD[dtype],
              f'{dtype} pipelined gradients off the unpipelined ones: {res}')
        return res

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        bf16 = pipelined_vs_unpipelined('bfloat16')
        model.float()
        f32 = pipelined_vs_unpipelined('float32')
    finally:
        torch.backends.cudnn.deterministic = deterministic
    bwd_by_kernel = bf16['launches_by_kernel']
    out['backward'] = {'clips': PIPE_TRAIN_CLIPS, 'n_micro': PIPE_MICRO,
                       'bfloat16': bf16, 'float32': f32}
    model.zero_grad(set_to_none=True)
    del model, fns, params, x
    torch.cuda.empty_cache()

    # (c) a homogeneous trunk: blocks 1-32 of resnet3d152's layer3
    deep = pretorched.resnet3d152(num_classes=400, pretrained=None)
    randomize_bn(deep, torch, seed=21)
    blocks = [deep.layer3[i] for i in range(*TRUNK_BLOCKS)]
    stacked = {k: v.cuda() for k, v in stack_block_params(blocks).items()}
    template = blocks[0].cuda().eval()
    del deep, blocks

    def block_fn(p, h):
        # bf16 compute on f32 parameters, as a model's bfloat16() runs
        with torch.autocast('cuda', dtype=torch.bfloat16):
            return torch.func.functional_call(template, p, (h,))

    h = torch.randn(PIPE_CLIPS, 1024, 4, 14, 14, device='cuda',
                    generator=g).bfloat16()
    with torch.inference_mode():
        set_counts(na, 0)
        trunk_pp = pipeline_apply(block_fn, stacked, h, devices=devices,
                                  n_micro=PIPE_MICRO)
        trunk_seq = sequential_apply(block_fn, stacked, h)
        trunk_rel = rel_l2(trunk_pp, trunk_seq)
        trunk_pp_ms, _ = timed_peak(lambda: pipeline_apply(
            block_fn, stacked, h, devices=devices, n_micro=PIPE_MICRO), torch)
        trunk_seq_ms, _ = timed_peak(
            lambda: sequential_apply(block_fn, stacked, h), torch)
    n_blocks = TRUNK_BLOCKS[1] - TRUNK_BLOCKS[0]
    print(f'pipeline_apply of resnet3d152 layer3 blocks {TRUNK_BLOCKS[0]}-'
          f'{TRUNK_BLOCKS[1] - 1} ({n_blocks} stacked, {n_blocks // PIPE_STAGES} '
          f'a stage) on {PIPE_CLIPS} clips (1024, 4, 14, 14) bf16, '
          f'n_micro={PIPE_MICRO}: rel L2 to sequential_apply {trunk_rel:.3e} '
          f'(tol {TOL_LOGITS_BF16:g}); {trunk_pp_ms:.3f} ms pipelined vs '
          f'{trunk_seq_ms:.3f} ms sequential', flush=True)
    check(bool(torch.isfinite(trunk_pp).all())
          and trunk_rel <= TOL_LOGITS_BF16 and counts(na) == (0, 0, 0),
          f'the trunk pipeline is off sequential_apply: {trunk_rel}')
    out['trunk'] = {'blocks': n_blocks, 'clips': PIPE_CLIPS,
                    'rel_l2': trunk_rel, 'pipelined_ms': trunk_pp_ms,
                    'sequential_ms': trunk_seq_ms}

    # (d) the expert-parallel MSTRN head of phase 12's TRN, and moe_apply
    trn = pretorched.trn(num_classes=400, num_segments=8, consensus='MSTRN',
                         arch='resnet50')
    randomize_bn(trn, torch, seed=3)
    trn.cuda().eval()
    videos = torch.randn(*TRN_VIDEOS, device='cuda', generator=g)
    fwd, spec = trn_expert_forward(trn)
    with torch.inference_mode():
        stack = mstrn_expert_params(trn.temporal_relation, spec)
        dense, expert = trn(videos), fwd(videos, stack)
        trn_rel = rel_to_max(expert, dense)
        frames = videos.transpose(1, 2).reshape(-1, *TRN_VIDEOS[1:2],
                                                *TRN_VIDEOS[3:])
        feats = trn.base_module._logits(trn.base_module._features(
            frames)).reshape(TRN_VIDEOS[0], 8, -1)
        from pretorched_tpu_torch.parallel.moe import mstrn_expert_apply
        head_ms = median_ms(lambda: mstrn_expert_apply(stack, spec, feats))
        dense_head_ms = median_ms(lambda: trn.temporal_relation(feats[:, None]))
        trn.bfloat16()
        dense_bf16, expert_bf16 = trn(videos).float(), fwd(videos).float()
        trn_rel_bf16 = rel_l2(expert_bf16, dense_bf16)
    print(f'trn_expert_forward (MSTRN over resnet50, {spec["E"]} experts, '
          f'{TRN_VIDEOS[0]} videos x 8 segments x 224 px, the stack '
          f'precomputed): f32 (TF32 off) max|expert - dense| / max|dense| '
          f'{trn_rel:.3e} (tol {TOL_TRN_EXPERT:g}); bf16 rel L2 '
          f'{trn_rel_bf16:.3e} (tol {TOL_LOGITS_BF16:g}); the f32 head alone '
          f'{head_ms:.3f} ms as experts vs {dense_head_ms:.3f} ms dense',
          flush=True)
    check(trn_rel <= TOL_TRN_EXPERT and trn_rel_bf16 <= TOL_LOGITS_BF16,
          f'the expert-parallel TRN is off the dense one: {trn_rel}, '
          f'{trn_rel_bf16}')
    out['trn'] = {'experts': spec['E'], 'rel_to_max_f32': trn_rel,
                  'rel_l2_bf16': trn_rel_bf16, 'head_ms': head_ms,
                  'dense_head_ms': dense_head_ms}

    # moe_apply on pooled resnet50 features of MOE_TOKENS frames
    base = trn.base_module.float()
    frames = torch.randn(MOE_TOKENS, 3, 224, 224, device='cuda', generator=g)
    with torch.inference_mode():
        tokens = torch.cat([base._logits(base._features(f))
                            for f in frames.split(256)]).float()
    del frames, trn, fwd, stack, videos
    d = tokens.shape[1]
    rng = np.random.RandomState(21)
    experts = {k: v.cuda() for k, v in stack_block_params([
        {'w1': rng.randn(d, MOE_HIDDEN).astype(np.float32) / d ** 0.5,
         'w2': rng.randn(MOE_HIDDEN, d).astype(np.float32) / MOE_HIDDEN ** 0.5}
        for _ in range(MOE_EXPERTS)]).items()}
    # standardized features: their shared mean would route every token to
    # one expert; the router's logits are then N(0, 1), expert 0's skewed
    # to N(0, MOE_SKEW^2), so it wins about a third of the tokens
    tokens = (tokens - tokens.mean(0)) / tokens.std(0).clamp_min(1e-6)
    router = torch.from_numpy(rng.randn(d, MOE_EXPERTS).astype(np.float32)
                              / d ** 0.5).cuda()
    router[:, 0] *= MOE_SKEW

    def expert_fn(p, t):
        return F.gelu(t @ p['w1']) @ p['w2']

    with torch.inference_mode():
        y, aux, metrics = moe_apply(expert_fn, experts, tokens, router,
                                    capacity_factor=1.0)
        ref = torch.from_numpy(moe_reference(expert_fn, experts, tokens,
                                             router, capacity_factor=1.0))
        moe_rel = rel_to_max(y.cpu(), ref)
        dropped = float(metrics['fraction_dropped'])
        moe_ms = median_ms(lambda: moe_apply(expert_fn, experts, tokens,
                                             router, capacity_factor=1.0))
    print(f'moe_apply: {MOE_TOKENS} pooled {d}-d resnet50 features '
          f'(standardized), '
          f'{MOE_EXPERTS} experts (GELU MLP, hidden {MOE_HIDDEN}), skewed '
          f'router, capacity factor 1.0 (capacity {metrics["capacity"]}): '
          f'fraction dropped {dropped:.4f}, aux loss {float(aux):.4f}; '
          f'max|y - moe_reference| / max|ref| {moe_rel:.3e} (tol '
          f'{TOL_MOE:g}); {moe_ms:.3f} ms', flush=True)
    check(moe_rel <= TOL_MOE and dropped > 0,
          f'moe_apply is off the per-token oracle: {moe_rel}, dropped '
          f'{dropped}')
    out['moe'] = {'tokens': MOE_TOKENS, 'experts': MOE_EXPERTS,
                  'fraction_dropped': dropped, 'aux_loss': float(aux),
                  'rel_to_max': moe_rel, 'ms': moe_ms}

    # (e) the mesh paths at world size 1 on NCCL
    mesh = meshes.make_mesh((1, 1), ('data', 'stage'))
    mesh_ep = meshes.make_mesh((1, 1), ('data', 'expert'))
    check(torch.distributed.get_backend() == 'nccl',
          f'the mesh runs on {torch.distributed.get_backend()}')
    with torch.inference_mode():
        trunk_mesh = pipeline_apply(block_fn, stacked, h, mesh,
                                    n_micro=PIPE_MICRO, batch_axes=('data',))
        y_mesh, _, _ = moe_apply(expert_fn, experts, tokens, router, mesh_ep,
                                 capacity_factor=1.0)
    mesh_rel = (rel_l2(trunk_mesh, trunk_pp), rel_to_max(y_mesh, y))
    print(f'the mesh paths at world size 1 (NCCL, {mesh}, {mesh_ep}): '
          f'pipeline_apply rel L2 {mesh_rel[0]:.3e} to the in-process '
          f'pipeline, moe_apply {mesh_rel[1]:.3e} (tol {TOL_PIPE_MESH:g})',
          flush=True)
    check(max(mesh_rel) <= TOL_PIPE_MESH,
          f'the mesh paths differ from the in-process ones: {mesh_rel}')
    out['mesh'] = {'pipeline_rel_l2': mesh_rel[0], 'moe_rel': mesh_rel[1]}
    torch.distributed.destroy_process_group()
    del stacked, template, h, tokens, experts
    torch.cuda.empty_cache()
    return out, fwd_by_kernel, bwd_by_kernel


def grad_spread(got, want):
    """{parameter: |got - want| / |want|}, |want| taken as at least 1e-4 of
    the largest gradient norm (biases that feed a BN or a softmax have no
    gradient but rounding)."""
    floor = 1e-4 * max(g.norm().item() for g in want.values())
    return {n: (got[n] - want[n]).norm().item()
            / max(want[n].norm().item(), floor) for n in want}


def seq_path(pretorched, na, torch, np, cli, unsharded_ms):
    """Phase 22: the seq axis (see the module docstring). ``unsharded_ms``:
    phase 6's step by CUDA events. Returns the phase's numbers."""
    import copy

    from pretorched_tpu_torch.models import nonlocalnet
    from pretorched_tpu_torch.parallel.seq import seq_parallel
    from pretorched_tpu_torch.parallel.train import (cross_entropy,
                                                     make_train_step,
                                                     sgd_step_decay)
    out = {'kernel_rows': k1_rows(na, torch, SEQ_SHAPES, SEQ_SHAPES, 'seq',
                                  22)}
    model = pretorched.nonlocalresnet3d50(num_classes=400,
                                          pretrained='kinetics-400')
    randomize_bn(model, torch, seed=22)
    model.cuda()
    base = copy.deepcopy(model)          # f32, unsharded: the twin
    x, labels = train_batch(cli, model.settings, torch)
    blocks = [m for m in model.modules()
              if isinstance(m, nonlocalnet.NonLocalBlock)]

    # (a) the attention reaches the logits: zeroing W.1 moves them
    model.bfloat16().eval()
    with torch.inference_mode():
        on = model(x[:2]).float()
        kept = [b.W[1].weight.clone() for b in blocks]
        for b in blocks:
            b.W[1].weight.zero_()
        off = model(x[:2]).float()
        for b, w in zip(blocks, kept):
            b.W[1].weight.copy_(w)
    moved = rel_l2(off, on)
    print(f'every BN randomized: zeroing the {len(blocks)} blocks\' W.1 '
          f'moves the bf16 logits of 2 clips by rel L2 {moved:.3e}',
          flush=True)
    check(moved > 1e-3, f'W.1 does not reach the logits: {moved}')

    # (b) bf16 train steps, time-sharded over 2 shards in one process
    seq_parallel(model, shards=SEQ_SHARDS)
    opt, sched = sgd_step_decay(model.parameters(), lr=TRAIN_LR,
                                momentum=0.9, weight_decay=1e-4)
    step = make_train_step(model, opt, sched, remat=(0,))
    attention, shapes = nonlocalnet.auto_nonlocal_attention, []

    def record(q, k, v, *args):
        shapes.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                       v.shape[2]))
        return attention(q, k, v, *args)

    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    set_counts(na, 0)
    device_ms, losses = [], []
    for i in range(TRAIN_STEPS):
        before = counts(na)
        nonlocalnet.auto_nonlocal_attention = record if i == 0 else attention
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        try:
            e0.record()
            res = step(x, labels)
            e1.record()
            torch.cuda.synchronize()
        finally:
            nonlocalnet.auto_nonlocal_attention = attention
        device_ms.append(e0.elapsed_time(e1))
        losses.append(res['loss'].item())
        launched = tuple(a - b for a, b in zip(counts(na), before))
        print(f'seq step {i + 1}: loss {losses[-1]:.4f} '
              f'{device_ms[-1]:.1f} ms CUDA events, launches fwd/dq/dkv '
              f'{launched}', flush=True)
        check(launched == (5, 5, 5) and np.isfinite(losses[-1]),
              f'seq step {i + 1}: launched {launched}, loss {losses[-1]}')
    launches, by_kernel = counts(na), kernel_counts(na)
    expect_kernels(na, TRAIN_KERNELS, TRAIN_STEPS, 'seq train run')
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30 - base_gb
    # phase 6's statistic: the median of steps 2-12
    step_ms = sorted(device_ms[1:])[len(device_ms[1:]) // 2]
    want_shapes = [SEQ_SHAPES['layer2']] * 2 + [SEQ_SHAPES['layer3']] * 3
    print(f'seq_parallel(nonlocalresnet3d50, shards={SEQ_SHARDS}), bf16, '
          f'remat=(0,), {TRAIN_CLIPS} clips x 32 x 224 px: step '
          f'{step_ms:.2f} ms by CUDA events (the median of steps '
          f'2-{TRAIN_STEPS}, {min(device_ms[1:]):.2f}-'
          f'{max(device_ms[1:]):.2f})'
          f' against {unsharded_ms:.2f} ms unsharded (phase 6, the same '
          'statistic) = '
          f'{TRAIN_CLIPS / step_ms * 1e3:.2f} vs '
          f'{TRAIN_CLIPS / unsharded_ms * 1e3:.2f} train clips/s; peak '
          f'device memory above the model {peak_gb:.2f} GiB; K1 launches '
          f'fwd/dq/dkv {launches} in {TRAIN_STEPS} steps, by program '
          f'{by_kernel}; K1 calls of the first step (B, N, Nk, C, Cv) '
          f'{shapes}', flush=True)
    check(shapes == want_shapes, f'K1 ran at {shapes}, not {want_shapes}')
    out['train'] = {'shards': SEQ_SHARDS, 'clips': TRAIN_CLIPS,
                    'step_ms': step_ms, 'steps_ms': device_ms,
                    'unsharded_step_ms': unsharded_ms, 'losses': losses,
                    'peak_gib': peak_gb, 'launches': launches,
                    'launches_by_kernel': by_kernel,
                    'w1_moves_logits': moved}
    del model, opt, sched, step, res
    torch.cuda.empty_cache()

    # (c) the seq step against the unsharded one from the same weights, on
    # 2 clips. In f64 (the attention plain, in f64) with train-mode BN and
    # the cross-entropy the two must agree to rounding. In f32 with the
    # kernels (TF32 off), where f32 is well conditioned: eval BN, a loss
    # linear in the logits, and each non-local block's theta scaled so
    # that its attention logits spread by 1 (on these random weights they
    # spread by up to 2e4: a saturated softmax, whose gradient f32 rounds
    # away with the plain attention as with the kernels). There each
    # parameter's gradient of the seq step (and of the unsharded one) is
    # held to the f64 step's, and a seq step whose halos send no gradient
    # back to their shard (a planted fault) must fail that check
    from pretorched_tpu_torch.parallel import seq as seq_rules

    x2, l2 = x[:SEQ_F32_CLIPS], labels[:SEQ_F32_CLIPS]
    g = torch.Generator(device='cuda').manual_seed(22)
    w2 = torch.randn(SEQ_F32_CLIPS, 400, device='cuda', generator=g)

    def one_step(shards, dtype, train, weights=base):
        m = copy.deepcopy(weights).to(dtype).train(train)
        if shards:
            seq_parallel(m, shards=shards)
        if dtype == torch.float64:
            nonlocalnet.auto_nonlocal_attention = attention_f64
        try:
            logits = m(x2.to(dtype))
            loss = (cross_entropy(logits, l2) if train else
                    (logits * w2.to(dtype)).sum() / w2.numel())
            loss.backward()
        finally:
            nonlocalnet.auto_nonlocal_attention = attention
        return loss.item(), {n: p.grad.double()
                             for n, p in m.named_parameters()}

    stacked_halo = seq_rules._Stacked.halo

    def halo_without_grad(self, x, left, right, value):
        """The planted fault: the halo frames carry no gradient back."""
        out = stacked_halo(self, x.detach(), left, right, value)
        length = x.shape[2]
        return torch.cat([out[:, :, :left], x, out[:, :, left + length:]],
                         dim=2)

    def tempered(weights):
        """A copy of ``weights`` whose non-local blocks' theta is divided
        by the spread (std) of the block's attention logits in the f64 eval
        forward of ``x2``; and those spreads."""
        spreads = []

        def record(q, k, v, *args):
            spreads.append(torch.bmm(q[:, :256], k.transpose(1, 2))
                           .std().item())
            return attention_f64(q, k, v, *args)

        m = copy.deepcopy(weights).double().eval()
        nonlocalnet.auto_nonlocal_attention = record
        try:
            with torch.no_grad():
                m(x2.double())
        finally:
            nonlocalnet.auto_nonlocal_attention = attention
        del m
        t = copy.deepcopy(weights)
        with torch.no_grad():
            for blk, spread in zip([m for m in t.modules() if isinstance(
                    m, nonlocalnet.NonLocalBlock)], spreads, strict=True):
                blk.theta.weight.div_(spread)
                blk.theta.bias.div_(spread)
        return t, spreads

    def together(got, want):
        """All gradients together: rel L2."""
        return (sum((got[n] - want[n]).norm().item() ** 2 for n in want)
                / sum(w.norm().item() ** 2 for w in want.values())) ** 0.5

    def spread_line(what, err, got, want):
        order = sorted(err, key=err.get, reverse=True)
        top = ', '.join(f'{n} {err[n]:.3e}' for n in order[:3])
        return (f'{what}: each gradient worst {top}; median '
                f'{err[order[len(order) // 2]]:.3e}; all together rel L2 '
                f'{together(got, want):.3e}')

    set_counts(na, 0)
    loss_d, gd = one_step(None, torch.float64, True)
    loss_ds, gds = one_step(SEQ_SHARDS, torch.float64, True)
    f64_err = grad_spread(gds, gd)
    f64_worst = max(f64_err, key=f64_err.get)
    f64_loss = abs(loss_ds - loss_d) / loss_d
    del gd, gds
    print(f'{SEQ_F32_CLIPS} clips, f64 (the attention in f64, plain; '
          f'train-mode BN, cross-entropy): loss unsharded {loss_d:.12f}, '
          f'seq {loss_ds:.12f} (rel {f64_loss:.2e}); each of the '
          f'{len(f64_err)} gradients against the unsharded step\'s: worst '
          f'{f64_err[f64_worst]:.3e} ({f64_worst}), median '
          f'{sorted(f64_err.values())[len(f64_err) // 2]:.3e} (tol '
          f'{TOL_SEQ_F64:g})', flush=True)
    check(f64_loss <= TOL_SEQ_F64 and f64_err[f64_worst] <= TOL_SEQ_F64,
          f'the f64 seq step is off the unsharded step: loss {f64_loss}, '
          f'{f64_worst} {f64_err[f64_worst]}')

    cool, spreads = tempered(base)
    lin_d, want = one_step(None, torch.float64, False, cool)
    lin_ref, ref = one_step(None, torch.float32, False, cool)
    lin_seq, got = one_step(SEQ_SHARDS, torch.float32, False, cool)
    seq_rules._Stacked.halo = halo_without_grad
    try:
        lin_bad, bad = one_step(SEQ_SHARDS, torch.float32, False, cool)
    finally:
        seq_rules._Stacked.halo = stacked_halo
    f32_launches = counts(na)
    expect_kernels(na, F32_PASS_KERNELS, 3, 'the f32 seq check')
    err = {k: grad_spread(v, want) for k, v in
           (('seq', got), ('unsharded', ref), ('fault', bad))}
    worst = {k: max(e.values()) for k, e in err.items()}
    loss_err = {k: abs(v - lin_d) / abs(lin_d) for k, v in
                (('seq', lin_seq), ('unsharded', lin_ref), ('fault', lin_bad))}
    print(f'f32 with the kernels, TF32 off, eval BN, a loss linear in the '
          f'logits, each block\'s theta divided by its attention logits\' '
          f'spread ({", ".join(f"{v:.3g}" for v in spreads)}), against the '
          f'f64 unsharded step (tol {TOL_SEQ_F32:g} each '
          f'gradient, {TOL_SEQ_LOSS:g} the loss): loss f64 {lin_d:.10e}, rel '
          f'seq {loss_err["seq"]:.2e}, unsharded '
          f'{loss_err["unsharded"]:.2e}, planted fault '
          f'{loss_err["fault"]:.2e}; launches fwd/dq/dkv {f32_launches}',
          flush=True)
    for k, g_ in (('seq', got), ('unsharded', ref), ('fault', bad)):
        print('  ' + spread_line({'seq': 'seq step', 'unsharded':
                                  'unsharded step', 'fault': 'seq step, '
                                  'halo gradients dropped'}[k], err[k], g_,
                                 want), flush=True)
    check(f32_launches == (15, 15, 15) and worst['seq'] <= TOL_SEQ_F32
          and worst['unsharded'] <= TOL_SEQ_F32
          and loss_err['seq'] <= TOL_SEQ_LOSS
          and loss_err['unsharded'] <= TOL_SEQ_LOSS,
          f'the f32 steps are off the f64 step: gradients {worst}, loss '
          f'{loss_err}, launches {f32_launches}')
    check(worst['fault'] > TOL_SEQ_F32,
          f'the f32 check passes a seq step without halo gradients: {worst}')
    out['f32'] = {'clips': SEQ_F32_CLIPS, 'f64_loss_rel': f64_loss,
                  'logit_spreads': spreads,
                  'f64_worst': f64_err[f64_worst],
                  'f64_worst_param': f64_worst,
                  'loss_rel': loss_err, 'worst': worst,
                  'worst_param': {k: max(e, key=e.get)
                                  for k, e in err.items()},
                  'median': {k: sorted(e.values())[len(e) // 2]
                             for k, e in err.items()},
                  'rel_l2': {'seq': together(got, want),
                             'unsharded': together(ref, want),
                             'fault': together(bad, want)}}
    del want, ref, got, bad
    torch.cuda.empty_cache()

    # (d) the whole-batch backward against its microbatches' (eval BN, a
    # loss linear in the logits, TF32 off): in f32 with cuDNN on and off,
    # on the weights as they are and with (c)'s tempered attention, and in
    # f64 (the attention plain, in f64), where the two must agree
    g = torch.Generator(device='cuda').manual_seed(22)
    weights = torch.randn(TRAIN_CLIPS, 400, device='cuda', generator=g)

    def linear_grads(parts, x):
        total = {}
        w = weights.to(x.dtype)
        for xs, ws in zip(x.chunk(parts), w.chunk(parts)):
            m.zero_grad(set_to_none=True)
            ((m(xs) * ws).sum() / w.numel()).backward()
            for n, p in m.named_parameters():
                total[n] = total[n] + p.grad.double() if n in total \
                    else p.grad.double()
        return total

    out['whole_batch'] = {}
    for name, cudnn, dtype, start in (
            ('cudnn', True, torch.float32, base),
            ('no_cudnn', False, torch.float32, base),
            ('tempered_cudnn', True, torch.float32, cool),
            ('tempered_no_cudnn', False, torch.float32, cool),
            ('f64', True, torch.float64, base)):
        torch.backends.cudnn.enabled = cudnn
        m = copy.deepcopy(start).to(dtype).eval()
        if dtype == torch.float64:
            nonlocalnet.auto_nonlocal_attention = attention_f64
        t0 = time.perf_counter()
        try:
            xs = x.to(dtype)
            whole = linear_grads(1, xs)
            parts = linear_grads(WHOLE_MICRO, xs)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.enabled = True
            nonlocalnet.auto_nonlocal_attention = attention
        rel = grad_spread(parts, whole)
        worst = max(rel, key=rel.get)
        row = {'worst': rel[worst], 'worst_param': worst,
               'median': sorted(rel.values())[len(rel) // 2],
               'seconds': time.perf_counter() - t0}
        out['whole_batch'][name] = row
        print(f'whole-batch backward of {TRAIN_CLIPS} clips against the sum '
              f'of its {WHOLE_MICRO} microbatches\' (eval BN, '
              f'{str(dtype)[6:]}, TF32 off, cuDNN {"on" if cudnn else "off"}'
              f'{", attention tempered as in (c)" if start is cool else ""}'
              f'): rel L2 worst {row["worst"]:.3e} ({worst}), median '
              f'{row["median"]:.3e} over {len(rel)} parameters; '
              f'{row["seconds"]:.1f} s', flush=True)
        del whole, parts, xs, m
    check(out['whole_batch']['f64']['worst'] <= TOL_SEQ_F64,
          f'in f64 the whole batch\'s gradients are off its microbatches\': '
          f'{out["whole_batch"]["f64"]}')
    del cool, base
    torch.cuda.empty_cache()
    return out


def seq_entries(seq, op):
    """The seq phase's keys of K1's ``op`` entry in the kernels line: its
    launches by program in the timed steps and its rows at the seq
    shapes."""
    return {'launches_seq': {k: n for k, n in
                             seq['train']['launches_by_kernel'].items()
                             if k.startswith(op + ' ')},
            'seq_shapes': {k: v for k, v in seq['kernel_rows'].items()
                           if k.startswith(op + ' ')}}


def kernel_label(line):
    """A readable name for a kernel of ptxas's 'Function properties for'
    line: its template arguments spelled out."""
    m = re.search(r'nonlocal_attention_(?:fwd|bwd_dq|bwd_dkv)_wgmma_kernel'
                  r'(?:ILi(\d)E)?', line)
    if m:
        chunks = (f', {m.group(1)} 64-column chunks of O' if m.group(1)
                  else '')
        return (f'{m.group(0).split("ILi")[0]} (bf16, wgmma + TMA ring'
                f'{chunks}, 2 consumer warpgroups at 240 registers, 1 '
                'producer at 24)')
    m = re.search(r'(nonlocal_attention_(?:fwd|bwd_dq|bwd_dkv)_wide_kernel)'
                  r'ILi(\d)E', line)
    if m:
        return (f'{m.group(1)} (bf16, wgmma + TMA, C, Cv <= 512, {m.group(2)} '
                '64-column chunks a consumer, 2 consumer warpgroups at 240 '
                'registers, 1 producer at 24)')
    m = re.search(r'nonlocal_attention_(fwd|bwd)_tf32_wgmma_kernelILi(\d+)E',
                  line)
    if m:
        return (f'nonlocal_attention_{m.group(1)}_tf32_wgmma_kernel (f32 '
                f'{"K1-fwd" if m.group(1) == "fwd" else "K1-dq, K1-dkv"} on '
                f'TF32 wgmma + TMA, 3 products; {m.group(2)} output columns '
                f'a consumer, 2 consumer warpgroups at 240 registers, 1 '
                f'producer at 24)')
    m = re.search(r'nonlocal_attention_(fwd|bwd)_cu\w*tf32_split_kernel', line)
    if m or 'tf32_split_kernel' in line:
        where = (f' of K1-{"fwd" if m.group(1) == "fwd" else "dq, K1-dkv"}'
                 if m else '')
        return (f'tf32_split_kernel (tf32_wgmma\'s pre-pass{where}: the '
                'operands\' TF32 halves, transposed where a product needs '
                'it)')
    m = re.search(r'nonlocal_attention_(fwd|bwd)_tf32x3_kernelILi(\d+)E',
                  line)
    if m:
        return (f'nonlocal_attention_{m.group(1)}_tf32x3_kernel (f32 on '
                f'mma.sync TF32, 3 products; {m.group(2)} 8-column tiles a '
                f'warp, up to {16 * int(m.group(2))} output columns a block)')
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
    eval_launches, eval_by_kernel, eval_layer3, cli, s2d_eval = main_path(
        pretorched, na, torch, np)
    # the s2d A/B's buffers (f32 stem outputs of 2 GB) go back to the card
    # before the training phases allocate
    torch.cuda.empty_cache()

    phase('5. non-local attention backward kernels vs plain PyTorch; K1\'s '
          'done line at N = 65,536')
    k1b = backward_vs_plain(na, torch)
    done_line = k1_done_line(na, torch)

    phase(f'6. training path: nonlocalresnet3d50, {TRAIN_STEPS} steps of '
          f'{TRAIN_CLIPS} clips x 32 frames x 224 px')
    train_launches, train_by_kernel, train_layer3, train_ms = train_path(
        pretorched, na, torch, np, cli)

    phase('6b. the f32 fine-tuning step: nonlocalresnet3d50 in f32, TF32 '
          f'off, {TRAIN_CLIPS} clips x 32 frames x 224 px, K1 on '
          'tf32_wgmma, K1-fwd alone on tf32x3, all three on tf32x3 and on '
          'the scalar programs in turns')
    f32_train = train_f32_path(pretorched, na, torch, np, cli)

    phase('7. gradient agreement: f32 step with the kernels, with the plain '
          'attention, and in f64')
    gradient_agreement(pretorched, na, torch, cli)

    phase('8. fused bottleneck tail kernel (K2) vs plain PyTorch')
    k2 = k2_vs_plain(torch, fb, fb_cuda, slowfast)

    phase(f'9. eval path: slowfast_resnet50, fused_blocks=32, {SF_CLIPS} '
          f'clips x {SF_FRAMES} frames x 224 px')
    k2_launches, k2_by_kernel, s2d_sf = slowfast_path(pretorched, torch, np,
                                                      cli, na, fb_cuda)

    phase('10. serving: resnet50 images and nonlocalresnet3d50 clips '
          'through serving.serve_model')
    served = serving_path(pretorched, na, torch, np)

    phase('11. eval path: r2plus1d50, 20 clips x 16 frames x 112 px, '
          'plain and s2d stems; resnext3d101, preact_resnet3d50, '
          'wideresnet3d50, resneti3d50')
    videos = video_models_path(pretorched, torch, na, fb_cuda)

    phase('12. eval path: trn (MSTRN over resnet50), 8 videos x 8 segments '
          'x 224 px')
    trn = trn_path(pretorched, torch)

    phase('13. MNISTNonLocalNet: K1-fwd on wgmma (bf16) and tf32_wgmma '
          '(f32)')
    mnist = mnist_path(na, torch)

    phase('14. BASELINE config 2 through examples/imagenet_eval_torch.py: '
          'se_resnext101_32x4d and nasnetamobile (eval, fast pipeline, '
          'ten-crop, train, resume), nasnetalarge at 331 px')
    torch.cuda.empty_cache()
    imagenet = imagenet_path(pretorched, torch, np, na, fb_cuda)

    phase('15. native-length eval: nonlocalresnet3d50, --frames native, '
          f'{NATIVE_CLIPS} clips, buckets {sorted(NATIVE_BUCKETS)}')
    native = native_path(pretorched, na, torch, np, cli)

    phase('16. BASELINE config 5: biggan256 (ch 96, 1000 classes) sampling '
          f'{BIGGAN_BATCH} images in bf16, K1-fwd at SAGAN\'s shapes')
    gan = biggan_path(na, torch)

    phase('17. the 2D families: ' + ', '.join(FAMILY_MODELS)
          + '; examples/imagenet_eval_torch.py -a resnext101_64x4d')
    families = families_path(pretorched, torch, np, na, fb_cuda)

    phase('18. the rest of the 2D zoo: ' + ', '.join(ZOO_MODELS)
          + '; examples/imagenet_eval_torch.py -a inceptionv4 (eval), '
          '-a dpn68b (a train step)')
    zoo = zoo_path(pretorched, torch, np, na, fb_cuda)

    phase('19. the video and audio families and VOC transfer: '
          + ', '.join(VIDEO_FAMILIES) + ', soundnet8 and BranchedSoundNet '
          'on WAVs; examples/voc2007_extract_torch.py -a resnet50, '
          'examples/visu_arch_torch.py -a resnet18')
    video_audio = video_audio_path(pretorched, torch, np, na, fb_cuda)

    phase('20. serving export of nonlocalresnet3d50, slowfast_resnet50 '
          '(fused_blocks=32) and resnet50 (symbolic batch), reloaded in a '
          'fresh process; the golden-accuracy tool; the mesh at world size '
          '1: --zero and --zero fsdp, ZeRO train steps')
    exported = export_mesh_path(pretorched, torch, np, na, fb_cuda, cli)

    phase('21. pipeline and experts: nonlocalresnet3d50 pipelined over its '
          f'four stages ({PIPE_CLIPS} clips forward, {PIPE_TRAIN_CLIPS} '
          'backward, 4 microbatches), resnet3d152 layer3 as a 4-stage '
          'trunk, the expert-parallel MSTRN head, moe_apply, the mesh paths '
          'at world size 1')
    piped, pipe_fwd, pipe_bwd = pipeline_moe_path(pretorched, na, torch, np)

    phase(f'22. the seq axis: nonlocalresnet3d50 time-sharded over '
          f'{SEQ_SHARDS} shards in one process, {TRAIN_STEPS} bf16 train '
          f'steps of {TRAIN_CLIPS} clips x 32 x 224 px; K1 at the seq shapes; the '
          'f32 step against the unsharded one; the whole-batch backward')
    seq = seq_path(pretorched, na, torch, np, cli, train_ms)

    phase('23. result')
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
         'launches_eval_s2d_forward': s2d_eval['k1_launches'],
         'launches_serving': served['launches'],
         'launches_mnist': mnist['launches_by_kernel'],
         'launches_native': native['launches'],
         'launches_by_kernel_native': native['launches_by_kernel'],
         'native_buckets': native['kernel_rows'],
         'shapes_mnist': [list(x) for x in MNIST_SHAPES],
         'launches_by_kernel': fwd_by_kernel,
         'launches_exported': exported['k1_launches'],
         'launches_pipelined': {'forward': pipe_fwd, 'backward': pipe_bwd},
         'pipelined_shapes': {k: v for k, v in piped['kernel_rows'].items()
                              if k.startswith('fwd')},
         **seq_entries(seq, 'fwd'),
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
        {'name': 'nonlocal_attention_fwd_mnist', 'route': 'cuda',
         'source': src + 'nonlocal_attention_fwd.cu', 'replaces': pallas + '33',
         'note': 'K1-fwd at MNISTNonLocalNet\'s shapes: the wgmma program '
                 'in bf16 on C = 16 and 32 padded to 64 by TMA (tf32_wgmma '
                 'in f32, launches_by_kernel); earlier_ms: the mma.sync '
                 'program it replaced there',
         'launches': sum(mnist['launches_by_kernel']['bfloat16'].values()),
         'launches_by_kernel': mnist['launches_by_kernel'],
         **mnist['timed'][MNIST_SHAPES[0]], 'shape': list(MNIST_SHAPES[0]),
         'dtype': 'bfloat16',
         'other_shapes': {str(list(k)): v for k, v in mnist['timed'].items()
                          if k != MNIST_SHAPES[0]}},
        {'name': 'nonlocal_attention_fwd_sagan', 'route': 'cuda',
         'source': src + 'nonlocal_attention_fwd.cu', 'replaces': pallas + '33',
         'note': 'K1-fwd at SAGAN\'s shapes in biggan256 sampling: the '
                 'wide wgmma program in bf16 on C = 96 padded to 128 by TMA '
                 '(biggan128\'s and the golden lock\'s on the narrow one, '
                 'tf32_wgmma in f32: other_shapes); earlier_ms: the '
                 'program it replaced there (mma.sync in bf16, tf32x3 in '
                 'f32)',
         'launches': gan['launches'],
         'launches_by_kernel': gan['launches_by_kernel'],
         **gan['kernel_rows']['biggan256 ch96 bfloat16'],
         'other_shapes': {k: v for k, v in gan['kernel_rows'].items()
                          if k != 'biggan256 ch96 bfloat16'}},
        {'name': 'nonlocal_attention_fwd_f32', 'route': 'cuda',
         'source': src + 'nonlocal_attention_fwd.cu', 'replaces': pallas + '33',
         'note': 'K1-fwd in f32 on TF32 wgmma + TMA (tf32_wgmma: three '
                 'TF32 products per f32 product, q and k split and v split '
                 'and transposed by a pre-pass, whose time is in ms) at '
                 'phase 3\'s layer-2 shape; launches: phase 6b\'s f32 '
                 'steps (launches_by_kernel, tf32x3\'s and scalar\'s in '
                 'the turns that force them); earlier_ms: the mma.sync '
                 'tf32x3 program it replaced, scalar_ms the scalar one; '
                 'layer3: the same at layer 3; train_shapes: the done '
                 'line\'s f32 block; sagan: phase 16\'s f32 rows',
         'launches': f32_train['launches_by_kernel']['fwd tf32_wgmma'],
         'launches_by_kernel': {
             k.split(' ', 1)[1]: n
             for k, n in f32_train['launches_by_kernel'].items()
             if k.startswith('fwd ')},
         'launches_biggan256_f32': gan['launches_by_kernel_f32'],
         **k1['layer2 float32'], 'layer3': k1['layer3 float32'],
         'train_shapes': {name: {key: row[key] for key in (
             'shape', 'programs', 'ms', 'tf32x3_ms', 'scalar_ms',
             'bound_ms', 'bound_ms_cuda_cores', 'library_ms',
             'fwd_max_abs_err')}
             for name, row in done_line['float32'].items()},
         'sagan': {k: v for k, v in gan['kernel_rows'].items()
                   if k.endswith('float32')}},
        {'name': 'nonlocal_attention_bwd_dq', 'route': 'cuda',
         'source': src + 'nonlocal_attention_bwd.cu', 'replaces': pallas + '141',
         'launches': train_launches[1], **k1b['layer2']['dq'],
         'launches_pipelined': {k: n for k, n in pipe_bwd.items()
                                if k.startswith('dq')},
         'pipelined_shapes': {k: v for k, v in piped['kernel_rows'].items()
                              if k.startswith('dq')},
         **seq_entries(seq, 'dq'),
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
         'launches_pipelined': {k: n for k, n in pipe_bwd.items()
                                if k.startswith('dkv')},
         'pipelined_shapes': {k: v for k, v in piped['kernel_rows'].items()
                              if k.startswith('dkv')},
         **seq_entries(seq, 'dkv'),
         'launches_by_kernel': dkv_by_kernel,
         'shape': list(TRAIN_SHAPES['layer2']), 'dtype': 'bfloat16'},
        {'name': 'nonlocal_attention_bwd_dkv_wide', 'route': 'cuda',
         'source': src + 'nonlocal_attention_bwd.cu', 'replaces': pallas + '172',
         'note': 'K1-dkv' + layer3,
         'launches': train_layer3[2], **k1b['layer3']['dkv'],
         'shape': list(TRAIN_SHAPES['layer3']), 'dtype': 'bfloat16'},
        *[{'name': f'nonlocal_attention_bwd_{op}_f32', 'route': 'cuda',
           'source': src + 'nonlocal_attention_bwd.cu',
           'replaces': pallas + ('141' if op == 'dq' else '172'),
           'note': f'K1-{op} in f32 on TF32 wgmma + TMA (tf32_wgmma: three '
                   'TF32 products per f32 product, the operands split into '
                   'their TF32 halves by a pre-pass, whose time is in ms); '
                   'launches: phase 6b\'s f32 steps (launches_by_kernel, '
                   'the tf32x3 and scalar programs\' in the turns that '
                   'force them); earlier_ms: the mma.sync tf32x3 program it '
                   'replaced, scalar_ms the scalar one; layer3: the same at '
                   'layer 3; train_shapes: the done line\'s f32 block',
           'launches': f32_train['launches_by_kernel'][f'{op} tf32_wgmma'],
           'launches_by_kernel': {
               k.split(' ', 1)[1]: n
               for k, n in f32_train['launches_by_kernel'].items()
               if k.startswith(op + ' ')},
           **k1b['layer2 float32'][op], 'shape': list(TRAIN_SHAPES['layer2']),
           'dtype': 'float32', 'layer3': {
               **k1b['layer3 float32'][op],
               'shape': list(TRAIN_SHAPES['layer3'])},
           'train_shapes': {name: {
               'ms': row['ms'][op], 'tf32x3_ms': row['tf32x3_ms'][op],
               'scalar_ms': row['scalar_ms'][op],
               'bound_ms': row['bound_ms'][op],
               'max_rel_err': row['max_rel_err']}
               for name, row in done_line['float32'].items()}}
          for op in ('dq', 'dkv')],
        {'name': 'fused_bottleneck_tail', 'route': 'cuda',
         'source': src + 'fused_block.cu',
         'replaces': 'pretorched_tpu/ops/pallas/fused_block.py:69',
         'launches': k2_launches, 'launches_by_kernel': k2_by_kernel,
         'launches_s2d_forward': s2d_sf['k2_launches'],
         'launches_exported': exported['k2_launches'],
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
        's2d': {'nonlocalresnet3d50': s2d_eval, 'slowfast_resnet50': s2d_sf},
        'video_models': videos, 'trn': trn, 'imagenet': imagenet,
        'biggan': {k: v for k, v in gan.items() if k != 'kernel_rows'},
        'families': families, 'zoo': zoo, 'video_audio': video_audio,
        'export_mesh': {k: v for k, v in exported.items()
                        if not k.endswith('_launches')},
        'native': {k: native[k] for k in ('buckets', 'path_clips_per_s')},
        'pipeline': {k: piped[k] for k in ('forward', 'backward', 'trunk',
                                           'mesh')},
        'moe': {'trn': piped['trn'], 'moe_apply': piped['moe']},
        'seq': {k: seq[k] for k in ('train', 'f32', 'whole_batch')},
        'train_f32': {k: v for k, v in f32_train.items()
                      if k != 'launches_by_kernel'},
        'k1_done_line': done_line, 'card': card}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        main()
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        sys.exit(1)
