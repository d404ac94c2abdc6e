#!/usr/bin/env python3
"""Probes behind the design choices of the port's K1-dq, K2, wide K1-fwd,
K1-dq and K1-dkv and f32 K1-fwd kernels, on one CUDA card (``pretorched_tpu_torch``; no
JAX).

    python3 tools/port_kernel_probes.py [k2] [dq] [lr] [wide] [tf32]
        [tf32_timing] [tf32_loads] [fwd32] [tw32] [tw32fwd] [host]

* ``k2``: builds variants of ``csrc/fused_block.cu`` (the source with one
  textual change each) into their own libraries and times the TMA kernel
  of each at the slice's four shapes, with the mma.sync kernel beside it:
  ``base``; ``no_compute`` (no conv2, conv3 or epilogue: loads, staging,
  stores and barriers alone); ``no_conv2``; ``no_conv3``; ``one_tile``
  and ``two_tiles`` (a warp takes one, or two interleaved, 16-pixel tiles
  whatever Cm and the residual); ``cout128`` (the TMA kernel also at Cout
  = 128 with one block an SM, as fast res4 needs).
* ``dq``: the same for ``csrc/nonlocal_attention_bwd.cu``'s wgmma K1-dq at
  the train shapes: ``base`` against ``branch`` (the dq product guarded by
  ``if (j < nw)``, which ptxas serializes).
* ``lr``: 12 bf16 train steps of ``chip_smoke.py``'s phase 6 (same
  fabricated checkpoint, batch and SGD) at lr 0.01 and 0.001, each with
  K1-dq on wgmma, on the generic kernel, and with the plain backward.
* ``wide``: the wide wgmma programs of K1-fwd, K1-dkv and K1-dq at layer 3
  (C = Cv = 512, N = Nk = 784): ``base`` (one ring slot of 64 keys, of 32
  queries, of 32 keys) against ``tk32x2`` (K1-fwd: 2 slots of 32 keys),
  ``tq16x2`` (K1-dkv: 2 slots of 16 queries), ``tk16x2`` (K1-dq: 2 slots of
  16 keys) and ``undefined_acc`` (K1-dkv's or K1-dq's score accumulators
  left undefined before their products, which ptxas serializes: C7515),
  with the largest difference from ``base``; K1-dq also beside the generic
  mma.sync program it replaced.
* ``tf32``: the f32 tensor-core programs of K1-dq and K1-dkv (tf32x3) at
  the train shapes of layers 2 and 3, ``sub_sample`` and the seq axis:
  ``base`` against ``truncating`` (every sum accumulated on the tensor
  cores, whose adds truncate, instead of partials joined by f32 adds),
  ``cvt`` (``cvt.rna.tf32.f32`` for the TF32 rounding), ``k32``
  (32-channel chunks of s and dp), ``all_tiles`` (every 8-column tile a
  warp holds multiplied, whatever the output's width: no branch), ``stages4``
  (a 4-slot ring), ``max_nt16`` (at most 16 tiles a warp: layer 3's
  512 columns in two grid.z chunks, each forming s and dp),
  ``two_blocks`` (two blocks an SM: at most 128 registers a thread and
  32-channel chunks) and ``two_blocks_s_truncating`` (that, with the s
  and dp chunks summed on the tensor cores: fewer live registers), each timed in
  turns with the scalar program beside them and held to the plain f32
  backward and to an f64 one (max error over the largest gradient); each
  variant's registers and the SASS opcode counts of its kernel at 16 tiles
  a warp (layer 2). ``tf32_timing``: the same against variants whose
  gradients are wrong, for their times alone: ``one_product`` (one TF32
  product per f32 product), ``no_split`` (three products of the unsplit
  bits: no split arithmetic) and both. ``tf32_loads``: likewise without
  the row chunks (``no_row_loads``), the column chunks (``no_col_loads``)
  or the rows of m (``no_m_loads``) copied from L2.
* ``fwd32``: the f32 K1-fwd on the tensor cores (tf32x3, ``csrc/
  nonlocal_attention_fwd.cu``) at layers 2 and 3's train shapes and
  SAGAN's: ``base`` against ``stages2`` and ``stages4`` (a 2- or 4-slot
  ring), ``k32`` (32-channel chunks of s), ``two_blocks`` (two blocks an
  SM: at most 128 registers a thread, 32-channel chunks), ``lo_raw`` (the
  low TF32 half passed unrounded: the tensor cores drop its low 13 bits),
  ``across_tiles`` (the three products of four tiles issued product by
  product across the tiles, in place of each tile's back to back as
  ``mma_tf32x3`` orders them) and, for their times alone (their outputs are wrong), ``one_product``
  (one TF32 product per f32 product), ``no_split`` (three products of the
  unsplit bits), ``own_max`` (each warp scales by its own half's row max:
  no exchange through shared memory, no extra barrier) and ``no_q_loads``,
  ``no_k_loads``, ``no_v_loads`` (a stage's copies from L2 left out); each
  timed in turns with the scalar program beside them, held to the plain
  f32 forward and to an f64 one (max |out - ref| and |lse - ref|), with
  its registers a thread at every instantiation and the SASS opcode counts
  at 16 tiles a warp (layer 2).
* ``tw32``: the f32 K1-dq and K1-dkv on TF32 wgmma + TMA (tf32_wgmma,
  ``csrc/nonlocal_attention_bwd.cu``) at the train shapes of layers 2
  and 3, ``sub_sample``, the seq axis and the narrow f32 widths
  (SAGAN's, the MNIST net's): ``base`` (score stages issued eight at a
  time, 6 ring slots, one X buffer, a tile's first m chunk released as
  soon as its products are done) against ``pairs`` and ``u4`` (two or
  four at a time: the tensor cores drain more often), ``x2_stages5``
  (two X buffers, 5 slots), ``whole_m`` (the m slots released after the
  whole X m product), ``first_build`` (those three together: the order
  of this program's first build), ``cross`` (each stage's partial and
  each tile's X m product left pending across loop iterations, so the
  tensor cores never drain: ptxas serializes the wgmmas instead),
  ``rows_evict_last`` (the rows' copies marked evict-last in L2) and
  ``truncating`` (each output's sum accumulated on the tensor cores over
  the whole streamed axis, no per-tile partial joined by an f32 add),
  each held to the plain f32 backward and to an f64 one; and, for their
  times alone (their outputs are wrong), ``prep_only`` (the pre-pass
  that splits and transposes the operands, alone: what splitting in
  shared memory could save at most), ``no_prep`` (the main kernel alone,
  on the scratch as it was), ``shared_rows`` (every block copies the
  same rows' operands, which then stay in L2), ``one_product`` (hi hi
  alone: one TF32 product per f32 product), ``no_lo_loads`` (the lo
  halves not copied from L2: half the bytes, as operands split in shared
  memory would move), ``no_scores`` (no product of s or dp issued) and
  ``no_x_m`` (no X m product issued): the phases' shares; each timed in
  turns with the mma.sync tf32x3 program beside them, with its
  registers.
* ``tw32fwd``: the f32 K1-fwd on TF32 wgmma + TMA (tf32_wgmma, ``csrc/
  nonlocal_attention_fwd.cu``) at layers 2 and 3 and SAGAN's shapes:
  ``base`` (score stages issued eight at a time, 6 ring slots, O's
  columns in grid.z parts of at most 256) against ``pairs`` (two at a
  time), ``stages4`` and ``stages5`` (4 or 5 ring slots), ``z4`` (parts
  of at most 128 columns: layer 3's 512 in four, each forming s again),
  ``truncating`` (P v accumulated on the tensor cores over all keys, O
  rescaled before each tile's product, no partial joined by an f32 add)
  and ``lo_raw`` (the low halves left unrounded, x - hi: equal to
  ``base`` bit for bit only if the tensor cores drop an operand's low 13
  bits), each held to the plain f32 forward and to an f64 one; and, for
  their times alone (their outputs are wrong), ``prep_only`` (the
  pre-pass alone), ``no_prep`` (the main kernel alone), ``one_product``
  (hi hi alone), ``no_pv`` (no P v product issued), ``no_q_loads`` and
  ``no_v_loads`` (a stage's q, or v^T, copies from L2 left out: what
  keeping the block's q resident in shared memory could save at most,
  and the P v operand's share); each timed in
  turns with tf32x3, scalar and one f32 SDPA call beside them, with the
  bound at the TF32 rate over 3 and its registers.
* ``host``: the host time of one K1-fwd wrapper call at layer 3's widths
  (B = 1 and 8), step by step (checks, allocation, device context and
  stream, pointers, the C entry with its four tensor maps and launch, the
  count), beside the mma.sync C entry's, one SDPA call's, and the CUDA-
  event times of the wrapper's call and of the bare C entry's.

Variant libraries go to ``build/probes/``. Every line names the card, and
every ptxas note the kernel it is about.
"""

import ctypes
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / 'build' / 'probes'
CSRC = REPO / 'pretorched_tpu_torch' / 'csrc'

K2_LOOP = 'for (int m0 = warp; m0 < mt; m0 += NT * kWarps) {'
K2_TAPS = ('      for (int tap = 0; tap < 9; ++tap) {\n'
           '        const int shift')
K2_CONV3 = ('            for (int e = 0; e < 4; ++e) acc3[u][j][e] = '
            'accp[u][j][e] = 0.f;\n        for (int ks = 0; ks < k2; ++ks) {')
K2_NT = 'constexpr int NT = CM <= 16 && !PROJ ? 2 : 1;'
K2_VARIANTS = {
    'base': [],
    'no_compute': [(K2_LOOP, K2_LOOP.replace('m0 < mt', 'm0 < 0'))],
    'no_conv2': [(K2_TAPS, K2_TAPS.replace('tap < 9', 'tap < 0'))],
    'no_conv3': [(K2_CONV3, K2_CONV3.replace('ks < k2', 'ks < 0'))],
    'one_tile': [(K2_NT, 'constexpr int NT = 1;')],
    'two_tiles': [(K2_NT, 'constexpr int NT = 2;')],
    'cout128': [('constexpr int kTmaMaxCout = 64;',
                 'constexpr int kTmaMaxCout = 128;'),
                ('kTwoBlocksSmem = 110 * 1024',
                 'kTwoBlocksSmem = 200 * 1024')],
}
DQ_NB = """          wgmma_rs_n64(acc[j], pa[kk],
                       wgmma_desc(kt + kk * 16 * 128 + (j < nw ? j : 0) * 8192,
                                  0, 1024),
                       1);"""
DQ_BRANCH = """          if (j < nw)
            wgmma_rs_n64(acc[j], pa[kk],
                         wgmma_desc(kt + kk * 16 * 128 + j * 8192, 0, 1024),
                         1);"""
DQ_VARIANTS = {'base': [], 'branch': [(DQ_NB, DQ_BRANCH)]}
WIDE_FWD_VARIANTS = {
    'base': [],
    'tk32x2': [('kFwdWideTk = 64;', 'kFwdWideTk = 32;'),
               ('kFwdWideStages = 1;', 'kFwdWideStages = 2;')]}
WIDE_DKV_VARIANTS = {
    'base': [],
    'tq16x2': [('kDkvWideTq = 32;', 'kDkvWideTq = 16;'),
               ('kDkvWideStages = 1;', 'kDkvWideStages = 2;')],
    'undefined_acc': [
        ('float st[TQ / 2] = {};\n        reg_fence(st);', 'float st[TQ / 2];'),
        ('float dp[TQ / 2] = {};   // as st above\n        reg_fence(dp);',
         'float dp[TQ / 2];')]}
WIDE_DQ_VARIANTS = {
    'base': [],
    'tk16x2': [('kDqWideTk = 32;', 'kDqWideTk = 16;'),
               ('kDqWideStages = 1;', 'kDqWideStages = 2;')],
    'undefined_acc': [
        ('float st[TK / 2] = {};\n        reg_fence(st);', 'float st[TK / 2];'),
        ('float dp[TK / 2] = {};   // as st above\n        reg_fence(dp);',
         'float dp[TK / 2];')]}
# tf32x3 (the f32 K1-dq and K1-dkv) against: its sums accumulated on the
# tensor cores (which truncate), cvt.rna.tf32.f32 for the TF32 rounding,
# 32-channel chunks, every 8-column tile multiplied whatever the output's
# width, a 4-slot ring, at most 16 tiles a warp (layer 3's 512 columns over
# grid.z, s and dp formed twice)
TF32_TRUNCATING = [
    ('      mma_tf32x3(partial[t], ahi, alo, bhi, blo);\n    }\n  }\n'
     '#pragma unroll\n  for (int t = 0; t < 4; ++t)\n#pragma unroll\n'
     '    for (int e = 0; e < 4; ++e) acc[t][e] += partial[t][e];\n}\n',
     '      mma_tf32x3(acc[t], ahi, alo, bhi, blo);\n    }\n  }\n'
     '  (void)partial;\n}\n'),
    ('            mma_tf32x3(partial[t], ahi, alo, bhi, blo);',
     '            mma_tf32x3(acc[t0 + t], ahi, alo, bhi, blo);'),
    ('          for (int e = 0; e < 4; ++e) acc[t0 + t][e] += partial[t][e];',
     '          for (int e = 0; e < 4; ++e) (void)partial[t][e];')]
TF32_CVT = ('mma_tiles.cuh',
            '  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;',
            '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : '
            '"f"(x));\n  return r;')
TF32_VARIANTS = {
    'base': [],
    'truncating': TF32_TRUNCATING,
    'cvt': [TF32_CVT],
    'k32': [('constexpr int kTK = 64; ', 'constexpr int kTK = 32; ')],
    'all_tiles': [('        if (t0 >= live) break;', '')],
    'stages4': [('constexpr int kTStages = 3; ', 'constexpr int kTStages = 4; ')],
    'max_nt16': [('constexpr int kTMaxNT = 32;', 'constexpr int kTMaxNT = 16;')],
    'two_blocks': [('__launch_bounds__(kTThreads)\n',
                    '__launch_bounds__(kTThreads, 2)\n'),
                   ('constexpr int kTK = 64; ', 'constexpr int kTK = 32; ')]}
TF32_VARIANTS['two_blocks_s_truncating'] = (
    TF32_VARIANTS['two_blocks'] + TF32_TRUNCATING[:1])
# timing only (their gradients are wrong): one TF32 product per f32 product,
# and no split arithmetic (hi = lo = the f32 bits, three products)
TF32_TIMING_VARIANTS = {
    'base': [],
    'one_product': [('mma_tiles.cuh', '''  mma_tf32(d, alo, bhi[0], bhi[1]);
  mma_tf32(d, ahi, blo[0], blo[1]);
  mma_tf32(d, ahi, bhi[0], bhi[1]);''', '''  mma_tf32(d, ahi, bhi[0], bhi[1]);''')],
    'no_split': [('mma_tiles.cuh', '''  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));''', '''  hi = lo = __float_as_uint(x);''')]}
TF32_TIMING_VARIANTS['one_product_no_split'] = (
    TF32_TIMING_VARIANTS['one_product'] + TF32_TIMING_VARIANTS['no_split'])
# and without the block's row chunks of s and dp, the tile's column chunks,
# or the rows of m: what their copies from L2 cost
TF32_LOAD_VARIANTS = {
    'base': [],
    'no_row_loads': [(
        '        load_tile_f32_async<kTRows, kTK, kTThreads>(\n'
        '            slot, kTLdK, is_s ? ra : rb, ch, r0, p.rows, k0, ch, vec);\n',
        '')],
    'no_col_loads': [(
        '        load_tile_f32_async<kTCols, kTK, kTThreads>(\n'
        '            slot + kTRows * kTLdK, kTLdK, is_s ? ca : cb, ch, c0, p.cols,\n'
        '            k0, ch, vec);\n', '')],
    'no_m_loads': [(
        '        load_tile_f32_async<kKM, 16 * NT, kTThreads>(\n'
        '            slot, kLdM, m, part.w, c0 + (j - n_s - n_dp) * kKM, p.cols, w0,\n'
        '            part.w, vec_m);\n', '')]}
TF32_SHAPES = {'layer2': (8, 6272, 6272, 256, 256),
               'layer3': (8, 784, 784, 512, 512),
               'sub_sample': (8, 6272, 784, 256, 256),
               'seq layer2': (16, 3136, 6272, 256, 256)}
# the f32 K1-fwd (tf32x3) against: a 2- or 4-slot ring, 32-channel chunks
# of s, two blocks an SM, the low half unrounded, the products issued
# across tiles; and, for their times alone, one product, no split
# arithmetic, each warp on its own row max, and each stage's copies left
# out
FWD32_LO = ('mma_tiles.cuh', '  lo = to_tf32(x - __uint_as_float(hi));',
            '  lo = __float_as_uint(x - __uint_as_float(hi));')
# the three products of four tiles issued product by product across the
# tiles (each tile's B halves split first), in q k^T and in P v
FWD32_ACROSS = [(
    """      uint32_t bhi[2], blo[2];
      split_tf32(y.x, bhi[0], blo[0]);
      split_tf32(y.y, bhi[1], blo[1]);
      mma_tf32x3(partial[t], ahi, alo, bhi, blo);
    }
""", """      split_tf32(y.x, bhi[t][0], blo[t][0]);
      split_tf32(y.y, bhi[t][1], blo[t][1]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) mma_tf32(partial[t], alo, bhi[t][0], bhi[t][1]);
#pragma unroll
    for (int t = 0; t < 4; ++t) mma_tf32(partial[t], ahi, blo[t][0], blo[t][1]);
#pragma unroll
    for (int t = 0; t < 4; ++t) mma_tf32(partial[t], ahi, bhi[t][0], bhi[t][1]);
"""), (
    """    split_tf32(x1.y, ahi[3], alo[3]);
#pragma unroll""", """    split_tf32(x1.y, ahi[3], alo[3]);
    uint32_t bhi[4][2], blo[4][2];
#pragma unroll"""), (
    """            uint32_t bhi[2], blo[2];
            split_tf32(bt[0], bhi[0], blo[0]);
            split_tf32(bt[kLdV], bhi[1], blo[1]);
            mma_tf32x3(partial[t], ahi, alo, bhi, blo);
          }
""", """            split_tf32(bt[0], bhi[t][0], blo[t][0]);
            split_tf32(bt[kLdV], bhi[t][1], blo[t][1]);
          }
#pragma unroll
          for (int t = 0; t < 4; ++t)
            mma_tf32(partial[t], alo, bhi[t][0], bhi[t][1]);
#pragma unroll
          for (int t = 0; t < 4; ++t)
            mma_tf32(partial[t], ahi, blo[t][0], blo[t][1]);
#pragma unroll
          for (int t = 0; t < 4; ++t)
            mma_tf32(partial[t], ahi, bhi[t][0], bhi[t][1]);
"""), (
    """                                   __float_as_uint(l0.y), __float_as_uint(l1.y)};
#pragma unroll""", """                                   __float_as_uint(l0.y), __float_as_uint(l1.y)};
          uint32_t bhi[4][2], blo[4][2];
#pragma unroll""")]
FWD32_VARIANTS = {
    'base': [],
    'stages2': [('constexpr int kXStages = 3; ', 'constexpr int kXStages = 2; ')],
    'stages4': [('constexpr int kXStages = 3; ', 'constexpr int kXStages = 4; ')],
    'k32': [('constexpr int kXK = 64; ', 'constexpr int kXK = 32; ')],
    'two_blocks': [('__launch_bounds__(kXThreads)\n',
                    '__launch_bounds__(kXThreads, 2)\n'),
                   ('constexpr int kXK = 64; ', 'constexpr int kXK = 32; ')],
    'lo_raw': [FWD32_LO],
    'across_tiles': FWD32_ACROSS,
    'one_product': TF32_TIMING_VARIANTS['one_product'],
    'no_split': TF32_TIMING_VARIANTS['no_split'],
    'own_max': [('fmaxf(m_r[h], fmaxf(red[rt], red[kXRows + rt]))',
                 'fmaxf(m_r[h], mx[h])')],
    'no_q_loads': [('        load_tile_f32_async<kXRows, kXK, kXThreads>(\n'
                    '            slot, kXLdK, qb, c, q0, n, j * kXK, c, vec_qk);\n',
                    '')],
    'no_k_loads': [('        load_tile_f32_async<kXKeys, kXK, kXThreads>(\n'
                    '            slot + kXRows * kXLdK, kXLdK, kb, c, k0, nk, '
                    'j * kXK, c, vec_qk);\n', '')],
    'no_v_loads': [('        load_tile_f32_async<kKV, 16 * NT, kXThreads>(\n'
                    '            slot, kLdV, vb, cv, k0 + (j - n_s) * kKV, nk, 0, '
                    'cv, vec_v);\n', '')]}
FWD32_SHAPES = {'layer2': (8, 6272, 6272, 256, 256),
                'layer3': (8, 784, 784, 512, 512),
                'biggan256': (32, 4096, 1024, 96, 384),
                'biggan128': (32, 4096, 1024, 48, 192)}
# the f32 K1-dq and K1-dkv on TF32 wgmma (tf32_wgmma) against: the score
# stages issued by pairs or fours (not eights), 5 ring slots with two X
# buffers, each tile's m slots released after the whole X m product, the
# first build's order (all three), the stages and the X m product left
# pending across loop iterations, each output summed on the tensor cores;
# and, for their times alone, the pre-pass alone, the main kernel alone,
# one product, no lo loads
TW_ROWS = """          tma_load(slot, am, full, ch, r0, 2 * bi);
          tma_load(slot + 8192, am, full, ch, r0, 2 * bi + 1);
"""
TW_PRODUCER = (TW_ROWS + """          tma_load(slot + 16384, bm, full, ch, c0, 2 * bi);
          tma_load(slot + 24576, bm, full, ch, c0, 2 * bi + 1);""",
               """          tma_load(slot, am, full, ch, r0, 2 * bi);
          tma_load(slot + 16384, bm, full, ch, c0, 2 * bi);""")
TW_TMA = "// src -> box (c0.., r0.., bi); rows past the tensor's end are not written."
TW_EVICT_LAST = r"""// The L2 eviction policy evict_last (createpolicy): lines so loaded stay
// in L2 ahead of the others.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// tma_load with an L2 eviction policy.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int r0,
                                         int bi, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(r0), "r"(bi), "l"(policy)
      : "memory");
}

"""
TW_THREE = """  wgmma_tf32(d, wgmma_desc(a_lo, 16, 1024), wgmma_desc(b_hi, 16, 1024),
             !first);
  wgmma_tf32(d, wgmma_desc(a_hi, 16, 1024), wgmma_desc(b_lo, 16, 1024), 1);
  wgmma_tf32(d, wgmma_desc(a_hi, 16, 1024), wgmma_desc(b_hi, 16, 1024), 1);"""
TW_ONE = """  wgmma_tf32(d, wgmma_desc(a_hi, 16, 1024), wgmma_desc(b_hi, 16, 1024),
             !first);"""
TW_PAIRS = ('kGUnroll = 8;', 'kGUnroll = 2;')
TW_X2 = [('kGStages = 6;', 'kGStages = 5;'), ('kGXBufs = 1;', 'kGXBufs = 2;')]
TW_PREP = """      (err = launch_split(static_cast<const float*>(cb_src), cb,
                          dkv ? m1 : nullptr, b, cols, cv, cvp, stream)))
    return err;
"""
TW_ACC = """          wgmma_tf32x3(pa, xs + i * 8192 + 32 * kk,
                       xs + 16384 + i * 8192 + 32 * kk, m + 32 * kk,
                       m + kMBytes + 32 * kk, (i | kk) == 0);"""
TW_JOIN = """      reg_fence(pa);
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) acc[e] += pa[e];
      ring->release(st + 2 + wg);"""
TW_WHOLE_M = ("""      wgmma_wait<1>();
      ring->release(st + wg);
      wgmma_wait<0>();""", """      wgmma_wait<0>();
      ring->release(st + wg);""")
TW_CROSS = [("""    int st = 0;   // the next ring stage
""", """    int st = 0;   // the next ring stage
    int m_own = 0;    // the previous tile's first m stage of this consumer
"""), ("""      const int n = p.nc + n_dp;
      int js = 0;
      for (; js + kGUnroll <= n; js += kGUnroll)
        tw_stages<kGUnroll>(s, dp, p0, p1, ring, ring_s, st, js, p.nc, b_off);
      for (; js < n; js += 2)
        tw_stages<2>(s, dp, p0, p1, ring, ring_s, st, js, p.nc, b_off);
      st += n;
""", """      const int n = p.nc + n_dp;
      tw_stage(p0, ring, ring_s, st, b_off);
      wgmma_wait<1>();
      reg_fence(pa);
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) acc[e] += pa[e];
      if (t > 0) {
        ring->release(m_own);
        ring->release(m_own + 2);
      }
      for (int j = 1; j < n - 1; j += 2) {
        tw_stage(p1, ring, ring_s, st + j, b_off);
        wgmma_wait<1>();
        tw_join(s, dp, p0, j - 1 < p.nc);
        ring->release(st + j - 1);
        tw_stage(p0, ring, ring_s, st + j + 1, b_off);
        wgmma_wait<1>();
        tw_join(s, dp, p1, j < p.nc);
        ring->release(st + j);
      }
      tw_stage(p1, ring, ring_s, st + n - 1, b_off);
      wgmma_wait<1>();
      tw_join(s, dp, p0, n - 2 < p.nc);
      ring->release(st + n - 2);
      wgmma_wait<0>();
      tw_join(s, dp, p1, n - 1 < p.nc);
      ring->release(st + n - 1);
      st += n;
"""), ("""      wgmma_wait<1>();
      ring->release(st + wg);
      wgmma_wait<0>();
      reg_fence(pa);
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) acc[e] += pa[e];
      ring->release(st + 2 + wg);
      st += 4;
    }
""", """      m_own = st + wg;
      st += 4;
    }
    wgmma_wait<0>();
    reg_fence(pa);
#pragma unroll
    for (int e = 0; e < WN / 2; ++e) acc[e] += pa[e];
    ring->release(m_own);
    ring->release(m_own + 2);
""")]
TW_VARIANTS = {
    'base': [],
    'pairs': [TW_PAIRS],
    'u4': [('kGUnroll = 8;', 'kGUnroll = 4;')],
    'x2_stages5': TW_X2,
    'whole_m': [TW_WHOLE_M],
    'first_build': [TW_PAIRS, *TW_X2, TW_WHOLE_M],
    'cross': TW_CROSS,
    'truncating': [(TW_ACC, TW_ACC.replace('(pa,', '(acc,')
                    .replace('(i | kk) == 0', 'false')),
                   (TW_JOIN, TW_JOIN.replace(
                       'reg_fence(pa);\n#pragma unroll\n      for (int e = 0; '
                       'e < WN / 2; ++e) acc[e] += pa[e];', 'reg_fence(acc);'))],
    'prep_only': [(TW_PREP, TW_PREP + '  return 0;\n')],
    'no_prep': [('  int err;\n  if ((err = launch_split(', '  int err;\n'
                 '  if (false && (err = launch_split(')],
    'one_product': [('wgmma_tiles.cuh', TW_THREE, TW_ONE)],
    'no_lo_loads': [TW_PRODUCER,
                    ('mbar_expect_tx(full, kGSlot);',
                     'mbar_expect_tx(full, kGSlot / 2);'),
                    ('mbar_expect_tx(full, 2 * kMBytes);',
                     'mbar_expect_tx(full, kMBytes);'),
                    ('          tma_load(slot + kMBytes, mmap, full, col, row, '
                     '2 * bi + 1);\n', '')]}
TW_VARIANTS['rows_evict_last'] = [
    ('wgmma_tiles.cuh', TW_TMA, TW_EVICT_LAST + TW_TMA),
    (TW_ROWS, TW_ROWS.replace('2 * bi);', '2 * bi, l2_evict_last());')
     .replace('2 * bi + 1);', '2 * bi + 1, l2_evict_last());'))]
TW_VARIANTS['shared_rows'] = [(TW_ROWS, TW_ROWS.replace('r0, 2 * bi + 1', '0, 1')
                               .replace('r0, 2 * bi', '0, 0'))]
TW_VARIANTS['no_scores'] = [('tf32_wgmma.cuh', """    wgmma_tf32x3(p, sl + 32 * kk, sl + 8192 + 32 * kk,
                 sl + 16384 + b_off + 32 * kk, sl + 24576 + b_off + 32 * kk,
                 kk == 0);""", '    ;')]
TW_VARIANTS['no_x_m'] = [("""          wgmma_tf32x3(pa, xs + i * 8192 + 32 * kk,
                       xs + 16384 + i * 8192 + 32 * kk, m + 32 * kk,
                       m + kMBytes + 32 * kk, (i | kk) == 0);""", '          ;')]
TW_TIMING_ONLY = ('prep_only', 'no_prep', 'one_product', 'no_lo_loads',
                  'no_scores', 'no_x_m', 'shared_rows')
TW_SHAPES = {'layer2': (8, 6272, 6272, 256, 256),
             'layer3': (8, 784, 784, 512, 512),
             'sub_sample': (8, 6272, 784, 256, 256),
             'seq layer2': (16, 3136, 6272, 256, 256),
             'biggan256': (32, 4096, 1024, 96, 384),
             'biggan128': (32, 4096, 1024, 48, 192),
             'mnist 16': (8, 196, 196, 16, 16),
             'mnist 32': (8, 49, 49, 32, 32)}
# the f32 K1-fwd on TF32 wgmma (tf32_wgmma) against: the score stages
# issued by pairs, 4 or 5 ring slots, O in parts of 128 columns, P v summed
# on the tensor cores over all keys, the low halves unrounded; and, for
# their times alone, the pre-pass alone, the main kernel alone, one
# product, no P v product
TF_PV = """          wgmma_tf32x3(pa, p_s + i * 8192 + 32 * kk,
                       p_s + 16384 + i * 8192 + 32 * kk, m + 32 * kk,
                       m + kVBytes + 32 * kk, (i | kk) == 0);"""
TF_JOIN = """      reg_fence(pa);
#pragma unroll
      for (int e = 0; e < WN / 2; ++e)
        acc[e] = acc[e] * alpha[(e >> 1) & 1] + pa[e];"""
TF_FENCE = """      ring->release(st + 3 - wg);
      wgmma_fence();"""
TF_Q_LOADS = """          tma_load(slot, &qmap, full, j * kFChunk, r0, 2 * bi);
          tma_load(slot + 8192, &qmap, full, j * kFChunk, r0, 2 * bi + 1);
"""
TF_V_LOADS = """          tma_load(slot, &vmap, full, key, row, 2 * bi);
          tma_load(slot + kVBytes, &vmap, full, key, row, 2 * bi + 1);
"""
TF_PREP = """      (err = launch_split(v, nullptr, vt, b, nk, cv, cvp, stream)))
    return err;
"""
TF_VARIANTS = {
    'base': [],
    'pairs': [('kFUnroll = 8;', 'kFUnroll = 2;')],
    'stages4': [('kFStages = 6;', 'kFStages = 4;')],
    'stages5': [('kFStages = 6;', 'kFStages = 5;')],
    'z4': [('kFMaxPart = 256;', 'kFMaxPart = 128;')],
    'truncating': [(TF_PV, TF_PV.replace('(pa,', '(acc,')
                    .replace('(i | kk) == 0', 'false')),
                   (TF_FENCE, TF_FENCE.replace(
                       '      wgmma_fence();',
                       '#pragma unroll\n      for (int e = 0; e < WN / 2; ++e)'
                       ' acc[e] *= alpha[(e >> 1) & 1];\n      wgmma_fence();')),
                   (TF_JOIN, '      reg_fence(acc);')],
    'lo_raw': [('mma_tiles.cuh', '  lo = to_tf32(x - __uint_as_float(hi));',
                '  lo = __float_as_uint(x - __uint_as_float(hi));')],
    'prep_only': [(TF_PREP, TF_PREP + '  return 0;\n')],
    'no_prep': [('  int err;\n  if ((err = launch_split(q,',
                 '  int err;\n  if (false && (err = launch_split(q,')],
    'one_product': [('wgmma_tiles.cuh', TW_THREE, TW_ONE)],
    'no_pv': [(TF_PV, '          ;')],
    'no_q_loads': [(TF_Q_LOADS, ''), ('mbar_expect_tx(full, kGSlot);',
                                      'mbar_expect_tx(full, kGSlot / 2);')],
    'no_v_loads': [(TF_V_LOADS, ''), ('mbar_expect_tx(full, 2 * kVBytes);',
                                      'mbar_expect_tx(full, 0);')]}
TF_TIMING_ONLY = ('prep_only', 'no_prep', 'one_product', 'no_pv',
                  'no_q_loads', 'no_v_loads')
TF_SHAPES = {'layer2': (8, 6272, 6272, 256, 256),
             'layer3': (8, 784, 784, 512, 512),
             'biggan256': (32, 4096, 1024, 96, 384),
             'biggan128': (32, 4096, 1024, 48, 192)}
WIDE_FWD_SHAPES = [(20, 784, 784, 512, 512), (8, 784, 784, 512, 512),
                   (1, 784, 784, 512, 512)]
WIDE_DKV_SHAPES = [(8, 784, 784, 512, 512), (2, 784, 196, 512, 512)]
WIDE_DQ_SHAPES = WIDE_DKV_SHAPES
K2_SHAPES = {'fast res2.0': (20, 32, 56, 56, 8, 8, 32, True),
             'fast res2.1-2': (20, 32, 56, 56, 32, 8, 32, False),
             'fast res3.1-3': (20, 32, 28, 28, 64, 16, 64, False),
             'fast res4.1-5': (20, 32, 14, 14, 128, 32, 128, False)}
DQ_SHAPES = [(8, 6272, 6272, 256, 256), (8, 6272, 784, 256, 256),
             (4, 4096, 512, 64, 256), (2, 1000, 1000, 128, 192)]


def card():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def median_ms(fn, reps=30):
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


def kernel_name(mangled):
    """The kernel's name and integer template arguments in a mangled
    symbol, e.g. 'nonlocal_attention_fwd_wide_kernel<4>'. The name follows
    its length's digits; the file's name in the anonymous namespace does
    not."""
    m = re.search(r'(?<=\d)((?:nonlocal_attention|fused_bottleneck_tail)_'
                  r'[a-z0-9_]*?kernel)((?:I(?:L[ib]\d+E)+E)?)', mangled)
    if not m:
        return mangled.strip(" '")
    args = re.findall(r'L[ib](\d+)E', m.group(2))
    return m.group(1) + (f'<{", ".join(args)}>' if args else '')


def build_variants(source, variants, tag):
    """One shared library per variant of ``source``, built side by side;
    ptxas's wgmma notes of each are printed."""
    from pretorched_tpu_torch.ops.cuda import build
    procs = {}
    for name, patches in variants.items():
        d = OUT / tag / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in CSRC.glob('*.cuh'):
            shutil.copy(f, d)
        texts = {source: (CSRC / source).read_text()}
        for patch in patches:     # (old, new) in source, or (file, old, new)
            target, old, new = patch if len(patch) == 3 else (source, *patch)
            text = texts.get(target) or (CSRC / target).read_text()
            if text.count(old) != 1:
                raise SystemExit(f'{tag} {name}: the patched text is not '
                                 f'found once in {target}')
            texts[target] = text.replace(old, new)
        for target, text in texts.items():
            (d / target).write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, '-shared', '-o',
             str(d / 'lib.so'), str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise SystemExit(f'{tag} {name}: nvcc failed\n{log}')
        (OUT / tag / name / 'build.log').write_text(log)
        for line in log.splitlines():
            if 'Potential Performance Loss' in line:
                note, _, fn = line.split('Loss: ')[1].partition(
                    ' in the function')
                print(f'  {tag} {name}: ptxas on {kernel_name(fn)}: {note}')
        libs[name] = ctypes.CDLL(str(OUT / tag / name / 'lib.so'))
    return libs


def probe_k2(smi):
    import torch
    from pretorched_tpu_torch.ops.cuda import fused_block as fb_cuda
    libs = build_variants('fused_block.cu', K2_VARIANTS, 'k2')
    for lib in libs.values():
        lib.pt_fused_bottleneck_tail_tma.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.pt_fused_bottleneck_tail_tma_rows.argtypes = [ctypes.c_int] * 7
    g = torch.Generator(device='cuda').manual_seed(0)
    print(f'K2, TMA kernel variants, CUDA-event medians of 30 ({smi})')
    for name, (n, t, h, w, cin, cm, cout, proj) in K2_SHAPES.items():
        y1 = torch.randn((n, cm, t, h, w), device='cuda',
                         generator=g).relu_().bfloat16()
        x = torch.randn((n, cin, t, h, w), device='cuda',
                        generator=g).relu_().bfloat16()

        def affine(c):
            return torch.stack([torch.rand(c, device='cuda', generator=g)
                                + 0.5, torch.rand(c, device='cuda',
                                                  generator=g) * 0.4 - 0.2])

        weights = (torch.randn(cm, cm, 3, 3, device='cuda', generator=g)
                   * 0.1, affine(cm),
                   torch.randn(cout, cm, device='cuda', generator=g) * 0.1,
                   affine(cout),
                   torch.randn(cout, cin, device='cuda', generator=g) * 0.1
                   if proj else None, affine(cout) if proj else None)
        with torch.no_grad():
            layout = fb_cuda.TailLayout(*weights)
            old = fb_cuda._prepare(y1, x, layout, 'mma_sync')
            want = fb_cuda.launch_tail(old).clone()
            old_ms = median_ms(lambda: fb_cuda.launch_tail(old))
            row = [f'mma.sync {old_ms:.4f}']
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            for vname, lib in libs.items():
                if lib.pt_fused_bottleneck_tail_tma_rows(
                        t, h, w, cm, cin, cout, int(proj)) < 1:
                    row.append(f'{vname} n/a')
                    continue
                out = torch.empty_like(want)
                ptrs = [ctypes.c_void_p(None if v is None else v.data_ptr())
                        for v in (old['y1'], old['x'], old['w2'], old['a2'],
                                  old['w3'], old['a3'], old['wp'], old['ap'],
                                  out)]

                def run():
                    err = lib.pt_fused_bottleneck_tail_tma(*ptrs, *old['dims'],
                                                           stream)
                    if err:
                        raise RuntimeError(f'{vname}: CUDA error {err}')

                ms = median_ms(run)
                same = ('' if vname.startswith('no_')
                        else f' ({"=" if torch.equal(out, want) else "!="})')
                row.append(f'{vname} {ms:.4f}{same}')
        print(f'  {name:14s} ms: ' + ', '.join(row), flush=True)
        del y1, x, old, want
        torch.cuda.empty_cache()


def probe_dq(smi):
    import torch
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
    libs = build_variants('nonlocal_attention_bwd.cu', DQ_VARIANTS, 'dq')
    for lib in libs.values():
        lib.pt_nonlocal_attention_bwd_dq_wgmma.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
    g = torch.Generator(device='cuda').manual_seed(1)
    print(f'K1-dq, wgmma kernel variants, CUDA-event medians of 30 ({smi})')
    for b, n, nk, c, cv in DQ_SHAPES:
        q = (torch.randn(b, n, c, device='cuda', generator=g)
             / c ** 0.25).bfloat16()
        k = (torch.randn(b, nk, c, device='cuda', generator=g)
             / c ** 0.25).bfloat16()
        v = torch.randn(b, nk, cv, device='cuda', generator=g).bfloat16()
        do = torch.randn(b, n, cv, device='cuda', generator=g).bfloat16()
        out, lse = na.nonlocal_attention_cuda(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        want = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        row = []
        for vname, lib in libs.items():
            dq = torch.empty_like(q)
            ptrs = [ctypes.c_void_p(t.data_ptr())
                    for t in (q, k, v, do, lse, delta, dq)]

            def run():
                err = lib.pt_nonlocal_attention_bwd_dq_wgmma(
                    *ptrs, b, n, nk, c, cv, 1.0, stream)
                if err:
                    raise RuntimeError(f'{vname}: CUDA error {err}')

            ms = median_ms(run)
            row.append(f'{vname} {ms:.4f}'
                       f' ({"=" if torch.equal(dq, want) else "!="})')
        print(f'  {(b, n, nk, c, cv)} ms: ' + ', '.join(row), flush=True)


def probe_wide(smi):
    import torch
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
    fwd_libs = build_variants('nonlocal_attention_fwd.cu', WIDE_FWD_VARIANTS,
                              'wide_fwd')
    dkv_libs = build_variants('nonlocal_attention_bwd.cu', WIDE_DKV_VARIANTS,
                              'wide_dkv')
    dq_libs = build_variants('nonlocal_attention_bwd.cu', WIDE_DQ_VARIANTS,
                             'wide_dq')
    for lib in fwd_libs.values():
        lib.pt_nonlocal_attention_fwd_wgmma_wide.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
    for lib in dkv_libs.values():
        lib.pt_nonlocal_attention_bwd_dkv_wgmma_wide.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
    for lib in dq_libs.values():
        lib.pt_nonlocal_attention_bwd_dq_wgmma_wide.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
    g = torch.Generator(device='cuda').manual_seed(2)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def inputs(b, n, nk, c, cv):
        return ((torch.randn(b, n, c, device='cuda', generator=g)
                 / c ** 0.25).bfloat16(),
                (torch.randn(b, nk, c, device='cuda', generator=g)
                 / c ** 0.25).bfloat16(),
                torch.randn(b, nk, cv, device='cuda', generator=g).bfloat16(),
                torch.randn(b, n, cv, device='cuda', generator=g).bfloat16())

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    print(f'K1-fwd, wide wgmma variants, CUDA-event medians of 30 ({smi})')
    for b, n, nk, c, cv in WIDE_FWD_SHAPES:
        q, k, v, _ = inputs(b, n, nk, c, cv)
        want = na.nonlocal_attention_cuda(q, k, v)[0]
        row = []
        for vname, lib in fwd_libs.items():
            out = torch.empty_like(want)
            lse = torch.empty(b, n, device='cuda')
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out, lse)]

            def run():
                err = lib.pt_nonlocal_attention_fwd_wgmma_wide(
                    *ptrs, b, n, nk, c, cv, 1.0, stream)
                if err:
                    raise RuntimeError(f'{vname}: CUDA error {err}')

            ms = median_ms(run)
            row.append(f'{vname} {ms:.4f} (max|d|/max {rel(out, want):.1e})')
        print(f'  {(b, n, nk, c, cv)} ms: ' + ', '.join(row), flush=True)
    print(f'K1-dkv, wide wgmma variants, CUDA-event medians of 30 ({smi})')
    for b, n, nk, c, cv in WIDE_DKV_SHAPES:
        q, k, v, do = inputs(b, n, nk, c, cv)
        out, lse = na.nonlocal_attention_cuda(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        want = na.nonlocal_attention_bwd_dkv_cuda(q, k, v, do, lse, delta)
        row = []
        for vname, lib in dkv_libs.items():
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            ptrs = [ctypes.c_void_p(t.data_ptr())
                    for t in (q, k, v, do, lse, delta, dk, dv)]

            def run():
                err = lib.pt_nonlocal_attention_bwd_dkv_wgmma_wide(
                    *ptrs, b, n, nk, c, cv, 1.0, stream)
                if err:
                    raise RuntimeError(f'{vname}: CUDA error {err}')

            ms = median_ms(run)
            err = max(rel(dk, want[0]), rel(dv, want[1]))
            row.append(f'{vname} {ms:.4f} (max|d|/max {err:.1e})')
        print(f'  {(b, n, nk, c, cv)} ms: ' + ', '.join(row), flush=True)
    print(f'K1-dq, wide wgmma variants, CUDA-event medians of 30 ({smi})')
    for b, n, nk, c, cv in WIDE_DQ_SHAPES:
        q, k, v, do = inputs(b, n, nk, c, cv)
        out, lse = na.nonlocal_attention_cuda(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        want = na.nonlocal_attention_bwd_dq_cuda(q, k, v, do, lse, delta)
        generic_ms = median_ms(lambda: na._launch_dq(q, k, v, do, lse, delta,
                                                     1.0, 'mma_sync'))
        row = [f'generic mma.sync {generic_ms:.4f}']
        for vname, lib in dq_libs.items():
            dq = torch.empty_like(q)
            ptrs = [ctypes.c_void_p(t.data_ptr())
                    for t in (q, k, v, do, lse, delta, dq)]

            def run():
                err = lib.pt_nonlocal_attention_bwd_dq_wgmma_wide(
                    *ptrs, b, n, nk, c, cv, 1.0, stream)
                if err:
                    raise RuntimeError(f'{vname}: CUDA error {err}')

            ms = median_ms(run)
            row.append(f'{vname} {ms:.4f} (max|d|/max {rel(dq, want):.1e}'
                       f'{", =" if torch.equal(dq, want) else ""})')
        print(f'  {(b, n, nk, c, cv)} ms: ' + ', '.join(row), flush=True)


def sass_opcodes(lib_path, kernel):
    """Opcode counts of ``kernel``'s SASS in a built library (cuobjdump)."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    out = subprocess.run([tool, '-sass', str(lib_path)], capture_output=True,
                         text=True, timeout=300).stdout
    counts, inside = {}, False
    for line in out.splitlines():
        if 'Function :' in line:
            inside = kernel in line
        elif inside:
            m = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?'
                         r'([A-Z][A-Z0-9_]*)', line)
            if m:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def bwd_f64(q, k, v, o, lse, do):
    """The plain backward (``nonlocal_attention_bwd_reference``) in f64."""
    import torch
    q, k, v, o, lse, do = (t.double() for t in (q, k, v, o, lse, do))
    p = torch.exp(torch.bmm(q, k.transpose(1, 2)) - lse[..., None])
    dv = torch.bmm(p.transpose(1, 2), do)
    ds = torch.bmm(do, v.transpose(1, 2))
    ds.sub_((do * o).sum(-1)[..., None]).mul_(p)
    del p
    return torch.bmm(ds, k), torch.bmm(ds.transpose(1, 2), q), dv


def probe_tf32(smi, variants=None, tag='tf32'):
    """tf32x3's variants (TF32_VARIANTS) at TF32_SHAPES: ms of K1-dq and
    K1-dkv in turns (variants, scalar, then back), each held to the plain
    f32 backward and to the f64 one."""
    import torch
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants('nonlocal_attention_bwd.cu',
                          variants or TF32_VARIANTS, tag)
    for name, lib in libs.items():
        for fn, outs in ((lib.pt_nonlocal_attention_bwd_dq_tf32x3, 1),
                         (lib.pt_nonlocal_attention_bwd_dkv_tf32x3, 2)):
            fn.argtypes = ([ctypes.c_void_p] * (6 + outs) + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_void_p])
        ops = sass_opcodes(OUT / tag / name / 'lib.so',
                           'tf32x3_kernelILi16E')
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:14]
        log = (OUT / tag / name / 'build.log').read_text().splitlines()
        regs = [re.search(r'Used (\d+) registers', log[i + 2]).group(1)
                + ' at NT ' + re.search(r'kernelILi(\d+)E', line).group(1)
                + (' (spills ' + re.search(r'(\d+) bytes spill stores',
                                           log[i + 1]).group(1) + ' B)'
                   if ' 0 bytes spill stores' not in log[i + 1] else '')
                for i, line in enumerate(log)
                if 'Function properties' in line and 'tf32x3' in line
                and i + 2 < len(log) and 'Used' in log[i + 2]]
        print(f'  {tag} {name}: registers {", ".join(regs)}; SASS of the '
              f'kernel at 16 tiles a warp, {sum(ops.values())} '
              f'instructions: '
              + ', '.join(f'{op} {n}' for op, n in top), flush=True)
    g = torch.Generator(device='cuda').manual_seed(3)
    print(f'f32 K1-dq and K1-dkv, tf32x3 variants against scalar, CUDA-event '
          f'medians of 5 in turns; max |d - ref| / max |ref| against the '
          f'plain f32 and the f64 backward ({smi})')
    for label, (b, n, nk, c, cv) in TF32_SHAPES.items():
        q = torch.randn(b, n, c, device='cuda', generator=g) / c ** 0.25
        k = torch.randn(b, nk, c, device='cuda', generator=g) / c ** 0.25
        v = torch.randn(b, nk, cv, device='cuda', generator=g)
        do = torch.randn(b, n, cv, device='cuda', generator=g)
        out, lse = na.nonlocal_attention_cuda(q, k, v)
        delta = (do * out).sum(-1)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        dims = (b, n, nk, c, cv, ctypes.c_float(1.0), stream)
        ins = [ctypes.c_void_p(t.data_ptr())
               for t in (q, k, v, do, lse, delta)]

        def runner(lib):
            dq = torch.empty_like(q)
            dk, dv = torch.empty_like(k), torch.empty_like(v)

            def dq_fn():
                err = lib.pt_nonlocal_attention_bwd_dq_tf32x3(
                    *ins, ctypes.c_void_p(dq.data_ptr()), *dims)
                if err:
                    raise RuntimeError(f'CUDA error {err}')

            def dkv_fn():
                err = lib.pt_nonlocal_attention_bwd_dkv_tf32x3(
                    *ins, ctypes.c_void_p(dk.data_ptr()),
                    ctypes.c_void_p(dv.data_ptr()), *dims)
                if err:
                    raise RuntimeError(f'CUDA error {err}')
            return dq_fn, dkv_fn, (dq, dk, dv)

        runs = {name: runner(lib) for name, lib in libs.items()}
        runs['scalar'] = (
            lambda: na._launch_dq(q, k, v, do, lse, delta, 1.0, 'scalar'),
            lambda: na._launch_dkv(q, k, v, do, lse, delta, 1.0, 'scalar'),
            None)
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            dq_fn, dkv_fn, _ = runs[name]
            times[name].append((median_ms(dq_fn, reps=5),
                                median_ms(dkv_fn, reps=5)))
        want = na.nonlocal_attention_bwd_reference(q, k, v, out, lse, do)
        exact = bwd_f64(q, k, v, out, lse, do)

        def rel(got, ref):
            return max(((x.double() - r.double()).abs().max()
                        / r.double().abs().max()).item()
                       for x, r in zip(got, ref))
        print(f'  {label} (B, N, Nk, C, Cv) = {(b, n, nk, c, cv)}: plain f32 '
              f'to f64 {rel(want, exact):.2e}', flush=True)
        for name, (dq_fn, dkv_fn, outs) in runs.items():
            ts = times[name]
            line = (f'    {name:18s} dq '
                    + ' / '.join(f'{t[0]:.3f}' for t in ts) + ' ms, dkv '
                    + ' / '.join(f'{t[1]:.3f}' for t in ts) + ' ms')
            if outs is not None:
                dq_fn()
                dkv_fn()
                torch.cuda.synchronize()
                line += (f'; to plain f32 {rel(outs, want):.2e}, to f64 '
                         f'{rel(outs, exact):.2e}')
            print(line, flush=True)
        del q, k, v, do, out, lse, delta, runs, want, exact
        torch.cuda.empty_cache()


def probe_tw32(smi):
    """tf32_wgmma's variants (TW_VARIANTS) at TW_SHAPES: ms of K1-dq and
    K1-dkv in turns (variants, tf32x3, then back), each held to the plain
    f32 backward and to the f64 one."""
    import torch
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = 'tw32'
    libs = build_variants('nonlocal_attention_bwd.cu', TW_VARIANTS, tag)
    for name, lib in libs.items():
        for fn, outs in ((lib.pt_nonlocal_attention_bwd_dq_tf32_wgmma, 1),
                         (lib.pt_nonlocal_attention_bwd_dkv_tf32_wgmma, 2)):
            fn.argtypes = ([ctypes.c_void_p] * (7 + outs)
                           + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_void_p])
        log = (OUT / tag / name / 'build.log').read_text().splitlines()
        regs = [kernel_name(line.split("'")[1]) + ' '
                + re.search(r'Used (\d+) registers', log[i + 3]).group(1)
                for i, line in enumerate(log)
                if 'Compiling entry function' in line and 'tf32_wgmma' in line
                and i + 3 < len(log) and 'Used' in log[i + 3]]
        spills = [line for line in log if 'spill stores' in line
                  and ' 0 bytes spill stores' not in line]
        print(f'  {tag} {name}: registers at entry {", ".join(regs)}; '
              f'{len(spills)} functions spill', flush=True)
    g = torch.Generator(device='cuda').manual_seed(3)
    print(f'f32 K1-dq and K1-dkv, tf32_wgmma variants against tf32x3, '
          f'CUDA-event medians of 5 in turns (the pre-pass included); max '
          f'|d - ref| / max |ref| against the plain f32 and the f64 backward '
          f'({smi})')
    for label, (b, n, nk, c, cv) in TW_SHAPES.items():
        q = torch.randn(b, n, c, device='cuda', generator=g) / c ** 0.25
        k = torch.randn(b, nk, c, device='cuda', generator=g) / c ** 0.25
        v = torch.randn(b, nk, cv, device='cuda', generator=g)
        do = torch.randn(b, n, cv, device='cuda', generator=g)
        out, lse = na.nonlocal_attention_cuda(q, k, v)
        delta = (do * out).sum(-1)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        dims = (b, n, nk, c, cv, ctypes.c_float(1.0), stream)
        ins = [ctypes.c_void_p(t.data_ptr())
               for t in (q, k, v, do, lse, delta)]
        scratch = torch.empty(max(na.tf32_wgmma_scratch_bytes(
            dkv, b, n, nk, c, cv) for dkv in (False, True)) // 4,
            device='cuda')
        sp = ctypes.c_void_p(scratch.data_ptr())

        def runner(lib):
            dq = torch.empty_like(q)
            dk, dv = torch.empty_like(k), torch.empty_like(v)

            def dq_fn():
                err = lib.pt_nonlocal_attention_bwd_dq_tf32_wgmma(
                    *ins, ctypes.c_void_p(dq.data_ptr()), sp, *dims)
                if err:
                    raise RuntimeError(f'CUDA error {err}')

            def dkv_fn():
                err = lib.pt_nonlocal_attention_bwd_dkv_tf32_wgmma(
                    *ins, ctypes.c_void_p(dk.data_ptr()),
                    ctypes.c_void_p(dv.data_ptr()), sp, *dims)
                if err:
                    raise RuntimeError(f'CUDA error {err}')
            return dq_fn, dkv_fn, (dq, dk, dv)

        runs = {name: runner(lib) for name, lib in libs.items()}
        runs['tf32x3'] = (
            lambda: na._launch_dq(q, k, v, do, lse, delta, 1.0, 'tf32x3'),
            lambda: na._launch_dkv(q, k, v, do, lse, delta, 1.0, 'tf32x3'),
            None)
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            dq_fn, dkv_fn, _ = runs[name]
            times[name].append((median_ms(dq_fn, reps=5),
                                median_ms(dkv_fn, reps=5)))
        want = na.nonlocal_attention_bwd_reference(q, k, v, out, lse, do)
        exact = bwd_f64(q, k, v, out, lse, do)

        def rel(got, ref):
            return max(((x.double() - r.double()).abs().max()
                        / r.double().abs().max()).item()
                       for x, r in zip(got, ref))
        print(f'  {label} (B, N, Nk, C, Cv) = {(b, n, nk, c, cv)}: plain f32 '
              f'to f64 {rel(want, exact):.2e}', flush=True)
        for name, (dq_fn, dkv_fn, outs) in runs.items():
            ts = times[name]
            line = (f'    {name:12s} dq '
                    + ' / '.join(f'{t[0]:.3f}' for t in ts) + ' ms, dkv '
                    + ' / '.join(f'{t[1]:.3f}' for t in ts) + ' ms')
            if outs is not None and name not in TW_TIMING_ONLY:
                dq_fn()
                dkv_fn()
                torch.cuda.synchronize()
                line += (f'; to plain f32 {rel(outs, want):.2e}, to f64 '
                         f'{rel(outs, exact):.2e}')
            print(line, flush=True)
        del q, k, v, do, out, lse, delta, runs, want, exact, scratch
        torch.cuda.empty_cache()


def fwd_f64(q, k, v):
    """The plain forward (out, lse) in f64."""
    import torch
    s = torch.bmm(q.double(), k.double().transpose(1, 2))
    lse = torch.logsumexp(s, -1)
    return torch.bmm(torch.exp(s - lse[..., None]), v.double()), lse


def probe_fwd32(smi):
    """The f32 K1-fwd's tf32x3 variants (FWD32_VARIANTS) at FWD32_SHAPES:
    ms in turns (variants, scalar, then back), each held to the plain f32
    forward and to the f64 one."""
    import torch
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants('nonlocal_attention_fwd.cu', FWD32_VARIANTS, 'fwd32')
    for name, lib in libs.items():
        lib.pt_nonlocal_attention_fwd_tf32x3.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
        ops = sass_opcodes(OUT / 'fwd32' / name / 'lib.so',
                           'fwd_tf32x3_kernelILi16E')
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:14]
        log = (OUT / 'fwd32' / name / 'build.log').read_text().splitlines()
        regs = [re.search(r'Used (\d+) registers', log[i + 2]).group(1)
                + ' at NT ' + re.search(r'kernelILi(\d+)E', line).group(1)
                + (' (spills ' + re.search(r'(\d+) bytes spill stores',
                                           log[i + 1]).group(1) + ' B)'
                   if ' 0 bytes spill stores' not in log[i + 1] else '')
                for i, line in enumerate(log)
                if 'Function properties' in line and 'fwd_tf32x3' in line
                and i + 2 < len(log) and 'Used' in log[i + 2]]
        print(f'  fwd32 {name}: registers {", ".join(regs)}; SASS of the '
              f'kernel at 16 tiles a warp, {sum(ops.values())} '
              f'instructions: '
              + ', '.join(f'{op} {n}' for op, n in top), flush=True)
    g = torch.Generator(device='cuda').manual_seed(3)
    print(f'f32 K1-fwd, tf32x3 variants against scalar, CUDA-event medians '
          f'of 5 in turns; max |out - ref| and |lse - ref| against the plain '
          f'f32 and the f64 forward ({smi})')
    for label, (b, n, nk, c, cv) in FWD32_SHAPES.items():
        q = torch.randn(b, n, c, device='cuda', generator=g) / c ** 0.25
        k = torch.randn(b, nk, c, device='cuda', generator=g) / c ** 0.25
        v = torch.randn(b, nk, cv, device='cuda', generator=g)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        dims = (b, n, nk, c, cv, ctypes.c_float(1.0), stream)

        def runner(lib):
            out = torch.empty(b, n, cv, device='cuda')
            lse = torch.empty(b, n, device='cuda')
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out, lse)]

            def fwd():
                err = lib.pt_nonlocal_attention_fwd_tf32x3(*ptrs, *dims)
                if err:
                    raise RuntimeError(f'CUDA error {err}')
            return fwd, (out, lse)

        runs = {name: runner(lib) for name, lib in libs.items()}
        runs['scalar'] = (lambda: na._launch_fwd(q, k, v, 1.0, 'scalar'),
                          None)
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(median_ms(runs[name][0], reps=5))
        want = na.nonlocal_attention_fwd_lse_reference(q, k, v)
        exact = fwd_f64(q, k, v)

        def err(got, ref):
            return tuple((x.double() - r.double()).abs().max().item()
                         for x, r in zip(got, ref))
        print(f'  {label} (B, N, Nk, C, Cv) = {(b, n, nk, c, cv)}: plain f32 '
              f'to f64 out {err(want, exact)[0]:.2e}, lse '
              f'{err(want, exact)[1]:.2e}', flush=True)
        for name, (fn, outs) in runs.items():
            line = (f'    {name:12s} '
                    + ' / '.join(f'{t:.3f}' for t in times[name]) + ' ms')
            if outs is not None:
                fn()
                torch.cuda.synchronize()
                to_plain, to_exact = err(outs, want), err(outs, exact)
                line += (f'; to plain f32 out {to_plain[0]:.2e}, lse '
                         f'{to_plain[1]:.2e}; to f64 out {to_exact[0]:.2e}, '
                         f'lse {to_exact[1]:.2e}')
            print(line, flush=True)
        del q, k, v, runs, want, exact
        torch.cuda.empty_cache()


def probe_tw32fwd(smi):
    """The f32 K1-fwd's tf32_wgmma variants (TF_VARIANTS) at TF_SHAPES: ms
    in turns (variants, tf32x3, scalar, SDPA f32, then back), each held to
    the plain f32 forward and to the f64 one, beside the bound at the TF32
    rate over 3 (operations: 2 B N Nk (C + Cv) at 495 / 3 TFLOP/s)."""
    import torch
    import torch.nn.functional as F
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = 'tw32fwd'
    libs = build_variants('nonlocal_attention_fwd.cu', TF_VARIANTS, tag)
    for name, lib in libs.items():
        lib.pt_nonlocal_attention_fwd_tf32_wgmma.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
        log = (OUT / tag / name / 'build.log').read_text().splitlines()
        regs = [kernel_name(line.split("'")[1]) + ' '
                + re.search(r'Used (\d+) registers', log[i + 3]).group(1)
                for i, line in enumerate(log)
                if 'Compiling entry function' in line
                and 'fwd_tf32_wgmma' in line
                and i + 3 < len(log) and 'Used' in log[i + 3]]
        spills = [line for line in log if 'spill stores' in line
                  and ' 0 bytes spill stores' not in line]
        print(f'  {tag} {name}: registers at entry {", ".join(regs)}; '
              f'{len(spills)} functions spill', flush=True)
    g = torch.Generator(device='cuda').manual_seed(3)
    print(f'f32 K1-fwd, tf32_wgmma variants against tf32x3, scalar and one '
          f'f32 SDPA call, CUDA-event medians of 5 in turns (the pre-pass '
          f'included); max |out - ref| and |lse - ref| against the plain f32 '
          f'and the f64 forward ({smi})')
    for label, (b, n, nk, c, cv) in TF_SHAPES.items():
        q = torch.randn(b, n, c, device='cuda', generator=g) / c ** 0.25
        k = torch.randn(b, nk, c, device='cuda', generator=g) / c ** 0.25
        v = torch.randn(b, nk, cv, device='cuda', generator=g)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        dims = (b, n, nk, c, cv, ctypes.c_float(1.0), stream)
        scratch = torch.empty(na.tf32_wgmma_fwd_scratch_bytes(
            b, n, nk, c, cv) // 4, device='cuda')

        def runner(lib):
            out = torch.empty(b, n, cv, device='cuda')
            lse = torch.empty(b, n, device='cuda')
            ptrs = [ctypes.c_void_p(t.data_ptr())
                    for t in (q, k, v, out, lse, scratch)]

            def fwd():
                err = lib.pt_nonlocal_attention_fwd_tf32_wgmma(*ptrs, *dims)
                if err:
                    raise RuntimeError(f'CUDA error {err}')
            return fwd, (out, lse)

        q4, k4, v4 = (x[:, None] for x in (q, k, v))
        runs = {name: runner(lib) for name, lib in libs.items()}
        runs['tf32x3'] = (lambda: na._launch_fwd(q, k, v, 1.0, 'tf32x3'),
                          None)
        runs['scalar'] = (lambda: na._launch_fwd(q, k, v, 1.0, 'scalar'),
                          None)
        runs['sdpa f32'] = (lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0), None)
        times = {name: [] for name in runs}
        with torch.no_grad():
            for name in list(runs) + list(runs)[::-1]:
                times[name].append(median_ms(runs[name][0], reps=5))
        want = na.nonlocal_attention_fwd_lse_reference(q, k, v)
        exact = fwd_f64(q, k, v)
        base = None

        def err(got, ref):
            return tuple((x.double() - r.double()).abs().max().item()
                         for x, r in zip(got, ref))
        bound = 2 * b * n * nk * (c + cv) / (495e12 / 3) * 1e3
        print(f'  {label} (B, N, Nk, C, Cv) = {(b, n, nk, c, cv)}: bound '
              f'{bound:.3f} ms (operations at the TF32 rate over 3); plain '
              f'f32 to f64 out {err(want, exact)[0]:.2e}, lse '
              f'{err(want, exact)[1]:.2e}', flush=True)
        for name, (fn, outs) in runs.items():
            line = (f'    {name:12s} '
                    + ' / '.join(f'{t:.3f}' for t in times[name]) + ' ms')
            if outs is not None and name not in TF_TIMING_ONLY:
                fn()
                torch.cuda.synchronize()
                to_plain, to_exact = err(outs, want), err(outs, exact)
                line += (f'; to plain f32 out {to_plain[0]:.2e}, lse '
                         f'{to_plain[1]:.2e}; to f64 out {to_exact[0]:.2e}, '
                         f'lse {to_exact[1]:.2e}')
                if name == 'base':
                    base = tuple(x.clone() for x in outs)
                elif base is not None:
                    line += ('; bitwise as base' if all(
                        torch.equal(x, y) for x, y in zip(outs, base))
                        else '; differs from base')
            elif name == 'tf32x3':
                got = na._launch_fwd(q, k, v, 1.0, 'tf32x3')
                to_exact = err(got, exact)
                line += (f'; to f64 out {to_exact[0]:.2e}, lse '
                         f'{to_exact[1]:.2e}')
            print(line, flush=True)
        del q, k, v, q4, k4, v4, runs, want, exact, scratch, base
        torch.cuda.empty_cache()


def probe_lr(smi):
    import numpy as np
    import torch
    import pretorched_tpu_torch as pretorched
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
    from pretorched_tpu_torch.parallel.train import (make_train_step,
                                                     sgd_step_decay)

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    smoke = load('chip_smoke', REPO / 'chip_smoke.py')
    cli = load('video_eval_torch', REPO / 'examples' / 'video_eval_torch.py')
    smoke.WORK = OUT / 'lr'
    shutil.rmtree(smoke.WORK, ignore_errors=True)
    os.environ['PRETORCHED_HOME'] = str(smoke.WORK / 'zoo')
    smoke.fabricate(pretorched, torch, np)

    def generic_dq(q, k, v, do, lse, delta, scale=1.0):
        return na._launch_dq(q, k, v, do, lse, delta, scale, 'mma_sync')

    generic_dq.launches, generic_dq.by_kernel = 0, dict.fromkeys(na.KERNELS, 0)
    backwards = {'wgmma': {}, 'generic': {'nonlocal_attention_bwd_dq_cuda':
                                          generic_dq},
                 'plain': {'nonlocal_attention_bwd_cuda':
                           na.nonlocal_attention_bwd_reference}}
    print(f'12 train steps of phase 6, the loss at each ({smi})')
    for lr in (0.01, 0.001):
        for name, patch in backwards.items():
            saved = {k: getattr(na, k) for k in patch}
            for k, fn in patch.items():
                setattr(na, k, fn)
            try:
                model = pretorched.nonlocalresnet3d50(
                    num_classes=400, pretrained='kinetics-400').cuda()
                model.bfloat16()
                opt, sched = sgd_step_decay(model.parameters(), lr=lr,
                                            momentum=0.9, weight_decay=1e-4)
                step = make_train_step(model, opt, sched, remat=(0,))
                x, labels = smoke.train_batch(cli, model.settings, torch)
                losses = [step(x, labels)['loss'].item() for _ in range(12)]
            finally:
                for k, fn in saved.items():
                    setattr(na, k, fn)
            print(f'  lr {lr:g}, {name} backward: '
                  + ' '.join(f'{v:.4g}' for v in losses), flush=True)
            del model, opt, step
            torch.cuda.empty_cache()


def host_us(fn, reps=100, rounds=7):
    """Host microseconds a call of ``fn`` takes, no synchronize inside a
    round: the median of ``rounds`` rounds of ``reps`` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return sorted(per)[rounds // 2]


def probe_host(smi):
    import types
    import torch
    import torch.nn.functional as F
    from pretorched_tpu_torch.ops.cuda import build
    from pretorched_tpu_torch.ops.cuda import nonlocal_attention as na
    lib = build.load_library()
    g = torch.Generator(device='cuda').manual_seed(4)
    print(f'K1-fwd wrapper, host us a call by step (median of 7 rounds of '
          f'100 calls, no synchronize in a round), layer 3 ({smi})')
    for b in (1, 8):
        n = nk = 784
        c = cv = 512
        q, k = ((torch.randn(b, r, c, device='cuda', generator=g)
                 / c ** 0.25).bfloat16() for r in (n, nk))
        v = torch.randn(b, nk, cv, device='cuda', generator=g).bfloat16()
        out = torch.empty(b, n, cv, device='cuda', dtype=torch.bfloat16)
        lse = torch.empty(b, n, device='cuda')
        ptrs = list(map(na._ptr, (q, k, v, out, lse)))
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        counter = types.SimpleNamespace(
            launches=0, by_kernel=dict.fromkeys(na.PROGRAMS, 0))

        def context():
            with torch.cuda.device(q.device):
                return torch.cuda.current_stream(q.device).cuda_stream

        def wide():
            return lib.pt_nonlocal_attention_fwd_wgmma_wide(
                *ptrs, b, n, nk, c, cv, 1.0, stream)

        def mma_sync():
            return lib.pt_nonlocal_attention_fwd(
                *ptrs, b, n, nk, c, cv, 1.0, 1, stream)

        steps = {
            '_check_inputs': lambda: na._check_inputs(q, k, v),
            'attention_kernel + _check_kernel': lambda: na._check_kernel(
                torch.bfloat16, c, cv,
                na.attention_kernel(torch.bfloat16, c, cv, 'fwd'), 'fwd'),
            'contiguous x3': lambda: (q.contiguous(), k.contiguous(),
                                      v.contiguous()),
            'allocate out, lse': lambda: (
                torch.empty((b, n, cv), dtype=q.dtype, device=q.device),
                torch.empty((b, n), dtype=torch.float32, device=q.device)),
            '_check_tma': lambda: na._check_tma(q, k, v, out),
            'load_library': build.load_library,
            'device context + current stream': context,
            'pointers': lambda: list(map(na._ptr, (q, k, v, out, lse))),
            'C entry, wide wgmma (4 maps, launch)': wide,
            'build.check + _count': lambda: (
                build.check(lib, 0, 'probe'), na._count(counter, 'wgmma')),
        }
        times = {name: host_us(fn) for name, fn in steps.items()}
        whole = host_us(lambda: na.nonlocal_attention_cuda(q, k, v))
        entry_mma = host_us(mma_sync)
        q4, k4, v4 = (t[:, None] for t in (q, k, v))
        with torch.no_grad():
            sdpa = host_us(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, scale=1.0))
            sdpa_ms = median_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, scale=1.0))
        call_ms = median_ms(lambda: na.nonlocal_attention_cuda(q, k, v))
        entry_ms = median_ms(wide)
        print(f'  B={b}: the wrapper call {whole:.1f} us; by step: '
              + ', '.join(f'{k} {t:.1f}' for k, t in times.items())
              + f' (sum {sum(times.values()):.1f}); the mma.sync C entry '
              f'{entry_mma:.1f} us; one SDPA call {sdpa:.1f} us', flush=True)
        print(f'  B={b}, CUDA events (median of 30): the wrapper call '
              f'{call_ms:.4f} ms, the bare wide C entry {entry_ms:.4f} ms, '
              f'SDPA {sdpa_ms:.4f} ms', flush=True)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('port_kernel_probes: no CUDA card')
    smi = card()
    probes = {'k2': probe_k2, 'dq': probe_dq, 'lr': probe_lr,
              'wide': probe_wide, 'tf32': probe_tf32,
              'tf32_timing': lambda smi: probe_tf32(
                  smi, TF32_TIMING_VARIANTS, 'tf32_timing'),
              'tf32_loads': lambda smi: probe_tf32(
                  smi, TF32_LOAD_VARIANTS, 'tf32_loads'),
              'fwd32': probe_fwd32, 'tw32': probe_tw32,
              'tw32fwd': probe_tw32fwd,
              'host': probe_host}
    for name in argv or list(probes):
        probes[name](smi)


if __name__ == '__main__':
    main(sys.argv[1:])
