"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds.

Only the clip, the batch and the pool shrink; the architecture stays at
full depth and width. ``dtype='float64'`` runs the program and the
reference in float64, where the two agree to rounding, so that a sound
run meets the cell's own limits and a fault is the only thing that fails
them.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import runner
from benchmark.harness.cells import Cell


def tiny_cell(name, dtype='float32', root=None):
    cell = Cell(name, root) if root else Cell(name)
    crop = 64 if cell.mode == 'train' else 32
    frames = 32 if cell.config['reference'] == 'slowfast' else 8
    cell.config['clip'] = {'frames': frames, 'crop': crop}
    cell.config['preprocess']['input_size'] = [3, crop, crop]
    cell.dtype = cell.traffic['dtype'] = dtype
    if cell.mode == 'eval':
        cell.traffic.update(clips_per_video=2, pool_videos=4, video_frames=40,
                            frame_height=40, frame_width=48, warmup_steps=1,
                            reference_clips=2)
    else:
        cell.traffic.update(clips_per_step=4)
        if dtype == 'float64':
            # one checked step: at this size three steps part chaotically
            # from the reference through the port's float32 attention
            cell.traffic.update(checked_steps=1)
    return cell


def run_tiny(cell, seed=2 ** 31 + 5, seconds=0.3):
    """One run of ``cell`` on the CPU: (result, compared lines)."""
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return runner.run_cell(cell.name, seed, seconds, 0, 'cpu',
                           time.perf_counter(), cell)
