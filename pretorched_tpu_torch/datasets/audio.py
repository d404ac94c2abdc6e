"""Audio ingestion for SoundNet.

Counterpart of ``pretorched_tpu/datasets/audio.py``. The reference demos
``torchaudio.load(mp3)`` -> waveform -> SoundNet (soundnet.py:93-98). Here a
WAV file decodes with the stdlib ``wave`` module (8-, 16- and 32-bit
samples), anything else (mp3, ogg, flac) through ``ffmpeg`` when it is on
PATH, and the rate is changed by linear interpolation. The samples are
computed in numpy exactly as the JAX module computes them; the port hands
them out channels-first, as torchaudio does: ``load_audio`` gives a (C, L)
tensor, ``soundnet_input`` a (1, 1, L) batch.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from typing import Optional, Tuple

import numpy as np
import torch


def _decode_wav(path: str) -> Tuple[np.ndarray, int]:
    """(L, C) float32 samples in [-1, 1] and the rate."""
    with wave.open(path, 'rb') as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f'unsupported WAV sample width {width}')
    return x.reshape(-1, ch), sr


def _decode_ffmpeg(path: str, sample_rate: int) -> Tuple[np.ndarray, int]:
    """(L, 1) float32 samples at ``sample_rate`` through ``ffmpeg``; raises
    when it is not on PATH."""
    ffmpeg = shutil.which('ffmpeg')
    if ffmpeg is None:
        raise RuntimeError(
            f'cannot decode {os.path.splitext(path)[1]!r}: ffmpeg not on '
            f'PATH (WAV decodes natively)')
    cmd = [ffmpeg, '-v', 'error', '-i', path, '-f', 's16le', '-acodec',
           'pcm_s16le', '-ar', str(sample_rate), '-ac', '1', '-']
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    x = np.frombuffer(out, np.int16).astype(np.float32) / 32768.0
    return x.reshape(-1, 1), sample_rate


def _resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return x
    n_out = int(round(len(x) * sr_out / sr_in))
    t_in = np.arange(len(x)) / sr_in
    t_out = np.arange(n_out) / sr_out
    return np.stack([np.interp(t_out, t_in, x[:, c])
                     for c in range(x.shape[1])], axis=1).astype(np.float32)


def resample(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """Linear-interpolation resample of a (C, L) waveform to (C, L')."""
    if sr_in == sr_out:
        return x
    return torch.from_numpy(np.ascontiguousarray(
        _resample(x.cpu().numpy().T, sr_in, sr_out).T))


def _load(path: str, sample_rate: Optional[int], mono: bool):
    if path.lower().endswith('.wav'):
        x, sr = _decode_wav(path)
    else:
        x, sr = _decode_ffmpeg(path, sample_rate or 22050)
    if mono and x.shape[1] > 1:
        x = x.mean(axis=1, keepdims=True)
    if sample_rate is not None and sr != sample_rate:
        x, sr = _resample(x, sr, sample_rate), sample_rate
    return x, sr


def load_audio(path: str, sample_rate: Optional[int] = 22050,
               mono: bool = True) -> Tuple[torch.Tensor, int]:
    """Decode an audio file -> (float32 waveform (C, L) in [-1, 1], rate)."""
    x, sr = _load(path, sample_rate, mono)
    return torch.from_numpy(np.ascontiguousarray(x.T)), sr


def soundnet_input(path: str, sample_rate: int = 22050,
                   min_length: Optional[int] = None) -> torch.Tensor:
    """File -> (1, 1, L) batch for ``soundnet8`` (the reference's
    ``sound.t().unsqueeze(0)``, soundnet.py:96). Audio shorter than
    ``min_length`` samples is tiled (the reference's commented torch.cat
    doubling)."""
    x, _ = _load(path, sample_rate, True)
    if len(x) == 0:
        raise ValueError(f'decoded zero samples from {path!r}')
    if min_length is not None and len(x) < min_length:
        reps = -(-min_length // len(x))
        x = np.tile(x, (reps, 1))[:min_length]
    return torch.from_numpy(np.ascontiguousarray(x.T))[None]
