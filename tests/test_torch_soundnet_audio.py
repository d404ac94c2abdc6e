"""The port's SoundNet, BranchedSoundNet and WAV ingestion against the JAX
package's, on the CPU.

The JAX ``SoundNet`` (14 classes) is built once, every BN randomized, and
carried into the port with ``state_dict_from_flax`` (strict load); the
multi-window head (``feature_dim`` 32,000 on 22,000 samples) and
``BranchedSoundNet`` (both heads, 300M parameters) take seeded variables
on a ``jax.eval_shape`` template instead, so nothing compiles an init. The
features agree at 2e-4, the logits at 2e-3. ``load_audio`` and
``soundnet_input`` give JAX's samples exactly for 8-, 16- and 32-bit WAVs,
stereo, a 16 kHz file resampled and a short one tiled; ``soundnet8`` loads
a hosted file without BN with ``strict=False`` and runs a WAV.
"""

import os
import wave

import jax
import numpy as np
import pytest
import torch

from pretorched_tpu.datasets import audio as jaudio
from pretorched_tpu.models.soundnet import BranchedSoundNet as JaxBranched
from pretorched_tpu.models.soundnet import SoundNet as JaxSoundNet
import pretorched_tpu_torch
from pretorched_tpu_torch.datasets import audio
from pretorched_tpu_torch.models.soundnet import BranchedSoundNet, SoundNet
from pretorched_tpu_torch.zoo.convert import state_dict_from_flax

from torch_port_helpers import (assert_near, one_torch_thread,  # noqa: F401
                                port_state_dict, randomize_bn, run_jax)

SAMPLES = 67724        # 262 conv8 steps: one 262,000-feature window


def _seeded(module, length, seed):
    """Variables of ``module`` on a ``jax.eval_shape`` template, filled
    from a seeded numpy generator: kernels normal at 1/sqrt(fan_in),
    biases and BN as ``randomize_bn`` draws them."""
    shapes = jax.eval_shape(module.init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, length, 1), np.float32))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == 'kernel':
            scale = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape).astype(np.float32)
                    * np.float32(scale))
        low, high = {'mean': (-0.3, 0.3), 'var': (0.5, 1.5),
                     'scale': (0.5, 1.5)}.get(leaf, (-0.2, 0.2))
        return rng.uniform(low, high, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _logits(model, x):
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return [o.numpy() for o in out] if isinstance(out, tuple) else out.numpy()


def test_soundnet_matches_jax():
    """One window of 262,000 features: the seven stages with their
    stride-1 max pools, ``conv8`` and the channel-major flatten (features
    at 2e-4), then the head (logits at 2e-3)."""
    jmod = JaxSoundNet(num_classes=14)
    variables = randomize_bn(dict(jax.jit(jmod.init)(
        jax.random.key(0), np.zeros((1, SAMPLES, 1), np.float32))), seed=1)
    x = np.random.RandomState(2).randn(2, 1, SAMPLES).astype(np.float32)
    xt = np.transpose(x, (0, 2, 1))
    want_f = np.asarray(run_jax(
        lambda v, x: jmod.apply(v, x, mode='features'), variables, xt))
    want = np.asarray(run_jax(jmod.apply, variables, xt))
    model = SoundNet(num_classes=14).eval()
    model.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        feats = model.features(torch.from_numpy(x)).numpy()
    assert feats.shape == (2, 262000)
    assert_near(feats, want_f, 2e-4)
    assert_near(_logits(model, x), want, 2e-3)


def test_soundnet_multiwindow_matches_jax():
    """22,000 samples give 83 steps, 83,000 features: two full windows of
    32,000 and the right-aligned third, averaged."""
    jmod = JaxSoundNet(num_classes=14, feature_dim=32000)
    variables = _seeded(jmod, 22000, seed=3)
    x = np.random.RandomState(4).randn(2, 1, 22000).astype(np.float32)
    want = np.asarray(run_jax(jmod.apply, variables,
                              np.transpose(x, (0, 2, 1))))
    model = SoundNet(num_classes=14, feature_dim=32000).eval()
    model.load_state_dict(port_state_dict(variables), strict=True)
    with torch.no_grad():
        assert model.features(torch.from_numpy(x)).shape == (2, 83000)
    assert_near(_logits(model, x), want, 2e-3)
    with pytest.raises(ValueError, match='need >= 32000 features'):
        model(torch.zeros(1, 1, 8000))


def test_branched_soundnet_matches_jax():
    """Both heads (1000 objects, 365 places) at 67,724 samples. The 1.2 GB
    of weights are loaded into a model built on the meta device, so the
    port holds no second copy."""
    jmod = JaxBranched()
    variables = _seeded(jmod, SAMPLES, seed=5)
    x = np.random.RandomState(6).randn(1, 1, SAMPLES).astype(np.float32)
    want = [np.asarray(w) for w in run_jax(jmod.apply, variables,
                                           np.transpose(x, (0, 2, 1)))]
    sd = {k: torch.from_numpy(v)
          for k, v in state_dict_from_flax(variables).items()}
    del variables
    with torch.device('meta'):
        model = BranchedSoundNet()
    model.load_state_dict(sd, strict=True, assign=True)
    del sd
    got = _logits(model.eval(), x)
    assert [g.shape for g in got] == [(1, 1000), (1, 365)]
    for g, w in zip(got, want):
        assert_near(g, w, 2e-3)


def _write_wav(path, samples, width, rate):
    """``samples`` (L, C) in [-1, 1) as a ``width``-byte PCM WAV."""
    if width == 1:
        pcm = np.round(samples * 127 + 128).astype(np.uint8)
    else:
        dtype = {2: np.int16, 4: np.int32}[width]
        pcm = np.round(samples * (np.iinfo(dtype).max - 1)).astype(dtype)
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(samples.shape[1])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


@pytest.mark.parametrize('width', [1, 2, 4])
def test_load_audio_matches_jax(width, tmp_path):
    """Stereo WAVs of 8-, 16- and 32-bit samples at 22,050 Hz: the port's
    (C, L) tensor is JAX's (L, C) array transposed, exactly, mono and
    not."""
    rng = np.random.RandomState(width)
    path = tmp_path / f'noise{width}.wav'
    _write_wav(path, rng.uniform(-0.9, 0.9, (5000, 2)), width, 22050)
    for mono in (True, False):
        got, rate = audio.load_audio(str(path), mono=mono)
        want, want_rate = jaudio.load_audio(str(path), mono=mono)
        assert rate == want_rate == 22050
        assert got.dtype == torch.float32 and got.shape == want.T.shape
        np.testing.assert_array_equal(got.numpy(), want.T)
    assert np.abs(got.numpy()).max() <= 1.0


def test_resample_and_tiling_match_jax(tmp_path):
    """A 16 kHz 16-bit tone read at 22,050 Hz (linear interpolation), and
    ``soundnet_input`` tiling it to 67,724 samples: JAX's samples exactly,
    channels-first; ``resample`` on a tensor as on the array."""
    sr = 16000
    t = np.arange(sr // 2) / sr
    tone = (0.8 * np.sin(2 * np.pi * 440.0 * t))[:, None]
    path = tmp_path / 'tone.wav'
    _write_wav(path, tone, 2, sr)
    got, rate = audio.load_audio(str(path))
    want, _ = jaudio.load_audio(str(path))
    assert rate == 22050 and got.shape == (1, 11025)
    np.testing.assert_array_equal(got.numpy(), want.T)
    batch = audio.soundnet_input(str(path), min_length=SAMPLES)
    want_batch = jaudio.soundnet_input(str(path), min_length=SAMPLES)
    assert batch.shape == (1, 1, SAMPLES)
    np.testing.assert_array_equal(batch.numpy(),
                                  np.transpose(want_batch, (0, 2, 1)))
    wave_ = np.random.RandomState(7).randn(2, 999).astype(np.float32)
    np.testing.assert_array_equal(
        audio.resample(torch.from_numpy(wave_), 16000, 22050).numpy(),
        jaudio.resample(wave_.T, 16000, 22050).T)


def test_other_formats_need_ffmpeg(tmp_path, monkeypatch):
    """A non-WAV file goes through ffmpeg, and without it on PATH the
    loader raises, as JAX's does."""
    path = tmp_path / 'clip.mp3'
    path.write_bytes(b'\0' * 16)
    monkeypatch.setattr(audio.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='ffmpeg not on PATH'):
        audio.load_audio(str(path))


def test_soundnet8_loads_a_hosted_file_without_bn(tmp_path, monkeypatch):
    """``soundnet8.pth`` in the weight cache, as the reference hosts it
    (no ``bn1..bn7``): loaded with ``strict=False``, the missing BN named;
    the waveform metadata; a WAV through ``soundnet_input`` to logits."""
    donor = pretorched_tpu_torch.soundnet8(num_classes=5)
    hosted = {k: v * 1.5 for k, v in donor.state_dict().items()
              if not k.startswith('bn')}
    (tmp_path / 'weights').mkdir()
    torch.save(hosted, tmp_path / 'weights' / 'soundnet8.pth')
    monkeypatch.setenv('PRETORCHED_HOME', str(tmp_path))
    with pytest.warns(UserWarning, match='bn1.weight'):
        model = pretorched_tpu_torch.soundnet8(num_classes=5,
                                               pretrained='imagenet')
    assert torch.equal(model.conv1.weight, hosted['conv1.weight'])
    assert model.input_space == 'waveform' and model.input_range == [-1, 1]
    assert model.input_size == [1, SAMPLES] and model.input_ndim == 3
    path = tmp_path / 'tone.wav'
    _write_wav(path, np.random.RandomState(8).uniform(-0.5, 0.5, (40000, 1)),
               2, 22050)
    x = audio.soundnet_input(str(path), min_length=SAMPLES)
    with torch.no_grad():
        out = model.eval()(x)
    assert out.shape == (1, 5) and bool(torch.isfinite(out).all())
    assert os.path.getsize(tmp_path / 'weights' / 'soundnet8.pth') > 0
