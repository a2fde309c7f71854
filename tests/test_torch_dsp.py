"""Port DSP frontend (window, STFT, spectrogram, log-mel, the inverse STFT
and the vocoder's ``denoise``) against the JAX package on the same
non-silent random waveforms."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.dsp import mel as jax_mel
from audiogpt_tpu.dsp.stft import istft as jax_istft
from audiogpt_tpu.dsp.stft import spectrogram as jax_spectrogram
from audiogpt_tpu.dsp.stft import stft as jax_stft
from audiogpt_tpu.dsp.window import hann_window as jax_hann
from audiogpt_tpu.engines.vocoder import denoise as jax_denoise
from audiogpt_tpu_torch.dsp import mel, stft
from audiogpt_tpu_torch.dsp.window import hann_window, pad_center
from audiogpt_tpu_torch.engines.vocoder import denoise

torch.set_num_threads(2)


def _wav(n, batch=(2,), seed=0):
    """Noise plus a tone: every band of the spectrum is away from zero."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * rng.randn(*batch, n) + 0.5 * np.sin(2 * np.pi * 440.0 * t)
            ).astype(np.float32)


def test_window_matches_jax():
    for n in (400, 1024):
        np.testing.assert_array_equal(hann_window(n), jax_hann(n))
        np.testing.assert_array_equal(hann_window(n, periodic=False),
                                      jax_hann(n, periodic=False))
    np.testing.assert_array_equal(pad_center(hann_window(400), 512)[:56], 0)


@pytest.mark.parametrize("pad_mode", ["constant", "reflect"])
def test_stft_matches_jax(pad_mode):
    x = _wav(5000)
    ref = np.asarray(jax_stft(jnp.asarray(x), 1024, 256, pad_mode=pad_mode))
    got = stft.stft(torch.from_numpy(x), 1024, 256, pad_mode=pad_mode)
    assert got.shape == ref.shape == (2, stft.n_frames(5000, 256, 1024), 513)
    # two f32 FFTs of 1024 points (pocketfft in both, other orders) on
    # frames of O(1) samples: 1e-3 absolute on bins of up to ~300
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("pad_mode,power", [("constant", 1.0),
                                            ("reflect", 2.0),
                                            ("reflect", 1.0),
                                            ("constant", 2.0)])
def test_spectrogram_matches_jax(pad_mode, power):
    x = _wav(4000, batch=(3,), seed=1)
    ref = np.asarray(jax_spectrogram(jnp.asarray(x), 512, 128,
                                     win_length=400, pad_mode=pad_mode,
                                     power=power))
    got = stft.spectrogram(torch.from_numpy(x), 512, 128, win_length=400,
                           pad_mode=pad_mode, power=power).numpy()
    # f32 FFTs; relative 1e-4 of the bin, plus 1e-3 of the largest bin for
    # the bins near zero that a different summation order moves most
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3 * ref.max())


@pytest.mark.parametrize("spec_name", ["LDM_MEL_16K", "PANNS_MEL_32K"])
def test_log_mel_matches_jax(spec_name):
    spec = getattr(mel, spec_name)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        getattr(jax_mel, spec_name))
    np.testing.assert_array_equal(spec.filterbank(),
                                  getattr(jax_mel, spec_name).filterbank())
    x = _wav(12000, seed=2)
    ref = np.asarray(jax_mel.log_mel(jnp.asarray(x),
                                     getattr(jax_mel, spec_name)))
    got = mel.log_mel(torch.from_numpy(x), spec).numpy()
    assert got.shape == ref.shape == (2, 1 + 12000 // spec.hop, spec.n_mels)
    # log10 / dB of f32 mel energies: 1e-4 relative of the energy is
    # 4.3e-5 in log10 and 4.3e-4 dB
    atol = 5e-5 if spec.log == "log10" else 5e-4
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def test_ldm_mel_and_normalize_match_jax():
    x = _wav(8000, seed=3)
    ref = np.asarray(jax_mel.ldm_mel(jnp.asarray(x)))
    got = mel.ldm_mel(torch.from_numpy(x)).numpy()
    assert got.min() >= 0.0 and got.max() <= 1.0
    # ldm_normalize scales log10 by 1/5: 1e-5 on values in [0, 1]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    spec = dataclasses.replace(mel.LDM_MEL_16K, n_mels=16, log="none")
    np.testing.assert_allclose(
        mel.log_mel(torch.from_numpy(x), spec).numpy(),
        np.asarray(jax_mel.log_mel(jnp.asarray(x), dataclasses.replace(
            jax_mel.LDM_MEL_16K, n_mels=16, log="none"))), rtol=1e-4,
        atol=1e-6)
    np.testing.assert_allclose(
        mel.ldm_denormalize(torch.from_numpy(got)).numpy(),
        np.asarray(jax_mel.ldm_denormalize(jnp.asarray(got))), atol=1e-6)


@pytest.mark.parametrize("n_fft,hop,win_length,length", [
    (256, 64, None, 3000), (128, 32, 100, 2900), (256, 64, None, 3100),
    (256, 64, None, None)])
def test_istft_matches_jax(n_fft, hop, win_length, length):
    """Overlap-add with window-sum-square normalisation, centre trim, and
    ``length`` cutting or zero-padding the end; a round trip of the STFT
    returns the signal where the frames cover it."""
    x = _wav(3000, seed=4)
    spec = np.asarray(jax_stft(jnp.asarray(x), n_fft, hop, win_length))
    ref = np.asarray(jax_istft(jnp.asarray(spec), n_fft, hop, win_length,
                               length=length))
    got = stft.istft(torch.from_numpy(spec), n_fft, hop, win_length,
                     length=length).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    # ≈ 1.6 in amplitude through an inverse FFT and a division
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    covered = min((3000 + 2 * (n_fft // 2) - n_fft) // hop * hop,
                  got.shape[-1])
    np.testing.assert_allclose(got[:, :covered], x[:, :covered], atol=2e-6)


def test_istft_uncentred_matches_jax():
    """``center=False`` keeps the edge samples, where the window sum falls
    towards 0 and the division amplifies each framework's last-digit error
    of the inverse FFT (3e-4 at the last sample): those are compared where
    the window-sum-square is at least 1 % of its peak."""
    n_fft, hop = 256, 64
    x = _wav(3000, seed=5)
    spec = np.asarray(jax_stft(jnp.asarray(x), n_fft, hop))
    ref = np.asarray(jax_istft(jnp.asarray(spec), n_fft, hop, center=False))
    got = stft.istft(torch.from_numpy(spec), n_fft, hop,
                     center=False).numpy()
    assert got.shape == ref.shape == (2, n_fft + hop * (spec.shape[1] - 1))
    w2 = pad_center(hann_window(n_fft), n_fft) ** 2
    wss = np.zeros(got.shape[-1])
    for i in range(spec.shape[1]):
        wss[i * hop: i * hop + n_fft] += w2
    kept = wss >= 0.01 * wss.max()
    assert kept.sum() >= 0.95 * got.shape[-1]
    np.testing.assert_allclose(got[:, kept], ref[:, kept], atol=2e-6, rtol=0)


def test_denoise_matches_jax():
    """Magnitude subtraction with the mixture's phase: a tone in noise
    keeps the tone and loses noise energy."""
    rng = np.random.RandomState(6)
    t = np.arange(16000) / 22050.0
    tone = 0.5 * np.sin(2 * np.pi * 220.0 * t)
    wav = (tone + 0.02 * rng.randn(t.size)).astype(np.float32)
    ref = jax_denoise(wav)
    got = denoise(wav, device="cpu")
    assert got.dtype == np.float32 and got.shape == ref.shape == wav.shape
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    mid = slice(2048, -2048)
    assert np.abs(got - tone)[mid].std() < np.abs(wav - tone)[mid].std()
    got2 = denoise(wav, v=0.05, n_fft=512, hop=128, win_length=400,
                   device="cpu")
    np.testing.assert_allclose(
        got2, jax_denoise(wav, v=0.05, n_fft=512, hop=128, win_length=400),
        atol=2e-6, rtol=0)
