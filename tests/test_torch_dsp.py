"""Port DSP frontend (window, STFT, spectrogram, log-mel) against the JAX
package on the same non-silent random waveforms."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.dsp import mel as jax_mel
from audiogpt_tpu.dsp.stft import spectrogram as jax_spectrogram
from audiogpt_tpu.dsp.stft import stft as jax_stft
from audiogpt_tpu.dsp.window import hann_window as jax_hann
from audiogpt_tpu_torch.dsp import mel, stft
from audiogpt_tpu_torch.dsp.window import hann_window, pad_center

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
