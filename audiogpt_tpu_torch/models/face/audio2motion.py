"""Audio → facial-landmark motion: GeneFace's variational motion generator,
the energy articulation prior and its numpy pseudo-target.

Counterpart of ``audiogpt_tpu/models/face/audio2motion.py``: the shared
80-bin LDM mel stands in for HuBERT features, and the output is 68 2-D
landmark offsets a video frame. The mel is encoded at its own rate and
resampled to the video rate (62.5 → 25 fps), the audio-conditioned
Gaussian prior gives the latent, and a conv stack decodes it.

JAX builds ``motion_enc`` and ``post_head`` (the posterior over motion and
audio) only when its training ``__call__`` runs, so its inference tree
holds neither. Here ``Audio2MotionVAE(cfg, posterior=True)`` owns them and
runs the training forward; the engine's model owns none, and
:func:`inference_tree` drops them from a training tree. The flax defaults
are kept: LayerNorm ε = 1e-6 and the tanh form of GELU.
``jax.image.resize(..., "linear")`` antialiases when it downsamples, which
:func:`resize_time` reproduces, forward and backward.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.models.tts.generspeech import ConvStack

#: the parameter names of Audio2Motion's conv stacks in the JAX tree
STACK_NAMES = ("in_proj", "ln_{}", "conv_{}")


@dataclasses.dataclass(frozen=True)
class Audio2MotionConfig:
    mel_bins: int = 80
    hidden: int = 256
    latent: int = 16
    landmarks: int = 68
    conv_layers: int = 3
    kernel: int = 5
    #: video frames per second; mel rate is sr/hop (62.5 for the LDM mel)
    fps: int = 25
    sample_rate: int = 16000
    hop: int = 256
    #: max landmark offset in unit-square coords (tanh clamp)
    motion_scale: float = 0.08

    @property
    def out_dim(self) -> int:
        return self.landmarks * 2

    def video_len(self, mel_len: int) -> int:
        return max(1, (mel_len * self.fps * self.hop) // self.sample_rate)


def resize_time(x: torch.Tensor, length: int) -> torch.Tensor:
    """x [B, T, C] → [B, length, C], linear along T with half-pixel
    centres, antialiased when it shrinks: ``jax.image.resize(x, (B,
    length, C), "linear")``."""
    y = F.interpolate(x.transpose(1, 2)[:, :, None, :], size=(1, length),
                      mode="bilinear", antialias=True, align_corners=False)
    return y[:, :, 0, :].transpose(1, 2)


#: the training-only submodules (the posterior) of the JAX tree
POSTERIOR = ("motion_enc", "post_head")


def inference_tree(tree: dict) -> dict:
    """A JAX Audio2Motion variable tree without the posterior: a trained
    tree drives the inference model (which owns neither head)."""
    params = tree.get("params", tree)
    params = {k: v for k, v in params.items() if k not in POSTERIOR}
    return {**tree, "params": params} if "params" in tree else params


class Audio2MotionVAE(nn.Module):
    """``generate(mel, draws, temperature)`` → landmark offsets
    [B, T_video, 68·2] in unit-square coords. ``posterior=True`` builds
    ``motion_enc`` and ``post_head`` for the training forward."""

    def __init__(self, cfg: Audio2MotionConfig, posterior: bool = False):
        super().__init__()
        self.cfg = c = cfg
        self.audio_enc = ConvStack(c.mel_bins, c.hidden, c.conv_layers,
                                   c.kernel, STACK_NAMES)
        if posterior:
            self.motion_enc = ConvStack(c.out_dim + c.hidden, c.hidden,
                                        c.conv_layers, c.kernel, STACK_NAMES)
            self.post_head = nn.Linear(c.hidden, 2 * c.latent)
        self.prior_head = nn.Linear(c.hidden, 2 * c.latent)
        self.decoder = ConvStack(c.latent + c.hidden, c.hidden,
                                 c.conv_layers, c.kernel, STACK_NAMES)
        self.out_head = nn.Linear(c.hidden, c.out_dim)

    def audio_features(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T_mel, M] → features at the video rate [B, T_v, H]."""
        return resize_time(self.audio_enc(mel),
                           self.cfg.video_len(mel.shape[1]))

    def _decode(self, z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        h = self.decoder(torch.cat([z, a], -1))
        return torch.tanh(self.out_head(h)) * self.cfg.motion_scale

    def forward(self, mel: torch.Tensor, motion: torch.Tensor,
                draws: torch.Generator | torch.Tensor):
        """The training forward: mel [B, T_mel, M] and the ground-truth
        offsets ``motion`` [B, T_v, 68·2] → (recon, (mu_q, lv_q),
        (mu_p, lv_p)), the log-variances clipped to [−8, 8]. ``draws``: the
        posterior's ε [B, T_v, latent], or a generator."""
        a = self.audio_features(mel)
        mu_q, lv_q = self.post_head(self.motion_enc(
            torch.cat([motion, a], -1))).chunk(2, dim=-1)
        mu_p, lv_p = self.prior_head(a).chunk(2, dim=-1)
        lv_q = lv_q.clamp(-8.0, 8.0)
        lv_p = lv_p.clamp(-8.0, 8.0)
        if isinstance(draws, torch.Generator):
            draws = torch.randn(mu_q.shape, generator=draws,
                                device=mu_q.device)
        z = mu_q + torch.exp(0.5 * lv_q) * draws
        return self._decode(z, a), (mu_q, lv_q), (mu_p, lv_p)

    def generate(self, mel: torch.Tensor,
                 draws: torch.Generator | torch.Tensor,
                 temperature: float = 1.0) -> torch.Tensor:
        """``draws``: the prior's noise [B, T_v, latent], or a generator."""
        a = self.audio_features(mel)
        mu, lv = self.prior_head(a).chunk(2, dim=-1)
        lv = lv.clamp(-8.0, 8.0)
        if isinstance(draws, torch.Generator):
            draws = torch.randn(mu.shape, generator=draws, device=mu.device)
        z = mu + temperature * torch.exp(0.5 * lv) * draws
        return self._decode(z, a)


def kl_gauss(mu_q, lv_q, mu_p, lv_p):
    """KL(q‖p) per element, both diagonal Gaussians."""
    return 0.5 * (lv_p - lv_q + (torch.exp(lv_q) + (mu_q - mu_p) ** 2)
                  / torch.exp(lv_p) - 1.0)


#: the landmarks the energy prior moves down (+y), and by how much of the
#: amplitude: the lower outer lip, the lower and upper inner lip, the chin
_ARTICULATION = (((49, 50, 51, 52, 53), 1.0), ((61, 62, 63), 0.8),
                 ((65, 66, 67), -0.2), ((6, 7, 8, 9, 10), 0.5))


def energy_articulation(mel: torch.Tensor, cfg: Audio2MotionConfig,
                        gain: float = 1.0) -> torch.Tensor:
    """mel [T_mel, M] (LDM-normalised, [0, 1]) → the deterministic mouth
    and jaw offsets [T_v, 68, 2]: the frame energy (mean over bins) at the
    video rate, centred over the whole mel, opens the mouth."""
    e = mel.mean(-1)
    tv = cfg.video_len(e.shape[0])
    e = resize_time(e[None, :, None], tv)[0, :, 0]
    e = torch.clamp((e - e.mean()) * 3.0 + 0.5, 0.0, 1.0) * gain
    off = torch.zeros(tv, 68, 2, device=mel.device)
    amp = 0.030 * e[:, None]
    for idx, k in _ARTICULATION:
        off[:, list(idx), 1] += amp * k
    return off


def pseudo_motion_targets(mel, video_len: int) -> np.ndarray:
    """The numpy twin of :func:`energy_articulation`, flattened to
    [T_v, 68·2]: the data loader's target for an audio-only corpus
    (``data/loader.py`` ``collate_motion``). The energy is resampled to
    the video rate by ``np.interp`` over ``linspace(0, T − 1, T_v)`` (no
    antialias), as the JAX package's is."""
    e = np.asarray(mel, np.float32).mean(-1)
    pos = np.linspace(0, len(e) - 1, video_len)
    e = np.interp(pos, np.arange(len(e)), e)
    e = np.clip((e - e.mean()) * 3.0 + 0.5, 0.0, 1.0)
    off = np.zeros((video_len, 68, 2), np.float32)
    amp = (0.030 * e)[:, None]
    for idx, k in _ARTICULATION:
        off[:, list(idx), 1] += amp * k
    return off.reshape(video_len, 136)
