"""VISinger: VITS-class end-to-end singing-voice synthesis.

Counterpart of ``audiogpt_tpu/models/svs/visinger.py:39-232`` (the
reference's ``t2s_VISinger`` tool drives ESPnet's external model,
``audio-chatgpt.py:341``; the JAX package builds the architecture
natively): a score encoder (phone + MIDI-pitch + slur embeddings → FFT
blocks → prior stats), a mean-only residual-coupling flow run in reverse
from the prior, and the HiFi-GAN decoder z → wav
(``models/vocoder/hifigan.py``). Frames come from the score's note
durations or the duration head. Training (:meth:`VISinger.train_step_outputs`,
``train/tasks/visinger.py``) runs the posterior encoder on the linear
spectrogram, the flow forward into prior space, the KL against the
expanded prior and the decoder on the whole posterior z. The decoder's
input width is ``latent_dim`` whatever ``decoder.in_channels`` says, as
flax infers it from z. Tensors are frame-major ``[B, T, C]`` at the
boundary, as in JAX; the flax ``nn.Conv`` layers are bare
``torch.nn.Conv1d`` under the flax scope names.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from audiogpt_tpu_torch.models.tts.fastspeech2 import (
    FastSpeech2,
    FFTBlocks,
    conv_time,
    length_regulator,
)
from audiogpt_tpu_torch.parallel.reduce import global_sums
from audiogpt_tpu_torch.models.vocoder.hifigan import (
    HifiGANConfig,
    HifiGANGenerator,
)


@dataclasses.dataclass(frozen=True)
class VISingerConfig:
    vocab_size: int = 100
    hidden: int = 192
    enc_layers: int = 4
    enc_heads: int = 2
    latent_dim: int = 192
    spec_bins: int = 513            # n_fft//2+1 posterior input
    posterior_layers: int = 8
    flow_layers: int = 4
    flow_wn_layers: int = 4
    max_frames: int = 1024
    decoder: HifiGANConfig = HifiGANConfig(
        in_channels=192, upsample_rates=(8, 8, 2, 2),
        upsample_kernel_sizes=(16, 16, 4, 4), upsample_initial_channel=256)


class WNStack(nn.Module):
    """Non-causal WaveNet stack (VITS WN), unconditioned: returns the sum
    of the skips."""

    def __init__(self, hidden: int, layers: int, kernel: int = 5):
        super().__init__()
        self.hidden, self.layers = hidden, layers
        for i in range(layers):
            self.add_module(f"in{i}", nn.Conv1d(hidden, 2 * hidden, kernel,
                                                padding="same"))
            self.add_module(f"rs{i}", nn.Linear(hidden, 2 * hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, skip = x, 0.0
        for i in range(self.layers):
            a = conv_time(getattr(self, f"in{i}"), h)
            acts = torch.tanh(a[..., :self.hidden]) \
                * torch.sigmoid(a[..., self.hidden:])
            rs = getattr(self, f"rs{i}")(acts)
            h = (h + rs[..., :self.hidden]) * math.sqrt(0.5)
            skip = skip + rs[..., self.hidden:]
        return skip


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling (VITS ResidualCouplingLayer); ``post`` is
    zero-initialised, as in JAX."""

    def __init__(self, channels: int, hidden: int, wn_layers: int):
        super().__init__()
        self.half = channels // 2
        self.pre = nn.Linear(self.half, hidden)
        self.wn = WNStack(hidden, wn_layers)
        self.post = nn.Linear(hidden, self.half)
        nn.init.zeros_(self.post.weight)
        nn.init.zeros_(self.post.bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
        m_ = mask[..., None]
        xa, xb = x[..., :self.half], x[..., self.half:]
        m = self.post(self.wn(self.pre(xa) * m_))
        xb = (xb - m if reverse else xb + m) * m_
        return torch.cat([xa, xb], -1)


class ResidualCouplingFlow(nn.Module):
    def __init__(self, channels: int, hidden: int, n_layers: int,
                 wn_layers: int):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"l{i}", ResidualCouplingLayer(channels, hidden,
                                                           wn_layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
        """Posterior → prior space; ``reverse`` flips the channels before
        each layer, last layer first."""
        if not reverse:
            for i in range(self.n_layers):
                x = getattr(self, f"l{i}")(x, mask).flip(-1)
        else:
            for i in reversed(range(self.n_layers)):
                x = getattr(self, f"l{i}")(x.flip(-1), mask, reverse=True)
        return x


class PosteriorEncoder(nn.Module):
    """Linear spectrogram → the posterior (z, m_q, logs_q), each
    [B, F, latent] and zero on the padded frames."""

    def __init__(self, cfg: VISingerConfig):
        super().__init__()
        self.pre = nn.Linear(cfg.spec_bins, cfg.hidden)
        self.wn = WNStack(cfg.hidden, cfg.posterior_layers)
        self.proj = nn.Linear(cfg.hidden, 2 * cfg.latent_dim)

    def forward(self, spec: torch.Tensor, mask: torch.Tensor,
                draws: torch.Generator | torch.Tensor):
        """``spec`` [B, F, bins], ``mask`` [B, F]; ``draws`` the ε
        [B, F, latent] of z = m + exp(logs)·ε, or a generator."""
        m_ = mask[..., None]
        h = self.wn(self.pre(spec) * m_)
        m, logs = (self.proj(h) * m_).chunk(2, -1)
        if isinstance(draws, torch.Generator):
            draws = torch.randn(m.shape, generator=draws, device=m.device)
        return (m + torch.exp(logs) * draws) * m_, m, logs


class ScoreEncoder(nn.Module):
    def __init__(self, cfg: VISingerConfig):
        super().__init__()
        self.hidden = cfg.hidden
        self.phone_embed = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.midi_embed = nn.Embedding(130, cfg.hidden)
        self.slur_embed = nn.Embedding(2, cfg.hidden)
        self.fft = FFTBlocks(cfg.hidden, cfg.enc_layers, cfg.enc_heads, 9)
        self.proj = nn.Linear(cfg.hidden, 2 * cfg.latent_dim)
        self.dur_proj = nn.Linear(cfg.hidden, 1)

    def forward(self, tokens, pitch_midi, is_slur):
        """→ (m_p, logs_p [B, T, latent], dur_log [B, T], nonpad [B, T])."""
        x = self.phone_embed(tokens) + self.midi_embed(pitch_midi) \
            + self.slur_embed(is_slur)
        nonpad = (tokens > 0).float()
        x = self.fft(x * math.sqrt(self.hidden), nonpad)
        m_p, logs_p = self.proj(x).chunk(2, -1)
        return m_p, logs_p, self.dur_proj(x)[..., 0], nonpad


class VISinger(nn.Module):
    def __init__(self, cfg: VISingerConfig):
        super().__init__()
        self.cfg = cfg
        self.score_encoder = ScoreEncoder(cfg)
        self.posterior_encoder = PosteriorEncoder(cfg)
        self.flow = ResidualCouplingFlow(cfg.latent_dim, cfg.hidden,
                                         cfg.flow_layers, cfg.flow_wn_layers)
        self.decoder = HifiGANGenerator(dataclasses.replace(
            cfg.decoder, in_channels=cfg.latent_dim))

    def train_step_outputs(self, tokens: torch.Tensor,
                           pitch_midi: torch.Tensor, is_slur: torch.Tensor,
                           mel2ph: torch.Tensor, spec: torch.Tensor,
                           draws: torch.Generator | torch.Tensor) -> dict:
        """The training forward on the score's ``mel2ph`` [B, F] and the
        linear ``spec`` [B, F, bins] → dict of ``wav`` [B, F · hop] (the
        decoder on the whole z), ``kl`` (KL(q ‖ p) after the flow, summed
        over the frames with a phone and divided by their count ·
        latent), ``dur`` (log-domain, per token), ``nonpad``, ``z`` and
        ``mask``. ``draws``: the posterior's ε [B, F, latent] or a
        generator."""
        m_p_ph, logs_p_ph, dur_log, nonpad = self.score_encoder(
            tokens, pitch_midi, is_slur)
        mask = (mel2ph > 0).float()
        # phone 0 is the pad: expand_states pads one zero row in front
        m_p = FastSpeech2.expand_states(m_p_ph, mel2ph)
        logs_p = FastSpeech2.expand_states(logs_p_ph, mel2ph)
        z, m_q, logs_q = self.posterior_encoder(spec, mask, draws)
        z_p = self.flow(z, mask)
        kl = logs_p - logs_q - 0.5 + 0.5 * (torch.exp(2 * logs_q)
                                            + (z_p - m_p) ** 2) \
            * torch.exp(-2 * logs_p)
        # over the global batch of a data-parallel run
        num, den = global_sums((kl * mask[..., None]).sum(), mask.sum())
        kl = num / (den * kl.shape[-1]).clamp_min(1.0)
        wav = self.decoder(z.transpose(1, 2))
        return {"wav": wav, "kl": kl, "dur": dur_log, "nonpad": nonpad,
                "z": z, "mask": mask}

    def forward(self, tokens: torch.Tensor, pitch_midi: torch.Tensor,
                is_slur: torch.Tensor, note_durs: torch.Tensor | None = None,
                frames_per_sec: float = 86.13,
                draws: torch.Generator | torch.Tensor | None = None,
                noise_scale: float = 0.667,
                mel2ph: torch.Tensor | None = None) -> dict:
        """Score → dict(wav [B, F · hop], mel2ph [B, F]) on the
        ``max_frames`` canvas. ``mel2ph`` comes from ``note_durs`` (seconds
        a token: round(s · frames_per_sec) frames) or the duration head.
        ``draws``: the prior's noise [B, F, latent] or a generator
        (default: one seeded with 0)."""
        cfg = self.cfg
        m_p_ph, logs_p_ph, dur_log, nonpad = self.score_encoder(
            tokens, pitch_midi, is_slur)
        if mel2ph is None:
            if note_durs is not None:
                dur = torch.round(note_durs * frames_per_sec) * nonpad
            else:
                dur = torch.round(torch.exp(dur_log) - 1.0).clamp_min(0.0) \
                    * nonpad
            mel2ph = length_regulator(dur, cfg.max_frames)
        mask = (mel2ph > 0).float()
        m_p = FastSpeech2.expand_states(m_p_ph, mel2ph)
        logs_p = FastSpeech2.expand_states(logs_p_ph, mel2ph)
        if draws is None:
            draws = torch.Generator(tokens.device).manual_seed(0)
        if isinstance(draws, torch.Generator):
            draws = torch.randn(m_p.shape, generator=draws,
                                device=m_p.device)
        z_p = m_p + torch.exp(logs_p) * draws * noise_scale
        z = self.flow(z_p * mask[..., None], mask, reverse=True)
        wav = self.decoder((z * mask[..., None]).transpose(1, 2))
        return {"wav": wav, "mel2ph": mel2ph}
