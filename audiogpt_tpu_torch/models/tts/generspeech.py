"""GenerSpeech: style-transfer TTS for an out-of-domain reference voice.

Counterpart of ``audiogpt_tpu/models/tts/generspeech.py:50-520`` at
inference (the reference's ``GenerSpeech``,
``NeuralSeq/modules/GenerSpeech/model/generspeech.py:15``): a FastSpeech2
body whose duration, pitch and decoder inputs carry a global style (the
JAX package's GST-style reference encoder in place of the reference's
external speaker and emotion encoders) and a local style (three VQ-coded
reference-mel branches, each aligned to the frames by a cross-attention
``ProsodyAligner``), then a Glow post-flow that samples the mel
conditioned on [mel, decoder input] (``run_post_glow``,
generspeech.py:233).

At inference ``MixStyle`` is the identity (``x + cond``) and the VQ reads
its codebook only: the EMA update, the commitment and guided-attention
losses and the training branches wait for the training slice, with the
JAX config's ``vq_ema=False`` (a codebook parameter for its jitted
trainer). The codebook sits in the ``vq_stats`` collection of the JAX
tree, here the buffers ``embedding``, ``ema_weight`` and ``ema_count``.
Every attention passes a dense key-padding mask, so it takes the plain
path, as in JAX. The flax ``LayerNorm`` defaults to ε = 1e-6 and
``jax.nn.gelu`` to the tanh form; both are kept.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.models.tts.fastspeech2 import (
    ConvPredictor,
    FastSpeech2,
    FastSpeech2Config,
    FFTBlocks,
    SinusoidalPositions,
    conv_time,
    denorm_f0,
    f0_to_coarse,
    length_regulator,
)
from audiogpt_tpu_torch.ops.attention import attention

# ---------------------------------------------------------------------------
# Style modules
# ---------------------------------------------------------------------------


class VQEmbeddingEMA(nn.Module):
    """Nearest-code vector quantizer (``prosody_util.py:16``) at inference.
    The codebook and its EMA statistics are buffers (the JAX ``vq_stats``
    collection)."""

    def __init__(self, n_codes: int = 64, dim: int = 256):
        super().__init__()
        self.dim = dim
        init = torch.randn(n_codes, dim) * 0.1
        self.register_buffer("embedding", init)
        self.register_buffer("ema_weight", init.clone())
        self.register_buffer("ema_count", torch.ones(n_codes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, D] → the nearest code of each row [B, T, D], in the
        straight-through form ``x + (code − x)`` as JAX computes it."""
        e = self.embedding
        flat = x.reshape(-1, self.dim)
        d = ((flat ** 2).sum(1, keepdim=True) - 2 * flat @ e.T
             + (e ** 2).sum(1)[None])
        return x + (e[d.argmin(-1)].reshape(x.shape) - x)


class ConvStack(nn.Module):
    """Residual conv encoder over the reference mel
    (``ConvBlocks(80, hidden, [1]*5, 5)``, ``prosody_util.py:175``): Dense
    in, then LN → Conv1d(k, SAME) → tanh-GELU residual blocks, on
    x [B, T, C]. ``names`` are the parameter names of the input Dense and
    of block ``i``'s LN and conv, as the model's JAX tree has them
    (Audio2Motion's stacks are ``("in_proj", "ln_{}", "conv_{}")``)."""

    def __init__(self, in_dim: int, hidden: int, layers: int = 5,
                 kernel: int = 5,
                 names: tuple[str, str, str] = ("inp", "ln{}", "conv{}")):
        super().__init__()
        self.layers = layers
        self.names = names
        self.add_module(names[0], nn.Linear(in_dim, hidden))
        for i in range(layers):
            self.add_module(names[1].format(i),
                            nn.LayerNorm(hidden, eps=1e-6))
            self.add_module(names[2].format(i),
                            nn.Conv1d(hidden, hidden, kernel, padding="same"))

    def forward(self, mel: torch.Tensor,
                nonpad: torch.Tensor | None = None) -> torch.Tensor:
        inp, ln, conv = self.names
        x = getattr(self, inp)(mel)
        for i in range(self.layers):
            h = conv_time(getattr(self, conv.format(i)),
                          getattr(self, ln.format(i))(x))
            x = x + F.gelu(h, approximate="tanh")
            if nonpad is not None:
                x = x * nonpad[..., None]
        return x


class LocalStyleAdaptor(nn.Module):
    """Reference mel → VQ-coded local style [B, T_ref, hidden]
    (``prosody_util.py:172``)."""

    def __init__(self, in_dim: int, hidden: int, n_codes: int = 64):
        super().__init__()
        self.encoder = ConvStack(in_dim, hidden)
        self.vq = VQEmbeddingEMA(n_codes, hidden)

    def forward(self, ref_mel, ref_nonpad=None):
        return self.vq(self.encoder(ref_mel, ref_nonpad))


class ProsodyAligner(nn.Module):
    """Text ← style cross-attention (``prosody_util.py:129``): 2 post-LN
    layers of 2 heads over the style's valid frames."""

    def __init__(self, hidden: int, num_layers: int = 2, heads: int = 2):
        super().__init__()
        self.num_layers, self.heads = num_layers, heads
        for li in range(num_layers):
            for n in ("q", "k", "v", "o"):
                self.add_module(f"{n}{li}", nn.Linear(hidden, hidden))
            self.add_module(f"ln1_{li}", nn.LayerNorm(hidden, eps=1e-6))
            self.add_module(f"ff1_{li}", nn.Linear(hidden, 4 * hidden))
            self.add_module(f"ff2_{li}", nn.Linear(4 * hidden, hidden))
            self.add_module(f"ln2_{li}", nn.LayerNorm(hidden, eps=1e-6))

    def forward(self, text_h: torch.Tensor, style_h: torch.Tensor,
                style_nonpad: torch.Tensor) -> torch.Tensor:
        x = text_h
        mask = style_nonpad[:, None, None, :] > 0

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, -1)

        for li in range(self.num_layers):
            layer = lambda n: getattr(self, f"{n}{li}")  # noqa: E731
            out = attention(split(layer("q")(x)), split(layer("k")(style_h)),
                            split(layer("v")(style_h)), mask=mask)
            x = layer("ln1_")(x + layer("o")(out.reshape(x.shape)))
            h = torch.relu(layer("ff1_")(x))
            x = layer("ln2_")(x + layer("ff2_")(h))
        return x


def _same_pad_2d(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """lax's SAME padding of a strided conv on x [B, C, H, W]: the total
    ``max((ceil(n/s) − 1)·s + k − n, 0)`` per axis, the extra one after
    (an even axis pads (0, 1), not torch's symmetric (1, 1))."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class GlobalStyleEncoder(nn.Module):
    """Reference mel → (spk_embed, emo_embed): four stride-2 3×3 convs with
    a LayerNorm over channels, the frames' mean (unmasked, as in JAX),
    and two heads (the JAX package's substitute for the reference's
    external encoders)."""

    CHANNELS = (32, 32, 64, 64)

    def __init__(self, n_mels: int, emb_dim: int = 256):
        super().__init__()
        cin, m = 1, n_mels
        for i, ch in enumerate(self.CHANNELS):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 3, stride=2))
            self.add_module(f"ln{i}", nn.LayerNorm(ch, eps=1e-6))
            cin, m = ch, -(-m // 2)
        self.proj = nn.Linear(m * cin, 256)
        self.spk_head = nn.Linear(256, emb_dim)
        self.emo_head = nn.Linear(256, emb_dim)

    def forward(self, ref_mel: torch.Tensor):
        x = ref_mel[:, None]                                 # [B, 1, T, M]
        for i in range(len(self.CHANNELS)):
            x = getattr(self, f"conv{i}")(_same_pad_2d(x))
            x = torch.relu(getattr(self, f"ln{i}")(x.permute(0, 2, 3, 1))
                           ).permute(0, 3, 1, 2)
        b, c, t, m = x.shape
        # flax's [B, T, M, C] flattened with C fastest
        x = x.permute(0, 2, 3, 1).reshape(b, t, m * c).mean(1)
        h = torch.tanh(self.proj(x))
        return self.spk_head(h), self.emo_head(h)


# ---------------------------------------------------------------------------
# Glow post-flow
# ---------------------------------------------------------------------------


class WNCoupling(nn.Module):
    """WaveNet affine coupling conditioned on ``g`` (glow_modules.py WN):
    xa [B, T, C/2], g [B, T, G] → (log_s, t). ``end`` is
    zero-initialised, as in JAX."""

    def __init__(self, channels: int, cond_dim: int, hidden: int,
                 layers: int, kernel: int = 3):
        super().__init__()
        self.hidden, self.layers = hidden, layers
        self.start = nn.Linear(channels // 2, hidden)
        self.cond = nn.Linear(cond_dim, 2 * hidden * layers)
        for i in range(layers):
            d = 2 ** i
            self.add_module(f"in{i}", nn.Conv1d(
                hidden, 2 * hidden, kernel, dilation=d,
                padding=d * (kernel - 1) // 2))
            self.add_module(f"rs{i}", nn.Linear(hidden, 2 * hidden))
        self.end = nn.Linear(hidden, channels)
        nn.init.zeros_(self.end.weight)
        nn.init.zeros_(self.end.bias)

    def forward(self, xa: torch.Tensor, g: torch.Tensor):
        h_ = self.hidden
        x = self.start(xa)
        cond = self.cond(g)
        skip = 0.0
        for i in range(self.layers):
            h = conv_time(getattr(self, f"in{i}"), x) \
                + cond[..., 2 * h_ * i: 2 * h_ * (i + 1)]
            acts = torch.tanh(h[..., :h_]) * torch.sigmoid(h[..., h_:])
            res_skip = getattr(self, f"rs{i}")(acts)
            x = x + res_skip[..., :h_]
            skip = skip + res_skip[..., h_:]
        log_s, t = self.end(skip).chunk(2, -1)
        return log_s, t


class GlowStep(nn.Module):
    """ActNorm → invertible 1×1 → affine coupling. ``reverse`` applies the
    inverse of ``inv1x1_w``, computed once per weight (a load or any
    in-place write bumps the parameter's version)."""

    def __init__(self, channels: int, cond_dim: int, hidden: int,
                 wn_layers: int):
        super().__init__()
        self.actnorm_logs = nn.Parameter(torch.zeros(channels))
        self.actnorm_bias = nn.Parameter(torch.zeros(channels))
        w = np.linalg.qr(np.random.default_rng(0).normal(
            size=(channels, channels)))[0]
        self.inv1x1_w = nn.Parameter(torch.tensor(w, dtype=torch.float32))
        self.wn = WNCoupling(channels, cond_dim, hidden, wn_layers)
        self._inv: tuple | None = None

    def inverse_w(self) -> torch.Tensor:
        w = self.inv1x1_w
        key = (w._version, w.data_ptr())
        if self._inv is None or self._inv[0] != key:
            with torch.no_grad(), torch.inference_mode(False):
                self._inv = (key, torch.linalg.inv(w))
        return self._inv[1]

    def forward(self, x: torch.Tensor, g: torch.Tensor, mask: torch.Tensor):
        """x [B, T, C] → (z, logdet)."""
        m = mask[..., None]
        x = (x * torch.exp(self.actnorm_logs) + self.actnorm_bias) * m
        logdet = self.actnorm_logs.sum() * mask.sum()
        x = x @ self.inv1x1_w
        logdet = logdet + torch.linalg.slogdet(self.inv1x1_w)[1] * mask.sum()
        xa, xb = x.chunk(2, -1)
        log_s, t = self.wn(xa, g)
        xb = (xb * torch.exp(log_s) + t) * m
        logdet = logdet + (log_s * m).sum()
        return torch.cat([xa, xb], -1) * m, logdet

    def reverse(self, z: torch.Tensor, g: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        za, zb = z.chunk(2, -1)
        log_s, t = self.wn(za, g)
        z = torch.cat([za, (zb - t) * torch.exp(-log_s)], -1)
        z = z @ self.inverse_w()
        return (z - self.actnorm_bias) * torch.exp(-self.actnorm_logs) \
            * mask[..., None]


class Glow(nn.Module):
    """Squeeze-2 Glow over mel frames (glow_modules.py Glow, n_sqz = 2)."""

    def __init__(self, in_channels: int = 80, cond_dim: int = 336,
                 hidden: int = 128, n_steps: int = 4, wn_layers: int = 3):
        super().__init__()
        self.in_channels, self.n_steps = in_channels, n_steps
        for i in range(n_steps):
            self.add_module(f"step{i}", GlowStep(2 * in_channels,
                                                 2 * cond_dim, hidden,
                                                 wn_layers))

    @staticmethod
    def squeeze(x: torch.Tensor, mask: torch.Tensor):
        """[B, T, C] → [B, T/2, 2C]; a pair's mask is the smaller of the
        two (an odd last frame is dropped)."""
        b, t, c = x.shape
        t2 = (t // 2) * 2
        x = x[:, :t2].reshape(b, t2 // 2, 2 * c)
        return x, mask[:, :t2].reshape(b, t2 // 2, 2).amin(-1)

    @staticmethod
    def unsqueeze(x: torch.Tensor, t_out: int) -> torch.Tensor:
        b, t, c2 = x.shape
        x = x.reshape(b, 2 * t, c2 // 2)
        return F.pad(x, (0, 0, 0, max(0, t_out - 2 * t)))[:, :t_out]

    def forward(self, mel, cond, mask):
        """→ (z, nll per element): the training objective."""
        x, m = self.squeeze(mel, mask)
        g, _ = self.squeeze(cond, mask)
        logdet = 0.0
        for i in range(self.n_steps):
            x, ld = getattr(self, f"step{i}")(x, g, m)
            logdet = logdet + ld
        n_elem = (m.sum() * x.shape[-1]).clamp_min(1.0)
        nll = (0.5 * x ** 2 * m[..., None]).sum() / n_elem \
            + 0.5 * math.log(2 * math.pi) - logdet / n_elem
        return x, nll

    def reverse(self, cond: torch.Tensor, mask: torch.Tensor,
                draws: torch.Generator | torch.Tensor,
                temperature: float = 0.8) -> torch.Tensor:
        """cond [B, T, G] → mel [B, T, C] from z · ``temperature`` on the
        squeezed mask; ``draws`` is z [B, T/2, 2C] or a generator."""
        g, m = self.squeeze(cond, mask)
        shape = (g.shape[0], g.shape[1], 2 * self.in_channels)
        if isinstance(draws, torch.Generator):
            draws = torch.randn(shape, generator=draws, device=g.device)
        x = draws * temperature * m[..., None]
        for i in reversed(range(self.n_steps)):
            x = getattr(self, f"step{i}").reverse(x, g, m)
        return self.unsqueeze(x, mask.shape[1])


# ---------------------------------------------------------------------------
# GenerSpeech
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GenerSpeechConfig:
    fs2: FastSpeech2Config = FastSpeech2Config(use_pitch_embed=True)
    n_vq: int = 64                  # hparams['nVQ']
    emb_dim: int = 256
    glow_hidden: int = 128
    glow_steps: int = 4
    glow_wn_layers: int = 3
    use_post_flow: bool = True


LEVELS = ("utter", "ph", "word")


class GenerSpeech(nn.Module):
    def __init__(self, cfg: GenerSpeechConfig):
        super().__init__()
        self.cfg = cfg
        fs = cfg.fs2
        d = fs.hidden_size
        self.embed_tokens = nn.Embedding(fs.vocab_size, d)
        self.enc_pos = SinusoidalPositions(d)
        self.encoder = FFTBlocks(d, fs.enc_layers, fs.num_heads,
                                 fs.enc_ffn_kernel_size, use_pos_embed=False)
        self.decoder = FFTBlocks(d, fs.dec_layers, fs.num_heads,
                                 fs.dec_ffn_kernel_size)
        self.mel_out = nn.Linear(d, fs.n_mels)
        self.dur_predictor = ConvPredictor(d, fs.pred_hidden,
                                           fs.dur_predictor_layers,
                                           fs.dur_predictor_kernel, 1)
        self.global_style = GlobalStyleEncoder(fs.n_mels, cfg.emb_dim)
        self.spk_embed_proj = nn.Linear(cfg.emb_dim, d)
        self.emo_embed_proj = nn.Linear(cfg.emb_dim, d)
        for level in LEVELS:
            self.add_module(f"style_{level}", LocalStyleAdaptor(
                fs.n_mels, d, cfg.n_vq))
            self.add_module(f"align_{level}", ProsodyAligner(d))
        self.pitch_embed = nn.Embedding(300, d)
        self.pitch_inpainter = ConvPredictor(d, d, 3, fs.predictor_kernel, 2,
                                             with_pos=True, pos_dim=d)
        if cfg.use_post_flow:
            self.post_flow = Glow(fs.n_mels, fs.n_mels + d, cfg.glow_hidden,
                                  cfg.glow_steps, cfg.glow_wn_layers)

    def style(self, ref_mel: torch.Tensor, ref_nonpad: torch.Tensor):
        """The reference's global style (spk, emo [B, 1, H]) and its three
        VQ-coded local style sequences."""
        spk_e, emo_e = self.global_style(ref_mel)
        local = [getattr(self, f"style_{level}")(ref_mel, ref_nonpad)
                 for level in LEVELS]
        return (self.spk_embed_proj(spk_e)[:, None],
                self.emo_embed_proj(emo_e)[:, None], local)

    def forward(self, tokens: torch.Tensor, ref_mel: torch.Tensor,
                ref_nonpad: torch.Tensor | None = None,
                mel2ph: torch.Tensor | None = None,
                f0: torch.Tensor | None = None, uv: torch.Tensor | None = None,
                draws: torch.Generator | torch.Tensor | None = None,
                infer_postflow: bool = True) -> dict:
        """tokens [B, T], reference mel [B, T_ref, M] (all-zero frames are
        padding) → dict of mel_out [B, F, M], mel2ph, dur, pitch_pred,
        f0_denorm, decoder_inp, and with the post-flow off ``postflow_nll``.
        ``draws``: the post-flow's z [B, F/2, 2M] or a generator (default:
        one seeded with 0)."""
        cfg = self.cfg.fs2
        ret = {}
        src_nonpad = (tokens > 0).float()
        if ref_nonpad is None:
            ref_nonpad = (ref_mel.abs().sum(-1) > 0).float()
        x = self.embed_tokens(tokens) * math.sqrt(cfg.hidden_size)
        encoder_out = self.encoder(x + self.enc_pos(src_nonpad), src_nonpad)
        spk, emo, local = self.style(ref_mel, ref_nonpad)

        dur_inp = (encoder_out + spk + emo) * src_nonpad[..., None]
        dur_log = self.dur_predictor(dur_inp, src_nonpad)[..., 0]
        ret["dur"] = dur_log
        if mel2ph is None:
            dur = torch.round(torch.exp(dur_log) - 1.0).clamp_min(0.0) \
                * src_nonpad
            mel2ph = length_regulator(dur, cfg.max_frames)
        ret["mel2ph"] = mel2ph
        tgt_nonpad = (mel2ph > 0).float()
        m = tgt_nonpad[..., None]

        # MixStyle at inference: the identity on x + cond
        decoder_inp = FastSpeech2.expand_states(encoder_out, mel2ph) \
            + (spk + emo)
        prosody = sum(getattr(self, f"align_{level}")(decoder_inp, quant,
                                                      ref_nonpad)
                      for level, quant in zip(LEVELS, local))

        pitch_inp = (decoder_inp + spk + emo + prosody) * m
        pitch_pred = self.pitch_inpainter(pitch_inp, nonpad=tgt_nonpad,
                                          pos_nonpad=tgt_nonpad)
        ret["pitch_pred"] = pitch_pred
        if f0 is None:
            f0 = pitch_pred[..., 0]
            uv = (pitch_pred[..., 1] > 0).float()
        f0_denorm = denorm_f0(f0, uv, cfg, pitch_padding=mel2ph == 0)
        ret["f0_denorm"] = f0_denorm
        decoder_inp = decoder_inp + self.pitch_embed(f0_to_coarse(f0_denorm))
        decoder_inp = (decoder_inp + spk + emo + prosody) * m
        ret["decoder_inp"] = decoder_inp
        mel = self.mel_out(self.decoder(decoder_inp, tgt_nonpad)) * m
        ret["mel_out"] = mel

        if self.cfg.use_post_flow:
            cond = torch.cat([mel, decoder_inp], -1)
            if infer_postflow:
                if draws is None:
                    draws = torch.Generator(tokens.device).manual_seed(0)
                ret["mel_out"] = self.post_flow.reverse(cond, tgt_nonpad,
                                                        draws) * m
            else:
                _, ret["postflow_nll"] = self.post_flow(mel, cond, tgt_nonpad)
        return ret
