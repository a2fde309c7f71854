"""GenerSpeech: style-transfer TTS for an out-of-domain reference voice,
at inference and in training.

Counterpart of ``audiogpt_tpu/models/tts/generspeech.py:50-520`` (the
reference's ``GenerSpeech``,
``NeuralSeq/modules/GenerSpeech/model/generspeech.py:15``): a FastSpeech2
body whose duration, pitch and decoder inputs carry a global style (the
JAX package's GST-style reference encoder in place of the reference's
external speaker and emotion encoders) and a local style (three VQ-coded
reference-mel branches, each aligned to the frames by a cross-attention
``ProsodyAligner``), then a Glow post-flow that samples the mel
conditioned on [mel, decoder input] (``run_post_glow``,
generspeech.py:233).

At inference ``MixStyle`` is the identity (``x + cond``) and the VQ reads
its codebook only. With ``train=True`` the forward mixes the feature
statistics (``MixStyle``, its draws replayable), returns the VQ
commitment (with ``vq_ema=False`` the codebook loss too), the aligners'
guided-attention loss and the post-flow's NLL of the target mel. With
``vq_ema`` (the JAX default) the codebook sits in the ``vq_stats``
collection of the JAX tree, here the buffers ``embedding``,
``ema_weight`` and ``ema_count``, and the training branch updates them
in place by the EMA rule, as JAX's ``train=True`` does (the training
recipe builds ``vq_ema=False``: the codebook is a parameter).
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
from audiogpt_tpu_torch.ops.conv import pad_same
from audiogpt_tpu_torch.parallel.reduce import (gather_rows, global_mean,
                                                global_rows, global_sums,
                                                local_rows)

# ---------------------------------------------------------------------------
# Style modules
# ---------------------------------------------------------------------------


class VQEmbeddingEMA(nn.Module):
    """Nearest-code vector quantizer (``prosody_util.py:16``). With ``ema``
    the codebook and its EMA statistics are buffers (the JAX ``vq_stats``
    collection), which a training call updates; without, the codebook is a
    parameter that the codebook loss trains (JAX ``vq_ema=False``)."""

    #: the EMA's decay and the counts' Laplace smoothing (JAX's defaults)
    decay, epsilon = 0.999, 1e-5

    def __init__(self, n_codes: int = 64, dim: int = 256, ema: bool = True):
        super().__init__()
        self.n_codes, self.dim, self.ema = n_codes, dim, ema
        init = torch.randn(n_codes, dim) * 0.1
        if ema:
            self.register_buffer("embedding", init)
            self.register_buffer("ema_weight", init.clone())
            self.register_buffer("ema_count", torch.ones(n_codes))
        else:
            self.embedding = nn.Parameter(init)

    def forward(self, x: torch.Tensor, train: bool = False):
        """x [B, T, D] → (the straight-through code ``x + sg(code − x)``,
        whose gradient reaches x and not the codebook; the code itself).
        With ``ema`` and ``train`` the codebook then moves by the EMA rule
        (:meth:`ema_update`); the code returned is the one read before."""
        e = self.embedding
        flat = x.reshape(-1, self.dim)
        d = ((flat ** 2).sum(1, keepdim=True) - 2 * flat @ e.T
             + (e ** 2).sum(1)[None])
        idx = d.argmin(-1)
        quant = e[idx].reshape(x.shape)
        if self.ema and train:
            self.ema_update(flat, idx)
        return x + (quant - x).detach(), quant

    @torch.no_grad()
    def ema_update(self, flat: torch.Tensor, idx: torch.Tensor) -> None:
        """JAX's ``vq_stats`` update (``generspeech.py:92-102``): the
        counts and code sums of ``flat`` [N, D] by its codes ``idx`` [N]
        decay into ``ema_count`` and ``ema_weight``, and the codebook is
        their ratio with Laplace-smoothed counts."""
        onehot = F.one_hot(idx, self.n_codes).to(flat.dtype)
        n = onehot.sum(0)
        dw = onehot.T @ flat.detach()
        count = self.decay * self.ema_count + (1 - self.decay) * n
        weight = self.decay * self.ema_weight + (1 - self.decay) * dw
        tot = count.sum()
        stable = (count + self.epsilon) / (tot + self.n_codes
                                           * self.epsilon) * tot
        self.ema_count.copy_(count)
        self.ema_weight.copy_(weight)
        self.embedding.copy_(weight / stable[:, None])


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
    (``prosody_util.py:172``); :meth:`losses`, the training branch, adds
    its loss: the commitment ``mean((h − sg(code))²)``, plus without EMA
    the codebook loss ``mean((sg(h) − code)²)`` (VQ-VAE eq. 3); with EMA
    it moves the codebook instead."""

    def __init__(self, in_dim: int, hidden: int, n_codes: int = 64,
                 ema: bool = True):
        super().__init__()
        self.encoder = ConvStack(in_dim, hidden)
        self.vq = VQEmbeddingEMA(n_codes, hidden, ema)

    def forward(self, ref_mel, ref_nonpad=None) -> torch.Tensor:
        return self.vq(self.encoder(ref_mel, ref_nonpad))[0]

    def losses(self, ref_mel, ref_nonpad=None):
        """The training branch → (the coded style, its VQ loss)."""
        h = self.encoder(ref_mel, ref_nonpad)
        quant_st, quant = self.vq(h, train=True)
        commit = global_mean((h - quant.detach()) ** 2)
        if not self.vq.ema:
            commit = commit + global_mean((h.detach() - quant) ** 2)
        return quant_st, commit


class ProsodyAligner(nn.Module):
    """Text ← style cross-attention (``prosody_util.py:129``): 2 post-LN
    layers of 2 heads over the style's valid frames. In training
    (:meth:`forward_guided`, given the text's mask) each layer also
    scores its head-averaged attention against a near-diagonal prior
    (``_make_guided_attention_mask``, σ = 0.3): the guided-attention
    loss, summed over the layers."""

    GUIDED_SIGMA = 0.3

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

    def guided_weight(self, text_nonpad, style_nonpad) -> torch.Tensor:
        """1 − exp(−(t/T − s/S)² / 2σ²) [B, T_text, T_style]: small on the
        diagonal of each pair's valid lengths."""
        tl = text_nonpad.sum(-1, keepdim=True).clamp_min(1.0)[..., None]
        sl = style_nonpad.sum(-1, keepdim=True).clamp_min(1.0)[..., None]
        ti = torch.arange(text_nonpad.shape[1],
                          device=tl.device)[None, :, None]
        si = torch.arange(style_nonpad.shape[1],
                          device=tl.device)[None, None, :]
        return 1.0 - torch.exp(-(ti / tl - si / sl) ** 2
                               / (2 * self.GUIDED_SIGMA ** 2))

    def forward(self, text_h: torch.Tensor, style_h: torch.Tensor,
                style_nonpad: torch.Tensor) -> torch.Tensor:
        """→ the aligned style [B, T_text, H]."""
        return self._layers(text_h, style_h, style_nonpad)[0]

    def forward_guided(self, text_h, style_h, style_nonpad, text_nonpad):
        """The training branch → (the aligned style, the guided-attention
        loss)."""
        return self._layers(text_h, style_h, style_nonpad, text_nonpad)

    def _layers(self, text_h, style_h, style_nonpad, text_nonpad=None):
        x = text_h
        mask = style_nonpad[:, None, None, :] > 0
        heads = self.heads

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], heads, -1)

        guided = None
        if text_nonpad is not None:
            guided = 0.0
            w = self.guided_weight(text_nonpad, style_nonpad)
            pair = text_nonpad[:, :, None] * style_nonpad[:, None, :]
        for li in range(self.num_layers):
            layer = lambda n: getattr(self, f"{n}{li}")  # noqa: E731
            q, k = split(layer("q")(x)), split(layer("k")(style_h))
            out = attention(q, k, split(layer("v")(style_h)), mask=mask)
            if guided is not None:
                # the head-averaged logits of this layer's q and k
                logits = torch.einsum("bthd,bshd->bhts", q, k).mean(1) \
                    / math.sqrt(q.shape[-1])
                probs = torch.softmax(logits.masked_fill(
                    style_nonpad[:, None, :] <= 0, -1e30), -1)
                num, den = global_sums((probs * w * pair).sum(),
                                       pair.sum())
                guided = guided + num / den.clamp_min(1.0)
            x = layer("ln1_")(x + layer("o")(out.reshape(x.shape)))
            h = torch.relu(layer("ff1_")(x))
            x = layer("ln2_")(x + layer("ff2_")(h))
        return x, guided


class MixStyle(nn.Module):
    """Feature-statistics mixing (``mixstyle.py``): in training, each
    item's mean and std over time are mixed with those of a permuted item
    of the batch, by λ ~ Beta(α, α) per item (α = 0.1), for the whole
    batch or for none (one Bernoulli(0.5) draw); the identity on
    ``x + cond`` otherwise.
    The std is the population one, as ``jnp.var``'s.

    ``draws`` come from an explicit generator (:meth:`draws`) or are
    replayed. In a data-parallel run the permutation and λ are drawn for
    the global batch and cut to the rank's rows, and the permuted
    statistics are every rank's (``gather_rows``), as JAX's step mixes
    across the whole sharded batch. ``torch.distributions.Beta`` and
    ``torch._standard_gamma``
    take no generator, so λ is drawn by Jöhnk's method in the log domain:
    from uniforms u, v, log X = log(u)/α and log Y = log(v)/α; the pair is
    accepted when X + Y ≤ 1, and then λ = X / (X + Y) is Beta(α, α)
    distributed. Each λ takes the first accepted of ``TRIES`` pairs (at
    α = 0.1 a pair is accepted with probability 0.986, so all 8 fail with
    probability ≈ 1e-15; then the first pair is taken)."""

    P, ALPHA, EPS, TRIES = 0.5, 0.1, 1e-6, 8

    def draws(self, batch: int, generator: torch.Generator,
              device: torch.device) -> dict:
        """{"perm": [B] long, "lam": [B, 1, 1], "apply": bool scalar} for
        ``batch`` rows: the global batch's draws at this rank's rows
        (``perm`` indexes the global batch)."""
        rows = global_rows(batch)
        perm = torch.randperm(rows, generator=generator, device=device)
        u, v = (torch.rand((self.TRIES, rows), generator=generator,
                           device=device, dtype=torch.float64)
                for _ in "uv")
        lx, ly = torch.log(u) / self.ALPHA, torch.log(v) / self.ALPHA
        first = (torch.logaddexp(lx, ly) <= 0).to(torch.uint8).argmax(0)
        lam = torch.sigmoid(lx - ly).gather(0, first[None])[0]
        apply = torch.rand((), generator=generator, device=device) < self.P
        return {"perm": local_rows(perm),
                "lam": local_rows(lam.float())[:, None, None],
                "apply": apply}

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                draws: dict | None = None) -> torch.Tensor:
        x = x + cond
        if draws is None:
            return x
        mu = x.mean(1, keepdim=True)
        sig = torch.sqrt(x.var(1, keepdim=True, correction=0) + self.EPS)
        perm, lam = draws["perm"], draws["lam"]
        sig_all, mu_all = gather_rows(sig), gather_rows(mu)
        mixed = (x - mu) / sig * (lam * sig + (1 - lam) * sig_all[perm]) \
            + (lam * mu + (1 - lam) * mu_all[perm])
        return torch.where(draws["apply"], mixed, x)


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
            x = getattr(self, f"conv{i}")(pad_same(x, 3, 2, dims=2))
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
        # over the global batch of a data-parallel run: the log-dets are
        # sums over the rows too
        sq, count, logdet = global_sums((0.5 * x ** 2 * m[..., None]).sum(),
                                        m.sum(), logdet)
        n_elem = (count * x.shape[-1]).clamp_min(1.0)
        nll = sq / n_elem + 0.5 * math.log(2 * math.pi) - logdet / n_elem
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
    vq_ema: bool = True             # False → codebook-loss VQ (training)


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
        self.mixstyle = MixStyle()
        for level in LEVELS:
            self.add_module(f"style_{level}", LocalStyleAdaptor(
                fs.n_mels, d, cfg.n_vq, cfg.vq_ema))
            self.add_module(f"align_{level}", ProsodyAligner(d))
        self.pitch_embed = nn.Embedding(300, d)
        self.pitch_inpainter = ConvPredictor(d, d, 3, fs.predictor_kernel, 2,
                                             with_pos=True, pos_dim=d)
        if cfg.use_post_flow:
            self.post_flow = Glow(fs.n_mels, fs.n_mels + d, cfg.glow_hidden,
                                  cfg.glow_steps, cfg.glow_wn_layers)

    def style(self, ref_mel: torch.Tensor, ref_nonpad: torch.Tensor,
              train: bool = False):
        """The reference's global style (spk, emo [B, 1, H]) and its three
        VQ-coded local style sequences, each with its VQ loss in
        training (None at inference)."""
        spk_e, emo_e = self.global_style(ref_mel)
        local = [getattr(self, f"style_{level}").losses(ref_mel, ref_nonpad)
                 if train else
                 (getattr(self, f"style_{level}")(ref_mel, ref_nonpad), None)
                 for level in LEVELS]
        return (self.spk_embed_proj(spk_e)[:, None],
                self.emo_embed_proj(emo_e)[:, None], local)

    def forward(self, tokens: torch.Tensor, ref_mel: torch.Tensor,
                ref_nonpad: torch.Tensor | None = None,
                mel2ph: torch.Tensor | None = None,
                f0: torch.Tensor | None = None, uv: torch.Tensor | None = None,
                draws: torch.Generator | torch.Tensor | dict | None = None,
                infer_postflow: bool = True, train: bool = False) -> dict:
        """tokens [B, T], reference mel [B, T_ref, M] (all-zero frames are
        padding) → dict of mel_out [B, F, M], mel2ph, dur, pitch_pred,
        f0_denorm, decoder_inp, and with the post-flow off ``postflow_nll``.
        ``draws``: the post-flow's z [B, F/2, 2M] or a generator (default:
        one seeded with 0).

        ``train=True`` is the training branch (JAX ``train=True``): the
        reference is the target mel [B, F, M] with ``mel2ph`` [B, F];
        ``MixStyle`` mixes with ``draws`` (:meth:`MixStyle.draws`' dict,
        or a generator to draw it from; default: one seeded with 0), and
        the dict adds ``vq_commit``, ``guided_attn`` and ``postflow_nll``
        (the post-flow forward on the target mel)."""
        cfg = self.cfg.fs2
        ret = {}
        src_nonpad = (tokens > 0).float()
        if ref_nonpad is None:
            ref_nonpad = (ref_mel.abs().sum(-1) > 0).float()
        x = self.embed_tokens(tokens) * math.sqrt(cfg.hidden_size)
        encoder_out = self.encoder(x + self.enc_pos(src_nonpad), src_nonpad)
        spk, emo, local = self.style(ref_mel, ref_nonpad, train)

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

        mix = None
        if train:
            if draws is None:
                draws = torch.Generator(tokens.device).manual_seed(0)
            mix = draws if isinstance(draws, dict) else \
                self.mixstyle.draws(tokens.shape[0], draws, tokens.device)
        decoder_inp = self.mixstyle(
            FastSpeech2.expand_states(encoder_out, mel2ph), spk + emo, mix)
        prosody, guided = 0.0, 0.0
        for level, (quant, _) in zip(LEVELS, local):
            align = getattr(self, f"align_{level}")
            if train:
                aligned, g = align.forward_guided(decoder_inp, quant,
                                                  ref_nonpad, tgt_nonpad)
                guided = guided + g
            else:
                aligned = align(decoder_inp, quant, ref_nonpad)
            prosody = prosody + aligned
        if train:
            ret["vq_commit"] = sum(c for _, c in local)
            ret["guided_attn"] = guided

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
            if train:
                _, ret["postflow_nll"] = self.post_flow(
                    ref_mel[:, :mel.shape[1]], cond, tgt_nonpad)
            elif infer_postflow:
                if draws is None:
                    draws = torch.Generator(tokens.device).manual_seed(0)
                ret["mel_out"] = self.post_flow.reverse(cond, tgt_nonpad,
                                                        draws) * m
            else:
                _, ret["postflow_nll"] = self.post_flow(mel, cond, tgt_nonpad)
        return ret
