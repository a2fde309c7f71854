"""PortaSpeech / SyntaSpeech: word-level VAE TTS with a flow-enhanced
prior, at inference and in training.

Counterpart of ``audiogpt_tpu/models/tts/portaspeech.py:55-539`` (the JAX
package's rebuild of the reference's missing ``modules.portaspeech``; the
wiring follows ``modules/syntaspeech/syntaspeech.py``): phone, word and
phone-to-word encoders (relative-window transformers, or with
``encoder_type="fft"`` FFT blocks) → word durations (a phone-level
conv stack summed per word; with ``use_graph`` the GGNN encoding of each
word is added first) → the length regulator on the ``max_frames`` canvas,
cut to a multiple of 4 frames → a word-to-mel attention in which a frame
sees only the phones of its own word → the prior: noise on the latent
grid (every 4th frame) through the reverse of the conditional coupling
flow (with ``use_graph`` its condition gains a GGNN over the frames'
words; ``use_prior_flow=False`` leaves the noise as it is) → the FVAE
decoder → mel [B, max_frames, 80]. With ``num_spk > 0`` a speaker
embedding (``num_spk + 1`` rows) is the style, added to the phone and
word encodings and to the decoder input; without ``text_encoder_postnet``
the attention's query is its own projection of the decoder input
(``dec_query_proj``) in place of the residual conv stack's output.

Training (:meth:`PortaSpeech.train_forward`) takes the ground-truth
``mel2word`` and mel instead: the posterior encoder (``FVAEEncoder``)
gives (m, logs) on the latent grid, z = m + exp(logs)·ε, the prior flow
takes z forward to the prior's space (or leaves it, without
``use_prior_flow``) and the KL is taken there (the couplings are
volume-preserving: no log-determinant). flax binds the
posterior only when the training branch runs, so the inference tree has
no ``fvae_enc``: the model owns one only when built with
``posterior=True``, and :func:`inference_tree` drops it from a training
tree for the engine.

Word grouping and in-word positions are one-hot products, the GGNN a
dense per-edge-type adjacency product, as in JAX. The flax defaults are
kept: LayerNorm ε = 1e-6, the exact GELU of ``ResConvStack`` and
``CondCoupling``, and the SAME padding of the posterior's strided conv
(kernel 2s, stride s: 2 frames before and 2 after for s = 4).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.models.tts.fastspeech2 import (
    FFTBlocks,
    conv_time,
    length_regulator,
)
from audiogpt_tpu_torch.ops.conv import FlaxConvTranspose1d, pad_same
from audiogpt_tpu_torch.ops.rel_attention import RelTransformerEncoder
from audiogpt_tpu_torch.parallel.reduce import global_sums


@dataclasses.dataclass(frozen=True)
class PortaSpeechConfig:
    ph_vocab_size: int = 100
    word_vocab_size: int = 100
    hidden_size: int = 192          # ps.yaml hidden_size
    enc_layers: int = 4
    word_enc_layers: int = 4
    num_heads: int = 2
    enc_ffn_kernel_size: int = 5
    #: 'rel_fft' = relative-window transformer; 'fft' = FFT blocks
    encoder_type: str = "rel_fft"
    rel_window: int = 4
    dur_predictor_layers: int = 3
    dur_predictor_kernel: int = 5
    n_mels: int = 80
    max_frames: int = 1024          # static mel canvas (multiple of strides)
    frames_multiple: int = 4
    # FVAE
    latent_size: int = 16
    fvae_hidden: int = 192
    fvae_kernel: int = 5
    fvae_enc_layers: int = 8       # the posterior's (training only)
    fvae_dec_layers: int = 4
    fvae_strides: int = 4
    # prior flow
    use_prior_flow: bool = True
    prior_flow_hidden: int = 64
    prior_flow_kernel: int = 3
    prior_flow_blocks: int = 4
    # SyntaSpeech extension
    use_graph: bool = False
    graph_steps: int = 5
    n_edge_types: int = 6
    num_spk: int = 0
    text_encoder_postnet: bool = True


# ---------------------------------------------------------------------------
# word-level helpers (one-hot products)
# ---------------------------------------------------------------------------


def word_onehot(x2word: torch.Tensor, max_words: int) -> torch.Tensor:
    """membership [B, W, T]: 1 where token t belongs to word w (1-based)."""
    words = torch.arange(1, max_words + 1, device=x2word.device)
    return (x2word[:, None, :] == words[None, :, None]).float()


def group_hidden_by_words(h: torch.Tensor, x2word: torch.Tensor,
                          max_words: int) -> torch.Tensor:
    """Mean-pool token states into word states [B, W, H]."""
    onehot = word_onehot(x2word, max_words)              # [B, W, T]
    cnt = onehot.sum(-1, keepdim=True).clamp_min(1.0)
    return (onehot @ h) / cnt


def expand_word_states(h_word: torch.Tensor,
                       x2word: torch.Tensor) -> torch.Tensor:
    """Gather word states to token or frame positions; index 0 → zeros."""
    h = F.pad(h_word, (0, 0, 1, 0))
    return torch.gather(h, 1, x2word[..., None].expand(-1, -1, h.shape[-1]))


def in_word_position(x2word: torch.Tensor, max_words: int) -> torch.Tensor:
    """Fractional position of each token inside its word, in (0, 1];
    padding (word 0) → 0."""
    member = word_onehot(x2word, max_words)              # [B, W, T]
    cum = torch.cumsum(member, -1) * member
    frac = cum / member.sum(-1, keepdim=True).clamp_min(1.0)
    return frac.sum(1)                                   # [B, T]


def clip_mel2word_to_multiple(mel2word: torch.Tensor,
                              multiple: int) -> torch.Tensor:
    """Cut the utterance to a frame count divisible by ``multiple`` on the
    static canvas."""
    n = (mel2word > 0).sum(1)
    frames = torch.arange(mel2word.shape[1], device=mel2word.device)
    return mel2word * (frames[None, :] < ((n // multiple) * multiple)[:, None])


def mel2word_to_dur(mel2word: torch.Tensor, max_words: int) -> torch.Tensor:
    """Frames per word [B, W]."""
    return word_onehot(mel2word, max_words).sum(-1)


class ContinuousSinPos(nn.Module):
    """Sinusoidal embedding of real-valued positions: [sin | cos] over a
    log-spaced bank of ``dim // 2`` frequencies."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freq = torch.exp(torch.arange(half, device=x.device)
                         * -(math.log(10000.0) / (half - 1)))
        ang = x[..., None] * freq
        return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# ---------------------------------------------------------------------------
# syntactic graph encoder (dense GGNN)
# ---------------------------------------------------------------------------


class GRUUpdate(nn.Module):
    """The GGNN's GRU cell: r before z, the state's denses without bias."""

    def __init__(self, hidden: int):
        super().__init__()
        self.x_rz = nn.Linear(hidden, 2 * hidden)
        self.h_rz = nn.Linear(hidden, 2 * hidden, bias=False)
        self.x_n = nn.Linear(hidden, hidden)
        self.h_n = nn.Linear(hidden, hidden, bias=False)

    def forward(self, msg: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        r, z = torch.sigmoid(self.x_rz(msg) + self.h_rz(h)).chunk(2, -1)
        n = torch.tanh(self.x_n(msg) + r * self.h_n(h))
        return (1.0 - z) * n + z * h


class GatedGraphConv(nn.Module):
    """GGNN layer: per-edge-type linear messages over a dense adjacency and
    a GRU update, the weights shared across its ``steps``."""

    def __init__(self, hidden: int, steps: int = 5, n_etypes: int = 6):
        super().__init__()
        self.steps = steps
        self.etype_kernel = nn.Parameter(
            torch.randn(n_etypes, hidden, hidden) / math.sqrt(hidden))
        self.gru = GRUUpdate(hidden)

    def forward(self, h: torch.Tensor, adj: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """h [B, W, H]; adj [B, E, W, W] (adj[b, e, i, j]: edge j→i);
        mask [B, W, 1]."""
        for _ in range(self.steps):
            msg = torch.einsum("beij,bjh,ehk->bik", adj, h,
                               self.etype_kernel)
            h = self.gru(msg, h) * mask
        return h


class GraphAuxEnc(nn.Module):
    """Two stacked GGNN layers with skip connections over word states."""

    def __init__(self, hidden: int, steps: int = 5, n_etypes: int = 6):
        super().__init__()
        self.ggc1 = GatedGraphConv(hidden, steps, n_etypes)
        self.ggc2 = GatedGraphConv(hidden, steps, n_etypes)

    def forward(self, h_word: torch.Tensor, adj: torch.Tensor,
                word_mask: torch.Tensor) -> torch.Tensor:
        m = word_mask[..., None]
        h1 = self.ggc1(h_word * m, adj, m) + h_word * m
        h2 = self.ggc2(h1, adj, m)
        return (h1 + h2) * m


# ---------------------------------------------------------------------------
# FVAE and prior flow
# ---------------------------------------------------------------------------


class ResConvStack(nn.Module):
    """Residual LN → (+ dense of the condition) → conv → exact GELU
    blocks, masked after each."""

    def __init__(self, hidden: int, layers: int, kernel: int,
                 cond_dim: int = 0):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"ln{i}", nn.LayerNorm(hidden, eps=1e-6))
            if cond_dim:
                self.add_module(f"cond{i}", nn.Linear(cond_dim, hidden))
            self.add_module(f"conv{i}", nn.Conv1d(hidden, hidden, kernel,
                                                  padding="same"))

    def forward(self, x: torch.Tensor, cond: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        for i in range(self.layers):
            h = getattr(self, f"ln{i}")(x)
            if cond is not None:
                h = h + getattr(self, f"cond{i}")(cond)
            h = conv_time(getattr(self, f"conv{i}"), h)
            x = x + F.gelu(h)
            if mask is not None:
                x = x * mask
        return x


class FVAEEncoder(nn.Module):
    """The posterior: mel [B, F, n_mels] → (m, logs) [B, F/s, latent] by
    a strided SAME conv (kernel 2s, stride s), the conditioned conv stack
    and a zero-initialised projection (the posterior starts at N(0, I))."""

    def __init__(self, cfg: PortaSpeechConfig):
        super().__init__()
        s, h = cfg.fvae_strides, cfg.fvae_hidden
        self.stride = s
        self.down = nn.Conv1d(cfg.n_mels, h, 2 * s, stride=s)
        self.stack = ResConvStack(h, cfg.fvae_enc_layers, cfg.fvae_kernel,
                                  cond_dim=cfg.hidden_size)
        self.proj = nn.Linear(h, 2 * cfg.latent_size)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, mels, cond_lat, lat_mask):
        s = self.stride
        h = self.down(pad_same(mels.transpose(1, 2), 2 * s, s))
        h = self.stack(h.transpose(1, 2) * lat_mask, cond_lat, lat_mask)
        m, logs = (self.proj(h) * lat_mask).chunk(2, -1)
        return m, logs


class FVAEDecoder(nn.Module):
    """Latent [B, F/s, latent] → mel [B, F, n_mels]: dense, the
    conditioned conv stack, a SAME transposed conv up by the stride."""

    def __init__(self, cfg: PortaSpeechConfig):
        super().__init__()
        s, h = cfg.fvae_strides, cfg.fvae_hidden
        self.pre = nn.Linear(cfg.latent_size, h)
        self.stack = ResConvStack(h, cfg.fvae_dec_layers, cfg.fvae_kernel,
                                  cond_dim=cfg.hidden_size)
        self.up = FlaxConvTranspose1d(h, h, 2 * s, s)
        self.out = nn.Linear(h, cfg.n_mels)

    def forward(self, z, cond_lat, lat_mask, frame_mask) -> torch.Tensor:
        h = self.pre(z) * lat_mask
        h = self.stack(h, cond_lat, lat_mask)
        h = self.up(h.transpose(1, 2)).transpose(1, 2)
        h = h[:, :frame_mask.shape[1]] * frame_mask
        return self.out(h) * frame_mask


class CondCoupling(nn.Module):
    """Mean-only affine coupling over the latent, conditioned on the text
    (volume-preserving)."""

    def __init__(self, latent: int, hidden: int, kernel: int, cond_dim: int):
        super().__init__()
        half = latent // 2
        self.pre = nn.Linear(half, hidden)
        self.cond = nn.Linear(cond_dim, hidden)
        self.conv = nn.Conv1d(hidden, hidden, kernel, padding="same")
        self.post = nn.Linear(hidden, half)
        nn.init.zeros_(self.post.weight)

    def forward(self, x, cond, mask, reverse: bool = False) -> torch.Tensor:
        half = x.shape[-1] // 2
        xa, xb = x[..., :half], x[..., half:]
        h = (self.pre(xa) + self.cond(cond)) * mask
        h = F.gelu(conv_time(self.conv, h)) * mask
        m = self.post(h)
        xb = (xb - m) * mask if reverse else (xb + m) * mask
        return torch.cat([xa, xb], -1)


class PriorFlow(nn.Module):
    def __init__(self, cfg: PortaSpeechConfig):
        super().__init__()
        self.n = cfg.prior_flow_blocks
        for i in range(self.n):
            self.add_module(f"f{i}", CondCoupling(
                cfg.latent_size, cfg.prior_flow_hidden, cfg.prior_flow_kernel,
                cfg.hidden_size))

    def forward(self, z, cond, mask, reverse: bool = False) -> torch.Tensor:
        """z (posterior) → prior space; ``reverse``: prior noise → z for
        the decoder, each flip before its coupling, in reverse order."""
        if not reverse:
            for i in range(self.n):
                z = getattr(self, f"f{i}")(z, cond, mask).flip(-1)
        else:
            for i in reversed(range(self.n)):
                z = getattr(self, f"f{i}")(z.flip(-1), cond, mask,
                                           reverse=True)
        return z


# ---------------------------------------------------------------------------
# duration predictor (word-level, optionally graph-augmented)
# ---------------------------------------------------------------------------


class WordDurationPredictor(nn.Module):
    """Phone-level conv stack → softplus frames, summed per word; with
    ``use_graph`` the GGNN encoding of each word is added to its phones
    first."""

    def __init__(self, cfg: PortaSpeechConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        if cfg.use_graph:
            self.graph_enc = GraphAuxEnc(d, cfg.graph_steps, cfg.n_edge_types)
        for i in range(cfg.dur_predictor_layers):
            self.add_module(f"conv{i}", nn.Conv1d(
                d, d, cfg.dur_predictor_kernel, padding="same"))
            self.add_module(f"ln{i}", nn.LayerNorm(d, eps=1e-6))
        self.out = nn.Linear(d, 1)

    def forward(self, x, src_nonpad, ph2word, max_words,
                graph_adj=None) -> torch.Tensor:
        if self.cfg.use_graph and graph_adj is not None:
            word_mask = (word_onehot(ph2word, max_words).sum(-1) > 0).float()
            g = self.graph_enc(group_hidden_by_words(x, ph2word, max_words),
                               graph_adj, word_mask)
            x = x + expand_word_states(g, ph2word)
        h = x
        for i in range(self.cfg.dur_predictor_layers):
            h = F.relu(conv_time(getattr(self, f"conv{i}"), h))
            h = getattr(self, f"ln{i}")(h) * src_nonpad[..., None]
        ph_dur = F.softplus(self.out(h)[..., 0]) * src_nonpad
        return torch.einsum("bwt,bt->bw", word_onehot(ph2word, max_words),
                            ph_dur)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def inference_tree(tree: dict) -> dict:
    """A JAX PortaSpeech variable tree without the posterior encoder: a
    training tree drives the inference model (which owns no
    ``fvae_enc``)."""
    params = tree.get("params", tree)
    params = {k: v for k, v in params.items() if k != "fvae_enc"}
    return {**tree, "params": params} if "params" in tree else params


class PortaSpeech(nn.Module):
    """``posterior=True`` builds the posterior encoder (``fvae_enc``) for
    :meth:`train_forward`; inference needs none."""

    def __init__(self, cfg: PortaSpeechConfig, posterior: bool = False):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.ph_embed = nn.Embedding(cfg.ph_vocab_size, d)
        self.word_embed = nn.Embedding(cfg.word_vocab_size, d)

        def enc(layers, use_pos_embed=True):
            if cfg.encoder_type == "rel_fft":
                return RelTransformerEncoder(d, 4 * d, cfg.num_heads, layers,
                                             cfg.enc_ffn_kernel_size,
                                             cfg.rel_window)
            return FFTBlocks(d, layers, cfg.num_heads,
                             cfg.enc_ffn_kernel_size,
                             use_pos_embed=use_pos_embed)

        self.encoder = enc(cfg.enc_layers)
        self.word_encoder = enc(cfg.word_enc_layers)
        self.ph2word_encoder = enc(cfg.word_enc_layers, use_pos_embed=False)
        self.sin_pos = ContinuousSinPos(d)
        self.enc_pos_proj = nn.Linear(2 * d, d)
        self.dec_res_proj = nn.Linear(2 * d, d)
        if cfg.text_encoder_postnet:
            self.text_postnet = ResConvStack(d, 3, 5)
        else:
            self.dec_query_proj = nn.Linear(2 * d, d)
        self.attn_q = nn.Linear(d, d, bias=False)
        self.attn_k = nn.Linear(d, d, bias=False)
        self.attn_v = nn.Linear(d, d, bias=False)
        self.attn_o = nn.Linear(d, d, bias=False)
        self.word_pos_proj = nn.Linear(d, d)
        self.dur_predictor = WordDurationPredictor(cfg)
        if posterior:
            self.fvae_enc = FVAEEncoder(cfg)
        self.fvae_dec = FVAEDecoder(cfg)
        if cfg.use_prior_flow:
            self.prior_flow = PriorFlow(cfg)
        if cfg.use_graph:
            self.prior_graph_enc = GraphAuxEnc(d, cfg.graph_steps,
                                               cfg.n_edge_types)
            self.prior_graph_proj = nn.Linear(d, d)
            nn.init.zeros_(self.prior_graph_proj.weight)
        if cfg.num_spk > 0:
            self.spk_embed = nn.Embedding(cfg.num_spk + 1, d)

    def _attention(self, ph_kv, dec_q, word_mask_ft):
        """Word-to-mel attention: frame f attends to the phones of its own
        word only."""
        d = self.cfg.hidden_size
        scores = (self.attn_q(dec_q) @ self.attn_k(ph_kv).transpose(1, 2)) \
            / math.sqrt(d)
        w = torch.softmax(scores.masked_fill(word_mask_ft <= 0, -1e9), -1)
        return self.attn_o(w @ self.attn_v(ph_kv)), w

    def encode(self, txt_tokens, word_tokens, ph2word, graph_adj=None,
               mel2word=None, spk_id=None) -> dict:
        """The text side: the encoders, the word durations and the
        word-to-mel attention → the decoder input ``x`` [B, F, d], ``dur``,
        ``mel2word``, ``attn``. Without ``mel2word`` (training passes the
        ground truth) the durations lay the words on the canvas. With
        ``num_spk > 0``, ``spk_id`` [B] picks the speaker style (none: no
        style, as in JAX)."""
        cfg = self.cfg
        d = cfg.hidden_size
        max_words = word_tokens.shape[1]
        src_nonpad = (txt_tokens > 0).float()
        word_nonpad = (word_tokens > 0).float()
        style = 0.0
        if cfg.num_spk > 0 and spk_id is not None:
            style = self.spk_embed(spk_id)[:, None, :]

        ph_enc = self.encoder(self.ph_embed(txt_tokens) * math.sqrt(d),
                              src_nonpad) * src_nonpad[..., None] + style
        word_emb_enc = self.word_encoder(
            self.word_embed(word_tokens) * math.sqrt(d), word_nonpad)
        ph_enc = ph_enc + expand_word_states(word_emb_enc + style, ph2word)
        ph_enc = ph_enc * src_nonpad[..., None]
        h_gb_word = group_hidden_by_words(ph_enc, ph2word, max_words)
        word_enc = self.ph2word_encoder(h_gb_word, word_nonpad) + word_emb_enc

        dur = self.dur_predictor(ph_enc * src_nonpad[..., None], src_nonpad,
                                 ph2word, max_words, graph_adj)
        if mel2word is None:
            mel2word = clip_mel2word_to_multiple(
                length_regulator(dur, cfg.max_frames), cfg.frames_multiple)
        tgt_nonpad = (mel2word > 0).float()

        enc_pos = self.sin_pos(in_word_position(ph2word, max_words))
        dec_pos = self.sin_pos(in_word_position(mel2word, max_words))
        ph_kv = self.enc_pos_proj(torch.cat([ph_enc, enc_pos], -1))
        dec_inp_cat = torch.cat([expand_word_states(word_enc, mel2word),
                                 dec_pos], -1)
        if cfg.text_encoder_postnet:
            x_res = self.text_postnet(self.dec_res_proj(dec_inp_cat),
                                      mask=tgt_nonpad[..., None])
            dec_q = x_res
        else:
            dec_q = self.dec_query_proj(dec_inp_cat)
            x_res = self.dec_res_proj(dec_inp_cat)
        word_mask_ft = word_onehot(mel2word, max_words).transpose(1, 2) \
            @ word_onehot(ph2word, max_words)
        attn_out, attn = self._attention(ph_kv, dec_q, word_mask_ft)
        x = attn_out + x_res + self.word_pos_proj(dec_pos)
        x = (x + style) * tgt_nonpad[..., None]
        return {"x": x, "dur": dur, "mel2word": mel2word, "attn": attn}

    def prior_cond(self, x, mel2word, graph_adj):
        """The prior flow's condition on the latent grid and its mask
        [B, F/s, 1]: the decoder input every s-th frame, with
        ``use_graph`` plus the projected GGNN over the frames' words."""
        cfg = self.cfg
        s = cfg.fvae_strides
        lat_mask = (mel2word > 0).float()[:, ::s, None]
        cond = x[:, ::s]
        if cfg.use_graph and graph_adj is not None:
            max_words = graph_adj.shape[-1]
            g = self.prior_graph_enc(
                group_hidden_by_words(x, mel2word, max_words), graph_adj,
                (word_onehot(mel2word, max_words).sum(-1) > 0).float())
            cond = cond + self.prior_graph_proj(
                expand_word_states(g, mel2word)[:, ::s])
        return cond, lat_mask

    def prior(self, x, mel2word, graph_adj,
              draws: torch.Generator | torch.Tensor,
              noise_scale: float = 1.0) -> torch.Tensor:
        """The prior's latent [B, F/s, latent] for the decoder: noise
        (``draws`` [B, max_frames/s, latent] or a generator) · scale on
        the latent grid, through the flow's reverse (with
        ``use_prior_flow``)."""
        cfg = self.cfg
        cond, lat_mask = self.prior_cond(x, mel2word, graph_adj)
        shape = (x.shape[0], cfg.max_frames // cfg.fvae_strides,
                 cfg.latent_size)
        if isinstance(draws, torch.Generator):
            draws = torch.randn(shape, generator=draws, device=x.device)
        z = draws * noise_scale * lat_mask
        if not cfg.use_prior_flow:
            return z
        return self.prior_flow(z, cond, lat_mask, reverse=True)

    def posterior(self, x, mel2word, tgt_mels, graph_adj,
                  eps: torch.Tensor) -> dict:
        """The training latent: the posterior's (m, logs) on the target mel,
        ``z_q = (m + exp(logs)·eps)`` on the latent grid, the flow forward
        to ``z_p`` (``z_q`` itself without ``use_prior_flow``) and the
        KL(q ‖ p) per latent element over the grid."""
        cfg = self.cfg
        cond, lat_mask = self.prior_cond(x, mel2word, graph_adj)
        m_q, logs_q = self.fvae_enc(tgt_mels, x[:, ::cfg.fvae_strides],
                                    lat_mask)
        z_q = (m_q + torch.exp(logs_q) * eps) * lat_mask
        z_p = self.prior_flow(z_q, cond, lat_mask) if cfg.use_prior_flow \
            else z_q
        kl = -logs_q + 0.5 * (z_p ** 2 - eps ** 2)
        # over the global batch of a data-parallel run
        num, den = global_sums((kl * lat_mask).sum(), lat_mask.sum())
        return {"z_q": z_q, "z_p": z_p, "m_q": m_q, "logs_q": logs_q,
                "kl": num / (den * cfg.latent_size).clamp_min(1.0)}

    def eps_shape(self, batch: int, frames: int) -> tuple:
        """The posterior's draw for mels of ``frames`` frames."""
        s = self.cfg.fvae_strides
        return batch, -(-frames // s), self.cfg.latent_size

    def train_forward(self, txt_tokens, word_tokens, ph2word, mel2word,
                      tgt_mels, graph_adj=None,
                      draws: torch.Generator | torch.Tensor | None = None,
                      spk_id: torch.Tensor | None = None) -> dict:
        """The training branch (JAX ``infer=False``): ground-truth
        ``mel2word`` [B, F] and mel [B, F, n_mels]; ``draws`` is ε
        [B, ⌈F/s⌉, latent] or a generator (default: one seeded with 0).
        → ``mel_out``, ``kl``, ``dur``, ``mel2word``, ``attn``, ``m_q``,
        ``logs_q``, ``z_p``, ``decoder_inp``."""
        ret = self.encode(txt_tokens, word_tokens, ph2word, graph_adj,
                          mel2word=mel2word, spk_id=spk_id)
        x = ret["x"]
        if draws is None:
            draws = torch.Generator(x.device).manual_seed(0)
        if isinstance(draws, torch.Generator):
            draws = torch.randn(self.eps_shape(*mel2word.shape),
                                generator=draws, device=x.device)
        post = self.posterior(x, mel2word, tgt_mels, graph_adj, draws)
        return {"mel_out": self.decode(post["z_q"], x, mel2word),
                "kl": post["kl"], "dur": ret["dur"], "mel2word": mel2word,
                "attn": ret["attn"], "m_q": post["m_q"],
                "logs_q": post["logs_q"], "z_p": post["z_p"],
                "decoder_inp": x}

    def decode(self, z, x, mel2word) -> torch.Tensor:
        """The FVAE decoder on the latent, conditioned on the decoder input
        → mel [B, F, n_mels]."""
        s = self.cfg.fvae_strides
        tgt_nonpad = (mel2word > 0).float()
        return self.fvae_dec(z, x[:, ::s], tgt_nonpad[:, ::s, None],
                             tgt_nonpad[..., None])

    def forward(self, txt_tokens, word_tokens, ph2word, graph_adj=None,
                draws: torch.Generator | torch.Tensor | None = None,
                noise_scale: float = 1.0,
                spk_id: torch.Tensor | None = None) -> dict:
        """txt_tokens [B, T_ph], word_tokens [B, W], ph2word [B, T_ph]
        (1-based, 0 = pad); ``graph_adj`` [B, E, W, W] with ``use_graph``.
        → ``mel_out`` [B, max_frames, n_mels], ``dur`` [B, W] (frames),
        ``mel2word``, ``attn`` [B, F, T_ph], ``decoder_inp``."""
        ret = self.encode(txt_tokens, word_tokens, ph2word, graph_adj,
                          spk_id=spk_id)
        if draws is None:
            draws = torch.Generator(txt_tokens.device).manual_seed(0)
        z = self.prior(ret["x"], ret["mel2word"], graph_adj, draws,
                       noise_scale)
        return {"mel_out": self.decode(z, ret["x"], ret["mel2word"]),
                "dur": ret["dur"], "mel2word": ret["mel2word"],
                "attn": ret["attn"], "decoder_inp": ret["x"]}
