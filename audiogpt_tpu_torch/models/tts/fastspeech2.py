"""FastSpeech2 (non-autoregressive TTS): tokens → mel on a static canvas.

Counterpart of ``audiogpt_tpu/models/tts/fastspeech2.py:35-421`` (the
reference's ``FastSpeech2``, ``NeuralSeq/modules/fastspeech/fs2.py:22``):
an FFT encoder (pre-LN bias-free MHA, pre-LN conv-FFN), the duration
predictor and a length regulator onto a fixed ``max_frames`` canvas, the
pitch predictor (``frame``: f0 and uv per frame; ``cwt``: a 10-scale
wavelet spectrum and uv per frame with the utterance's log-f0 mean and std,
``dsp/f0.py`` ``cwt2f0``) and its embedding, optional energy and speaker
embeddings, the FFT decoder and the mel projection. DiffSinger's encoder
options (``svs/diffsinger.py:45``): ``use_midi`` adds MIDI-pitch,
note-duration and slur embeddings to the token embedding, and ``rel_pos``
takes ESPnet's reversed positional table in place of fairseq's.

Tensors are token- or frame-major, ``[B, T, C]``, as in the JAX package;
the convs run on a transposed view. Submodules carry the flax scope names
(``embed_tokens``, ``encoder.layer_0.attn.in_proj``, ``ffn_conv``,
``dur_predictor.conv_0``, ``pitch_predictor``, ``pitch_embed``,
``mel_out``, the ``pos_alpha`` parameters): each flax ``nn.Conv`` is a bare
``torch.nn.Conv1d``, so ``utils/jax_params.py`` maps the tree unchanged.
The attention passes a dense key-padding ``mask=``, so ``ops/attention.py``
takes its plain path and the flash kernel never runs here, as in JAX.

The forward is also the training forward (``train/tasks/fs2.py``): given
the ground-truth ``mel2ph``, f0 and uv it predicts no alignment or pitch.
The config leaves out the JAX field ``dropout``, which no JAX layer reads:
neither package drops out in training.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.dsp.f0 import cwt2f0
from audiogpt_tpu_torch.ops.attention import attention

# f0 constants (NeuralSeq/utils/pitch_utils.py:14-19)
F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
F0_MEL_MIN = 1127.0 * math.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * math.log(1.0 + F0_MAX / 700.0)


@dataclasses.dataclass(frozen=True)
class FastSpeech2Config:
    vocab_size: int = 100
    hidden_size: int = 256
    enc_layers: int = 4
    dec_layers: int = 4
    num_heads: int = 2
    enc_ffn_kernel_size: int = 9
    dec_ffn_kernel_size: int = 9
    n_mels: int = 80
    dur_predictor_layers: int = 2
    dur_predictor_kernel: int = 3
    predictor_layers: int = 5
    predictor_kernel: int = 5
    predictor_hidden: int = -1     # -1 → hidden_size
    use_pitch_embed: bool = True
    use_energy_embed: bool = False
    use_uv: bool = True
    pitch_type: str = "frame"      # 'frame' | 'cwt' (fs2.py:191)
    cwt_std_scale: float = 0.8     # hparams['cwt_std_scale']
    pitch_norm: str = "standard"   # 'standard' | 'log'
    f0_mean: float = 200.0
    f0_std: float = 60.0
    num_spk: int = 0               # >0 → speaker-id embedding
    max_frames: int = 2048         # static mel canvas
    use_midi: bool = False         # DiffSinger: midi/slur embeddings
    rel_pos: bool = False          # ESPnet-style reversed PE (ds1000 rel_pos)
    # Mask predictor activations at padded frames between conv layers (the
    # JAX package's fix); False = the reference's behaviour, where conv bias
    # values leak from padding into valid tail frames.
    predictor_mask_pad: bool = True

    @property
    def pred_hidden(self) -> int:
        return self.predictor_hidden if self.predictor_hidden > 0 \
            else self.hidden_size


# ---------------------------------------------------------------------------
# f0 utilities (pitch_utils.py)
# ---------------------------------------------------------------------------


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """Hz → coarse bin in [1, 255]; 0 Hz (unvoiced/pad) → bin 1.
    ``torch.round`` rounds half to even, as ``jnp.rint``."""
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - F0_MEL_MIN) * (F0_BIN - 2) \
        / (F0_MEL_MAX - F0_MEL_MIN) + 1.0
    scaled = torch.where(f0_mel > 0, scaled, f0_mel)
    return torch.round(scaled.clamp(1.0, F0_BIN - 1)).long()


def norm_f0(f0, uv, cfg: FastSpeech2Config):
    if cfg.pitch_norm == "standard":
        f0 = (f0 - cfg.f0_mean) / cfg.f0_std
    elif cfg.pitch_norm == "log":
        f0 = torch.log2(f0.clamp_min(1e-5))
    if uv is not None and cfg.use_uv:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    return f0


def denorm_f0(f0, uv, cfg: FastSpeech2Config, pitch_padding=None):
    if cfg.pitch_norm == "standard":
        f0 = f0 * cfg.f0_std + cfg.f0_mean
    elif cfg.pitch_norm == "log":
        f0 = 2.0 ** f0
    if uv is not None and cfg.use_uv:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    if pitch_padding is not None:
        f0 = torch.where(pitch_padding, torch.zeros_like(f0), f0)
    return f0


def length_regulator(dur: torch.Tensor, max_frames: int,
                     alpha: float = 1.0) -> torch.Tensor:
    """Durations [B, T_txt] (pad rows 0) → mel2ph [B, max_frames] (long).

    Frame f belongs to token i (1-based) iff cumsum[i-1] <= f < cumsum[i];
    frames past the total are 0 (padding), and durations past the canvas
    are cut, as in the JAX package."""
    dur = torch.round(dur.float() * alpha).long()
    csum = dur.cumsum(1)                                     # [B, T]
    csum_prev = csum - dur
    pos = torch.arange(max_frames, device=dur.device)[None, None, :]
    tok = torch.arange(1, dur.shape[1] + 1, device=dur.device)[None, :, None]
    mask = (pos >= csum_prev[:, :, None]) & (pos < csum[:, :, None])
    return (tok * mask).sum(1)                               # [B, F]


def sinusoid_table(n_pos: int, dim: int) -> np.ndarray:
    """fairseq-style table (common_layers.py:104): [sin | cos] halves."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64)
                  * -(math.log(10000.0) / (half - 1)))
    ang = np.arange(n_pos, dtype=np.float64)[:, None] * freq[None, :]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        emb = np.concatenate([emb, np.zeros((n_pos, 1))], axis=1)
    return emb.astype(np.float32)


class SinusoidalPositions(nn.Module):
    """fairseq positions of the non-pad items: pad → ``padding_idx`` (a
    zero row), else ``padding_idx`` + the running count. No parameters:
    the table is a buffer left out of the state dict."""

    def __init__(self, dim: int, max_pos: int = 4096, padding_idx: int = 0):
        super().__init__()
        table = torch.from_numpy(sinusoid_table(max_pos + 1 + padding_idx,
                                                dim))
        table[padding_idx] = 0.0
        self.padding_idx = padding_idx
        self.register_buffer("table", table, persistent=False)

    def forward(self, nonpad: torch.Tensor) -> torch.Tensor:
        pos = (nonpad.cumsum(1) * nonpad + self.padding_idx).long()
        return self.table[pos]


# ---------------------------------------------------------------------------
# FFT blocks
# ---------------------------------------------------------------------------


def conv_time(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A conv over time on x [B, T, C]."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class BiasFreeMHA(nn.Module):
    """fairseq MultiheadAttention(bias=False) as used by EncSALayer."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj = nn.Linear(dim, 3 * dim, bias=False)
        self.out_proj = nn.Linear(dim, dim, bias=False)

    def forward(self, x: torch.Tensor, nonpad: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        q, k, v = (u.reshape(b, t, self.heads, d // self.heads)
                   for u in self.in_proj(x).chunk(3, dim=-1))
        mask = nonpad[:, None, None, :] > 0        # key padding, dense
        out = attention(q, k, v, mask=mask)
        return self.out_proj(out.reshape(b, t, d))


class FFTBlock(nn.Module):
    """EncSALayer: pre-LN self-attn + pre-LN conv-FFN, masked after each."""

    def __init__(self, dim: int, heads: int, ffn_kernel: int):
        super().__init__()
        self.ffn_kernel = ffn_kernel
        self.ln1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = BiasFreeMHA(dim, heads)
        self.ln2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn_conv = nn.Conv1d(dim, 4 * dim, ffn_kernel, padding="same")
        self.ffn_out = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, nonpad: torch.Tensor) -> torch.Tensor:
        m = nonpad[..., None]
        x = (x + self.attn(self.ln1(x), nonpad)) * m
        h = conv_time(self.ffn_conv, self.ln2(x)) * self.ffn_kernel ** -0.5
        h = self.ffn_out(F.gelu(h))                 # exact gelu
        return (x + h) * m


class FFTBlocks(nn.Module):
    def __init__(self, dim: int, layers: int, heads: int, ffn_kernel: int,
                 use_pos_embed: bool = True, use_last_norm: bool = True):
        super().__init__()
        self.n_layers = layers
        if use_pos_embed:
            self.pos_alpha = nn.Parameter(torch.ones(1))
            self.pos = SinusoidalPositions(dim)
        else:
            self.pos_alpha = None
        for i in range(layers):
            self.add_module(f"layer_{i}", FFTBlock(dim, heads, ffn_kernel))
        self.ln = nn.LayerNorm(dim, eps=1e-5) if use_last_norm else None

    def forward(self, x: torch.Tensor, nonpad: torch.Tensor) -> torch.Tensor:
        m = nonpad[..., None]
        if self.pos_alpha is not None:
            x = x + self.pos_alpha * self.pos(nonpad)
        x = x * m
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, nonpad)
        if self.ln is not None:
            x = self.ln(x) * m
        return x


class ConvPredictor(nn.Module):
    """Shared conv stack of the duration/pitch/energy predictors:
    n×(conv → relu → LayerNorm over channels) → linear, on x [B, T, C]."""

    def __init__(self, in_dim: int, hidden: int, layers: int, kernel: int,
                 odim: int, with_pos: bool = False, pos_dim: int = 0):
        super().__init__()
        self.n_layers = layers
        if with_pos:
            self.pos_alpha = nn.Parameter(torch.ones(1))
            self.pos = SinusoidalPositions(pos_dim or in_dim)
        else:
            self.pos_alpha = None
        for i in range(layers):
            cin = in_dim if i == 0 else hidden
            self.add_module(f"conv_{i}", nn.Conv1d(cin, hidden, kernel,
                                                   padding="same"))
            self.add_module(f"ln_{i}", nn.LayerNorm(hidden, eps=1e-5))
        self.out = nn.Linear(hidden, odim)

    def forward(self, x: torch.Tensor, nonpad: torch.Tensor | None = None,
                pos_nonpad: torch.Tensor | None = None) -> torch.Tensor:
        if self.pos_alpha is not None:
            # the reference derives positions from `xs[..., 0] != 0`
            # (tts_modules.py:247): padded frames get the zero embedding
            if pos_nonpad is None:
                pos_nonpad = x.new_ones(x.shape[:2])
            x = x + self.pos_alpha * self.pos(pos_nonpad)
        for i in range(self.n_layers):
            x = torch.relu(conv_time(getattr(self, f"conv_{i}"), x))
            x = getattr(self, f"ln_{i}")(x)
            if nonpad is not None:
                x = x * nonpad[..., None]
        x = self.out(x)
        if nonpad is not None:
            x = x * nonpad[..., None]
        return x


# ---------------------------------------------------------------------------
# FastSpeech2
# ---------------------------------------------------------------------------


class FastSpeech2(nn.Module):
    def __init__(self, cfg: FastSpeech2Config):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        self.enc_pos = SinusoidalPositions(d)
        self.encoder = FFTBlocks(d, cfg.enc_layers, cfg.num_heads,
                                 cfg.enc_ffn_kernel_size, use_pos_embed=False)
        self.decoder = FFTBlocks(d, cfg.dec_layers, cfg.num_heads,
                                 cfg.dec_ffn_kernel_size)
        self.mel_out = nn.Linear(d, cfg.n_mels)
        self.dur_predictor = ConvPredictor(d, cfg.pred_hidden,
                                           cfg.dur_predictor_layers,
                                           cfg.dur_predictor_kernel, 1)
        if cfg.use_pitch_embed:
            self.pitch_embed = nn.Embedding(300, d)
            if cfg.pitch_type == "cwt":
                # 10 CWT scales + uv logit (fs2.py:191-203)
                self.cwt_predictor = ConvPredictor(
                    d, cfg.pred_hidden, cfg.predictor_layers,
                    cfg.predictor_kernel, 11, with_pos=True, pos_dim=d)
                self.cwt_stats = nn.Linear(d, 2)
            else:
                self.pitch_predictor = ConvPredictor(
                    d, cfg.pred_hidden, cfg.predictor_layers,
                    cfg.predictor_kernel, 2 if cfg.use_uv else 1,
                    with_pos=True, pos_dim=d)
        if cfg.use_energy_embed:
            self.energy_embed = nn.Embedding(256, d)
            self.energy_predictor = ConvPredictor(
                d, cfg.pred_hidden, cfg.predictor_layers,
                cfg.predictor_kernel, 1, with_pos=True, pos_dim=d)
        if cfg.num_spk > 0:
            self.spk_embed = nn.Embedding(cfg.num_spk + 1, d)
        if cfg.use_midi:
            self.midi_embed = nn.Embedding(300, d)
            self.midi_dur_layer = nn.Linear(1, d)
            self.is_slur_embed = nn.Embedding(2, d)

    def encode(self, tokens: torch.Tensor,
               pitch_midi: torch.Tensor | None = None,
               midi_dur: torch.Tensor | None = None,
               is_slur: torch.Tensor | None = None):
        """tokens [B, T] → (encoder_out [B, T, H], nonpad [B, T])
        (FastspeechEncoder:352; the MIDI variant diffsinger_midi/fs2.py:57)."""
        cfg = self.cfg
        nonpad = (tokens > 0).float()
        x = self.embed_tokens(tokens) * math.sqrt(cfg.hidden_size)
        if cfg.use_midi and pitch_midi is not None:
            x = x + self.midi_embed(pitch_midi)
            if midi_dur is not None:
                x = x + self.midi_dur_layer(midi_dur[..., None])
            if is_slur is not None:
                x = x + self.is_slur_embed(is_slur)
        if cfg.rel_pos:
            # ESPnet RelPositionalEncoding (espnet_positional_embedding.py:89):
            # x·√d (a second time) + the reversed, interleaved sin/cos table.
            # The reference builds the table once at max_len 5000 and slices
            # its head, so row i carries position 4999 − i.
            t, d = tokens.shape[1], cfg.hidden_size
            pos = torch.arange(4999, 4999 - t, -1, dtype=torch.float32,
                               device=tokens.device)[:, None]
            div = torch.exp(torch.arange(0, d, 2, device=tokens.device)
                            * -(math.log(10000.0) / d))
            pe = torch.stack([torch.sin(pos * div), torch.cos(pos * div)],
                             -1).reshape(t, d)
            x = x * math.sqrt(d) + pe
        else:
            x = x + self.enc_pos(nonpad)
        return self.encoder(x, nonpad), nonpad

    @staticmethod
    def expand_states(h: torch.Tensor, mel2ph: torch.Tensor) -> torch.Tensor:
        """Gather token states to frames; mel2ph == 0 → zeros (fs2.py:246)."""
        h = F.pad(h, (0, 0, 1, 0))
        idx = mel2ph[..., None].expand(-1, -1, h.shape[-1])
        return torch.gather(h, 1, idx)

    def forward(self, tokens: torch.Tensor, mel2ph: torch.Tensor | None = None,
                f0: torch.Tensor | None = None, uv: torch.Tensor | None = None,
                spk_id: torch.Tensor | None = None,
                pitch_midi: torch.Tensor | None = None,
                midi_dur: torch.Tensor | None = None,
                is_slur: torch.Tensor | None = None) -> dict:
        """Returns a dict: mel_out [B, F, n_mels], dur (log-domain
        prediction), mel2ph, pitch_pred (``cwt``: cwt, f0_mean, f0_std),
        f0_denorm, decoder_inp (and energy_pred). Training passes the
        ground-truth mel2ph / f0 / uv; inference predicts them onto F =
        ``cfg.max_frames``."""
        cfg = self.cfg
        ret = {}
        encoder_out, src_nonpad = self.encode(tokens, pitch_midi, midi_dur,
                                              is_slur)

        spk = 0.0
        if cfg.num_spk > 0 and spk_id is not None:
            spk = self.spk_embed(spk_id)[:, None, :]

        # --- duration
        dur_inp = (encoder_out + spk) * src_nonpad[..., None]
        dur_log = self.dur_predictor(dur_inp, src_nonpad)[..., 0]
        ret["dur"] = dur_log
        if mel2ph is None:
            # round half to even, as jnp.round
            dur = torch.round(torch.exp(dur_log) - 1.0).clamp_min(0.0)
            mel2ph = length_regulator(dur * src_nonpad, cfg.max_frames)
        ret["mel2ph"] = mel2ph

        decoder_inp = self.expand_states(encoder_out, mel2ph)
        tgt_nonpad = (mel2ph > 0).float()

        # --- pitch (fs2.py:174-221; the 'frame' and 'cwt' branches)
        if cfg.use_pitch_embed:
            pitch_inp = (decoder_inp + spk) * tgt_nonpad[..., None]
            nonpad = tgt_nonpad if cfg.predictor_mask_pad else None
            if cfg.pitch_type == "cwt":
                cwt_out = self.cwt_predictor(pitch_inp, nonpad=nonpad,
                                             pos_nonpad=tgt_nonpad)
                ret["cwt"] = cwt_out
                stats = self.cwt_stats(encoder_out[:, 0])   # fs2.py:194
                mean, std = stats[:, 0], stats[:, 1] * cfg.cwt_std_scale
                ret["f0_mean"], ret["f0_std"] = mean, std
                if f0 is None:
                    f0 = norm_f0(cwt2f0(cwt_out[..., :10], mean, std), None,
                                 cfg)
                if cfg.use_uv and uv is None:
                    uv = (cwt_out[..., -1] > 0).float()
            else:
                pitch_pred = self.pitch_predictor(pitch_inp, nonpad=nonpad,
                                                  pos_nonpad=tgt_nonpad)
                ret["pitch_pred"] = pitch_pred
                if f0 is None:
                    f0 = pitch_pred[..., 0]
                if cfg.use_uv and uv is None:
                    uv = (pitch_pred[..., 1] > 0).float()
            f0_denorm = denorm_f0(f0, uv, cfg, pitch_padding=mel2ph == 0)
            ret["f0_denorm"] = f0_denorm
            decoder_inp = decoder_inp + self.pitch_embed(
                f0_to_coarse(f0_denorm))

        if cfg.use_energy_embed:
            energy_pred = self.energy_predictor(
                (decoder_inp + spk) * tgt_nonpad[..., None])[..., 0]
            ret["energy_pred"] = energy_pred
            e = torch.div(energy_pred * 256, 4, rounding_mode="floor")
            decoder_inp = decoder_inp + self.energy_embed(
                e.clamp(0, 255).long())

        decoder_inp = (decoder_inp + spk) * tgt_nonpad[..., None]
        ret["decoder_inp"] = decoder_inp
        x = self.decoder(decoder_inp, tgt_nonpad)
        ret["mel_out"] = self.mel_out(x) * tgt_nonpad[..., None]
        return ret
