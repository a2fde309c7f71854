"""Whisper-class ASR encoder-decoder and its decode loop.

Counterpart of ``audiogpt_tpu/models/asr/whisper.py``: the whisper log-mel
frontend (n_fft 400, hop 160, 80 slaney mels, last frame dropped, dynamic
range clamp), the encoder (two convs, sinusoidal positions, pre-LN blocks)
and the decoder (tied output projection) with a static-length KV cache.
Submodules carry the flax scope names, so ``load_jax_params`` loads a JAX
tree strictly. Config default is whisper-base.

The encoder's self-attention over 1500 positions takes the flash kernel on
the card (``ops/attention.py``'s dispatch rule); the decoder's cached
attentions carry a dense mask and its cross-attentions are short, so they
take the plain product.

:func:`decode` is the JAX package's one-program decode as a Python loop over
the token positions: the prime forward over the SOT prompt (no-speech and
language probabilities at the SOT position), then one cached step per token
with the logit filters (static suppress masks, blank suppression at the
first sampled token, whisper's timestamp rules) and greedy or Gumbel-max
sampling. The cross-attention keys and values of the encoder states are
projected once per decode, not at every step: the same product. The loop
stops once every row has emitted EOT, checked every 16 steps (each check is
a host sync); the tokens stay EOT-padded to ``P + max_tokens``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.dsp.mel import mel_filterbank
from audiogpt_tpu_torch.dsp.stft import spectrogram
from audiogpt_tpu_torch.ops.attention import KVCache, attention

#: steps between the decode loop's checks that every row is done
DONE_CHECK_EVERY = 16


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500          # encoder positions (30 s / 2 / 10ms)
    n_audio_state: int = 512         # base
    n_audio_head: int = 8
    n_audio_layer: int = 6
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 512
    n_text_head: int = 8
    n_text_layer: int = 6
    sample_rate: int = 16000
    chunk_length: int = 30           # seconds

    @property
    def n_samples(self) -> int:
        return self.sample_rate * self.chunk_length


# ---------------------------------------------------------------------------
# Frontend (whisper/audio.py semantics)
# ---------------------------------------------------------------------------


def whisper_log_mel(wav: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """wav [..., n_samples] f32 at 16 kHz → log-mel [..., frames, n_mels].

    |stft(400, 160, hann)|² with the final frame dropped, slaney mel (fmin
    0, fmax 8000), log10 clamped at 1e-10, dynamic-range floor at max − 8,
    then (x + 4) / 4."""
    power = spectrogram(wav, 400, 160, 400, center=True, pad_mode="reflect",
                        power=2.0)[..., :-1, :]
    fb = torch.from_numpy(mel_filterbank(16000, 400, n_mels, 0.0, 8000.0)).to(
        wav.device, non_blocking=True)
    log_spec = torch.log10(torch.clamp_min(power @ fb, 1e-10))
    floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0


def sinusoids(length: int, channels: int,
              max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions."""
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def cache_mask(index: int, t_q: int, max_len: int,
               device: torch.device) -> torch.Tensor:
    """Causal valid-length mask over a cache that holds ``index`` positions
    after this chunk's write: query j of the chunk sees entries up to its own
    position ``index - t_q + j``, so the multi-token prime stays causal
    (the no-speech and language probabilities at the SOT position see only
    SOT). → [1, 1, t_q, max_len], True = keep."""
    pos = torch.arange(max_len, device=device)
    q_pos = torch.arange(index - t_q, index, device=device)
    return (pos[None, :] <= q_pos[:, None])[None, None]


class MHA(nn.Module):
    """Whisper attention: q/v/out have bias, k doesn't."""

    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model, bias=False)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.n_head, -1)

    def kv(self, src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Keys and values of ``src`` [B, S, d] → two [B, S, H, D]."""
        return self._split(self.k(src)), self._split(self.v(src))

    def forward(self, x: torch.Tensor, kv=None, is_causal: bool = False,
                cache: KVCache | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """``kv=None`` is self-attention; else the cross-attention source
        [B, S, d] or its projected ``(k, v)``. With ``cache`` (decode) this
        chunk's K/V are written to it and attention spans the cache under
        ``mask`` (:func:`cache_mask` when not given)."""
        q = self._split(self.q(x))
        k, v = kv if isinstance(kv, tuple) else self.kv(x if kv is None
                                                        else kv)
        if cache is not None:
            cache.update(k, v)
            k, v = cache.k, cache.v
            if mask is None:
                mask = cache_mask(cache.index, x.shape[1], k.shape[1],
                                  x.device)
        out = attention(q, k, v, mask=mask,
                        is_causal=is_causal and cache is None)
        b, t = out.shape[:2]
        return self.out(out.reshape(b, t, -1))


class ResidualBlock(nn.Module):
    """Pre-LN transformer block; optional cross-attention (decoder)."""

    def __init__(self, d_model: int, n_head: int, cross: bool = False):
        super().__init__()
        self.cross = cross
        self.attn = MHA(d_model, n_head)
        self.attn_ln = nn.LayerNorm(d_model, eps=1e-5)
        if cross:
            self.cross_attn = MHA(d_model, n_head)
            self.cross_attn_ln = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp_ln = nn.LayerNorm(d_model, eps=1e-5)
        self.fc1 = nn.Linear(d_model, 4 * d_model)
        self.fc2 = nn.Linear(4 * d_model, d_model)

    def forward(self, x: torch.Tensor, xa=None,
                cache: KVCache | None = None,
                mask: torch.Tensor | None = None,
                is_causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.attn_ln(x), is_causal=is_causal, cache=cache,
                          mask=mask)
        if self.cross:
            x = x + self.cross_attn(self.cross_attn_ln(x), kv=xa)
        return x + self.fc2(F.gelu(self.fc1(self.mlp_ln(x))))


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.n_audio_state
        self.conv1 = nn.Conv1d(cfg.n_mels, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        for i in range(cfg.n_audio_layer):
            self.add_module(f"block_{i}", ResidualBlock(d, cfg.n_audio_head))
        self.ln_post = nn.LayerNorm(d, eps=1e-5)
        self.register_buffer("positions", torch.from_numpy(
            sinusoids(cfg.n_audio_ctx, d)), persistent=False)
        self.n_layer = cfg.n_audio_layer

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, frames (= 2·ctx), n_mels] → [B, ctx, d]."""
        x = F.gelu(self.conv1(mel.transpose(1, 2)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        # the table in the stream's dtype: the bf16 mode stays bf16
        x = x + self.positions[: x.shape[1]].to(x.dtype)
        for i in range(self.n_layer):
            x = getattr(self, f"block_{i}")(x)
        return self.ln_post(x)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.n_text_state
        self.token_embedding = nn.Embedding(cfg.n_vocab, d)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(cfg.n_text_ctx, d))
        for i in range(cfg.n_text_layer):
            self.add_module(f"block_{i}",
                            ResidualBlock(d, cfg.n_text_head, cross=True))
        self.ln = nn.LayerNorm(d, eps=1e-5)
        self.n_layer = cfg.n_text_layer

    @property
    def blocks(self) -> list[ResidualBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.n_layer)]

    def cross_kv(self, xa: torch.Tensor) -> list:
        """The cross-attention keys and values of the encoder states, per
        layer: computed once per decode and passed as ``xa``."""
        return [blk.cross_attn.kv(xa) for blk in self.blocks]

    def forward(self, tokens: torch.Tensor, xa, pos_offset: int = 0,
                caches: list[KVCache] | None = None) -> torch.Tensor:
        """tokens [B, t] + encoder states xa [B, ctx, d] (or
        :meth:`cross_kv` of them) → logits [B, t, vocab]. With ``caches``
        (one :class:`KVCache` per layer) this is an incremental step: the
        caches advance by t, and the attention is causal over them."""
        t = tokens.shape[1]
        x = self.token_embedding(tokens) \
            + self.positional_embedding[pos_offset:pos_offset + t]
        mask = None
        if caches is not None:
            mask = cache_mask(caches[0].index + t, t, caches[0].k.shape[1],
                              x.device)
        for i, blk in enumerate(self.blocks):
            x = blk(x, xa[i] if isinstance(xa, list) else xa,
                    cache=None if caches is None else caches[i], mask=mask,
                    is_causal=caches is None)
        return self.ln(x) @ self.token_embedding.weight.T


class WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfig | None = None):
        super().__init__()
        self.cfg = cfg or WhisperConfig()
        self.encoder = WhisperEncoder(self.cfg)
        self.decoder = WhisperDecoder(self.cfg)

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        return self.decoder(tokens, self.encoder(mel))

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.encoder(mel)

    def decode_step(self, tokens: torch.Tensor, xa, pos_offset: int,
                    caches: list[KVCache]) -> torch.Tensor:
        return self.decoder(tokens, xa, pos_offset=pos_offset, caches=caches)


# ---------------------------------------------------------------------------
# Decode (greedy / sampled, with logit filters)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _logit_masks(n_vocab: int, eot_id: int, suppress: tuple,
                 suppress_gte: int | None, blank_ids: tuple,
                 timestamps: bool, ts_begin: int | None,
                 max_initial_timestamp: int | None):
    """(base, first, is_ts) as numpy: the additive −inf mask of every step,
    that of the first sampled token, and the timestamp-token flags."""
    base = np.zeros((n_vocab,), np.float32)
    if suppress_gte is not None and suppress_gte < n_vocab:
        base[suppress_gte:] = -np.inf
    for i in suppress:
        if 0 <= i < n_vocab:
            base[i] = -np.inf
    if timestamps:
        # the timestamp region must stay reachable; <|notimestamps|>
        # (directly below it) must not (whisper ApplyTimestampRules.apply)
        base[ts_begin:] = 0.0
        if ts_begin - 1 != eot_id:
            base[ts_begin - 1] = -np.inf
    base[eot_id] = 0.0  # EOT must stay reachable
    first = base.copy()
    for i in blank_ids:
        if 0 <= i < n_vocab:
            first[i] = -np.inf
    if timestamps:
        # the first sampled token must be a timestamp, capped at the
        # max_initial_timestamp option (whisper default 1 s = 50 ticks)
        first[:ts_begin] = -np.inf
        if max_initial_timestamp is not None:
            first[ts_begin + max_initial_timestamp + 1:] = -np.inf
    is_ts = np.arange(n_vocab) >= (ts_begin if timestamps else n_vocab)
    return base, first, is_ts


def _pick(lg: torch.Tensor, temperature: float,
          gumbel: torch.Tensor | None) -> torch.Tensor:
    """Argmax at temperature 0, else Gumbel-max sampling from lg / T (what
    ``jax.random.categorical`` computes)."""
    if temperature > 0:
        return torch.argmax(lg / max(temperature, 1e-6) + gumbel, dim=-1)
    return torch.argmax(lg, dim=-1)


def _gumbel(noise, i: int, shape, device) -> torch.Tensor:
    """Draw ``i`` of the decode: the i-th tensor of a sequence (replayed
    draws), or standard Gumbel noise from a ``torch.Generator``."""
    if isinstance(noise, torch.Generator):
        u = torch.rand(shape, generator=noise, device=device)
        return -torch.log(-torch.log(u.clamp_min_(torch.finfo(u.dtype).tiny)))
    return noise[i].to(device)


def _apply_ts_rules(lg, last, prev_ts, max_ts, is_ts, text_ids, ts_begin):
    """whisper ApplyTimestampRules as batch-vectorized masks over carried
    state: ``prev_ts``: was the token before ``last`` a timestamp;
    ``max_ts``: largest timestamp sampled so far; ``text_ids``: ids below
    EOT."""
    neg = float("-inf")
    last_ts = last >= ts_begin
    # after an opening pair (..ts ts) text must follow; after a lone closing
    # timestamp (..text ts) only a timestamp/EOT may follow
    pair = last_ts & prev_ts
    lone = last_ts & ~prev_ts
    lg = lg.masked_fill(pair[:, None] & is_ts[None, :], neg)
    lg = lg.masked_fill(lone[:, None] & text_ids[None, :], neg)
    # timestamps never decrease (equality allowed only when closing
    # re-opens at the same tick, i.e. directly after a lone close)
    bound = torch.where(lone, max_ts, max_ts + 1)
    vocab_ids = torch.arange(lg.shape[-1], device=lg.device)
    lg = lg.masked_fill(is_ts[None, :] & (vocab_ids[None, :] < bound[:, None]),
                        neg)
    # if the total timestamp probability beats every text token, force a
    # timestamp (on the already-masked logits)
    lp = torch.log_softmax(lg, dim=-1)
    ts_lp = torch.logsumexp(lp.masked_fill(~is_ts[None, :], neg), dim=-1)
    txt_max = lp.masked_fill(is_ts[None, :], neg).amax(dim=-1)
    force = ts_lp > txt_max
    return lg.masked_fill(force[:, None] & ~is_ts[None, :], neg)


def compute_dtype(model: nn.Module) -> torch.dtype:
    return next(model.parameters()).dtype


@torch.inference_mode()
def prime(model: WhisperModel, mel: torch.Tensor, prompt: torch.Tensor,
          cache_len: int):
    """Encoder + the prompt's forward through fresh caches of ``cache_len``
    positions. The mel goes in in the model's dtype (the bf16 mode stays
    bf16 from encoder to logits); the logits come back in f32.
    → (cross K/V per layer, caches, logits [B, P, vocab] f32)."""
    cfg = model.cfg
    dtype = compute_dtype(model)
    xa = model.encode(mel.to(dtype))
    cross = model.decoder.cross_kv(xa)
    caches = [KVCache.create(prompt.shape[0], cache_len, cfg.n_text_head,
                             cfg.n_text_state // cfg.n_text_head, dtype,
                             mel.device)
              for _ in range(cfg.n_text_layer)]
    logits = model.decode_step(prompt, cross, 0, caches).float()
    return cross, caches, logits


@torch.inference_mode()
def decode(model: WhisperModel, mel: torch.Tensor, prompt: torch.Tensor,
           max_tokens: int, eot_id: int, *, suppress: tuple = (),
           suppress_gte: int | None = None, blank_ids: tuple = (),
           no_speech_id: int | None = None, temperature: float = 0.0,
           noise: torch.Generator | Sequence[torch.Tensor] | None = None,
           lang_range: tuple | None = None, timestamps: bool = False,
           timestamp_begin: int | None = None,
           max_initial_timestamp: int | None = 50):
    """Whisper decode with the reference's logit filters (openai-whisper
    ``DecodingTask._get_logit_filters``), as the JAX ``decode``:

      * ``suppress`` / ``suppress_gte``: −inf at every step;
      * ``blank_ids``: also suppressed at the first sampled token;
      * ``no_speech_id``: p(no-speech) at the prime's SOT position;
      * ``temperature``: 0 → argmax, > 0 → Gumbel-max sampling with draws
        from ``noise`` (a ``torch.Generator`` on the mel's device, or
        ``max_tokens + 1`` tensors [B, vocab]: the first pick's, then each
        step's, as ``jax.random.categorical`` draws them);
      * ``lang_range`` ``(base_id, n)``: softmax over that block at the SOT
        position (whisper ``detect_language``);
      * ``timestamps`` + ``timestamp_begin``: timestamp-token mode with the
        ``ApplyTimestampRules`` constraints.

    mel [B, frames, n_mels] and prompt [B, P] (int64) on the model's device.
    → ``(tokens [B, P + max_tokens], avg_logprob [B], no_speech_prob [B],
    lang_probs [B, n])`` on the device; ``avg_logprob`` is the mean logprob
    of the sampled tokens, EOT included."""
    cfg = model.cfg
    dev = mel.device
    b, p = prompt.shape
    ts_begin = timestamp_begin
    if timestamps and (ts_begin is None
                       or not eot_id < ts_begin < cfg.n_vocab):
        raise ValueError(
            f"timestamp decode needs eot < timestamp_begin < n_vocab "
            f"(got {ts_begin}, eot {eot_id}, vocab {cfg.n_vocab})")
    if temperature > 0 and noise is None:
        raise ValueError("sampling at temperature > 0 needs noise: a "
                         "torch.Generator or the draws")
    base, first, is_ts = (torch.from_numpy(m).to(dev, non_blocking=True)
                          for m in _logit_masks(
                              cfg.n_vocab, eot_id, tuple(suppress),
                              suppress_gte, tuple(blank_ids), timestamps,
                              ts_begin, max_initial_timestamp))
    cross, caches, logits = prime(model, mel, prompt, p + max_tokens)
    if no_speech_id is not None:
        ns_prob = torch.softmax(logits[:, 0], dim=-1)[:, no_speech_id]
    else:
        ns_prob = torch.zeros(b, device=dev)
    if lang_range is not None:
        lb, ln = lang_range
        lang_probs = torch.softmax(logits[:, 0, lb:lb + ln], dim=-1)
    else:
        lang_probs = torch.zeros(b, 0, device=dev)

    def draw(i):
        if temperature <= 0:
            return None
        return _gumbel(noise, i, (b, cfg.n_vocab), dev)

    l0 = logits[:, -1] + first
    last = _pick(l0, temperature, draw(0))
    sum_lp = torch.log_softmax(l0, dim=-1).gather(1, last[:, None])[:, 0]
    count = torch.ones(b, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    if timestamps:
        text_ids = torch.arange(cfg.n_vocab, device=dev) < eot_id
        # whisper treats the (empty) penultimate slot before the first
        # sampled token as a timestamp, so text is forced right after the
        # opening tick
        prev_ts = torch.ones(b, dtype=torch.bool, device=dev)
        max_ts = torch.where(last >= ts_begin, last,
                             torch.full_like(last, ts_begin))
    toks = []
    for i in range(max_tokens):
        tok = torch.where(done, eot_id, last)
        step = model.decode_step(tok[:, None], cross, p + i, caches)
        lg = step[:, -1].float() + base
        if timestamps:
            lg = _apply_ts_rules(lg, last, prev_ts, max_ts, is_ts, text_ids,
                                 ts_begin)
        nxt = _pick(lg, temperature, draw(i + 1))
        tok_lp = torch.log_softmax(lg, dim=-1).gather(1, nxt[:, None])[:, 0]
        done_now = done | (tok == eot_id)
        sum_lp = sum_lp + torch.where(done_now, 0.0, tok_lp)
        count = count + (~done_now).float()
        if timestamps:
            prev_ts = last >= ts_begin
            max_ts = torch.where((nxt >= ts_begin) & ~done_now,
                                 torch.maximum(max_ts, nxt), max_ts)
        toks.append(tok)
        last, done = nxt, done_now
        if (i + 1) % DONE_CHECK_EVERY == 0 and i + 1 < max_tokens \
                and bool(done.all()):
            # every later token is EOT and adds nothing to the statistics
            toks.append(torch.full((b, max_tokens - i - 1), eot_id,
                                   dtype=tok.dtype, device=dev))
            break
    body = torch.cat([t if t.ndim == 2 else t[:, None] for t in toks], 1) \
        if toks else prompt[:, :0]
    return (torch.cat([prompt, body], 1), sum_lp / count, ns_prob,
            lang_probs)

