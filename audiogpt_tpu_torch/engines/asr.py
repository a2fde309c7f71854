"""ASR engine: waveform → text (robust whisper decoding).

Counterpart of ``audiogpt_tpu/engines/asr.py:33-521``: the reference's ASR
tool (``audio-chatgpt.py:560-577``): pad/trim to 30 s windows → log-mel →
encoder → decode with non-speech and blank suppression, no-speech detection
and the temperature-fallback ladder on low-logprob or highly compressible
decodes (openai-whisper ``DecodingTask`` + ``transcribe.py``), language
auto-detection with one re-dispatch, and the seam join of >30 s audio.

Three behaviours of the JAX engine are not copied: ``transcribe`` takes
one stream (``[T]`` or ``[1, T]``) and refuses more rows, which
``transcribe_batch`` serves; ``detect_language`` runs the encoder and the
prime only, not a whole decode; ``warmup`` runs the timestamp mode too.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from audiogpt_tpu_torch.engines.base import (ParamsEntry, resolve_device,
                                             run_copy)
from audiogpt_tpu_torch.models.asr.whisper import (
    WhisperConfig,
    WhisperModel,
    decode,
    prime,
    whisper_log_mel,
)
from audiogpt_tpu_torch.registry import ENGINES
from audiogpt_tpu_torch.text.bpe import (
    ByteBPE,
    WhisperDetokenizer,
    load_bpe_dir,
    load_clip_bpe,
    non_speech_ids,
    warn_fallback,
)

# whisper-multilingual special tokens (vocab 51865)
SOT = 50258
EOT = 50257
TASK_TRANSCRIBE = 50359
TASK_TRANSLATE = 50358
NO_TIMESTAMPS = 50363
NO_SPEECH = 50362
SOT_PREV = 50361
LANG_BASE = 50259       # + language index (en=0, zh=1, ...)
N_LANGS = 99            # languages in the multilingual token block
TIMESTAMP_BEGIN = NO_TIMESTAMPS + 1   # <|0.00|>
TS_PRECISION = 0.02     # seconds per timestamp tick (whisper: 2 frames)

# the reference's ``transcribe()`` defaults: the t = 0 decode is retried at
# rising temperatures while its compression ratio exceeds 2.4 or its mean
# logprob is under −1; a window whose no-speech probability beats 0.6 and
# fails the logprob bar returns ""
COMPRESSION_RATIO_THRESHOLD = 2.4
LOGPROB_THRESHOLD = -1.0
NO_SPEECH_THRESHOLD = 0.6
HALO_SEC = 1.0          # overlap between the windows of audio over 30 s


def compression_ratio(text: str) -> float:
    """whisper's degenerate-repetition statistic: UTF-8 length over
    zlib-compressed length (looping output compresses absurdly well)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def dedup_join(texts: list[str], max_overlap_words: int = 8) -> str:
    """Join per-window transcripts, dropping the seam's duplicate: windows
    overlap by a halo, so a word straddling a boundary ends one window and
    starts the next; the longest case-insensitive suffix/prefix word match
    is dropped."""
    out: list[str] = []
    for t in texts:
        words = t.split()
        if out and words:
            k = min(max_overlap_words, len(out), len(words))
            for j in range(k, 0, -1):
                if [w.lower() for w in out[-j:]] == \
                        [w.lower() for w in words[:j]]:
                    words = words[j:]
                    break
        out.extend(words)
    return " ".join(out)


def pad_or_trim(wav: np.ndarray, n_samples: int) -> np.ndarray:
    wav = np.asarray(wav, np.float32)
    if wav.shape[-1] >= n_samples:
        return wav[..., :n_samples]
    width = [(0, 0)] * (wav.ndim - 1) + [(0, n_samples - wav.shape[-1])]
    return np.pad(wav, width)


@ENGINES.register("asr")
class ASREngine(ParamsEntry):
    name = "asr"

    def __init__(self, cfg: WhisperConfig | None = None, params=None,
                 max_tokens: int = 224, rng_seed: int = 0, vocab=None,
                 temperatures=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                 bf16: bool = False,
                 device: str | torch.device | None = None):
        """``params``: the JAX engine's whisper tree as numpy arrays (loaded
        with :meth:`load_jax_params`); ``None`` keeps a seeded random init.
        ``device=None`` is the card, and raises without one.

        ``temperatures``: the fallback ladder, the reference's default.
        Random weights fail the logprob bar by construction (≈ −log V):
        pass ``temperatures=(0.0,)`` for one deterministic pass. Sampling
        at rung ``a`` draws from a generator seeded from ``rng_seed`` and
        ``a``, so a call is deterministic.

        ``bf16``: the model keeps f32 parameters and a bf16 copy is cast
        once (and again after every weight load); the mel goes in as bf16,
        the KV cache is bf16, the logits are read in f32, and the encoder's
        attention takes the flash kernel's bf16 entry."""
        self.device = resolve_device(device)
        self.cfg = cfg or WhisperConfig()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            self.model = WhisperModel(self.cfg)
        self.model.to(self.device).eval()
        self.bf16 = bf16
        self.rng_seed = rng_seed
        self.max_tokens = max_tokens
        self.temperatures = tuple(temperatures)
        self._warned_no_vocab = False
        self._filters_cache = None
        if params is not None:
            self.load_jax_params(params)
        else:
            self._weights_loaded()
        if vocab is not None:
            self.set_vocab(vocab)
        else:
            # out of the box: the bundled CLIP BPE data, so transcribe
            # returns text (its ids are not OpenAI's whisper ranks: imported
            # whisper weights need theirs through set_vocab)
            try:
                self.text_decoder = WhisperDetokenizer(load_clip_bpe(),
                                                       eot=EOT)
            except FileNotFoundError:
                pass  # no bundled data: raw token-id strings + warning

    def _weights_loaded(self) -> None:
        # ``model`` keeps the f32 parameters; the run copy is cast again
        self._run = run_copy(self.model, self.bf16)

    def set_vocab(self, vocab) -> None:
        """Wire a whisper BPE vocab so ``transcribe`` returns text: a path
        (tokenizer dir, ``tokenizer.json``, ``vocab.json`` or ``*.tiktoken``,
        see ``text/bpe.py`` ``load_bpe_dir``) or a built codec /
        ``tokens -> str`` callable."""
        if isinstance(vocab, str):
            vocab = load_bpe_dir(vocab)
        if isinstance(vocab, ByteBPE):
            vocab = WhisperDetokenizer(vocab, eot=EOT)
        self.text_decoder = vocab
        self._filters_cache = None  # suppression ids are vocab-dependent

    def warmup(self, batch_sizes=(1,)) -> None:
        """Run every batch rung once in both decode modes (plain and
        timestamp), so a serving request meets no first-call cost."""
        for nb in batch_sizes:
            wav = np.zeros((int(nb), self.cfg.n_samples), np.float32)
            self._decode_stats(wav)
            if self.supports_timestamps:
                self._decode_stats(wav, timestamps=True)

    def sot_sequence(self, task: str = "translate", language: int = 0,
                     timestamps: bool = False) -> list[int]:
        """The reference uses whisper's translate task
        (audio-chatgpt.py:1296). In timestamp mode ``<|notimestamps|>`` is
        dropped."""
        task_tok = TASK_TRANSLATE if task == "translate" else TASK_TRANSCRIBE
        seq = [SOT, LANG_BASE + language, task_tok]
        if not timestamps:
            seq.append(NO_TIMESTAMPS)
        return seq

    def _prompts(self, batch: int, task: str, language,
                 timestamps: bool = False) -> np.ndarray:
        """SOT prompts [B, P]; ``language`` an int (shared) or a per-row
        array (mixed-language batches from auto-detection)."""
        langs = np.broadcast_to(np.asarray(language, np.int64), (batch,))
        rows = [self.sot_sequence(task, int(l), timestamps) for l in langs]
        return np.asarray(rows, np.int64)

    @property
    def supports_lang_detect(self) -> bool:
        """The language-token block exists in this vocab (tiny configs
        shrink n_vocab below it and fall back to the default language)."""
        return self.cfg.n_vocab >= LANG_BASE + N_LANGS

    @property
    def supports_timestamps(self) -> bool:
        return self.cfg.n_vocab > TIMESTAMP_BEGIN

    @property
    def eot(self) -> int:
        return EOT if self.cfg.n_vocab > EOT else self.cfg.n_vocab - 1

    @property
    def _filters(self):
        """(suppress_ids, suppress_gte, blank_ids, no_speech_id): the static
        logit-filter spec against the wired codec, cached until
        ``set_vocab`` changes it."""
        if self._filters_cache is None:
            eot = self.eot
            codec = getattr(getattr(self, "text_decoder", None), "codec",
                            None)
            sup: tuple = ()
            blanks = [eot]
            if codec is not None:
                sup = tuple(i for i in non_speech_ids(codec)
                            if i < self.cfg.n_vocab)
                space = codec.encode(" ")
                if len(space) == 1:
                    blanks.append(int(space[0]))
            gte = eot + 1 if self.cfg.n_vocab > eot + 1 else None
            nsid = NO_SPEECH if self.cfg.n_vocab > NO_SPEECH else None
            self._filters_cache = (sup, gte, tuple(blanks), nsid)
        return self._filters_cache

    def _mel(self, wav: np.ndarray) -> torch.Tensor:
        """wav [B, T] → the padded/trimmed windows' log-mel on the device."""
        wav = pad_or_trim(wav, self.cfg.n_samples)
        x = torch.from_numpy(np.ascontiguousarray(wav)).to(self.device,
                                                           non_blocking=True)
        return whisper_log_mel(x, self.cfg.n_mels)

    def _noise(self, attempt: int, batch: int) -> torch.Generator:
        """The sampling draws of ladder rung ``attempt`` (a decode of
        ``batch`` rows): a generator seeded from ``rng_seed`` and the rung.
        (A caller that replays draws, [batch, vocab] each, replaces this.)"""
        return torch.Generator(self.device).manual_seed(
            (self.rng_seed + 1) * 1_000_003 + attempt)

    def _decode_stats(self, wav: np.ndarray, task: str = "translate",
                      language=0, temperature: float = 0.0,
                      attempt: int = 0, timestamps: bool = False):
        """wav [B, T] at 16 kHz → (tokens [B, P + max_tokens], avg_logprob
        [B], no_speech_prob [B], lang_probs [B, N_LANGS]) as numpy, one
        encoder + decode with the static suppression masks. ``language``:
        int or per-row array. With the language block in the vocab,
        lang_probs (softmax at the SOT position) rides along."""
        if timestamps and not self.supports_timestamps:
            raise ValueError(
                f"timestamp decode needs n_vocab > {TIMESTAMP_BEGIN} "
                f"(got {self.cfg.n_vocab})")
        mel = self._mel(wav)
        prompt = torch.from_numpy(self._prompts(
            wav.shape[0], task, language, timestamps)).to(self.device,
                                                          non_blocking=True)
        sup, gte, blanks, nsid = self._filters
        lang_range = ((LANG_BASE, N_LANGS) if self.supports_lang_detect
                      else None)
        out = decode(
            self._run, mel, prompt, max_tokens=self.max_tokens,
            eot_id=self.eot, suppress=sup, suppress_gte=gte,
            blank_ids=blanks, no_speech_id=nsid, temperature=temperature,
            noise=(self._noise(attempt, wav.shape[0]) if temperature > 0
                   else None),
            lang_range=lang_range, timestamps=timestamps,
            timestamp_begin=TIMESTAMP_BEGIN if timestamps else None)
        return tuple(t.cpu().numpy() for t in out)

    @torch.inference_mode()
    def detect_language(self, wav: np.ndarray):
        """→ (language index [B], probs [B, N_LANGS]): whisper's
        ``detect_language``, the softmax over the 99 language tokens at the
        SOT position of the prompt's forward (encoder + prime, no decode)."""
        if not self.supports_lang_detect:
            raise ValueError(
                f"language detection needs n_vocab >= {LANG_BASE + N_LANGS} "
                f"(got {self.cfg.n_vocab})")
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        prompt = torch.from_numpy(self._prompts(wav.shape[0], "translate",
                                                0)).to(self.device)
        logits = prime(self._run, self._mel(wav), prompt, prompt.shape[1])[2]
        probs = torch.softmax(logits[:, 0, LANG_BASE:LANG_BASE + N_LANGS],
                              dim=-1).cpu().numpy()
        return probs.argmax(-1), probs

    def transcribe_tokens(self, wav: np.ndarray, task: str = "translate",
                          language: int = 0) -> np.ndarray:
        """wav [T] or [B, T] at 16 kHz → token ids [B, P + max_tokens]
        (deterministic t=0 decode with suppression)."""
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        return self._decode_stats(wav, task, language)[0]

    def _tokens_to_text(self, toks, task: str, language: int = 0,
                        timestamps: bool = False) -> str:
        dec = getattr(self, "text_decoder", None)
        prompt_len = len(self.sot_sequence(task, 0, timestamps))
        body = [int(t) for t in toks[prompt_len:] if int(t) < EOT]
        if dec is not None:
            return dec(body)
        if not self._warned_no_vocab:
            self._warned_no_vocab = True
            warn_fallback("ASREngine",
                          "no whisper vocab wired (set_vocab): emitting raw "
                          "token-id strings")
        return " ".join(str(t) for t in body)

    def _parse_segments(self, toks, task: str) -> list:
        """Timestamp-mode token row → [(start_s, end_s | None, text)]:
        ``<|t0|> text <|t1|><|t1'|> text <|t2|> … [<|tk|>] <eot>``; a lone
        trailing timestamp before EOT leaves the last segment's end open
        (None: the caller substitutes the window end)."""
        prompt_len = len(self.sot_sequence(task, 0, timestamps=True))
        segs: list = []
        start: float | None = None
        text_toks: list[int] = []
        for t in toks[prompt_len:]:
            t = int(t)
            if t == self.eot:
                break
            if t >= TIMESTAMP_BEGIN:
                tick = (t - TIMESTAMP_BEGIN) * TS_PRECISION
                if text_toks and start is not None:
                    segs.append((start, tick, self._detok(text_toks)))
                    text_toks, start = [], None
                else:
                    start = tick  # (re-)opening tick; latest wins
            elif t < EOT:
                text_toks.append(t)
        if text_toks and start is not None:
            segs.append((start, None, self._detok(text_toks)))
        return [s for s in segs if s[2].strip()]

    def _detok(self, ids: list[int]) -> str:
        dec = getattr(self, "text_decoder", None)
        if dec is not None:
            return dec(ids)
        return " ".join(str(t) for t in ids)

    @staticmethod
    def _needs_fallback(text: str, avg_lp: float) -> bool:
        """whisper ``decode_with_fallback``: retry at a higher temperature
        when the decode compresses too well or is under-confident."""
        return (compression_ratio(text) > COMPRESSION_RATIO_THRESHOLD
                or avg_lp < LOGPROB_THRESHOLD)

    @staticmethod
    def _gated(avg_lp: float, ns_prob: float) -> bool:
        """whisper's no-speech skip: a window that looks like silence AND
        failed the confidence bar contributes no text."""
        return ns_prob > NO_SPEECH_THRESHOLD and avg_lp < LOGPROB_THRESHOLD

    def _robust_decode(self, stack: np.ndarray, task: str,
                       language, timestamps: bool = False):
        """Temperature-fallback decode of ``stack [n, T]``: the pending rows
        ride one batched decode per ladder rung (padded to a power of two);
        rows that pass the quality checks drop out of the ladder.

        ``language=None`` auto-detects: the first rung's decode carries the
        language-block softmax; rows whose detected language differs from
        the assumed default are decoded once more with the detected token
        in their SOT row.

        → ``(texts [n], token rows [n], gated [n])``; ``gated`` marks the
        windows the no-speech gate silenced."""
        n = stack.shape[0]
        auto = language is None and self.supports_lang_detect
        langs = np.zeros((n,), np.int64) if language is None \
            else np.broadcast_to(np.asarray(language, np.int64), (n,)).copy()
        texts = [""] * n
        rows = [None] * n
        stats = [(0.0, 0.0)] * n
        pending = list(range(n))
        for attempt, t in enumerate(self.temperatures):
            nb = 1
            while nb < len(pending):
                nb *= 2
            sub = np.zeros((nb, stack.shape[1]), np.float32)
            sublang = np.zeros((nb,), np.int64)
            for r, pi in enumerate(pending):
                sub[r] = stack[pi]
                sublang[r] = langs[pi]
            toks, avg_lp, ns, lp = self._decode_stats(
                sub, task, sublang, temperature=float(t), attempt=attempt,
                timestamps=timestamps)
            if auto and attempt == 0:
                det = lp[: len(pending)].argmax(-1).astype(np.int64)
                if np.any(det != sublang[: len(pending)]):
                    for r, pi in enumerate(pending):
                        langs[pi] = det[r]
                    sublang[: len(pending)] = det
                    toks, avg_lp, ns, lp = self._decode_stats(
                        sub, task, sublang, temperature=float(t),
                        attempt=attempt, timestamps=timestamps)
                auto = False  # position-0 logits are language-invariant
            retry = []
            for r, pi in enumerate(pending):
                texts[pi] = self._tokens_to_text(toks[r], task,
                                                 timestamps=timestamps)
                rows[pi] = toks[r]
                stats[pi] = (float(avg_lp[r]), float(ns[r]))
                if self._needs_fallback(texts[pi], float(avg_lp[r])):
                    retry.append(pi)
            pending = retry
            if not pending:
                break
        gated = [self._gated(*stats[i]) for i in range(n)]
        return ([("" if gated[i] else texts[i]) for i in range(n)],
                rows, gated)

    def _windows(self, wav: np.ndarray):
        """wav [T] → (stack [n, n_samples], offsets_s [n], halo_s). Audio
        longer than whisper's 30 s becomes overlapping windows (``HALO_SEC``
        shared per seam) decoded as one batch."""
        n = self.cfg.n_samples
        sr = self.cfg.sample_rate
        if wav.shape[-1] <= n:
            return pad_or_trim(wav[None], n), [0.0], 0.0
        halo = min(int(HALO_SEC * sr), n // 4)
        stride = n - halo
        wins, offs, i = [], [], 0
        while True:
            wins.append(wav[i: i + n])
            offs.append(i / sr)
            if i + n >= wav.shape[-1]:
                break
            i += stride
        stack = np.zeros((len(wins), n), np.float32)
        for r, w in enumerate(wins):
            stack[r, : len(w)] = w
        return stack, offs, halo / sr

    def transcribe(self, wav: np.ndarray, task: str = "translate",
                   language: int | None = None,
                   return_segments: bool = False):
        """One stream, wav [T] or [1, T] at 16 kHz → text, or
        ``[(start_s, end_s, text), …]`` with ``return_segments=True``
        (whisper's timestamp-token mode). ``language=None`` auto-detects.

        Audio longer than 30 s is transcribed in overlapping windows
        decoded as one batch; plain-text mode joins the seams with
        :func:`dedup_join`, segment mode keeps each segment in the window
        that owns its midpoint (window k owns ``[off_k + halo, off_{k+1} +
        halo)``), so times stay monotonic."""
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 2 and wav.shape[0] == 1:
            wav = wav[0]
        if wav.ndim != 1:
            raise ValueError(
                f"transcribe takes one stream, [T] or [1, T], not "
                f"{list(wav.shape)}: pass several to transcribe_batch")
        stack, offs, halo = self._windows(wav)
        texts, rows, gated = self._robust_decode(
            stack, task, language, timestamps=return_segments)
        if not return_segments:
            return dedup_join([t.strip() for t in texts if t.strip()])
        dur = wav.shape[-1] / self.cfg.sample_rate
        out: list = []
        for k, (off, row) in enumerate(zip(offs, rows)):
            if gated[k]:
                continue
            lo = off + halo if k > 0 else 0.0
            hi = offs[k + 1] + halo if k + 1 < len(offs) else float("inf")
            win_end = min(off + self.cfg.chunk_length, dur)
            for s, e, txt in self._parse_segments(row, task):
                s = off + s
                # lone trailing open tick → window end; clamp so end ≥ start
                # even on untrained weights whose ticks overrun the window
                e = off + e if e is not None else win_end
                e = max(s, min(e, dur))
                mid = (s + e) / 2
                if lo <= mid < hi:
                    out.append((s, e, txt))
        return out

    def transcribe_batch(self, wavs, task: str = "translate",
                         language: int | None = None) -> list[str]:
        """Many wavs (each cut to 30 s) → texts, one batched decode per
        fallback rung, padded to a power of two; ``language=None``
        auto-detects per row."""
        n = self.cfg.n_samples
        stack = np.zeros((len(wavs), n), np.float32)
        for i, w in enumerate(wavs):
            w = np.asarray(w, np.float32)[:n]
            stack[i, : len(w)] = w
        return self._robust_decode(stack, task, language)[0]
