"""TTS engine: text → phones → mel (FastSpeech2) → wav (vocoder).

Counterpart of ``audiogpt_tpu/engines/tts.py:26-291``, the agent's
"Synthesize Speech" tool (the reference's ``TTS``, ``audio-chatgpt.py:275``):
``EnglishFrontend`` (normalise, G2P, ARPAbet ids) → FastSpeech2 on a token
bucket, its length regulator onto the ``max_frames`` canvas → vocoder →
wav at the vocoder's rate.

With a plain mel → wav vocoder (HiFi-GAN without NSF, or BigVGAN) a chunk
is one pass on the device (:meth:`TTSEngine.synthesize_chunk`): FS2, the
f32 vocoder on the whole canvas as the JAX program runs it, the int16
conversion, and one copy of the valid samples to the host; the mel never
leaves the card. Other vocoders (NSF, PWG, MelGAN) take ``text_to_mel`` →
``vocoder(mel)``, as in JAX. The JAX engine's ``download_rows`` ladder and
``host_sync`` were TPU workarounds and have no counterpart.

Long texts are cut at clause punctuation (then by word bisection) into
chunks whose phones fit the largest token bucket (and, for PortaSpeech,
whose words fit the largest word bucket). As in JAX, only phones and words
are checked: a chunk whose durations overrun the canvas loses its tail in
``length_regulator``.

:class:`PortaSpeechTTSEngine` (``audiogpt_tpu/engines/tts.py:297-399``) serves
PortaSpeech and, with ``use_graph``, SyntaSpeech: the words wrapped in
``<BOS>`` / ``<EOS>``, phones and words on their buckets, the syntactic
word graph built on the host, the model on the device, then the vocoder.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from audiogpt_tpu_torch.engines.base import (
    Bucketer,
    ParamsEntry,
    on_device,
    resolve_device,
    seeded,
)
from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
from audiogpt_tpu_torch.models.tts import (
    FastSpeech2,
    FastSpeech2Config,
    PortaSpeech,
    PortaSpeechConfig,
)
from audiogpt_tpu_torch.models.tts.portaspeech import inference_tree
from audiogpt_tpu_torch.registry import ENGINES
from audiogpt_tpu_torch.text import (
    EnglishFrontend,
    TokenTextEncoder,
    default_arpabet_vocab,
)
from audiogpt_tpu_torch.text.syntax import build_word_graph
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

TOKEN_BUCKETS = (32, 64, 128, 256)
WORD_BUCKETS = (8, 16, 32, 64)


def split_for_buckets(frontend, text: str, fits) -> list[str]:
    """Split long input into clause chunks for which ``fits(ProcessedText)``
    holds: cut at clause punctuation, pack clauses greedily, and bisect on
    words a clause that still overflows."""
    def ok(t: str) -> bool:
        return fits(frontend(t))

    if ok(text):
        return [text]
    parts = [p.strip() for p in
             re.split(r"(?<=[.!?;:,])\s+", text.strip()) if p.strip()]
    chunks: list[str] = []
    cur = ""
    for p in parts:
        cand = (cur + " " + p).strip()
        if cur and not ok(cand):
            chunks.append(cur)
            cur = p
        else:
            cur = cand
    if cur:
        chunks.append(cur)
    out: list[str] = []
    stack = chunks[::-1]
    while stack:
        c = stack.pop()
        if ok(c):
            out.append(c)
            continue
        words = c.split()
        if len(words) < 2:
            out.append(c)  # a single unsplittable token; the engine raises
            continue
        mid = len(words) // 2
        stack.append(" ".join(words[mid:]))
        stack.append(" ".join(words[:mid]))
    return out


def synthesize_stream(engine, text: str, gap_sec: float = 0.1,
                      max_phones: int | None = None):
    """Yield wav chunks (float32 [T] at ``engine.sample_rate``) as each
    clause chunk is synthesised, with ``gap_sec`` of silence between them.

    A chunk's phones fit the largest phone bucket (``engine.ph_bucketer``,
    else ``engine.bucketer``) and, for an engine with a word bucket ladder
    (``engine.word_bucketer``), its words plus ``<BOS>`` / ``<EOS>`` fit
    the largest word bucket. ``max_phones`` caps the phones per chunk (a
    streaming caller's small cap makes the first chunk one clause);
    ``None`` or 0 packs clauses greedily up to the largest bucket. A
    negative cap raises ``ValueError`` (the JAX server lets it through,
    ``serving/server.py:286``). Engines with ``_fused_ok`` synthesise a
    chunk in one pass (``synthesize_chunk``)."""
    if max_phones is not None and max_phones < 0:
        raise ValueError(f"max_phones must be >= 0, got {max_phones}")
    phones = engine.ph_bucketer if hasattr(engine, "ph_bucketer") \
        else engine.bucketer
    bucket_cap = max(phones.buckets)
    phone_cap = min(bucket_cap, max_phones) if max_phones else bucket_cap
    word_cap = max(engine.word_bucketer.buckets) \
        if hasattr(engine, "word_bucketer") else None

    def fits(pt) -> bool:
        return len(pt.phones) <= phone_cap and (
            word_cap is None or len(pt.words) + 2 <= word_cap)

    chunks = split_for_buckets(engine.frontend, text, fits)
    gap = np.zeros(int(gap_sec * engine.sample_rate), np.float32)
    fused = getattr(engine, "_fused_ok", False)
    for i, c in enumerate(chunks):
        yield (engine.synthesize_chunk(c) if fused
               else engine.vocoder(engine.text_to_mel(c)))
        if i < len(chunks) - 1:
            yield gap


def synthesize_long(engine, text: str, gap_sec: float = 0.1) -> np.ndarray:
    """Chunked long-form text → wav: the concatenation of
    :func:`synthesize_stream`."""
    pieces = list(synthesize_stream(engine, text, gap_sec))
    return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)


def _trimmed_len(mel: np.ndarray) -> int:
    """Frames up to the last one that is not all zero (at least 1)."""
    nz = np.nonzero(np.abs(mel).sum(-1) > 0)[0]
    return int(nz[-1]) + 1 if len(nz) else 1


@ENGINES.register("tts")
class TTSEngine(ParamsEntry):
    name = "tts"

    def __init__(self, cfg: FastSpeech2Config | None = None, params=None,
                 vocoder: VocoderEngine | None = None,
                 frontend: EnglishFrontend | None = None,
                 phone_vocab: list[str] | None = None,
                 token_buckets=TOKEN_BUCKETS, rng_seed: int = 0,
                 device: str | torch.device | None = None):
        """``params``: the JAX engine's FastSpeech2 tree as numpy arrays;
        ``None`` keeps a seeded random init. ``vocoder`` defaults to
        ``VocoderEngine("hifigan")`` (V1, 22.05 kHz) on the same device.
        ``device=None`` is the card, and raises without one."""
        self.device = resolve_device(device)
        if frontend is None:
            if phone_vocab is None:
                phone_vocab = default_arpabet_vocab()
            encoder = TokenTextEncoder(phone_vocab)
            frontend = EnglishFrontend(phone_encoder=encoder)
        self.frontend = frontend
        vocab_size = len(frontend.phone_encoder)
        self.cfg = cfg or FastSpeech2Config(vocab_size=vocab_size,
                                            max_frames=1024)
        if self.cfg.vocab_size < vocab_size:
            self.cfg = dataclasses.replace(self.cfg, vocab_size=vocab_size)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            self.model = FastSpeech2(self.cfg)
        if params is not None:
            load_jax_params(self.model, params)
        self.model.to(self.device).eval()
        self.vocoder = vocoder or VocoderEngine("hifigan", device=self.device)
        if self.vocoder.device != self.device:
            raise ValueError(f"vocoder on {self.vocoder.device}, engine on "
                             f"{self.device}")
        self.bucketer = Bucketer(token_buckets)

    @property
    def sample_rate(self) -> int:
        return self.vocoder.cfg.sample_rate

    @property
    def _fused_ok(self) -> bool:
        """The fused pass applies to vocoders with a plain mel → wav
        forward (no f0, no noise input)."""
        v = self.vocoder
        return (v.kind == "hifigan" and not v.cfg.use_nsf) \
            or v.kind == "bigvgan"

    def _tokens(self, rows: list[list[int]], batch: int | None = None
                ) -> torch.Tensor:
        """Token ids, zero-padded to [batch or len(rows), bucket], on the
        engine's device."""
        tb = self.bucketer.bucket(max(len(r) for r in rows))
        toks = np.zeros((batch or len(rows), tb), np.int64)
        for i, r in enumerate(rows):
            if len(r) > tb:
                raise ValueError(f"{len(r)} phones exceed the largest "
                                 f"token bucket {tb}")
            toks[i, :len(r)] = r
        return torch.from_numpy(toks).to(self.device)

    @torch.inference_mode()
    def _fs2(self, toks: torch.Tensor):
        """FS2 on the token bucket → (mel [B, max_frames, n_mels] on the
        canvas, valid frames [B], at least 1)."""
        out = self.model(toks)
        return out["mel_out"], (out["mel2ph"] > 0).sum(1).clamp_min(1)

    @torch.inference_mode()
    def _vocode16(self, mel: torch.Tensor) -> torch.Tensor:
        """The f32 vocoder on the whole canvas → int16 wav [B, max_frames ·
        hop]. The cast truncates toward zero, as JAX's ``astype``."""
        wav = self.vocoder.model(mel.transpose(1, 2))
        return (wav * 32767.0).clamp(-32768.0, 32767.0).to(torch.int16)

    def _fused(self, toks: torch.Tensor):
        """The fused pass on the device → (int16 wav, valid frames)."""
        mel, n = self._fs2(toks)
        return self._vocode16(mel), n

    def _valid_rows(self, wav16: torch.Tensor, n: torch.Tensor,
                    rows: int) -> list[np.ndarray]:
        """The first ``rows`` rows' valid samples, copied to the host in one
        transfer, as float32 in [-1, 1]."""
        ends = (n[:rows] * self.vocoder.hop_size).tolist()
        flat = torch.cat([wav16[r, :e] for r, e in enumerate(ends)]).cpu()
        wav = flat.numpy().astype(np.float32) / 32767.0
        return np.split(wav, np.cumsum(ends)[:-1])

    def warmup(self, batch_sizes=(1,), token_buckets=None) -> None:
        """Run every (batch, token-bucket) rung once, so a serving request
        meets no first-call cost (cuDNN's algorithm choice, allocator
        growth)."""
        for nb in batch_sizes:
            for tb in token_buckets or self.bucketer.buckets:
                toks = torch.zeros(int(nb), int(tb), dtype=torch.long,
                                   device=self.device)
                if self._fused_ok:
                    self._fused(toks)
                else:
                    self._fs2(toks)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def text_to_mel(self, text: str) -> np.ndarray:
        """text → mel [frames, n_mels], trailing all-zero frames trimmed."""
        mel, _ = self._fs2(self._tokens([self.frontend.encode(text)]))
        mel = mel[0].cpu().numpy()
        return mel[:_trimmed_len(mel)]

    def synthesize_chunk(self, text: str) -> np.ndarray:
        """One bucketed chunk through the fused pass; only the valid int16
        samples cross to the host. → float32 [T] (int16 / 32767)."""
        wav16, n = self._fused(self._tokens([self.frontend.encode(text)]))
        return self._valid_rows(wav16, n, 1)[0]

    def __call__(self, text: str) -> np.ndarray:
        """text → waveform at ``sample_rate``; long inputs are chunked at
        clause boundaries and joined with short gaps."""
        return synthesize_long(self, text)

    def batch_synthesize(self, texts: list[str]) -> list[np.ndarray]:
        """Many texts → waveforms through one FS2 pass (and one vocoder
        pass) at a batch of the next power of two: the micro-batching entry
        point (``serving/batcher.py`` ``BatchedTTS``). Texts beyond the
        largest token bucket go through the chunked single synthesis."""
        ids = [self.frontend.encode(t) for t in texts]
        top = max(self.bucketer.buckets)
        out: list[np.ndarray | None] = [None] * len(texts)
        idx = [i for i, v in enumerate(ids) if len(v) <= top]
        for i, v in enumerate(ids):
            if len(v) > top:
                out[i] = synthesize_long(self, texts[i])
        if idx:
            n = len(idx)
            nb = 1
            while nb < n:
                nb *= 2
            toks = self._tokens([ids[i] for i in idx], batch=nb)
            if self._fused_ok:
                wavs = self._valid_rows(*self._fused(toks), n)
            else:
                hop = self.vocoder.hop_size
                mels = self._fs2(toks)[0][:n].cpu().numpy()
                lens = [_trimmed_len(m) for m in mels]
                full = self.vocoder(mels[:, :max(lens)])
                wavs = [full[r, :lens[r] * hop] for r in range(n)]
            for r, i in enumerate(idx):
                out[i] = wavs[r]
        return out  # type: ignore[return-value]


def _padded(ids, bucketer: Bucketer) -> np.ndarray:
    """ids → int64 [1, bucket], zero-padded; too long for the largest
    bucket raises."""
    b = bucketer.bucket(len(ids))
    if len(ids) > b:
        raise ValueError(f"length {len(ids)} exceeds largest bucket {b}")
    out = np.zeros((1, b), np.int64)
    out[0, :len(ids)] = ids
    return out


@ENGINES.register("tts_portaspeech")
class PortaSpeechTTSEngine(ParamsEntry):
    """PortaSpeech / SyntaSpeech text → mel → wav: the app's
    ``tts_portaspeech`` and ``syntaspeech`` engines. With ``cfg.use_graph``
    the dense syntactic word graph is built for each chunk. Every call
    draws the prior's noise from the engine's generator (JAX folds a call
    counter into its key); ``text_to_mel(..., draws=)`` takes it
    explicitly."""

    name = "tts_portaspeech"
    #: the posterior encoder of a training tree or trainer checkpoint
    training_only = ("fvae_enc",)

    def __init__(self, cfg: PortaSpeechConfig | None = None, params=None,
                 vocoder: VocoderEngine | None = None,
                 frontend: EnglishFrontend | None = None,
                 phone_vocab: list[str] | None = None,
                 word_vocab: list[str] | None = None,
                 token_buckets=TOKEN_BUCKETS, word_buckets=WORD_BUCKETS,
                 noise_scale: float = 0.8, rng_seed: int = 0,
                 device: str | torch.device | None = None):
        """``params``: the JAX engine's PortaSpeech tree as numpy arrays
        (a training tree's posterior encoder is dropped); ``None`` keeps a
        seeded random init. ``vocoder`` defaults to
        ``VocoderEngine("hifigan")`` on the same device. Words outside
        ``word_vocab`` are ``<UNK>``. ``device=None`` is the card, and
        raises without one."""
        self.device = resolve_device(device)
        if frontend is None:
            frontend = EnglishFrontend(phone_encoder=TokenTextEncoder(
                phone_vocab or default_arpabet_vocab()))
        self.frontend = frontend
        self.word_encoder = TokenTextEncoder(word_vocab or ["<BOS>", "<EOS>"])
        vocab_size = len(frontend.phone_encoder)
        self.cfg = cfg or PortaSpeechConfig(
            ph_vocab_size=vocab_size,
            word_vocab_size=len(self.word_encoder), max_frames=1024)
        if self.cfg.ph_vocab_size < vocab_size:
            self.cfg = dataclasses.replace(self.cfg, ph_vocab_size=vocab_size)
        self.model = on_device(seeded(rng_seed, lambda: PortaSpeech(
            self.cfg)), self.device,
            None if params is None else inference_tree(params))
        self.noise_scale = noise_scale
        self.vocoder = vocoder or VocoderEngine("hifigan", device=self.device)
        if self.vocoder.device != self.device:
            raise ValueError(f"vocoder on {self.vocoder.device}, engine on "
                             f"{self.device}")
        self.ph_bucketer = Bucketer(token_buckets)
        self.word_bucketer = Bucketer(word_buckets)
        self._gen = torch.Generator(self.device).manual_seed(rng_seed + 1)

    @property
    def sample_rate(self) -> int:
        return self.vocoder.cfg.sample_rate

    def inputs(self, text: str) -> dict:
        """The model's inputs on the device: phone ids, word ids and the
        1-based phone → word map on their buckets (the words wrapped in
        ``<BOS>`` / ``<EOS>`` when the phones are), and with ``use_graph``
        the word graph [1, E, W, W]."""
        pt = self.frontend(text)
        words = list(pt.words)
        p2w = np.asarray(pt.ph2word, np.int64)
        if pt.phones and pt.phones[0] == "<BOS>":
            words = ["<BOS>"] + words + ["<EOS>"]
            p2w = p2w + 1
        toks = _padded(self.frontend.phone_encoder.encode(pt.phones),
                       self.ph_bucketer)
        wids = _padded(self.word_encoder.encode(words), self.word_bucketer)
        out = {"txt_tokens": toks, "word_tokens": wids,
               "ph2word": _padded(p2w, self.ph_bucketer)}
        if self.cfg.use_graph:
            out["graph_adj"] = build_word_graph(
                words, max_words=wids.shape[1])[None]
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in out.items()}

    @torch.inference_mode()
    def text_to_mel(self, text: str, draws=None) -> np.ndarray:
        """text → mel [frames, n_mels], trailing all-zero frames trimmed.
        ``draws``: the prior's noise [1, max_frames / 4, latent] (default:
        the engine's generator)."""
        mel = self.model(**self.inputs(text), noise_scale=self.noise_scale,
                         draws=self._gen if draws is None else draws
                         )["mel_out"][0].cpu().numpy()
        return mel[:_trimmed_len(mel)]

    def __call__(self, text: str) -> np.ndarray:
        """text → waveform at ``sample_rate``; long inputs are chunked at
        clause boundaries and joined with short gaps."""
        return synthesize_long(self, text)
