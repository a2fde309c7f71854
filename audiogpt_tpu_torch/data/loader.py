"""Host input pipeline: records → static-shape numpy batches.

Counterpart of ``audiogpt_tpu/data/loader.py``. The reference uses torch's
``DataLoader`` with per-batch dynamic padding (``FastSpeechDataset.collater``
in ``NeuralSeq/tasks/tts/dataset_utils.py``). Here, as in the JAX package,
every batch is padded to a rung of a :class:`BucketSpec` (the token-budget
TTS loader) or to one fixed shape (``ArrayDataLoader``, the vocoder crops),
so a run sees a handful of batch shapes and the step's kernels, launch
configurations and allocator blocks repeat. Dummy rows carry ``weight`` 0,
so the loss is unchanged. Batches stay numpy: the trainer copies each to
the device once. The shuffles and crops draw from numpy's ``default_rng``
with JAX's keys, so the batch stream equals the JAX loader's.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from audiogpt_tpu_torch.data.batching import (BucketSpec, EndlessSampler,
                                              batch_by_size, collate_1d,
                                              collate_2d, ordered_indices)


def _pad_tokens(tok, n: int) -> np.ndarray:
    t = np.asarray(tok, np.int32)[:n]
    return np.pad(t, (0, n - len(t)))


def collate_mel_image(samples: list[dict], width: int,
                      text_len: int | None = None) -> dict[str, np.ndarray]:
    """LDM/VAE batch: records with ``mel`` [T, M] in LDM domain [0, 1]
    (``TRANSFORMS_16000`` output, extract_mel_spectrogram.py:140) → VAE-domain
    images [B, M, width, 1] in [-1, 1] (NHWC, as the JAX batch; the task
    transposes); optional CLAP ``text_ids`` [B, text_len] and
    ``text_mask``."""
    mels = []
    for s in samples:
        # records store [T, M] (binarizer convention) → image rows = mels
        m = np.asarray(s["mel"], np.float32).T
        m = m[:, :width]
        m = np.pad(m, ((0, 0), (0, width - m.shape[1])))
        mels.append(m * 2.0 - 1.0)
    batch = {"mels": np.stack(mels)[..., None],
             "weight": np.ones(len(samples), np.float32)}
    if text_len is not None and "text_ids" in samples[0]:
        batch["text_ids"] = np.stack(
            [_pad_tokens(s["text_ids"], text_len) for s in samples])
        batch["text_mask"] = (batch["text_ids"] != 0).astype(np.int32)
    return batch


def _pad_or_crop_1d(x, n: int) -> np.ndarray:
    x = np.asarray(x, np.float32)[:n]
    return np.pad(x, (0, n - len(x)))


def collate_tagging(samples: list[dict], n_samples: int
                    ) -> dict[str, np.ndarray]:
    """SED batch (AudioSet tagging, ``audio_infer/pytorch/main.py:377``'s
    schema): ``wav`` [B, n_samples] cut or padded, ``wav_len``, the
    multi-hot ``target`` [B, C] and ``weight`` ones."""
    return {
        "wav": np.stack([_pad_or_crop_1d(s["wav"], n_samples)
                         for s in samples]),
        "wav_len": np.asarray([min(len(s["wav"]), n_samples)
                               for s in samples], np.int32),
        "target": np.stack([np.asarray(s["target"], np.float32)
                            for s in samples]),
        "weight": np.ones(len(samples), np.float32),
    }


def collate_mixture(samples: list[dict], n_samples: int
                    ) -> dict[str, np.ndarray]:
    """Separation batch: ``mix`` [B, n_samples] and ``sources`` [B, n_src,
    n_samples], each cut or padded, and ``weight`` ones."""
    mixes, srcs = [], []
    for s in samples:
        mixes.append(_pad_or_crop_1d(s["mix"], n_samples))
        srcs.append(np.stack([_pad_or_crop_1d(x, n_samples)
                              for x in np.asarray(s["sources"], np.float32)]))
    return {"mix": np.stack(mixes), "sources": np.stack(srcs),
            "weight": np.ones(len(samples), np.float32)}


def collate_audio_text(samples: list[dict], n_samples: int, text_len: int,
                       schema: str = "caption") -> dict[str, np.ndarray]:
    """Fixed-length wav crops ``wav`` [B, n_samples] with their lengths
    ``wav_len``, and the text: the captioner's ``tokens`` / ``token_len``
    (``schema="caption"``, the records' ``tokens``) or CLAP's contrastive
    ``text_ids`` / ``text_mask`` (``schema="clap"``, the records'
    ``text_ids``; the mask is ``ids != 0``)."""
    wav = np.stack([_pad_or_crop_1d(s["wav"], n_samples) for s in samples])
    wav_len = np.asarray([min(len(s["wav"]), n_samples) for s in samples],
                         np.int32)
    base = {"wav": wav, "wav_len": wav_len,
            "weight": np.ones(len(samples), np.float32)}
    key = "tokens" if schema == "caption" else "text_ids"
    toks = np.stack([_pad_tokens(s[key], text_len) for s in samples])
    if schema == "caption":
        base["tokens"] = toks
        base["token_len"] = np.asarray(
            [min(len(s[key]), text_len) for s in samples], np.int32)
    else:
        base["text_ids"] = toks
        base["text_mask"] = (toks != 0).astype(np.int32)
    return base


def collate_motion(samples: list[dict], mel_len: int, video_len: int,
                   out_dim: int = 136) -> dict[str, np.ndarray]:
    """Audio2Motion batch: ``mels`` [B, mel_len, M] cut or padded, and
    ``motion`` [B, video_len, out_dim] landmark-offset targets, a record's
    own ``motion`` (from video) when it has one, else the energy
    articulation pseudo-target of its padded mel
    (``models/face/audio2motion.py`` ``pseudo_motion_targets``), so the
    recipe trains on any binarized speech corpus."""
    from audiogpt_tpu_torch.models.face.audio2motion import \
        pseudo_motion_targets

    mels, motions = [], []
    for s in samples:
        m = np.asarray(s["mel"], np.float32)[:mel_len]
        m = np.pad(m, ((0, mel_len - m.shape[0]), (0, 0)))
        mels.append(m)
        if "motion" in s:
            mo = np.asarray(s["motion"], np.float32)[:video_len]
            mo = np.pad(mo, ((0, video_len - mo.shape[0]), (0, 0)))
        else:
            mo = pseudo_motion_targets(m, video_len)
        motions.append(mo[:, :out_dim])
    return {"mels": np.stack(mels), "motion": np.stack(motions),
            "weight": np.ones(len(samples), np.float32)}


class ArrayDataLoader:
    """Fixed-batch, fixed-shape loader for the non-bucketed recipes.

    One static shape per instance. The final short batch of an epoch pads
    with dummy rows (weight 0) so the shape never changes. Iterating
    (training) reshuffles per epoch forever; ``epoch(e)`` yields a single
    deterministic pass (validation). The permutation is keyed by (seed,
    epoch) with numpy's generator, as JAX's loader keys it."""

    def __init__(self, ds, collate: Callable[[list[dict]], dict],
                 batch_size: int, shuffle: bool = True, seed: int = 1234,
                 shard: int = 0, num_shards: int = 1):
        self.ds = ds
        self.collate = collate
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard, self.num_shards = shard, num_shards

    def _pad_batch(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        n = len(batch["weight"])
        if n == self.batch_size:
            return batch
        pad = self.batch_size - n
        out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
               for k, v in batch.items()}
        out["weight"][n:] = 0.0
        return out

    def epoch(self, epoch: int) -> Iterator[dict[str, np.ndarray]]:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        idx = idx[self.shard::self.num_shards]
        for i in range(0, len(idx), self.batch_size):
            chunk = [self.ds[int(j)] for j in idx[i: i + self.batch_size]]
            yield self._pad_batch(self.collate(chunk))

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1


# ---------------------------------------------------------------------------
# The TTS recipes' token-budget loader and the vocoder's random crops
# ---------------------------------------------------------------------------

def collate_tts(samples: list[dict[str, Any]], spec: BucketSpec | None,
                wav_hop: int | None = None) -> dict[str, np.ndarray]:
    """Pad a list of binarized TTS records into one static-shape batch.

    Emits the reference's batch schema (``dataset_utils.py`` collater):
    txt_tokens, txt_lengths, mels, mel_lengths, (f0, uv, pitch, mel2ph,
    mel2word, energy, the SVS score fields ``pitch_midi`` / ``midi_dur`` /
    ``is_slur`` on the token axis, the word fields and graph, the emotion
    id, the style vectors, the linear ``spec`` on the mel's frame axis,
    cwt_spec when present), spk_ids, plus ``weight`` [B] marking real rows.
    ``wav_hop`` also emits the sample-level ``wav``, cut or padded to
    ``mel_len · wav_hop`` (the end-to-end VISinger recipe). The JAX
    signature's ``n_mels`` is unused there and left out.
    """
    tok_len = max(len(s["tokens"]) for s in samples)
    mel_len = max(s["mel"].shape[0] for s in samples)
    bsz = len(samples)
    if spec is not None:
        tok_len = spec.round_len(tok_len)
        mel_len = spec.round_len(mel_len)
        bsz = spec.round_batch(bsz)

    def pad_rows(x: np.ndarray) -> np.ndarray:
        if x.shape[0] == bsz:
            return x
        if x.shape[0] > bsz:
            raise ValueError(
                f"batch of {x.shape[0]} exceeds the largest batch bucket "
                f"{bsz}; raise BucketSpec.max_batch or cap max_sentences")
        pad = np.zeros((bsz - x.shape[0],) + x.shape[1:], x.dtype)
        return np.concatenate([x, pad], axis=0)

    batch = {
        "txt_tokens": pad_rows(collate_1d([s["tokens"] for s in samples],
                                          max_len=tok_len)),
        "txt_lengths": pad_rows(np.asarray([len(s["tokens"])
                                            for s in samples], np.int32)),
        "mels": pad_rows(collate_2d([s["mel"] for s in samples],
                                    max_len=mel_len)),
        "mel_lengths": pad_rows(np.asarray([s["mel"].shape[0]
                                            for s in samples], np.int32)),
        "spk_ids": pad_rows(np.asarray([s.get("spk_id", 0) for s in samples],
                                       np.int32)),
        "weight": pad_rows(np.ones(len(samples), np.float32)),
    }
    for key in ("f0", "uv", "pitch", "mel2ph", "mel2word", "energy"):
        if key in samples[0]:
            dtype = np.int32 if key in ("pitch", "mel2ph", "mel2word") \
                else np.float32
            batch[key] = pad_rows(collate_1d(
                [np.asarray(s[key], dtype) for s in samples], max_len=mel_len))
    for key in ("pitch_midi", "midi_dur", "is_slur"):
        # token-level SVS score fields (diffsinger_task.py batch schema)
        if key in samples[0]:
            dtype = np.float32 if key == "midi_dur" else np.int32
            batch[key] = pad_rows(collate_1d(
                [np.asarray(s[key], dtype) for s in samples],
                max_len=tok_len))
    if "word_tokens" in samples[0]:
        # word-level fields for PortaSpeech-class models; word length gets
        # its own (small) bucketed axis
        word_len = max(len(s["word_tokens"]) for s in samples)
        if spec is not None:
            word_len = spec.round_len(word_len)
        batch["word_tokens"] = pad_rows(collate_1d(
            [s["word_tokens"] for s in samples], max_len=word_len))
        batch["word_lengths"] = pad_rows(np.asarray(
            [len(s["word_tokens"]) for s in samples], np.int32))
        batch["ph2word"] = pad_rows(collate_1d(
            [np.asarray(s["ph2word"], np.int32) for s in samples],
            max_len=tok_len))
        if "graph_adj" in samples[0]:
            adjs = []
            for s in samples:
                a = np.asarray(s["graph_adj"], np.float32)
                pad_w = word_len - a.shape[1]
                adjs.append(np.pad(a, ((0, 0), (0, pad_w), (0, pad_w))))
            batch["graph_adj"] = pad_rows(np.stack(adjs))
    if "emo_id" in samples[0]:
        # categorical emotion label (EmotionBinarizer, the reference's
        # base_binarizer_emotion.py emo_map)
        batch["emo_ids"] = pad_rows(np.asarray(
            [s["emo_id"] for s in samples], np.int32))
    for key in ("spk_embed", "emo_embed"):
        # fixed-size style vectors (with_style_embed binarization)
        if key in samples[0]:
            batch[key] = pad_rows(np.stack(
                [np.asarray(s[key], np.float32) for s in samples]))
    if "spec" in samples[0]:
        # linear spectrogram frames (the VISinger posterior's input), on
        # the mel's frame axis
        batch["spec"] = pad_rows(collate_2d(
            [np.asarray(s["spec"], np.float32) for s in samples],
            max_len=mel_len))
    if wav_hop is not None and "wav" in samples[0]:
        n = mel_len * wav_hop
        wavs = []
        for s in samples:
            w = np.asarray(s["wav"], np.float32)[:n]
            wavs.append(np.pad(w, (0, n - len(w))))
        batch["wav"] = pad_rows(np.stack(wavs))
    if "cwt_spec" in samples[0]:
        batch["cwt_spec"] = pad_rows(collate_2d(
            [s["cwt_spec"] for s in samples], max_len=mel_len))
        batch["f0_mean"] = pad_rows(np.asarray(
            [s.get("f0_mean", 0.0) for s in samples], np.float32))
        batch["f0_std"] = pad_rows(np.asarray(
            [s.get("f0_std", 1.0) for s in samples], np.float32))
    return batch


class TTSDataLoader:
    """Token-budget batches over a RecordDataset, reshuffled every epoch.

    ``sizes`` (each record's ``len``, the binarizer's ``{split}_lengths.npy``)
    spares reading every record to learn it. ``collate_fn(samples, spec)``
    replaces :func:`collate_tts` (VISinger's binds ``wav_hop``)."""

    def __init__(self, ds, max_tokens: int = 30000,
                 max_sentences: int = 100, spec: BucketSpec | None = None,
                 sizes: Sequence[int] | None = None,
                 shuffle: bool = True, seed: int = 1234,
                 collate_fn: Callable[..., dict] | None = None):
        self.ds = ds
        self.collate_fn = collate_fn or collate_tts
        self.spec = spec
        self.max_tokens = max_tokens
        if spec is not None:
            # a batch can never exceed the largest batch bucket, else the
            # static-shape pad would be negative
            max_sentences = min(max_sentences, spec.batch_buckets[-1])
        self.max_sentences = max_sentences
        self.shuffle = shuffle
        self.seed = seed
        if sizes is None:
            sizes = [ds[i]["len"] for i in range(len(ds))]
        self.sizes = np.asarray(sizes, np.int64)
        if len(self.sizes) != len(ds):
            raise ValueError(f"{len(self.sizes)} sizes for {len(ds)} records")

    def batches_for_epoch(self, epoch: int) -> list[list[int]]:
        idx = ordered_indices(self.sizes, shuffle=self.shuffle,
                              seed=(self.seed, epoch) if self.shuffle
                              else None)
        batches = batch_by_size(
            idx, lambda i: int(self.sizes[i]), self.max_tokens,
            self.max_sentences)
        if not self.shuffle:
            return batches
        order = np.random.default_rng((self.seed, epoch, 7)).permutation(
            len(batches))
        return [batches[i] for i in order]

    def epoch(self, epoch: int) -> Iterator[dict[str, np.ndarray]]:
        for b in self.batches_for_epoch(epoch):
            yield self.collate_fn([self.ds[i] for i in b], self.spec)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        e = 0
        while True:
            yield from self.epoch(e)
            e += 1


def prefetch(it: Iterator[Any], depth: int = 2) -> Iterator[Any]:
    """Run ``it`` in a daemon thread, keeping ``depth`` items ready."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()

    def worker():
        try:
            for x in it:
                q.put(x)
        finally:
            q.put(done)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        x = q.get()
        if x is done:
            return
        yield x


def collate_vocoder(samples: list[dict], segment_frames: int, hop: int,
                    rng: np.random.Generator | None = None
                    ) -> dict[str, np.ndarray]:
    """Random aligned (mel window, wav segment) crops for GAN vocoder
    training (the reference's ``VocoderDataset`` crop,
    ``tasks/vocoder/dataset_utils.py``). Records need ``mel`` and ``wav``
    (binarize with ``with_wav=True``). Short items pad with zeros; one
    ``rng.integers`` draw per item longer than the crop, in order."""
    rng = rng or np.random.default_rng()
    mels, wavs = [], []
    for s in samples:
        mel = np.asarray(s["mel"], np.float32)
        wav = np.asarray(s["wav"], np.float32)
        frames = mel.shape[0]
        if frames <= segment_frames:
            pad = segment_frames - frames
            mel = np.pad(mel, ((0, pad), (0, 0)))
            wav = np.pad(wav, (0, segment_frames * hop - len(wav)))[
                : segment_frames * hop]
        else:
            start = int(rng.integers(0, frames - segment_frames + 1))
            mel = mel[start: start + segment_frames]
            w0 = start * hop
            wav = np.pad(wav, (0, max(0, w0 + segment_frames * hop
                                      - len(wav))))[w0: w0 + segment_frames
                                                    * hop]
        mels.append(mel)
        wavs.append(wav)
    return {"mels": np.stack(mels), "wav": np.stack(wavs),
            "weight": np.ones(len(samples), np.float32)}


class VocoderDataLoader:
    """Endless random-crop batches for GAN vocoder training: one fixed
    shape, [batch_size, segment_frames, n_mels] mels and
    [batch_size, segment_frames · hop] wavs."""

    def __init__(self, ds, segment_frames: int, hop: int, batch_size: int,
                 seed: int = 0):
        self.ds = ds
        self.segment_frames = segment_frames
        self.hop = hop
        self.batch_size = batch_size
        self.sampler = EndlessSampler(len(ds), seed=seed)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        it = iter(self.sampler)
        while True:
            idx = [next(it) for _ in range(self.batch_size)]
            yield collate_vocoder([self.ds[i] for i in idx],
                                  self.segment_frames, self.hop, self.rng)
