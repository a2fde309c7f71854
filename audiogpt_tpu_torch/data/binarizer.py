"""Dataset binarization for TTS training, and opening a binarized split.

Counterpart of ``audiogpt_tpu/data/binarizer.py:34-290``, ``:352`` and
``:470`` (the reference's ``NeuralSeq/data_gen/tts/base_binarizer.py:22-220``):
metadata → per-item {phones, mel, f0, mel2ph alignment, speaker} → the
record store (``data/records.py``, the same bytes as the JAX package's)
with the ``phone_set.json`` / ``spk_map.json`` / ``*_lengths.npy`` /
``train_f0s_mean_std.npy`` sidecars.

The per-item mel and f0 run on the binarizer's device (``None``: the card)
through the port's DSP frontend (``dsp/mel.py``, ``dsp/f0.py``), as the JAX
package runs them on its device; the CWT targets, the energy and the word
fields are computed on the host in numpy, as there. Alignments are an
optional input: ``durations`` per item, or an MFA TextGrid
(``data/textgrid.py``). ``EmotionBinarizer`` (the GenerSpeech data
path) adds ``emo_map.json`` and each record's ``emo_id``;
``SVSBinarizer`` (the DiffSinger and VISinger data path) reads
opencpop-style scores into the MIDI fields and a score alignment;
``ZhBinarizer`` runs the Mandarin frontend (``text/zh.py``) and the
reference's two duration rules.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch

from audiogpt_tpu_torch.data.records import RecordDataset, RecordWriter
from audiogpt_tpu_torch.dsp.f0 import (continuous_lf0, cwt_lf0, estimate_f0,
                                       f0_to_coarse, norm_scale)
from audiogpt_tpu_torch.dsp.mel import NEURALSEQ_MEL_22K, MelSpec, log_mel
from audiogpt_tpu_torch.engines.base import resolve_device, seeded
from audiogpt_tpu_torch.text.encoder import TokenTextEncoder
from audiogpt_tpu_torch.text.frontend import EnglishFrontend


@dataclasses.dataclass(frozen=True)
class BinarizeConfig:
    mel: MelSpec = NEURALSEQ_MEL_22K
    with_f0: bool = True
    with_f0cwt: bool = False
    with_energy: bool = False
    with_wav: bool = False
    #: store 256-d speaker + emotion embeddings from the global style
    #: encoder (the reference's emotion binarizer runs external
    #: resemblyzer / emotion-encoder ckpts — data_gen/tts/emotion/)
    with_style_embed: bool = False
    #: store word-level fields (word_tokens/ph2word/mel2word) for
    #: PortaSpeech-class word-duration models (reference: word_set.json +
    #: ph2word in base_binarizer, tasks/tts/ps.py:21)
    with_words: bool = False
    #: additionally store the dense syntactic word graph [E, W, W] for
    #: SyntaSpeech (reference: Sentence2GraphParser at binarize time)
    with_graph: bool = False
    #: ordered wav pre-processor names applied before mel/f0 extraction
    #: (``data/wav_processors.py``). Input wavs are assumed to be at
    #: ``mel.sr`` unless 'resample' is included.
    wav_processors: tuple = ()
    f0_fmin: float = 80.0
    f0_fmax: float = 750.0
    valid_fraction: float = 0.05
    test_items: int = 0
    min_sec: float = 0.0
    max_sec: float = 60.0


@dataclasses.dataclass
class Item:
    """One utterance of raw input. ``text`` OR pre-phonemized ``phones`` must
    be given; ``durations`` (frames per phone) is the optional alignment."""

    name: str
    wav: np.ndarray            # [T] float32 at cfg.mel.sr
    text: str | None = None
    phones: Sequence[str] | None = None
    spk: str = "SPK1"
    durations: Sequence[int] | None = None
    #: MFA TextGrid — a path or the raw file text (reference
    #: base_binarizer.py:188 get_align); used when ``durations`` is absent
    textgrid: str | None = None
    #: emotion tag (the reference's ``EmotionBinarizer.item2emo`` default)
    emotion: str = "Neutral"


def mel2ph_from_durations(durations: Sequence[int],
                          n_frames: int) -> np.ndarray:
    """Per-frame phone index (1-based; 0 = padding), the reference's
    ``mel2ph`` encoding (``data_gen_utils.get_mel2ph``)."""
    out = np.zeros(n_frames, np.int32)
    t = 0
    for i, d in enumerate(durations, start=1):
        out[t:t + int(d)] = i
        t += int(d)
    return out


class TTSBinarizer:
    """Drive with ``binarize(items, out_dir)``; reload shards with
    :func:`load_split`.

    ``with_style_embed`` runs the port's ``GlobalStyleEncoder``
    (``models/tts/generspeech.py``), built for ``cfg.mel.n_mels``;
    ``style_params`` (a JAX param tree of numpy leaves) is loaded into it
    when given. Without it, the encoder's weights are a seeded torch init,
    which differs from the JAX binarizer's default (flax's init from
    ``PRNGKey(0)``): pass JAX's params across to get its embeddings."""

    def __init__(self, cfg: BinarizeConfig | None = None,
                 frontend: EnglishFrontend | None = None,
                 style_params: Mapping | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg or BinarizeConfig()
        self.frontend = frontend or EnglishFrontend()
        self.device = resolve_device(device)
        self._word_encoder: TokenTextEncoder | None = None
        self._style = None
        if self.cfg.with_style_embed:
            from audiogpt_tpu_torch.models.tts.generspeech import (
                GlobalStyleEncoder)
            from audiogpt_tpu_torch.utils.jax_params import load_jax_params

            enc = seeded(0, lambda: GlobalStyleEncoder(self.cfg.mel.n_mels))
            if style_params is not None:
                load_jax_params(enc, style_params)
            self._style = enc.to(self.device).eval()

    # -- vocab ---------------------------------------------------------------
    def build_vocabs(self, items: Iterable[Item]
                     ) -> tuple[TokenTextEncoder, dict]:
        phones: set[str] = set()
        spks: set[str] = set()
        for it in items:
            phones.update(self._phones_of(it))
            spks.add(it.spk)
        enc = EnglishFrontend.build_phone_vocab(sorted(phones))
        spk_map = {s: i for i, s in enumerate(sorted(spks))}
        return enc, spk_map

    def _phones_of(self, it: Item) -> list[str]:
        if it.phones is not None:
            return list(it.phones)
        if it.text is None:
            raise ValueError(f"item {it.name}: need text or phones")
        return self.frontend(it.text).phones

    # -- per-item ------------------------------------------------------------
    def process_item(self, it: Item, enc: TokenTextEncoder,
                     spk_map: Mapping[str, int]) -> dict[str, Any] | None:
        cfg = self.cfg
        sec = len(it.wav) / cfg.mel.sr
        if not (cfg.min_sec <= sec <= cfg.max_sec):
            return None
        phones = self._phones_of(it)
        tokens = np.asarray(enc.encode(phones), np.int32)

        wav = np.asarray(it.wav, np.float32)
        if cfg.wav_processors:
            from audiogpt_tpu_torch.data.wav_processors import \
                apply_processors

            wav, _sr = apply_processors(
                cfg.wav_processors, wav, cfg.mel.sr,
                options={"resample": {"target_sr": cfg.mel.sr,
                                      "device": self.device}})
            wav = np.asarray(wav, np.float32)
        x = torch.from_numpy(wav).to(self.device)
        mel_dev = log_mel(x, cfg.mel)                          # [T, n_mels]
        mel = mel_dev.cpu().numpy()
        rec: dict[str, Any] = {
            "item_name": it.name,
            "txt": it.text or " ".join(phones),
            "ph": " ".join(phones),
            "tokens": tokens,
            "mel": mel.astype(np.float32),
            "spk_id": int(spk_map.get(it.spk, 0)),
            "len": int(mel.shape[0]),
            "sec": float(sec),
        }
        if cfg.with_f0:
            f0, _uv = estimate_f0(x, sr=cfg.mel.sr, hop=cfg.mel.hop,
                                  fmin=cfg.f0_fmin, fmax=cfg.f0_fmax)
            f0 = f0.cpu().numpy()[: mel.shape[0]]
            f0 = np.pad(f0, (0, mel.shape[0] - len(f0)))
            rec["f0"] = f0.astype(np.float32)
            rec["pitch"] = f0_to_coarse(f0)
            if cfg.with_f0cwt and (f0 > 0).any():
                uv_, lf0 = continuous_lf0(f0)
                lf0_norm = (lf0 - lf0[uv_ > 0].mean()) \
                    / max(lf0[uv_ > 0].std(), 1e-8)
                W, _scales = cwt_lf0(lf0_norm)
                Wn, _, _ = norm_scale(W)
                rec["cwt_spec"] = Wn.astype(np.float32)
                rec["f0_mean"] = float(lf0[uv_ > 0].mean())
                rec["f0_std"] = float(lf0[uv_ > 0].std())
        if cfg.with_energy:
            # frame energy = RMS of the linear-domain mel frame, the
            # quantity FastSpeech2's energy adaptor consumes; the log-mel
            # is log10, so linear = 10**mel
            rec["energy"] = np.sqrt(
                ((10.0 ** mel.astype(np.float64)) ** 2).mean(-1)
            ).astype(np.float32)
        if it.durations is not None:
            rec["mel2ph"] = mel2ph_from_durations(it.durations, mel.shape[0])
        elif it.textgrid is not None:
            from audiogpt_tpu_torch.data.textgrid import mel2ph_from_textgrid

            tg_text = it.textgrid
            if "\n" not in tg_text and os.path.exists(tg_text):
                with open(tg_text) as f:
                    tg_text = f.read()
            mel2ph, dur = mel2ph_from_textgrid(
                tg_text, phones, mel.shape[0], cfg.mel.sr, cfg.mel.hop)
            rec["mel2ph"] = mel2ph
            rec["dur"] = dur
        if cfg.with_wav:
            rec["wav"] = wav
        if self._style is not None:
            with torch.no_grad():
                spk_e, emo_e = self._style(mel_dev[None])
            rec["spk_embed"] = spk_e[0].cpu().numpy()
            rec["emo_embed"] = emo_e[0].cpu().numpy()
        if (cfg.with_words or cfg.with_graph) and it.text is not None \
                and self._word_encoder is not None:
            pt = self.frontend(it.text)
            words = list(pt.words)
            p2w = np.asarray(pt.ph2word, np.int32)
            if pt.phones and pt.phones[0] == "<BOS>":
                # the frontend maps <BOS>→word 0 and <EOS>→len(words)+1;
                # make them real words (the reference's word lists carry
                # <BOS>/<EOS> too, syntactic_graph_buider.py:33)
                words = ["<BOS>"] + words + ["<EOS>"]
                p2w = p2w + 1
            rec["word_tokens"] = np.asarray(
                self._word_encoder.encode(words), np.int32)
            rec["ph2word"] = p2w[: len(tokens)]
            if "mel2ph" in rec:
                ph2w = np.concatenate([[0], rec["ph2word"]])  # 0 = padding
                rec["mel2word"] = ph2w[rec["mel2ph"]].astype(np.int32)
            if cfg.with_graph:
                from audiogpt_tpu_torch.text.syntax import build_word_graph

                rec["graph_adj"] = build_word_graph(words)
        return rec

    # -- driver --------------------------------------------------------------
    def binarize(self, items: Sequence[Item], out_dir: str) -> dict[str, int]:
        """Split test / valid / train, write the records and sidecars;
        → the records written per split."""
        cfg = self.cfg
        os.makedirs(out_dir, exist_ok=True)
        enc, spk_map = self.build_vocabs(items)
        enc.save(os.path.join(out_dir, "phone_set.json"))
        with open(os.path.join(out_dir, "spk_map.json"), "w") as f:
            json.dump(spk_map, f)
        if cfg.with_words or cfg.with_graph:
            words: set[str] = {"<BOS>", "<EOS>"}
            for it in items:
                if it.text is not None:
                    words.update(self.frontend(it.text).words)
            self._word_encoder = TokenTextEncoder(sorted(words))
            self._word_encoder.save(os.path.join(out_dir, "word_set.json"))

        n_test = cfg.test_items
        n_valid = max(1, int(len(items) * cfg.valid_fraction)) \
            if len(items) > 1 else 0
        splits = {
            "test": items[:n_test],
            "valid": items[n_test:n_test + n_valid],
            "train": items[n_test + n_valid:],
        }
        counts = {}
        for split, split_items in splits.items():
            writer = RecordWriter(os.path.join(out_dir, split))
            lengths, f0s = [], []
            for it in split_items:
                rec = self.process_item(it, enc, spk_map)
                if rec is None:
                    continue
                writer.add(rec)
                lengths.append(rec["len"])
                if "f0" in rec:
                    f0s.append(rec["f0"])
            writer.finalize()
            counts[split] = len(lengths)
            np.save(os.path.join(out_dir, f"{split}_lengths.npy"),
                    np.asarray(lengths, np.int64))
            if f0s and split == "train":
                cat = np.concatenate(f0s)
                voiced = cat[cat > 0]
                stats = [float(voiced.mean()), float(voiced.std())] \
                    if voiced.size else [0.0, 1.0]
                np.save(os.path.join(out_dir, "train_f0s_mean_std.npy"),
                        np.asarray(stats))
        return counts


def load_split(out_dir: str, split: str) -> RecordDataset:
    """The ``split`` records (``train``, ``valid``, ...) under ``out_dir``."""
    return RecordDataset(os.path.join(out_dir, split))


def load_phone_encoder(out_dir: str) -> TokenTextEncoder:
    return TokenTextEncoder.from_file(os.path.join(out_dir, "phone_set.json"))


def load_word_encoder(out_dir: str) -> TokenTextEncoder:
    """Word vocab written by ``with_words``/``with_graph`` binarization
    (reference: ``word_set.json``, tasks/tts/ps.py:21)."""
    return TokenTextEncoder.from_file(os.path.join(out_dir, "word_set.json"))


class EmotionBinarizer(TTSBinarizer):
    """Emotion-tagged binarization, the GenerSpeech data path
    (``audiogpt_tpu/data/binarizer.py:358-396``; the reference's
    ``EmotionBinarizer``, ``data_gen/tts/base_binarizer_emotion.py:28``):
    a sorted ``emo_map.json`` maps each item's ``emotion`` (default
    "Neutral") to an id, stored as the record's ``emo_id`` beside the
    speaker id. The reference's two external embedding nets are the
    global style encoder here: ``with_style_embed`` (on by default) stores
    ``spk_embed`` / ``emo_embed``."""

    def __init__(self, cfg: BinarizeConfig | None = None, **kw):
        super().__init__(cfg or BinarizeConfig(with_style_embed=True), **kw)
        self._emo_map: dict[str, int] = {}

    def build_emo_map(self, items: Iterable[Item]) -> dict[str, int]:
        emos = sorted({it.emotion for it in items})
        return {e: i for i, e in enumerate(emos)}

    def process_item(self, it, enc, spk_map):
        rec = super().process_item(it, enc, spk_map)
        if rec is not None:
            rec["emo_id"] = int(self._emo_map.get(it.emotion, 0))
        return rec

    def binarize(self, items: Sequence[Item], out_dir: str) -> dict[str, int]:
        os.makedirs(out_dir, exist_ok=True)
        self._emo_map = self.build_emo_map(items)
        with open(os.path.join(out_dir, "emo_map.json"), "w") as f:
            json.dump(self._emo_map, f)
        return super().binarize(items, out_dir)


def load_emo_map(out_dir: str) -> dict[str, int]:
    with open(os.path.join(out_dir, "emo_map.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class SVSItem:
    """One scored singing utterance (opencpop transcription format:
    pinyin words, '|'-windowed note names and note durations in
    seconds)."""

    name: str
    wav: np.ndarray
    text: str                  # pinyin words, e.g. "xiao jiu wo SP"
    notes: str                 # "C#4/Db4 | F#4/Gb4 | rest"
    notes_duration: str        # "0.407 | 0.376 | 0.2"
    spk: str = "SPK1"


class SVSBinarizer(TTSBinarizer):
    """Score-annotated singing → records with the MIDI conditioning fields
    DiffSinger-MIDI trains on (``audiogpt_tpu/data/binarizer.py:291-349``;
    ``pitch_midi`` / ``midi_dur`` / ``is_slur`` are read at the reference's
    ``tasks/svs/diffsinger_task.py:30``), with the score grammar of the SVS
    engines (``engines/svs.py`` ``parse_score``, ``note_to_midi``).

    ``mel2ph`` comes from the score: each word's base note duration is
    split evenly over its non-slur phones, a slur repeat keeps its own
    note's duration, and a phone takes ``round(seconds · sr / hop)``
    frames (half to even, as ``np.round``)."""

    def _phones_of(self, it) -> list[str]:
        if not isinstance(it, SVSItem):     # the base Item of process_item
            return super()._phones_of(it)
        from audiogpt_tpu_torch.engines.svs import parse_score

        return parse_score(it.text, it.notes, it.notes_duration)[0]

    def process_item(self, it, enc: TokenTextEncoder,
                     spk_map: Mapping[str, int]) -> dict[str, Any] | None:
        from audiogpt_tpu_torch.engines.svs import note_to_midi, parse_score

        base = Item(name=it.name, wav=it.wav, phones=self._phones_of(it),
                    spk=it.spk)
        rec = super().process_item(base, enc, spk_map)
        if rec is None:
            return None
        _, notes, durs, slur, ph2word = parse_score(
            it.text, it.notes, it.notes_duration)
        rec["txt"] = it.text
        rec["pitch_midi"] = np.asarray([note_to_midi(n) for n in notes],
                                       np.int32)
        rec["midi_dur"] = np.asarray([float(d) for d in durs], np.float32)
        rec["is_slur"] = np.asarray(slur, np.int32)
        rec["ph2word"] = np.asarray(ph2word, np.int32)
        sec = np.asarray([float(d) for d in durs], np.float64)
        w = np.asarray(ph2word)
        s = np.asarray(slur)
        base_cnt = np.zeros(w.max() + 1, np.int64)
        np.add.at(base_cnt, w[s == 0], 1)
        share = np.where(s == 0, sec / np.maximum(base_cnt[w], 1), sec)
        frames = np.round(share * self.cfg.mel.sr /
                          self.cfg.mel.hop).astype(np.int64)
        rec["mel2ph"] = mel2ph_from_durations(frames, rec["mel"].shape[0])
        return rec


class ZhBinarizer(TTSBinarizer):
    """Mandarin binarization with the reference's duration post-processing
    (``audiogpt_tpu/data/binarizer.py:399-467``; the reference's
    ``data_gen/tts/binarizer_zh.py:12`` ``get_align``), applied in this
    order to an aligned item:

      1. a separator or punctuation phone gives its leading voiced frames
         (f0 > 0) to the preceding final, so a pause starts where voicing
         stops, and collapses into it entirely when fewer than
         :attr:`min_sep_frames` remain;
      2. an initial and its following final split their total evenly (the
         initial takes ``total // 2``).

    Phones come from ``text/zh.py`` ``ZhTTSFrontend``; the initials are its
    ``INITIALS`` (the reference's ``ALL_SHENMU``). An item without an
    alignment or an f0 track is written as the base binarizer writes it."""

    #: rule 1's collapse threshold in frames (the reference's hard 100)
    min_sep_frames: int = 100

    def __init__(self, cfg: BinarizeConfig | None = None, frontend=None,
                 **kw):
        if frontend is None:
            from audiogpt_tpu_torch.text.zh import ZhTTSFrontend

            frontend = ZhTTSFrontend()
        super().__init__(cfg, frontend=frontend, **kw)

    def _fix_durations(self, dur: np.ndarray, phones: Sequence[str],
                       f0: np.ndarray) -> np.ndarray:
        from audiogpt_tpu_torch.text.zh import INITIALS

        dur = np.asarray(dur, np.int64).copy()
        initials = set(INITIALS)
        ends = np.cumsum(dur)
        starts = ends - dur
        for i, p in enumerate(phones):
            if i == 0 or p[0] == "<" or p[0].isalnum():
                continue
            seg = f0[starts[i]:ends[i]]
            j = 0
            while j < len(seg) and seg[j] != 0:
                j += 1
            dur[i - 1] += j
            dur[i] -= j
            if dur[i] < self.min_sep_frames:
                dur[i - 1] += dur[i]
                dur[i] = 0
        for i, p in enumerate(phones[:-1]):
            if p in initials and dur[i] > 0:
                nxt = phones[i + 1]
                if nxt[0].isalpha() and nxt not in initials:
                    total = dur[i] + dur[i + 1]
                    dur[i] = total // 2
                    dur[i + 1] = total - dur[i]
        return dur

    def process_item(self, it, enc, spk_map):
        rec = super().process_item(it, enc, spk_map)
        if rec is None or "mel2ph" not in rec or "f0" not in rec:
            return rec
        phones = rec["ph"].split(" ")
        dur = rec.get("dur")
        if dur is None:
            dur = np.bincount(rec["mel2ph"],
                              minlength=len(phones) + 1)[1:len(phones) + 1]
        dur = self._fix_durations(np.asarray(dur), phones, rec["f0"])
        rec["dur"] = dur.astype(np.int32)
        rec["mel2ph"] = mel2ph_from_durations(dur, rec["mel"].shape[0])
        return rec


def items_from_csv(csv_path: str, wav_loader=None, sr: int = 22050,
                   textgrid_dir: str | None = None,
                   device: str | torch.device | None = None) -> list[Item]:
    """The reference's metadata layout → :class:`Item` list.

    ``metadata_phone.csv`` columns (base_binarizer_emotion.py:44-57):
    ``item_name, txt, ph, wav_fn[, spk_name][, others]`` where ``others``
    is the emotion tag; TextGrids live at ``{textgrid_dir}/{item}.TextGrid``.
    ``wav_loader(path) -> np.ndarray`` defaults to the port's wav reader,
    resampling to ``sr`` on ``device`` (``None``: the card).
    """
    import csv

    if wav_loader is None:
        from audiogpt_tpu_torch.utils.audio_io import load_wav

        def wav_loader(p):
            wav, _ = load_wav(p, sr=sr, device=device)
            return wav

    items: list[Item] = []
    with open(csv_path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            name = row["item_name"]
            tg = None
            if textgrid_dir is not None:
                cand = os.path.join(textgrid_dir, f"{name}.TextGrid")
                tg = cand if os.path.exists(cand) else None
            items.append(Item(
                name=name,
                wav=np.asarray(wav_loader(row["wav_fn"]), np.float32),
                text=row.get("txt") or None,
                phones=(row["ph"].split(" ") if row.get("ph") else None),
                spk=row.get("spk_name") or "SPK1",
                emotion=(row.get("others") or "Neutral").strip('"'),
                textgrid=tg))
    return items
