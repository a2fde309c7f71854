"""Singing-voice synthesis engines: DiffSinger + vocoder (``SVSEngine``)
and VISinger (``VISingerEngine``), on opencpop-style scores.

Counterpart of ``audiogpt_tpu/engines/svs.py:25-260``, the agent's
"Generate Singing Voice From User Input Text, Note and Duration Sequence"
tool (the reference's ``T2S``, ``audio-chatgpt.py:298-340`` →
``base_svs_infer.py:71-155``). A score is word-level: space-separated
pinyin (or romanized) syllables, '|'-separated note and duration windows
a word. Syllables split into initial and final (``text/zh.py``); a
user-supplied ``pinyin2phs`` table takes precedence; ``SP`` / ``AP`` /
``rest`` are the silence and breath marks. Extra notes in a window repeat
the word's last phone as slurs. As in JAX, every phone of a word carries
the word's whole duration (``parse_score``).

The score's phones, MIDI notes, durations and slur flags are padded onto
a token bucket; the model runs on the device and only the trimmed output
comes to the host. Each engine draws from a ``torch.Generator`` seeded
with ``rng_seed`` (the JAX engines split a key per call); ``draws=``
replays given draws.
"""

from __future__ import annotations

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
from audiogpt_tpu_torch.models.svs import (
    DiffSinger,
    DiffSingerConfig,
    VISinger,
    VISingerConfig,
)
from audiogpt_tpu_torch.models.tts.pitch_extractor import PitchExtractor
from audiogpt_tpu_torch.registry import ENGINES
from audiogpt_tpu_torch.text.encoder import TokenTextEncoder
from audiogpt_tpu_torch.text.zh import INITIALS, split_pinyin

_NOTE_OFFSET = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


def note_to_midi(name: str) -> int:
    """'C#4/Db4' → 61; 'rest' → 0 (librosa.note_to_midi semantics)."""
    name = name.split("/")[0].strip()
    m = re.match(r"^([A-Ga-g])([#b♯♭]*)(-?\d+)$", name)
    if not m:
        return 0
    letter, accidental, octave = m.groups()
    midi = _NOTE_OFFSET[letter.upper()] + 12 * (int(octave) + 1)
    for a in accidental:
        midi += 1 if a in "#♯" else -1
    return midi


def _default_svs_vocab() -> list[str]:
    """opencpop-style pinyin initial/final phone set + specials."""
    finals = ["a", "o", "e", "i", "u", "v", "ai", "ei", "ao", "ou",
              "an", "en", "ang", "eng", "ong", "er", "ia", "iao",
              "ian", "iang", "ie", "in", "ing", "iong", "iu", "ua",
              "uai", "uan", "uang", "ui", "un", "uo", "ve", "vn"]
    return sorted(set(INITIALS + finals + ["<AP>", "<SP>", "rest"]))


def parse_score(text: str, notes: str, notes_duration: str,
                pinyin2phs: dict[str, str] | None = None):
    """Word-level opencpop score → per-phone (phones, notes, durations,
    slur flags, phone → word) (``base_svs_infer.py:72-140``). Raises
    ``ValueError`` when the word, note and duration windows differ in
    number."""
    pinyin2phs = pinyin2phs or {}
    words = [w for w in re.split(r"[\s]+", text.strip()) if w]
    ph_per_word = []
    specials = {"SP": "<SP>", "AP": "<AP>", "rest": "rest"}
    for w in words:
        if w in pinyin2phs:
            ph_per_word.append(pinyin2phs[w])
        elif w in specials:
            # breath/silence marks in opencpop scores (base_svs_infer)
            ph_per_word.append(specials[w])
        else:
            ph_per_word.append(" ".join(split_pinyin(w)))
    note_windows = [x.strip() for x in notes.split("|") if x.strip()]
    dur_windows = [x.strip() for x in notes_duration.split("|") if x.strip()]
    if not (len(note_windows) == len(ph_per_word) == len(dur_windows)):
        raise ValueError(
            f"word/note/duration window counts differ: "
            f"{len(ph_per_word)}/{len(note_windows)}/{len(dur_windows)}")
    phs, note_lst, dur_lst, slur, ph2word = [], [], [], [], []
    for i, word_phs in enumerate(ph_per_word):
        wp = word_phs.split()
        wn = note_windows[i].split()
        wd = dur_windows[i].split()
        for p in wp:
            phs.append(p)
            note_lst.append(wn[0])
            dur_lst.append(wd[0])
            slur.append(0)
            ph2word.append(i + 1)
        for j in range(1, len(wn)):  # slur: repeat the final
            phs.append(wp[-1])
            note_lst.append(wn[j])
            dur_lst.append(wd[j])
            slur.append(1)
            ph2word.append(i + 1)
    return phs, note_lst, dur_lst, slur, ph2word


def parse_word_level(text: str, notes: str, notes_duration: str,
                     pinyin2phs: dict[str, str] | None = None):
    """The score as the engines read it: (phones, notes, durations, slur
    flags)."""
    return parse_score(text, notes, notes_duration, pinyin2phs)[:4]


def score_tensors(engine, text: str, notes: str, notes_duration: str):
    """The engine's score inputs on its device, each ``[1, token bucket]``:
    phone ids, MIDI notes, durations in seconds and slur flags. A duration
    that is not a number raises ``ValueError``."""
    phs, note_lst, dur_lst, slur = parse_word_level(
        text, notes, notes_duration, engine.pinyin2phs)
    rows = (engine.phone_encoder.encode(phs),
            [note_to_midi(n) for n in note_lst],
            [float(d) for d in dur_lst], slur)
    out = []
    for row, dtype in zip(rows, (torch.long, torch.long, torch.float32,
                                 torch.long)):
        x = torch.tensor([row], dtype=dtype)
        out.append(engine.bucketer.pad_to_bucket(x, axis=1)[0].to(
            engine.device))
    return out


@ENGINES.register("svs")
class SVSEngine(ParamsEntry):
    name = "svs"

    def __init__(self, cfg: DiffSingerConfig | None = None, params=None,
                 vocoder: VocoderEngine | None = None,
                 phone_encoder: TokenTextEncoder | None = None,
                 pinyin2phs: dict[str, str] | None = None,
                 pitch_extractor: PitchExtractor | None = None,
                 pe_params=None, token_buckets=(32, 64, 128),
                 rng_seed: int = 0, pndm_speedup: int = 10,
                 device: str | torch.device | None = None):
        """``params``: the JAX engine's DiffSinger tree as numpy arrays
        (``None``: a seeded random init). ``vocoder`` defaults to
        ``VocoderEngine("hifigan")`` on the same device (the JAX engine
        returns the mel without one). ``pitch_extractor`` (with
        ``pe_params``, its JAX tree) gives an NSF vocoder its f0 when the
        model predicts none (the reference's ``pe_enable``).
        ``pndm_speedup`` > 1 samples by PLMS at that step, else DDPM.
        ``device=None`` is the card, and raises without one."""
        self.device = resolve_device(device)
        self.cfg = cfg or DiffSingerConfig()
        self.model = on_device(seeded(rng_seed,
                                      lambda: DiffSinger(self.cfg)),
                               self.device, params)
        self.pitch_extractor = None if pitch_extractor is None else \
            on_device(pitch_extractor, self.device, pe_params)
        self.pinyin2phs = pinyin2phs or {}
        self.pndm_speedup = pndm_speedup
        self.phone_encoder = phone_encoder or TokenTextEncoder(
            _default_svs_vocab())
        self.vocoder = vocoder or VocoderEngine("hifigan",
                                                device=self.device)
        if self.vocoder.device != self.device:
            raise ValueError(f"vocoder on {self.vocoder.device}, engine on "
                             f"{self.device}")
        self.bucketer = Bucketer(token_buckets)
        self._gen = torch.Generator(self.device).manual_seed(rng_seed)

    @property
    def sample_rate(self) -> int:
        """The vocoder's rate."""
        return self.vocoder.cfg.sample_rate

    @torch.inference_mode()
    def synthesize_mel(self, text: str, notes: str, notes_duration: str,
                       draws=None) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Score → (mel [frames, n_mels], f0 [frames] or None) on the
        device, trimmed after the last frame with a phone (at least 1).
        The f0 comes from the model, else from the pitch extractor on the
        mel padded onto the vocoder's bucket."""
        toks, midi, dur, slur = score_tensors(self, text, notes,
                                              notes_duration)
        out = self.model(toks, pitch_midi=midi, midi_dur=dur, is_slur=slur,
                         draws=self._gen if draws is None else draws,
                         pndm_speedup=self.pndm_speedup)
        valid = torch.nonzero(out["mel2ph"][0] > 0)
        n = int(valid[-1]) + 1 if len(valid) else 1
        mel = out["mel_out"][0, :n]
        f0 = out["f0_denorm"]
        if f0 is not None:
            f0 = f0[0, :n]
        elif self.pitch_extractor is not None:
            vb = self.vocoder.bucketer
            mb = mel[None]
            if n <= max(vb.buckets):
                mb, _ = vb.pad_to_bucket(mb, axis=1)
            f0 = self.pitch_extractor(mb)["f0_denorm_pred"][0, :n]
        return mel, f0

    def synthesize(self, text: str, notes: str, notes_duration: str,
                   draws=None) -> np.ndarray:
        """Score → float32 wav at ``sample_rate``."""
        mel, f0 = self.synthesize_mel(text, notes, notes_duration, draws)
        wav = self.vocoder.vocode(mel.T[None].contiguous(),
                                  None if f0 is None else f0[None])
        return wav[0].cpu().numpy()


@ENGINES.register("visinger")
class VISingerEngine(ParamsEntry):
    """VITS-class end-to-end SVS (the reference's ``t2s_VISinger`` tool,
    audio-chatgpt.py:341): the score surface of :class:`SVSEngine`, frames
    from the note durations, the wav straight from the model."""

    name = "visinger"

    def __init__(self, cfg: VISingerConfig | None = None, params=None,
                 phone_encoder: TokenTextEncoder | None = None,
                 pinyin2phs: dict[str, str] | None = None,
                 token_buckets=(32, 64, 128), rng_seed: int = 0,
                 sample_rate: int = 24000,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg or VISingerConfig()
        self.model = on_device(seeded(rng_seed, lambda: VISinger(self.cfg)),
                               self.device, params)
        self.pinyin2phs = pinyin2phs or {}
        self.phone_encoder = phone_encoder or TokenTextEncoder(
            _default_svs_vocab())
        self.bucketer = Bucketer(token_buckets)
        self.sample_rate = sample_rate
        self._gen = torch.Generator(self.device).manual_seed(rng_seed)

    @property
    def frames_per_sec(self) -> float:
        return self.sample_rate / self.cfg.decoder.hop_size

    @torch.inference_mode()
    def synthesize(self, text: str, notes: str, notes_duration: str,
                   draws=None) -> np.ndarray:
        """Score → float32 wav at ``sample_rate``, the frames with a phone
        only. ``draws``: the prior's noise [1, max_frames, latent]."""
        toks, midi, dur, slur = score_tensors(self, text, notes,
                                              notes_duration)
        out = self.model(toks, midi, slur, note_durs=dur,
                         frames_per_sec=self.frames_per_sec,
                         draws=self._gen if draws is None else draws)
        n = int((out["mel2ph"][0] > 0).sum())
        return out["wav"][0, :n * self.cfg.decoder.hop_size].cpu().numpy()
