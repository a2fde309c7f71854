"""Analysis engines: the audio captioner, sound-event detection (PANN, or
the PVT net), target-sound detection and the image captioner — the
agent's "Generate Text From The Audio", "Detect The Sound Event From The
Audio", "Target Sound Detection" and "Get Photo Description" tools.

Counterpart of ``audiogpt_tpu/engines/analysis.py:39-296``
(``CaptionEngine``, ``SEDEngine``, ``TSDEngine``, ``ImageCaptionEngine``;
the reference's ``A2T``, ``SoundDetection``, ``TargetSoundDetection`` and
``ImageCaptioning``, ``audio-chatgpt.py:578, 612, 775, 126``). Audio is
padded to a dyadic ladder of lengths (``Bucketer``), as in JAX. Weights are
the JAX param trees (numpy) through ``load_jax_params``, or a seeded random
init. ``SEDEngine.plot`` draws the JAX figure's two panels with PIL.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from audiogpt_tpu_torch.dsp.mel import MelSpec, log_mel
from audiogpt_tpu_torch.dsp.stft import stft
from audiogpt_tpu_torch.engines.base import (Bucketer, ParamsEntry,
                                             TimedCalls,
                                             on_device, resolve_device,
                                             seeded)
from audiogpt_tpu_torch.models.caption.blip import (BlipCaptioner,
                                                    BlipConfig,
                                                    greedy_caption,
                                                    preprocess_image)
from audiogpt_tpu_torch.models.caption.captioner import (
    CaptionConfig, CaptionModel, caption_beam_decode, caption_greedy_decode)
from audiogpt_tpu_torch.models.sed.panns_sed import (SEDConfig, SEDModel,
                                                     audioset_labels,
                                                     detect_events)
from audiogpt_tpu_torch.models.sed.tsd import (TSDConfig, TSDModel,
                                               decode_timestamps,
                                               median_filter)
from audiogpt_tpu_torch.models.textenc.clap import (CLAPTextConfig,
                                                    CLAPTextEncoder,
                                                    WordPieceTokenizer)
from audiogpt_tpu_torch.registry import ENGINES
from audiogpt_tpu_torch.utils.media import resolve_media


@ENGINES.register("caption")
class CaptionEngine(ParamsEntry, TimedCalls):
    """wav (32 kHz) → caption string. ``vocab``: the id → word list; without
    one, ids render as ``<id>``."""

    name = "caption"

    def __init__(self, cfg: CaptionConfig | None = None, params=None,
                 vocab: list[str] | None = None, rng_seed: int = 0,
                 max_sec: float = 32.0,
                 device: str | torch.device | None = None):
        """``params``: the JAX captioner's variables (``params`` and
        ``batch_stats``) as numpy arrays; ``None`` keeps a seeded random
        init. ``device=None`` is the card, and raises without one."""
        self.device = resolve_device(device)
        self.cfg = cfg or CaptionConfig()
        self.model = on_device(seeded(rng_seed, lambda: CaptionModel(
            self.cfg)), self.device, params)
        self.vocab = vocab
        self.sr = 32000
        self.bucketer = Bucketer(Bucketer.ladder(self.sr * 2,
                                                 int(self.sr * max_sec)))
        self._timings: dict[str, float] = {}

    def _padded(self, wav: np.ndarray):
        x = torch.from_numpy(np.asarray(wav, np.float32)[None])
        padded, n = self.bucketer.pad_to_bucket(x.to(self.device))
        return padded, torch.tensor([n], device=self.device)

    def caption_tokens(self, wav: np.ndarray) -> np.ndarray:
        """Greedy ids [max_caption_len]."""
        return caption_greedy_decode(self.model,
                                     *self._padded(wav))[0].cpu().numpy()

    def _decode_words(self, toks) -> str:
        words = []
        for t in toks[1:]:
            if t == self.cfg.eos_id:
                break
            words.append(self.vocab[t] if self.vocab and t < len(self.vocab)
                         else f"<{t}>")
        return " ".join(words)

    def caption(self, wav: np.ndarray) -> str:
        return self._timed(self.name, lambda: self._decode_words(
            self.caption_tokens(wav)))

    def caption_beam(self, wav: np.ndarray, beam_size: int = 3) -> str:
        """Beam-search caption (the reference A2T configs decode with beam,
        ``base_model.py``)."""
        def run():
            toks = caption_beam_decode(self.model, *self._padded(wav),
                                       beam_size=beam_size)
            return self._decode_words(toks[0].cpu().numpy())

        return self._timed(self.name, run)


@ENGINES.register("sed")
class SEDEngine(ParamsEntry, TimedCalls):
    """wav (32 kHz) → AudioSet framewise events (and the top-k summary or
    its figure)."""

    name = "sed"

    def __init__(self, cfg: SEDConfig | None = None, params=None,
                 model: torch.nn.Module | None = None, rng_seed: int = 0,
                 max_sec: float = 32.0,
                 device: str | torch.device | None = None):
        """``model`` overrides the net (``PVTSED``: the reference's actual
        SoundDetection net); the default is PANN-SED. Both take (wav,
        wav_len) and return the same dict. ``params``: the JAX model's
        variables as numpy arrays. ``device=None`` is the card."""
        self.device = resolve_device(device)
        if model is not None:
            self.cfg = model.cfg
        else:
            self.cfg = cfg or SEDConfig()
            model = seeded(rng_seed, lambda: SEDModel(self.cfg))
        self.model = on_device(model, self.device, params)
        sr = self.cfg.sample_rate
        self.bucketer = Bucketer(Bucketer.ladder(sr * 2, int(sr * max_sec)))
        self._timings: dict[str, float] = {}

    @torch.inference_mode()
    def framewise(self, wav: np.ndarray) -> np.ndarray:
        """→ [ceil(len / hop), classes] per-frame probabilities."""
        x = torch.from_numpy(np.asarray(wav, np.float32)[None])
        padded, n = self.bucketer.pad_to_bucket(x.to(self.device))
        out = self.model(padded, torch.tensor([n], device=self.device))
        frames = math.ceil(n / self.cfg.hop)
        return out["framewise_output"][0, :frames].cpu().numpy()

    def detect(self, wav: np.ndarray, top_k: int = 10):
        def run():
            fps = self.cfg.sample_rate / self.cfg.hop
            return detect_events(self.framewise(wav), audioset_labels(),
                                 top_k=top_k, frames_per_second=fps)

        return self._timed(self.name, run)

    def plot_panels(self, wav: np.ndarray, top_k: int = 10) -> dict:
        """The figure's data: ``spec`` the log magnitude spectrogram [F, T]
        of ``stft(wav, 1024, hop)``, ``order`` the top-k classes by peak,
        ``labels`` their names, ``matrix`` their framewise curves [T, k]
        and ``fps`` the frames a second."""
        wav = np.asarray(wav, np.float32)
        fw = self.framewise(wav)
        names = audioset_labels()
        order = np.argsort(fw.max(axis=0))[::-1][:top_k]
        with torch.inference_mode():
            spec = stft(torch.from_numpy(wav).to(self.device), 1024,
                        self.cfg.hop).abs().cpu().numpy().T
        return {"spec": np.log(np.maximum(spec, 1e-8)), "order": order,
                "labels": [names[i] if i < len(names) else str(i)
                           for i in order],
                "matrix": fw[:, order],
                "fps": self.cfg.sample_rate / self.cfg.hop}

    def plot(self, wav: np.ndarray, out_path: str, top_k: int = 10) -> str:
        """Two-panel figure, written to ``out_path`` (returned): the log
        spectrogram and the top-k framewise event matrix with one tick a
        second — the reference tool's artifact (audio-chatgpt.py:655-673),
        drawn with PIL."""
        def run():
            render_sed_figure(self.plot_panels(wav, top_k), out_path)
            return out_path

        return self._timed(self.name, run)


def _jet(x: np.ndarray) -> np.ndarray:
    """Values in [0, 1] → uint8 RGB in the jet colormap."""
    x = np.clip(x, 0.0, 1.0)[..., None]
    rgb = np.clip(1.5 - np.abs(4.0 * x - np.array([3.0, 2.0, 1.0])), 0, 1)
    return (255 * rgb).astype(np.uint8)


def render_sed_figure(panels: dict, out_path: str, width: int = 1000,
                      height: int = 400) -> None:
    """Draw :meth:`SEDEngine.plot_panels` as a PNG: the spectrogram (low
    frequencies at the bottom, scaled to its own range) above the event
    matrix (one row a class, [0, 1]), a shared time axis in seconds."""
    from PIL import Image, ImageDraw

    spec, mat, fps = panels["spec"], panels["matrix"], panels["fps"]
    left, right, top, gap, bottom = 230, 20, 24, 28, 40
    pw = width - left - right
    ph = (height - top - gap - bottom) // 2
    img = Image.new("RGB", (width, height), "white")
    draw = ImageDraw.Draw(img)
    lo, hi = float(spec.min()), float(spec.max())
    top_panel = _jet((spec[::-1] - lo) / max(hi - lo, 1e-12))
    img.paste(Image.fromarray(top_panel).resize((pw, ph), Image.NEAREST),
              (left, top))
    y1 = top + ph + gap
    img.paste(Image.fromarray(_jet(mat.T)).resize((pw, ph), Image.NEAREST),
              (left, y1))
    draw.text((left, 6), "Log spectrogram", fill="black")
    draw.text((8, top + ph // 2), "Frequency bins", fill="black")
    k = len(panels["labels"])
    for i, label in enumerate(panels["labels"]):
        y = y1 + int((i + 0.5) * ph / max(k, 1))
        draw.text((8, y - 6), label[:34], fill="black")
        draw.line([(left, y), (left + pw, y)], fill=(0, 0, 0))
    frames = spec.shape[-1]
    for sec, f in enumerate(range(0, frames, max(int(fps), 1))):
        x = left + int(f * pw / frames)
        draw.line([(x, y1 + ph), (x, y1 + ph + 5)], fill="black")
        draw.text((x - 3, y1 + ph + 8), str(sec), fill="black")
    draw.text((left + pw // 2 - 20, height - 16), "Seconds", fill="black")
    img.save(out_path)


@ENGINES.register("tsd")
class TSDEngine(ParamsEntry, TimedCalls):
    """(wav, text query) → on/offset seconds of the described sound. The
    query embeds through the CLAP text tower's CLS projection, cut to the
    TSD net's conditioning width (no reference embedding file needed)."""

    name = "tsd"

    def __init__(self, cfg: TSDConfig | None = None,
                 clap_cfg: CLAPTextConfig | None = None,
                 params=None, clap_params=None, tokenizer=None,
                 rng_seed: int = 0, sample_rate: int = 22050,
                 mel: MelSpec | None = None, max_sec: float = 30.0,
                 device: str | torch.device | None = None):
        """``params`` / ``clap_params``: the JAX TSD net's variables and the
        CLAP text tower's params as numpy arrays. ``device=None`` is the
        card."""
        self.device = resolve_device(device)
        self.cfg = cfg or TSDConfig()
        self.clap_cfg = clap_cfg or CLAPTextConfig()
        self.model = on_device(seeded(rng_seed, lambda: TSDModel(self.cfg)),
                            self.device, params)
        self.clap = on_device(seeded(rng_seed + 1, lambda: CLAPTextEncoder(
            self.clap_cfg)), self.device, clap_params)
        self.tokenizer = tokenizer or WordPieceTokenizer(
            vocab_size=self.clap_cfg.bert.vocab_size)
        self.mel = mel or MelSpec(sample_rate, 1024, 256, 1024,
                                  self.cfg.mel_bins, 50.0, sample_rate / 2,
                                  power=1.0, log="log10")
        frames_cap = int(max_sec * sample_rate / self.mel.hop)
        self.bucketer = Bucketer(Bucketer.ladder(256, frames_cap))
        self._timings: dict[str, float] = {}

    @torch.inference_mode()
    def embed_text(self, text: str) -> torch.Tensor:
        """→ [1, embedding_dim] on the engine's device."""
        ids, mask = self.tokenizer.encode(text, self.clap_cfg.max_length)
        emb = self.clap.cls_embedding(
            torch.from_numpy(ids)[None].long().to(self.device),
            torch.from_numpy(mask)[None].to(self.device))
        return emb[..., : self.cfg.embedding_dim]

    @torch.inference_mode()
    def decision(self, wav: np.ndarray, text: str) -> np.ndarray:
        """→ the target's probability at each mel frame [frames]."""
        m = log_mel(torch.from_numpy(np.asarray(wav, np.float32))
                    .to(self.device), self.mel)              # [T, M]
        padded, frames = self.bucketer.pad_to_bucket(m[None], axis=1)
        _, up = self.model(padded, self.embed_text(text))
        return up[0, :frames, 0].cpu().numpy()

    def detect(self, wav: np.ndarray, text: str, threshold: float = 0.5,
               window: int = 7):
        def run():
            probs = self.decision(wav, text)
            filtered = median_filter(probs[:, None], window, threshold)[:, 0]
            return decode_timestamps(filtered, self.mel.sr / self.mel.hop)

        return self._timed(self.name, run)


@ENGINES.register("i2t")
class ImageCaptionEngine(ParamsEntry, TimedCalls):
    """Image → caption string with the BLIP captioner.

    ``vocab_path``: a BERT ``vocab.txt`` for the WordPiece decode; without
    one the bundled derived vocab loads where it fits the embedding table,
    else token ids render as ``<id>`` placeholders. A relative image path is
    read under ``media_root`` (the server points it at its own), so the path
    the T2I tool returns can be described; a path that resolves outside the
    root raises ``ValueError`` (``utils/media.py``)."""

    name = "i2t"

    def __init__(self, cfg: BlipConfig | None = None, params=None,
                 vocab_path: str | None = None, rng_seed: int = 0,
                 max_tokens: int = 24, media_root: str = ".",
                 device: str | torch.device | None = None):
        """``params``: the JAX captioner's param tree as numpy arrays;
        ``None`` keeps a seeded random init. ``device=None`` is the card,
        and raises without one."""
        self.device = resolve_device(device)
        self.cfg = cfg or BlipConfig()
        self.model = on_device(seeded(rng_seed, lambda: BlipCaptioner(
            self.cfg)), self.device, params)
        self.max_tokens = max_tokens
        self.tokenizer = WordPieceTokenizer(
            vocab_path, vocab_size=self.cfg.text.vocab_size)
        self.media_root = media_root
        self._timings: dict[str, float] = {}

    def caption_tokens(self, images: np.ndarray) -> np.ndarray:
        """BLIP-normalised images [B, S, S, 3] → tokens
        [B, 1 + max_tokens]."""
        x = torch.from_numpy(np.asarray(images, np.float32)).to(self.device)
        return greedy_caption(self.model, x, self.max_tokens).cpu().numpy()

    def caption_image(self, image) -> str:
        """Image path or array → caption text: the tokens after BOS up to
        the first EOS."""
        if isinstance(image, str):
            image = resolve_media(image, self.media_root)
        px = preprocess_image(image, self.cfg.vision.image_size)
        body = self.caption_tokens(px)[0, 1:]
        stop = np.flatnonzero(body == self.cfg.text.eos_id)
        if len(stop):
            body = body[: stop[0]]
        return self.tokenizer.decode(body)

    def __call__(self, image_path: str) -> str:
        return self._timed(self.name, lambda: self.caption_image(image_path))

    def warmup(self) -> None:
        s = self.cfg.vision.image_size
        self.caption_tokens(np.zeros((1, s, s, 3), np.float32))
