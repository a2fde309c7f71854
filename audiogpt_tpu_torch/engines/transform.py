"""Transform engines: language-queried extraction, speech enhancement and
separation, and mono → binaural rendering — the agent's "Extract Sound
Event From Mixture Audio Based On Language Description", "Speech
Enhancement In Single-Channel", "Speech Separation In Single-Channel" and
"Sythesize Binaural Audio From A Mono Audio Input" tools.

Counterpart of ``audiogpt_tpu/engines/transform.py:32-155`` (the
reference's ``SoundExtraction``, ``Speech_Enh_SS_SC`` / ``Speech_SS`` and
``Binaural``, ``audio-chatgpt.py:675, 957, 1009, 713``). Weights are the
JAX param trees (numpy) through ``load_jax_params``, or a seeded random
init. The JAX package's jitted-program caches have no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from audiogpt_tpu_torch.dsp.stft import istft, stft
from audiogpt_tpu_torch.engines.base import (Bucketer, ParamsEntry,
                                             TimedCalls,
                                             on_device, resolve_device,
                                             seeded)
from audiogpt_tpu_torch.models.binaural.binaural import (BinauralConfig,
                                                         BinauralNetwork,
                                                         binauralize_chunked)
from audiogpt_tpu_torch.models.extraction.lassnet import (LASSNet,
                                                          LASSNetConfig)
from audiogpt_tpu_torch.models.separation.convtasnet import (
    ConvTasNet, ConvTasNetConfig, separate_streaming)
from audiogpt_tpu_torch.models.textenc.clap import WordPieceTokenizer
from audiogpt_tpu_torch.registry import ENGINES


@ENGINES.register("extraction")
class ExtractionEngine(ParamsEntry, TimedCalls):
    """(mixture wav, text query) → the extracted source: LASSNet's
    magnitude mask on the STFT, resynthesised with the mixture's phase
    (``audio-chatgpt.py:697-705``)."""

    name = "extraction"

    def __init__(self, cfg: LASSNetConfig | None = None, params=None,
                 tokenizer=None, rng_seed: int = 0, sample_rate: int = 32000,
                 n_fft: int = 1024, hop: int = 256, max_sec: float = 20.0,
                 device: str | torch.device | None = None):
        """``params``: the JAX LASSNet's variables as numpy arrays.
        ``device=None`` is the card, and raises without one."""
        self.device = resolve_device(device)
        self.cfg = cfg or LASSNetConfig()
        self.model = on_device(seeded(rng_seed, lambda: LASSNet(self.cfg)),
                            self.device, params)
        self.sr, self.n_fft, self.hop = sample_rate, n_fft, hop
        self.tokenizer = tokenizer or WordPieceTokenizer(
            vocab_size=self.cfg.bert.vocab_size)
        frames_cap = int(max_sec * sample_rate / hop)
        self.bucketer = Bucketer(Bucketer.ladder(256, frames_cap))
        self._timings: dict[str, float] = {}

    @torch.inference_mode()
    def _extract(self, wav: np.ndarray, text: str) -> np.ndarray:
        x = torch.from_numpy(np.asarray(wav, np.float32)).to(self.device)
        spec = stft(x, self.n_fft, self.hop)                  # [T, F]
        padded, frames = self.bucketer.pad_to_bucket(spec.abs()[None],
                                                     axis=1)
        ids, mask = self.tokenizer.encode(text, 64)
        m = self.model(padded,
                       torch.from_numpy(ids)[None].long().to(self.device),
                       torch.from_numpy(mask)[None].to(self.device))
        est = m[0, :frames] * spec                            # mixture phase
        return istft(est, self.n_fft, self.hop,
                     length=len(wav)).cpu().numpy()

    def extract(self, wav: np.ndarray, text: str) -> np.ndarray:
        """→ the extracted wav, as long as ``wav``."""
        return self._timed(self.name, lambda: self._extract(wav, text))


@ENGINES.register("separation")
class SeparationEngine(ParamsEntry, TimedCalls):
    """Conv-TasNet enhancement (n_src = 1) or separation (n_src = 2),
    streamed with overlap-add (2.4 s / 0.8 s, the reference's ESPnet
    contract)."""

    name = "separation"

    def __init__(self, cfg: ConvTasNetConfig | None = None, params=None,
                 model: torch.nn.Module | None = None, rng_seed: int = 0,
                 device: str | torch.device | None = None):
        """``model`` overrides the net (``SkiM``, the reference Speech_SS
        backbone); the default is Conv-TasNet. Both take (mix [B, T],
        valid_len [B]) → [B, n_src, T]. ``params``: the JAX net's params
        as numpy arrays. ``device=None`` is the card."""
        self.device = resolve_device(device)
        if model is not None:
            self.cfg = model.cfg
        else:
            self.cfg = cfg or ConvTasNetConfig()
            model = seeded(rng_seed, lambda: ConvTasNet(self.cfg))
        self.model = on_device(model, self.device, params)
        self._timings: dict[str, float] = {}

    def separate(self, wav: np.ndarray, segment_sec: float = 2.4,
                 hop_sec: float = 0.8) -> np.ndarray:
        """→ [n_src, T]."""
        return self._timed(self.name, lambda: separate_streaming(
            self.model, np.asarray(wav, np.float32), segment_sec, hop_sec))

    def enhance(self, wav: np.ndarray) -> np.ndarray:
        """→ [T] (the first or only source)."""
        return self.separate(wav)[0]


@ENGINES.register("binaural")
class BinauralEngine(ParamsEntry, TimedCalls):
    """mono (48 kHz) + listener trajectory → stereo binaural. Without a
    trajectory, a slow 1 m orbit (the reference samples a stored
    tx-position file, ``audio-chatgpt.py:727-736``)."""

    name = "binaural"

    def __init__(self, cfg: BinauralConfig | None = None, params=None,
                 rng_seed: int = 0,
                 device: str | torch.device | None = None):
        """``params``: the JAX network's params as numpy arrays.
        ``device=None`` is the card."""
        self.device = resolve_device(device)
        self.cfg = cfg or BinauralConfig()
        self.model = on_device(seeded(rng_seed, lambda: BinauralNetwork(
            self.cfg)), self.device, params)
        self._timings: dict[str, float] = {}

    def default_trajectory(self, n_view: int) -> np.ndarray:
        """[7, n_view]: (x, y, z, q0, q1, q2, q3) — a 1 m-radius orbit."""
        t = np.linspace(0, 2 * np.pi, n_view, endpoint=False)
        traj = np.zeros((7, n_view), np.float32)
        traj[0] = np.cos(0.1 * t)
        traj[1] = np.sin(0.1 * t)
        traj[3] = 1.0
        return traj

    def binauralize(self, mono: np.ndarray,
                    view: np.ndarray | None = None) -> np.ndarray:
        """→ [2, T] stereo."""
        mono = np.asarray(mono, np.float32)
        if view is None:
            view = self.default_trajectory(len(mono)
                                           // self.cfg.view_rate_div)
        return self._timed(self.name, lambda: binauralize_chunked(
            self.model, mono, np.asarray(view, np.float32)))
