"""GeneFace-class engine: driving audio → talking-portrait video file.

Counterpart of ``audiogpt_tpu/engines/face.py:31-127``, the agent's
"Generate a talking human portrait video given a input Audio" tool (the
reference's ``GeneFace``, ``audio-chatgpt.py:589-611``): the LDM mel of
the 16 kHz audio, padded onto a mel bucket → landmark motion (the
Audio2Motion prior's sample plus the energy articulation prior, added to
the template) → the landmark warp of the portrait → an MJPEG AVI with the
audio muxed in, under ``media_root``. Mel, motion and warp run on the
device; the frames cross to the host once, as uint8, for the JPEG encoder.

The audio path is read under ``media_root`` (the server points it at its
own), and a path that resolves outside it (absolute, ``..``, or through a
link) is refused: the JAX engine tries the working directory first and
takes an absolute path as given (``engines/face.py:116-120``), which lets
a served turn read any file on the host. A clip longer than the largest
bucket is cut to it, as in JAX: the video covers its first 2048 mel
frames, the muxed audio is whole.
"""

from __future__ import annotations

import os
import uuid

import numpy as np
import torch

from audiogpt_tpu_torch.dsp.mel import LDM_MEL_16K, ldm_normalize, log_mel
from audiogpt_tpu_torch.engines.base import (
    Bucketer,
    ParamsEntry,
    TimedCalls,
    on_device,
    resolve_device,
    seeded,
)
from audiogpt_tpu_torch.models.face import (
    Audio2MotionConfig,
    Audio2MotionVAE,
    LandmarkWarper,
    default_portrait,
    energy_articulation,
    template_landmarks,
)
from audiogpt_tpu_torch.models.face.audio2motion import (POSTERIOR,
                                                       inference_tree)
from audiogpt_tpu_torch.registry import ENGINES
from audiogpt_tpu_torch.utils.media import resolve_media
from audiogpt_tpu_torch.utils.video_io import write_mjpeg_avi


@ENGINES.register("geneface")
class GeneFaceEngine(ParamsEntry, TimedCalls):
    name = "geneface"
    #: the posterior heads of a training tree or trainer checkpoint
    training_only = POSTERIOR

    def __init__(self, cfg: Audio2MotionConfig | None = None, params=None,
                 portrait: np.ndarray | None = None,
                 media_root: str = ".", video_size: int = 256,
                 buckets: tuple[int, ...] = (256, 512, 1024, 2048),
                 rng_seed: int = 0, use_energy_prior: bool = True,
                 device: str | torch.device | None = None):
        """``params``: the JAX engine's Audio2Motion tree as numpy arrays
        (a training tree's posterior heads are dropped); ``None`` keeps a
        seeded random init. ``portrait``: [H, W, 3] in
        [0, 1] or uint8 (default: the procedural one). ``device=None`` is
        the card, and raises without one."""
        self.device = resolve_device(device)
        self.cfg = cfg or Audio2MotionConfig()
        self.model = on_device(seeded(rng_seed, lambda: Audio2MotionVAE(
            self.cfg)), self.device,
            None if params is None else inference_tree(params))
        self.media_root = media_root
        self.use_energy_prior = use_energy_prior
        self.bucketer = Bucketer(buckets)
        self.warper = LandmarkWarper(video_size, video_size, self.device)
        self.portrait = (default_portrait(video_size, video_size)
                         if portrait is None else portrait)
        self._template = torch.from_numpy(
            template_landmarks().astype(np.float32)).to(self.device)
        self._gen = torch.Generator(self.device).manual_seed(rng_seed)
        self._timings: dict[str, float] = {}

    def mel(self, wav: np.ndarray) -> torch.Tensor:
        """16 kHz wav [T] → LDM-normalised mel [frames, 80] on the
        device."""
        x = torch.from_numpy(np.ascontiguousarray(wav, np.float32))
        return ldm_normalize(log_mel(x.to(self.device), LDM_MEL_16K))

    @torch.inference_mode()
    def motion(self, mel: torch.Tensor, draws=None) -> torch.Tensor:
        """mel [T_mel, 80] → landmarks [T_video, 68, 2] on the device: the
        model runs on the mel padded (or cut) to its bucket, and the
        frames of the clip are kept. ``draws``: the prior's noise
        [1, video_len(bucket), latent] (default: the engine's
        generator)."""
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        t = mel.shape[0]
        b = self.bucketer.bucket(t)
        mel_p = torch.nn.functional.pad(mel[:b], (0, 0, 0, max(0, b - t)))
        off = self.model.generate(mel_p[None], self._gen if draws is None
                                  else draws)[0]
        lm = self._template + off.reshape(-1, 68, 2)
        if self.use_energy_prior:
            lm = lm + energy_articulation(mel_p, self.cfg)
        return lm[:self.cfg.video_len(min(t, b))]

    def landmarks(self, mel, draws=None) -> np.ndarray:
        """mel [T_mel, 80] (LDM-normalised) → [T_video, 68, 2] on the
        host."""
        return self.motion(mel, draws).cpu().numpy()

    @torch.inference_mode()
    def audio_to_video(self, audio_path: str, draws=None) -> str:
        """Audio file → the relative path of the AVI written under
        ``media_root``."""
        # imported here: utils/audio_io imports engines/base
        from audiogpt_tpu_torch.utils.audio_io import load_wav

        # read under media_root; a path outside it raises ValueError
        wav, _ = load_wav(resolve_media(audio_path, self.media_root),
                          sr=self.cfg.sample_rate, device=self.device)
        frames = self.warper.render(self.portrait,
                                    self.motion(self.mel(wav), draws))
        rel = os.path.join("video", f"{uuid.uuid4().hex[:8]}.avi")
        out = os.path.join(self.media_root, rel)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        write_mjpeg_avi(out, frames, fps=self.cfg.fps, audio=wav,
                        sample_rate=self.cfg.sample_rate)
        return rel

    def __call__(self, audio_path: str) -> str:
        return self._timed("geneface", lambda: self.audio_to_video(
            audio_path))

    def warmup(self) -> None:
        """Run every mel bucket once (cuDNN's algorithm choice, allocator
        growth) and the warp."""
        for b in self.bucketer.buckets:
            lm = self.motion(torch.zeros(b, self.cfg.mel_bins,
                                         device=self.device))
        self.warper.render(self.portrait, lm[:1])
