"""Style-transfer TTS engine: the agent's "Style Transfer" tool
(GenerSpeech + vocoder).

Counterpart of ``audiogpt_tpu/engines/tts_ood.py:29-100`` (the reference's
``TTS_OOD``, ``audio-chatgpt.py:383``). The reference voice's log-mel
(``NEURALSEQ_MEL_22K``, on the device) conditions the model directly: no
forced aligner, no external speaker or emotion encoder. Text goes through
the English frontend onto a token bucket, the reference mel onto a frame
bucket; GenerSpeech samples the mel through its Glow post-flow
(``infer_postflow``), and the vocoder makes the wav.

Two JAX faults are not copied:

- The JAX app builds this engine without a vocoder, and ``synthesize``
  then returns the mel, which the tool writes as an 80-channel "wav" of
  clipped mel values (``audiogpt_tpu/app.py:55-59``,
  ``audiogpt_tpu/engines/tts_ood.py:97-99``). Here the vocoder defaults to
  ``VocoderEngine("hifigan")``, the TTS engine's 22.05 kHz HiFi-GAN on the
  same mel frontend, and ``synthesize`` always returns mono audio.
- A reference longer than the largest frame bucket (512 frames, about
  5.9 s) raises in JAX (``Bucketer.pad_to_bucket``), so most recorded
  voices fail. Here its first frames up to that bucket are taken; JAX
  accepts no longer reference, so nothing that JAX accepts changes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audiogpt_tpu_torch.dsp.mel import NEURALSEQ_MEL_22K, MelSpec, log_mel
from audiogpt_tpu_torch.engines.base import (
    Bucketer,
    ParamsEntry,
    on_device,
    resolve_device,
    seeded,
)
from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
from audiogpt_tpu_torch.models.tts.generspeech import (
    GenerSpeech,
    GenerSpeechConfig,
)
from audiogpt_tpu_torch.registry import ENGINES
from audiogpt_tpu_torch.text import (
    EnglishFrontend,
    TokenTextEncoder,
    default_arpabet_vocab,
)


@ENGINES.register("tts_ood")
class StyleTransferEngine(ParamsEntry):
    name = "tts_ood"

    #: sample the mel through the Glow post-flow (``run_post_glow``,
    #: generspeech.py:233); False takes the FS2 decoder's mel
    infer_postflow: bool = True

    def __init__(self, cfg: GenerSpeechConfig | None = None, params=None,
                 vocoder: VocoderEngine | None = None,
                 frontend: EnglishFrontend | None = None,
                 phone_encoder: TokenTextEncoder | None = None,
                 mel: MelSpec | None = None,
                 token_buckets=(32, 64, 128),
                 ref_frame_buckets=(128, 256, 512), rng_seed: int = 0,
                 device: str | torch.device | None = None):
        """``params``: the JAX engine's GenerSpeech tree (``params`` and
        ``vq_stats``) as numpy arrays; ``None`` keeps a seeded random init.
        ``device=None`` is the card, and raises without one."""
        self.device = resolve_device(device)
        self.cfg = cfg or GenerSpeechConfig()
        self.model = on_device(seeded(rng_seed,
                                      lambda: GenerSpeech(self.cfg)),
                               self.device, params)
        mel = mel or NEURALSEQ_MEL_22K
        if mel.n_mels != self.cfg.fs2.n_mels:
            mel = dataclasses.replace(mel, n_mels=self.cfg.fs2.n_mels)
        self.mel = mel
        self.vocoder = vocoder or VocoderEngine("hifigan",
                                                device=self.device)
        if self.vocoder.device != self.device:
            raise ValueError(f"vocoder on {self.vocoder.device}, engine on "
                             f"{self.device}")
        self.frontend = frontend or EnglishFrontend(
            phone_encoder=phone_encoder
            or TokenTextEncoder(default_arpabet_vocab()))
        self.token_bucketer = Bucketer(token_buckets)
        self.ref_bucketer = Bucketer(ref_frame_buckets)
        self._gen = torch.Generator(self.device).manual_seed(rng_seed)

    @property
    def sample_rate(self) -> int:
        return self.mel.sr

    def ref_mel(self, ref_wav: np.ndarray) -> torch.Tensor:
        """The reference wav at ``mel.sr`` → its log-mel on the device,
        [1, frame bucket, n_mels], cut to the largest bucket."""
        x = torch.from_numpy(np.asarray(ref_wav, np.float32)).to(self.device)
        ref = log_mel(x, self.mel)[None, :max(self.ref_bucketer.buckets)]
        return self.ref_bucketer.pad_to_bucket(ref, axis=1)[0]

    @torch.inference_mode()
    def synthesize_mel(self, text: str, ref_wav: np.ndarray,
                       draws=None) -> torch.Tensor:
        """(text, reference wav) → mel [frames, n_mels] on the device,
        trimmed after the last frame with a phone (at least 1). ``draws``:
        the post-flow's z (default: the engine's generator)."""
        ids = torch.tensor([self.frontend.encode(text)])
        toks = self.token_bucketer.pad_to_bucket(ids, axis=1)[0].to(
            self.device)
        out = self.model(toks, self.ref_mel(ref_wav),
                         draws=self._gen if draws is None else draws,
                         infer_postflow=self.infer_postflow
                         and self.cfg.use_post_flow)
        valid = torch.nonzero(out["mel2ph"][0] > 0)
        return out["mel_out"][0, :int(valid[-1]) + 1 if len(valid) else 1]

    def synthesize(self, text: str, ref_wav: np.ndarray,
                   draws=None) -> np.ndarray:
        """(text, reference voice wav at ``sample_rate``) → float32 mono wav
        in the reference's style."""
        mel = self.synthesize_mel(text, ref_wav, draws)
        return self.vocoder.vocode(mel.T[None].contiguous())[0].cpu().numpy()
