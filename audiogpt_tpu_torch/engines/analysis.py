"""Analysis engines. For now the image captioner alone: the agent's "Get
Photo Description" tool.

Counterpart of ``audiogpt_tpu/engines/analysis.py:242-296``
(``ImageCaptionEngine``; the reference's ``ImageCaptioning``,
``audio-chatgpt.py:126-137``: HF BLIP-base greedy generate). The audio
captioner, sound-event and target-sound detectors of that module are not
ported yet.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from audiogpt_tpu_torch.engines.base import resolve_device
from audiogpt_tpu_torch.models.caption.blip import (BlipCaptioner,
                                                    BlipConfig,
                                                    greedy_caption,
                                                    preprocess_image)
from audiogpt_tpu_torch.models.textenc.clap import WordPieceTokenizer
from audiogpt_tpu_torch.utils.jax_params import load_jax_params


class ImageCaptionEngine:
    """Image → caption string with the BLIP captioner.

    ``vocab_path``: a BERT ``vocab.txt`` for the WordPiece decode; without
    one the bundled derived vocab loads where it fits the embedding table,
    else token ids render as ``<id>`` placeholders. A relative image path is
    read under ``media_root`` (the server points it at its own), so the path
    the T2I tool returns can be described."""

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
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rng_seed)
            self.model = BlipCaptioner(self.cfg)
        self.model.to(self.device).eval()
        if params is not None:
            load_jax_params(self.model, params)
        self.max_tokens = max_tokens
        self.tokenizer = WordPieceTokenizer(
            vocab_path, vocab_size=self.cfg.text.vocab_size)
        self.media_root = media_root
        self._timings: dict[str, float] = {}

    @property
    def timings(self) -> dict[str, float]:
        """Wall seconds of the last call, by tool name."""
        return dict(self._timings)

    def caption_tokens(self, images: np.ndarray) -> np.ndarray:
        """BLIP-normalised images [B, S, S, 3] → tokens
        [B, 1 + max_tokens]."""
        x = torch.from_numpy(np.asarray(images, np.float32)).to(self.device)
        return greedy_caption(self.model, x, self.max_tokens).cpu().numpy()

    def caption_image(self, image) -> str:
        """Image path or array → caption text: the tokens after BOS up to
        the first EOS."""
        if isinstance(image, str):
            image = os.path.join(self.media_root, image.strip())
        px = preprocess_image(image, self.cfg.vision.image_size)
        body = self.caption_tokens(px)[0, 1:]
        stop = np.flatnonzero(body == self.cfg.text.eos_id)
        if len(stop):
            body = body[: stop[0]]
        return self.tokenizer.decode(body)

    def __call__(self, image_path: str) -> str:
        t0 = time.perf_counter()
        out = self.caption_image(image_path)
        self._timings["i2t"] = time.perf_counter() - t0
        return out

    def warmup(self) -> None:
        s = self.cfg.vision.image_size
        self.caption_tokens(np.zeros((1, s, s, 3), np.float32))
