"""Sketch-mask inpainting round-trip for the serving layer.

Counterpart of ``audiogpt_tpu/serving/inpaint.py:1-81``: ``compute_mel``
runs on the port's ``dsp/mel.py``; the PNG helpers are copies and import
PIL and matplotlib only when called. The reference UI
(``audio-chatgpt.py:418-540, 1351-1374``) renders the uploaded clip's mel
as a viridis PNG, lets the user DRAW the region to regenerate, then maps
the sketch back onto the mel grid and inpaints.
This module is the server-side half of that loop:

  * :func:`render_mel_png` — mel [80, crop] → viridis-colormapped PNG
    (``show_mel_fn``, audio-chatgpt.py:495-503; crop_len 500);
  * :func:`decode_mask_png` — user sketch PNG → regenerate-mask [frames, 80]
    in [0, 1] (``inference``, audio-chatgpt.py:532-540: grayscale/255, time
    padded with 0 = untouched).

The engine keeps 1 = KEEP semantics (samplers.py:87), so the server inverts
the drawn mask before calling ``T2AEngine.inpaint``.
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np
import torch

from audiogpt_tpu_torch.dsp.mel import LDM_MEL_16K, ldm_normalize, log_mel
from audiogpt_tpu_torch.engines.base import resolve_device

CROP_LEN = 500  # displayed mel frames (audio-chatgpt.py:496)


def compute_mel(wav: np.ndarray, cfg,
                device: str | torch.device | None = None) -> np.ndarray:
    """wav [n] → LDM-normalized mel [frames, mel_bins] on the fixed
    848-frame inpaint canvas (``gen_mel``, audio-chatgpt.py:453-470),
    computed on ``device`` (``None`` is the card)."""
    n = cfg.inpaint_mel_len * cfg.hop
    wav = np.asarray(wav, np.float32)
    wav = np.pad(wav, (0, max(0, n - len(wav))))[:n]
    spec = dataclasses.replace(LDM_MEL_16K, sr=cfg.sample_rate, hop=cfg.hop,
                               n_mels=cfg.mel_bins)
    x = torch.from_numpy(wav).to(resolve_device(device))
    return ldm_normalize(log_mel(x, spec)).cpu().numpy()[
        : cfg.inpaint_mel_len]


def render_mel_png(mel: np.ndarray, crop: int = CROP_LEN) -> bytes:
    """mel [frames, mel_bins] in [0,1] → PNG bytes, image [mel_bins, crop]
    with bin 0 on the top row (exactly the reference's ``show_mel_fn``
    layout so a drawn mask maps 1:1 back onto the grid)."""
    from PIL import Image
    from matplotlib import cm

    img = np.clip(mel[:crop].T, 0.0, 1.0)           # [mel_bins, crop]
    rgba = (cm.viridis(img) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, format="PNG")
    return buf.getvalue()


def decode_mask_png(data: bytes, mel_bins: int = 80) -> np.ndarray:
    """Sketch PNG (white/alpha = regenerate) → mask [frames, mel_bins] in
    [0,1], 1 = REGENERATE. The image's rows map to mel bins (top row =
    bin 0, matching :func:`render_mel_png`), columns to frames. A canvas
    overlay usually ships RGBA with transparent background — use alpha as
    the mask when present, else grayscale/255."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if "A" in img.getbands():
        a = np.asarray(img.getchannel("A"), np.float32) / 255.0
        if a.min() < 1.0:        # alpha varies → drawn-on-transparent overlay
            arr = a
        else:                    # fully opaque (e.g. exported/painted PNG):
            # alpha carries no stroke information — use luminance
            arr = np.asarray(img.convert("L"), np.float32) / 255.0
    else:
        arr = np.asarray(img.convert("L"), np.float32) / 255.0
    if arr.shape[0] != mel_bins:  # browser canvas may be scaled — resize
        img2 = Image.fromarray((arr * 255).astype(np.uint8))
        img2 = img2.resize((arr.shape[1], mel_bins))
        arr = np.asarray(img2, np.float32) / 255.0
    return arr.T  # [frames, mel_bins]
