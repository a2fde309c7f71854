"""Mono → binaural rendering.

Counterpart of ``audiogpt_tpu/models/binaural/binaural.py:27-136`` (the
reference's ``BinauralNetwork``, ``mono2binaural/src/models.py:86``): a
geometric time warp (each ear's distance from the source, from the 7-dof
view: position and an (x, y, z, w) quaternion) plus a learned warpfield
(four causal k = 2 convs over the view frames), clamped causal, applied by
a monotone (``cummax``) linear-interpolation warp. Both warpfields reach
the sample rate by nearest resizing with half-pixel centres (JAX's
``"nearest"``: torch's ``"nearest-exact"``). :func:`binauralize_chunked`
keeps the reference's 1 s chunks with an 800-sample halo
(``audio-chatgpt.py:747-765``) and clips to [-1, 1].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SPEED_OF_SOUND = 343.0
MOUTH_OFFSET = np.array([0.09, 0.0, -0.20], np.float32)
LEFT_EAR = np.array([0.0, -0.08, -0.22], np.float32)
RIGHT_EAR = np.array([0.0, 0.08, -0.22], np.float32)


@dataclasses.dataclass(frozen=True)
class BinauralConfig:
    view_dim: int = 7
    warpnet_layers: int = 4
    warpnet_channels: int = 64
    sample_rate: int = 48000
    view_rate_div: int = 400  # one view frame per 400 samples


def quat_apply_inverse(quat: torch.Tensor, v: np.ndarray) -> torch.Tensor:
    """Rotate ``v`` by the inverse of the quaternions ``quat`` [..., 4]
    (x, y, z, w: scipy's layout, as the reference's
    ``R.from_quat(...).apply(inverse=True)``, models.py:25-26)."""
    q = quat / torch.linalg.vector_norm(quat, dim=-1,
                                        keepdim=True).clamp_min(1e-12)
    xyz, w = q[..., :3], q[..., 3:4]
    vv = torch.as_tensor(v, device=quat.device).expand_as(xyz)
    t = 2.0 * torch.linalg.cross(-xyz, vv, dim=-1)
    return vv + w * t + torch.linalg.cross(-xyz, t, dim=-1)


def _nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """Resize the last axis of [B, C, K] to ``size`` (half-pixel nearest)."""
    return F.interpolate(x, size=size, mode="nearest-exact")


def geometric_warpfield(view: torch.Tensor, seq_length: int,
                        sample_rate: int) -> torch.Tensor:
    """view [B, 7, K] → warpfield [B, 2, T] (negative delays in samples)."""
    pos, quat = view[:, :3], view[:, 3:]
    # a zero quaternion (zero-padded view) → no NaN (models.py:22-24)
    norms = torch.linalg.vector_norm(quat, dim=1, keepdim=True)
    quat = quat + (norms == 0).to(quat.dtype)
    mouth = quat_apply_inverse(quat.transpose(1, 2),
                               MOUTH_OFFSET).transpose(1, 2)  # [B, 3, K]
    ears = [torch.as_tensor(e, device=view.device)[None, :, None]
            for e in (LEFT_EAR, RIGHT_EAR)]
    disp = torch.stack([pos + mouth - e for e in ears], dim=1)  # [B, 2, 3, K]
    dist = torch.sqrt((disp ** 2).sum(dim=2))                   # [B, 2, K]
    return -_nearest(dist, seq_length) / SPEED_OF_SOUND * sample_rate


def monotone_warp(signal: torch.Tensor,
                  warpfield: torch.Tensor) -> torch.Tensor:
    """Linear-interpolation warp kept monotone by ``cummax``; [B, 2, T]
    each."""
    t = signal.shape[-1]
    pos = (warpfield + torch.arange(t, dtype=warpfield.dtype,
                                    device=warpfield.device)).clamp(0, t - 1)
    pos = torch.cummax(pos, dim=-1).values
    lo = torch.floor(pos)
    idx_r = torch.ceil(pos).long().clamp(0, t - 1)
    alpha = pos - lo
    return (1.0 - alpha) * signal.gather(-1, lo.long()) \
        + alpha * signal.gather(-1, idx_r)


class BinauralNetwork(nn.Module):
    def __init__(self, cfg: BinauralConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.view_dim
        for i in range(cfg.warpnet_layers):
            self.add_module(f"warp_conv_{i}",
                            nn.Conv1d(ch, cfg.warpnet_channels, 2))
            ch = cfg.warpnet_channels
        self.warp_linear = nn.Conv1d(ch, 2, 1)

    def forward(self, mono: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
        """mono [B, T], view [B, 7, T // 400] → binaural [B, 2, T]."""
        t = mono.shape[-1]
        geo = geometric_warpfield(view, t, self.cfg.sample_rate)
        # the learned warpfield: causal convs over the view frames
        # (Warpnet:63-71)
        x = view
        for i in range(self.cfg.warpnet_layers):
            x = F.relu(getattr(self, f"warp_conv_{i}")(F.pad(x, (1, 0))))
        neural = _nearest(self.warp_linear(x), t)
        warpfield = -F.relu(-(geo + neural))         # causality clamp
        return monotone_warp(torch.stack([mono, mono], dim=1), warpfield)


@torch.inference_mode()
def binauralize_chunked(model: BinauralNetwork, mono: np.ndarray,
                        view: np.ndarray, chunk_size: int = 48000,
                        rec_field: int = 800) -> np.ndarray:
    """mono [T], view [7, T // 400] → stereo [2, T'] (T' = T floored to
    whole view frames), on the device of ``model``'s parameters: chunks of
    ``chunk_size`` samples, each with a ``rec_field`` halo before it (a
    multiple of 400), concatenated and clipped to [-1, 1]."""
    div = model.cfg.view_rate_div
    dev = next(model.parameters()).device
    t = (mono.shape[-1] // div) * div
    mono, view = mono[:t], view[:, : t // div]
    outs = []
    for i in range(0, t, chunk_size):
        lo = max(0, i - rec_field)
        m = torch.from_numpy(np.ascontiguousarray(mono[lo: i + chunk_size]))
        v = torch.from_numpy(np.ascontiguousarray(
            view[:, lo // div: (i + chunk_size) // div]))
        out = model(m[None].to(dev), v[None].to(dev))[0]
        outs.append(out[:, rec_field:] if i > 0 else out)
    return torch.cat(outs, dim=-1).clamp(-1.0, 1.0).cpu().numpy()
