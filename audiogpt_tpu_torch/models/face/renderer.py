"""Landmark-driven portrait renderer: a piecewise-affine warp of one
portrait to each frame's 68 landmarks.

Counterpart of ``audiogpt_tpu/models/face/renderer.py:1-176``. The
canonical landmark template and 8 border anchors are Delaunay-triangulated
once, at construction, with scipy, and each pixel's triangle and
barycentric weights are a host constant, as in JAX. Here they become one
dense weight matrix ``[H·W, 76]`` (three non-zeros a row), so the offsets
of every frame are one product with the frames' displacements ``[76,
T·2]``. The backward warp inverts the forward displacement field (``src =
dst + Σ bary·(template − frame)``) and samples the portrait bilinearly
with four gathers, clipped and floored as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def template_landmarks() -> np.ndarray:
    """[68, 2] (x, y) in [0, 1]², y down. Procedural neutral face:
    0-16 jaw, 17-21/22-26 brows, 27-35 nose, 36-41/42-47 eyes,
    48-67 mouth (outer 48-59, inner 60-67)."""
    pts = np.zeros((68, 2))
    th = np.linspace(np.pi, 2 * np.pi, 17)
    pts[0:17] = np.stack([0.5 + 0.32 * np.cos(th),
                          0.52 - 0.38 * np.sin(th)], 1)
    bx = np.linspace(-0.21, -0.05, 5)
    arch = 0.015 * np.cos(np.linspace(-1.2, 1.2, 5))
    pts[17:22] = np.stack([0.5 + bx, 0.34 - arch], 1)
    pts[22:27] = np.stack([0.5 - bx[::-1], 0.34 - arch[::-1]], 1)
    pts[27:31] = np.stack([np.full(4, 0.5), np.linspace(0.38, 0.52, 4)], 1)
    nx = np.linspace(-0.05, 0.05, 5)
    pts[31:36] = np.stack([0.5 + nx, 0.56 - 0.01 * np.abs(nx) / 0.05], 1)

    def eye(cx, cy, w=0.055, h=0.020):
        ex = np.array([-w, -w * 0.45, w * 0.45, w, w * 0.45, -w * 0.45])
        ey = np.array([0.0, -h, -h, 0.0, h, h])
        return np.stack([cx + ex, cy + ey], 1)

    pts[36:42] = eye(0.5 - 0.13, 0.40)
    pts[42:48] = eye(0.5 + 0.13, 0.40)
    mth = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    pts[48:60] = np.stack([0.5 + 0.085 * np.cos(mth),
                           0.70 + 0.042 * np.sin(mth)], 1)
    ith = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    pts[60:68] = np.stack([0.5 + 0.050 * np.cos(ith),
                           0.70 + 0.018 * np.sin(ith)], 1)
    return pts


def _border_anchors() -> np.ndarray:
    """8 fixed points pinning the warp to zero at the image border."""
    return np.array([[0, 0], [0.5, 0], [1, 0], [0, 0.5], [1, 0.5],
                     [0, 1], [0.5, 1], [1, 1]], np.float64)


class LandmarkWarper:
    """The warp field of an H×W canvas from the canonical template, on
    ``device``; ``render(portrait, landmarks)`` warps the portrait to each
    frame's landmarks."""

    def __init__(self, height: int = 256, width: int = 256,
                 device: str | torch.device = "cpu"):
        from scipy.spatial import Delaunay

        self.height, self.width = height, width
        tpl = np.concatenate([template_landmarks(), _border_anchors()])
        tri = Delaunay(tpl)
        ys, xs = np.mgrid[0:height, 0:width]
        q = np.stack([(xs + 0.5) / width, (ys + 0.5) / height],
                     -1).reshape(-1, 2)
        simplex = tri.find_simplex(q)
        simplex = np.maximum(simplex, 0)  # border px → any triangle, bary≈edge
        verts = tri.simplices[simplex]                   # [P, 3]
        T = tri.transform[simplex]                       # [P, 3, 2]
        b2 = np.einsum("pij,pj->pi", T[:, :2], q - T[:, 2])
        bary = np.concatenate([b2, 1.0 - b2.sum(1, keepdims=True)], 1)
        bary = np.clip(bary, 0.0, 1.0)
        bary /= np.maximum(bary.sum(1, keepdims=True), 1e-8)
        weights = np.zeros((height * width, len(tpl)), np.float32)
        rows = np.arange(height * width)[:, None]
        np.add.at(weights, (np.broadcast_to(rows, verts.shape), verts),
                  bary.astype(np.float32))
        self.device = torch.device(device)
        self._weights = torch.from_numpy(weights).to(self.device)
        self._template = torch.from_numpy(tpl.astype(np.float32)).to(
            self.device)                                 # [76, 2]
        self._xs = ((torch.arange(width, device=self.device) + 0.5)
                    / width)[None, :].expand(height, width).reshape(-1)
        self._ys = ((torch.arange(height, device=self.device) + 0.5)
                    / height)[:, None].expand(height, width).reshape(-1)

    def offsets(self, landmarks: torch.Tensor) -> torch.Tensor:
        """landmarks [T, 68, 2] → each pixel's source offset [T, H·W, 2]."""
        t = landmarks.shape[0]
        tpl = self._template
        full = torch.cat([landmarks, tpl[68:].expand(t, 8, 2)], 1)
        disp = (tpl - full).permute(1, 0, 2).reshape(len(tpl), t * 2)
        return (self._weights @ disp).reshape(-1, t, 2).transpose(0, 1)

    def frames(self, portrait: torch.Tensor,
               landmarks: torch.Tensor) -> torch.Tensor:
        """portrait [H, W, 3] in [0, 1]; landmarks [T, 68, 2] → uint8
        frames [T, H, W, 3] on the warper's device: clip to [0, 1], times
        255, truncated, as numpy's ``astype`` truncates."""
        H, W = self.height, self.width
        off = self.offsets(landmarks)
        fx = torch.clamp((self._xs + off[..., 0]) * W - 0.5, 0.0, W - 1.001)
        fy = torch.clamp((self._ys + off[..., 1]) * H - 0.5, 0.0, H - 1.001)
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
        i00 = y0.long() * W + x0.long()                  # [T, P]
        p = portrait.reshape(H * W, 3)
        out = (p[i00] * ((1 - wx) * (1 - wy))
               + p[i00 + 1] * (wx * (1 - wy))
               + p[i00 + W] * ((1 - wx) * wy)
               + p[i00 + W + 1] * (wx * wy))
        return (out.clamp(0.0, 1.0) * 255).to(torch.uint8).reshape(
            -1, H, W, 3)

    def render(self, portrait, landmarks) -> np.ndarray:
        """portrait [H, W, 3] float (0-1) or uint8; landmarks [T, 68, 2] in
        unit coords → uint8 frames [T, H, W, 3] on the host."""
        p = np.asarray(portrait, np.float32)
        if p.max() > 1.5:
            p = p / 255.0
        lm = torch.as_tensor(landmarks, dtype=torch.float32,
                             device=self.device)
        return self.frames(torch.from_numpy(p).to(self.device),
                           lm).cpu().numpy()


def default_portrait(height: int = 256, width: int = 256) -> np.ndarray:
    """Procedural cartoon portrait aligned with the landmark template (used
    when no reference photo is supplied)."""
    tpl = template_landmarks()
    ys, xs = np.mgrid[0:height, 0:width]
    x = (xs + 0.5) / width
    y = (ys + 0.5) / height
    img = np.ones((height, width, 3)) * np.array([0.16, 0.22, 0.30])
    face = (((x - 0.5) / 0.34) ** 2 + ((y - 0.50) / 0.42) ** 2) <= 1.0
    img[face] = [0.91, 0.76, 0.65]

    def disc(cx, cy, r, color, aspect=1.0):
        m = (((x - cx) / r) ** 2 + ((y - cy) / (r * aspect)) ** 2) <= 1.0
        img[m] = color

    for c in (tpl[36:42].mean(0), tpl[42:48].mean(0)):      # eyes
        disc(c[0], c[1], 0.055, [1.0, 1.0, 1.0], 0.55)
        disc(c[0], c[1], 0.022, [0.15, 0.25, 0.45], 1.0)
    for c in (tpl[17:22], tpl[22:27]):                       # brows
        b = c.mean(0)
        m = (np.abs(y - b[1]) < 0.012) & (np.abs(x - b[0]) < 0.07)
        img[m] = [0.25, 0.17, 0.12]
    disc(0.5, 0.54, 0.022, [0.80, 0.60, 0.50], 1.4)          # nose tip
    disc(0.5, 0.70, 0.085, [0.75, 0.35, 0.33], 0.5)          # lips
    disc(0.5, 0.70, 0.048, [0.45, 0.15, 0.15], 0.4)          # mouth
    return img.astype(np.float32)
