#!/usr/bin/env python3
"""FLOPs of one training step of the SVS, face, LDM-family and analysis
recipes at their configs' full widths, counted on the CPU.

    python3 train_flops.py

Each task is built from its config file (``train_cli.build_task`` on the
CPU), moved to the meta device, and one step of each optimized group (the
loss's forward and the gradient of its group) runs under
``FlopCounterMode`` on meta tensors of fixed batch shapes: DiffSinger
[32, 1024] frames, VISinger [8, 512] (its wav 256 samples a frame),
Audio2Motion [16, 512] mel frames, the VAE [8, 80, 624], CLAP 32 clips
of 160 000 samples with 77 tokens, SED and captioning 32 clips of 320 000
samples (captions of 22 tokens) and separation 8 mixtures of 64 000
samples with two sources. The shapes only, no data and no
arithmetic, so the count takes seconds. The counts are aten's
(convolutions and matmuls), as the trainer's own count of a step's first
batch of a shape; elementwise work is not counted.
Prints one JSON line: for each recipe its shapes, parameters and each
group's TFLOP, with the f32 FMA bound (67 TFLOP/s, an H100 SXM without
its tensor cores) of the step.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def _meta(*shape, dtype=None):
    import torch

    return torch.zeros(*shape, dtype=dtype or torch.float32, device="meta")


def _step_flops(task, batch: dict, draws: dict) -> dict:
    """Each group's forward and gradient on meta tensors → TFLOP."""
    import torch

    from audiogpt_tpu_torch.utils.flops import count_flops

    def step(fn, params, kw):
        loss, _ = fn(batch, None, **kw)
        torch.autograd.grad(loss, params, allow_unused=True)

    out = {}
    for grp, fn in task.loss_fns.items():
        params = [p for p in task.modules[grp].parameters()
                  if p.requires_grad]
        kw = {} if draws.get(grp) is None else {"draws": draws[grp]}
        out[grp] = count_flops(lambda: step(fn, params, kw))[1] / 1e12
    return out


def count(name: str, config: str, batch: dict, draws: dict,
          overrides: str = "") -> dict:
    import torch

    from audiogpt_tpu_torch import train_cli
    from audiogpt_tpu_torch.config import load_config
    from audiogpt_tpu_torch.utils.flops import F32_FLOPS

    cfg = load_config(os.path.join(ROOT, "configs", config),
                      overrides=overrides)
    task = train_cli.build_task(cfg, device="cpu")
    for mod in task.modules.values():
        mod.to("meta")
    groups = _step_flops(task, batch, draws)
    total = sum(groups.values())
    return {"recipe": name, "config": config,
            "shapes": {k: list(v.shape) for k, v in batch.items()},
            "params": {g: sum(p.numel() for p in task.modules[g].parameters())
                       for g in task.loss_fns},
            "tflop": groups, "tflop_step": total,
            "f32_bound_ms": total * 1e12 / F32_FLOPS * 1e3,
            "torch": torch.__version__}


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    i64 = torch.long
    res = []
    b, f, t = 32, 1024, 64
    res.append(count("diffsinger", "svs/diffsinger.yaml", {
        "txt_tokens": _meta(b, t, dtype=i64), "mels": _meta(b, f, 80),
        "mel2ph": _meta(b, f, dtype=i64),
        "pitch_midi": _meta(b, t, dtype=i64), "midi_dur": _meta(b, t),
        "is_slur": _meta(b, t, dtype=i64), "weight": _meta(b)},
        {"model": {"t": _meta(b, dtype=i64), "noise": _meta(b, f, 80)}}))
    b, f = 8, 512
    eps = _meta(b, f, 192)
    res.append(count("visinger", "svs/visinger.yaml", {
        "txt_tokens": _meta(b, t, dtype=i64),
        "pitch_midi": _meta(b, t, dtype=i64),
        "is_slur": _meta(b, t, dtype=i64), "mel2ph": _meta(b, f, dtype=i64),
        "spec": _meta(b, f, 513), "wav": _meta(b, f * 256),
        "weight": _meta(b)}, {"model": eps, "disc": eps}))
    res.append(count("audio2motion", "face/audio2motion.yaml", {
        "mels": _meta(16, 512, 80), "motion": _meta(16, 204, 136),
        "weight": _meta(16)}, {"model": _meta(16, 204, 16)}))
    eps = _meta(8, 4, 10, 78)
    res.append(count("vae", "t2a/vae.yaml", {
        "mels": _meta(8, 80, 624, 1), "weight": _meta(8)},
        {"model": eps, "disc": eps}))
    res.append(count("clap", "t2a/clap.yaml", {
        "wav": _meta(32, 160000), "wav_len": _meta(32, dtype=i64),
        "text_ids": _meta(32, 77, dtype=i64),
        "text_mask": _meta(32, 77, dtype=i64), "weight": _meta(32)}, {}))
    b, n = 32, 320000
    res.append(count("sed", "sed/panns.yaml", {
        "wav": _meta(b, n), "wav_len": _meta(b, dtype=i64),
        "target": _meta(b, 527), "weight": _meta(b)},
        {"model": {"lam": _meta(()), "perm": _meta(b, dtype=i64)}}))
    res.append(count("caption", "caption/cnn14rnn.yaml", {
        "wav": _meta(b, n), "wav_len": _meta(b, dtype=i64),
        "tokens": _meta(b, 22, dtype=i64), "token_len": _meta(b, dtype=i64),
        "weight": _meta(b)}, {}))
    res.append(count("separation", "separation/convtasnet.yaml", {
        "mix": _meta(8, 64000), "sources": _meta(8, 2, 64000),
        "weight": _meta(8)}, {}))
    print(json.dumps({"train_flops": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
