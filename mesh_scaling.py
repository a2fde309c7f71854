#!/usr/bin/env python3
"""Candidate sharding of the T2A and T2I engines over the cards of one
process: ``txt2audio_best`` (the tool's sampler, n = 3 rounded up to the
cards) and ``txt2img`` (512², DDIM-50, n = 4) on a
``parallel.device_mesh`` of the first k cards, one replica a card, at each
k of ``--cards``; the same seeded random weights at every k.

    python mesh_scaling.py --cards 1 2 4           # needs four cards
    python mesh_scaling.py --cards 1 2 --calls t2a --warm 3

Prints the card's name and power limit (``nvidia-smi``), then one JSON line
a run: the call, cards, n and its rounding, cold and warm (median) wall,
each replica's K1 and K2 launches (by card), the peak memory of each card,
and the output's largest difference from the first run with the same
rounded n (the one-card run shards nothing; TF32 off), and each card's
busy share of one more call traced with ``torch.profiler``. Without CUDA
it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TEXT = "a dog barks in the rain"
IMAGE_TEXT = "a watercolor painting of a lighthouse on a cliff at dawn"


def fill_random(module, gen) -> None:
    """Seeded noise in every parameter: weights normal · fan_in^-½, norm
    scales 1 + 0.1·N, every other vector 0.1·N."""
    import torch
    from torch import nn

    norms = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d)
    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                noise = torch.randn(p.shape, generator=gen, device=p.device)
                if isinstance(mod, norms) and name == "weight":
                    p.copy_(1.0 + 0.1 * noise)
                elif p.ndim >= 2:
                    p.copy_(noise / p[0].numel() ** 0.5)
                else:
                    p.copy_(0.1 * noise)


def timed(fn) -> tuple:
    """``fn()`` after every kernel count is set to 0, ending in a
    synchronise of every card → (output, seconds, K1 and K2 launches by
    card)."""
    import torch

    from audiogpt_tpu_torch.ops import _build
    from audiogpt_tpu_torch.ops.flash_attention import flash_attention
    from audiogpt_tpu_torch.ops.snake_aa import snake_aa

    for w in (flash_attention, snake_aa):
        _build.reset_counts(w)
    t0 = time.perf_counter()
    out = fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return out, time.perf_counter() - t0, {
        "flash_attention": dict(flash_attention.launches_by_device),
        "snake_aa": dict(snake_aa.launches_by_device)}


def busy_shares(fn, cards: int) -> dict:
    """One call of ``fn`` under ``torch.profiler``, the devices traced
    alone → its wall and each card's busy share: the union of that card's
    kernel and copy intervals over the traced wall (tracing slows the host
    a little)."""
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        for i in range(cards):
            torch.cuda.synchronize(i)
        wall = time.perf_counter() - t0
    spans: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    shares = {}
    for dev, sp in sorted(spans.items()):
        union, end = 0.0, -math.inf
        for start, stop in sorted(sp):
            union += max(0.0, stop - max(start, end))
            end = max(end, stop)
        shares[dev] = union / 1e6 / wall
    return {"traced_wall_s": wall, "busy_share_by_card": shares}


def run(name: str, build, call, cards: int, warm: int) -> tuple:
    import torch

    from audiogpt_tpu_torch.parallel import device_mesh

    mesh = device_mesh([f"cuda:{i}" for i in range(cards)])
    for i in range(cards):
        torch.cuda.reset_peak_memory_stats(i)
    t0 = time.perf_counter()
    eng = build(mesh)
    setup_s = time.perf_counter() - t0
    out, cold_s, _ = timed(lambda: call(eng))
    runs = [timed(lambda: call(eng)) for _ in range(warm)]
    walls = sorted(r[1] for r in runs)
    rec = {"call": name, "cards": cards, "setup_s": setup_s,
           "cold_s": cold_s, "warm_s": statistics.median(walls),
           "warm_max_s": walls[-1], "warm_calls": warm,
           "launches_by_card": runs[-1][2],
           **busy_shares(lambda: call(eng), cards),
           "peak_mem_gb_by_card": [torch.cuda.max_memory_allocated(i) / 1e9
                                   for i in range(cards)]}
    return rec, out


def t2a_setup(gen, args) -> tuple:
    """The main path's engine (BigVGAN, the PANN CLAP scorer) filled once
    on the first card → (a mesh → engine on those weights, its call)."""
    from audiogpt_tpu_torch.engines import T2AConfig, T2AEngine, VocoderEngine
    from audiogpt_tpu_torch.models.textenc import CLAPScorer

    voc = VocoderEngine("bigvgan", buckets=(624,), device="cuda:0")
    scorer = CLAPScorer(sample_rate=16000, device="cuda:0")
    base = T2AEngine(T2AConfig(), vocoder=voc, scorer=scorer,
                     device="cuda:0")
    for m in (base.unet, base.vae, base.clap, voc.model, scorer.text,
              scorer.audio):
        fill_random(m, gen)
    states = {k: getattr(base, k).state_dict()
              for k in ("unet", "vae", "clap")}

    def build(mesh):
        eng = T2AEngine(T2AConfig(), vocoder=voc, scorer=scorer, mesh=mesh)
        eng.load_state_dict(states)
        return eng

    return build, lambda e: e.txt2audio_best(TEXT, n_samples=3, seed=0)


def t2i_setup(gen, args) -> tuple:
    """The T2I tool's engine (SD-1.x at 512²) filled once on the first
    card → (a mesh → engine on those weights, its call)."""
    from audiogpt_tpu_torch.engines import T2IConfig, T2IEngine

    base = T2IEngine(T2IConfig(), device="cuda:0")
    for m in (base.unet, base.vae, base.text):
        fill_random(m, gen)
    states = {k: getattr(base, k).state_dict()
              for k in ("unet", "vae", "text")}

    def build(mesh):
        eng = T2IEngine(T2IConfig(), tokenizer=base.tokenizer, mesh=mesh)
        eng.load_state_dict(states)
        return eng

    return build, lambda e: e.txt2img(IMAGE_TEXT, n_samples=4,
                                      steps=args.t2i_steps, seed=0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--calls", nargs="+", default=["t2a", "t2i"],
                    choices=["t2a", "t2i"])
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--t2i-steps", type=int, default=50)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mesh_scaling: CUDA is not available", file=sys.stderr)
        return 1
    if max(args.cards) > torch.cuda.device_count():
        print(f"mesh_scaling: {max(args.cards)} cards asked, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    setups = {"t2a": t2a_setup, "t2i": t2i_setup}
    builds = {name: setups[name](gen, args) for name in args.calls}
    firsts = {}
    for name, (build, call) in builds.items():
        for cards in args.cards:
            rec, out = run(name, build, call, cards, args.warm)
            arrays = out if isinstance(out, tuple) else (out,)
            rounded = len(arrays[-1])
            rec["n_samples"], rec["rounded_n"] = (3, rounded) \
                if name == "t2a" else (4, rounded)
            if name == "t2i":
                rec["steps"] = args.t2i_steps
            ref = firsts.setdefault((name, rounded), (cards, arrays))
            rec["max_abs_diff_from"] = {
                "cards": ref[0], "diff": [float(np.abs(a - b).max())
                                          for a, b in zip(arrays, ref[1])]}
            if name == "t2a":
                rec["scores"] = out[2].tolist()
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
