#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``audiogpt_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. probe: CUDA must be present; the card's name and power limit; TF32 off.
2. build: ``nvcc`` compiles ``audiogpt_tpu_torch/csrc/*.cu`` for sm_90a;
   ptxas' registers and spills; whether ``cuobjdump -sass`` shows tensor-core
   instructions (HMMA / HGMMA) in the flash kernel.
3. flash_attention: both entries (f32, bf16) against their plain versions at
   the UNet shape and two more; kernel, plain and
   ``scaled_dot_product_attention`` (same dtype) times; the grid's blocks
   and waves; bounds at the route's rate (3xTF32 or bf16 tensor cores) and
   at the f32 FMA rate.
4. snake_aa: both entries against the plain up → snake → down chain at the
   four BigVGAN stage shapes; kernel, plain and ``x.clone()`` times.
5. main_path: ``T2AEngine(T2AConfig(), vocoder=VocoderEngine("bigvgan"))`` at
   full width with seeded random weights runs ``txt2audio_best`` (3
   candidates, DPM-Solver++(2M)-12, CFG); the launch counters show that it
   went through both kernels; the median and the slowest of 10 warm calls
   are reported (host clock, each call ending in a synchronise).
6. main_path_bf16: the same weights in ``T2AConfig(unet_bf16=True)``: the
   flash kernel's bf16 entry on the same call, its counts, warm median and
   the mel's distance from the f32 call's.
7. small_reference: a narrow engine on the card against the same engine on
   the CPU (plain versions), same weights and initial noise.
8. profile: one warm main-path call under ``torch.profiler`` (device time by
   kernel; the device's busy share of the traced call and of the untraced
   warm median), then the time of each layer (text tower, sampler, VAE
   decode, vocoder) between CUDA events, median of 5 runs.

Before the last line: ``{"kernels": [...]}`` and the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``. Times are
measured with CUDA events after a warmup: a kernel's ``ms`` (and the
library call's and the copy's) over a CUDA graph of 50 launches, the device
time alone; ``ms_events`` over 50 launches from Python, host cost included,
as ``plain_ms`` is; bounds use the H100 SXM peaks
(3.35 TB/s; 495 TFLOP/s TF32 and 989 bf16 on the tensor cores, 67 TFLOP/s
f32 without them).
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12                     # FMA units, no tensor cores
TF32_FLOPS = 495e12                   # tensor cores, dense
BF16_FLOPS = 989e12
#: the f32 flash entry does three TF32 products per product (3xTF32)
FLASH_FLOPS = {"float32": TF32_FLOPS / 3, "bfloat16": BF16_FLOPS}
CLIP_SECONDS = 624 * 256 / 16000      # T2AConfig.mel_len · hop / sample_rate
TEXT = "a dog barks in the rain"
WARM_CALLS = 10                       # warm main-path calls timed
STAGE_RUNS = 5                        # per-layer timings, median taken


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3, graph: bool = False) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls between CUDA
    events. With ``graph`` the calls are captured in one CUDA graph and the
    replay is timed: the device time alone, without the host's cost of each
    launch (which exceeds a 20 µs kernel's own time when the launches come
    from Python). Without, the host's launch rate is part of the time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    if graph:
        run()
    else:
        for _ in range(iters):
            run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float,
             rate: float = F32_FLOPS) -> tuple[float, str]:
    """The least time for ``n_bytes`` of device memory traffic and ``flops``
    at ``rate``, and which of the two sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / rate
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


def tensor_core_sass(lib: Path) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the flash kernel's SASS,
    counted by opcode from ``cuobjdump -sass``."""
    from audiogpt_tpu_torch.ops import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts: dict = {}
    in_flash = False
    for line in sass.splitlines():
        if "Function :" in line:
            in_flash = "flash_fwd_kernel" in line
        elif in_flash and (m := re.search(r"\b(HGMMA|HMMA)[\w.]*", line)):
            counts[m.group(0)] = counts.get(m.group(0), 0) + 1
    return counts


def phase_build() -> None:
    from audiogpt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    ptxas = [line.strip() for line in
             (_build.BUILD_DIR / "build.log").read_text().splitlines()
             if "entry function" in line or "registers" in line
             or "spill" in line]
    sass = tensor_core_sass(lib)
    emit({"phase": "build", "seconds": seconds, "library": lib.name,
          "ptxas": ptxas, "flash_sass_tensor_core": sass})
    if not sass:
        raise AssertionError("no HMMA/HGMMA in the flash kernel's SASS")


#: bf16 kernel vs bf16 plain version: both round the output to bf16 (2^-7
#: of the value) and p to bf16 at other points (2^-9 of each weight)
BF16_FLASH_TOL = (1e-2, 2 ** -7)          # absolute, relative


def phase_flash(gen) -> dict:
    """Both flash entries at three cases; → {dtype name: kernel record}."""
    import torch
    import torch.nn.functional as F

    from audiogpt_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
        launch_grid,
    )

    cases = [("unet_level0", (6, 780, 8, 40), None, False),
             ("kv_mask", (2, 1500, 6, 64), (1500, 1100), False),
             ("causal", (1, 256, 2, 80), None, True)]
    kernels = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        results = []
        for name, (b, t, h, d), lens, causal in cases:
            q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            mask = None
            if lens is not None:
                mask = (torch.arange(t, device="cuda")[None]
                        < torch.tensor(lens, device="cuda")[:, None]).float()
            out = flash_attention(q, k, v, kv_mask=mask, causal=causal)
            ref = flash_attention_reference(q, k, v, kv_mask=mask,
                                            causal=causal)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if dtype == torch.float32:
                ok = err <= 1e-4
            else:
                atol, rtol = BF16_FLASH_TOL
                ok = bool((diff <= atol + rtol * ref.float().abs()).all())
            if not ok:
                raise AssertionError(f"flash_attention {dname} {name}: max "
                                     f"abs err {err}")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa_mask = None if mask is None else (mask > 0)[:, None, None, :]
            def kernel():
                return flash_attention(q, k, v, kv_mask=mask, causal=causal)

            ms = time_ms(kernel, 50, graph=True)
            ms_events = time_ms(kernel, 50)
            plain = time_ms(lambda: flash_attention_reference(
                q, k, v, kv_mask=mask, causal=causal), 20)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, is_causal=causal), 50,
                graph=True)
            # pairs this run's data needs: valid keys per row, or the triangle
            pairs = (t * (t + 1) / 2 * b if causal
                     else t * (sum(lens) if lens else b * t))
            flops = 4 * pairs * h * d
            n_bytes = 4 * q.element_size() * b * t * h * d \
                + (4 * b * t if lens else 0)
            bms, by = bound_ms(n_bytes, flops, FLASH_FLOPS[dname])
            fma_bms, _ = bound_ms(n_bytes, flops, F32_FLOPS)
            res = {"phase": "flash_attention", "dtype": dname, "case": name,
                   "shape": [b, t, h, d], "max_abs_err": err, "ms": ms,
                   "ms_events": ms_events, "plain_ms": plain,
                   "library_ms": lib, "bound_ms": bms,
                   "bound_by": by, "bound_share": bms / ms,
                   "fma_bound_ms": fma_bms,
                   **launch_grid(b, t, h, d, dtype)}
            emit(res)
            results.append(res)
        kernels[dname] = {"name": f"flash_attention_{dname}",
                          "results": results}
    return kernels


def phase_snake(gen) -> dict:
    """Both snake entries at the four BigVGAN stages; → {dtype name: kernel
    record}, with the f32 path's launches per stage."""
    import torch

    from audiogpt_tpu_torch.ops.snake_aa import snake_aa, snake_aa_reference

    # BigVGANConfig() stages at 624 mel frames, batch 3; each stage has 18
    # activations (3 AMP blocks x 3 dilations x 2), the last one also act_post
    stages = [("stage0", 256, 4992, 18), ("stage1", 128, 39936, 18),
              ("stage2", 64, 79872, 18), ("stage3", 32, 159744, 19)]
    kernels = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        results, path = [], {}
        for name, c, t, n in stages:
            x = torch.randn(3, c, t, generator=gen, device="cuda").to(dtype)
            alpha = torch.exp(0.1 * torch.randn(c, generator=gen,
                                                device="cuda"))
            beta = torch.exp(0.1 * torch.randn(c, generator=gen,
                                               device="cuda"))
            out = snake_aa(x, alpha, beta)
            ref = snake_aa_reference(x, alpha, beta)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if dtype == torch.float32:
                ok = err <= 1e-5
            else:
                # both compute in f32 and round once to bf16: one step apart
                ok = bool((diff <= 2 ** -7 * ref.float().abs() + 1e-3).all())
            if not ok:
                raise AssertionError(f"snake_aa {dname} {name}: max abs err "
                                     f"{err}")
            ms = time_ms(lambda: snake_aa(x, alpha, beta), 50, graph=True)
            ms_events = time_ms(lambda: snake_aa(x, alpha, beta), 50)
            plain = time_ms(lambda: snake_aa_reference(x, alpha, beta), 20)
            copy = time_ms(lambda: x.clone(), 50, graph=True)
            # per output: 2×6 up taps and 12 down taps as FMAs, snake 5 ops
            # and a sine per phase, in f32 for both entries
            bms, by = bound_ms(2 * x.element_size() * x.numel() + 4 * 2 * c,
                               (2 * 24 + 2 * 6) * x.numel())
            res = {"phase": "snake_aa", "dtype": dname, "case": name,
                   "shape": [3, c, t], "max_abs_err": err, "ms": ms,
                   "ms_events": ms_events, "plain_ms": plain,
                   "library_ms": None, "copy_ms": copy,
                   "bound_ms": bms, "bound_by": by, "bound_share": bms / ms}
            emit(res)
            results.append(res)
            path[name] = n
        kernels[dname] = {"name": f"snake_aa_{dname}", "results": results,
                          "path": path}
    return kernels


def fill_random(module, gen) -> None:
    """Seeded noise in every parameter: weights normal · fan_in^-½, norm
    scales 1 + 0.1·N, biases and snake log-α/β 0.1·N."""
    import torch
    from torch import nn

    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                noise = torch.randn(p.shape, generator=gen, device=p.device)
                if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)) \
                        and name == "weight":
                    p.copy_(1.0 + 0.1 * noise)
                elif p.ndim >= 2:
                    p.copy_(noise / math.sqrt(p[0].numel()))
                else:
                    p.copy_(0.1 * noise)


def expected_launches(eng) -> dict:
    """Kernel launches of one ``txt2audio_best`` call, from the configs:
    the sampler's UNet evals (``ddim_steps(12)`` spaces 13 timesteps,
    range(0, 1000, 83)) times the level-0 self-attentions (Tq·Tk ≥ 256²:
    the down path's res blocks plus the up path's), and every BigVGAN AMP
    activation (2 per dilation) plus ``act_post``; the flash launches are
    bf16 under ``unet_bf16``, the vocoder's are f32."""
    cfg, vcfg = eng.cfg, eng.vocoder.cfg
    evals = len(eng.schedule.ddim_steps(cfg.tool_steps)[0])
    attn0 = 2 * cfg.unet.num_res_blocks + 1
    snakes = sum(2 * len(d) for d in vcfg.resblock_dilation_sizes)
    return {"flash_attention": evals * attn0,
            "flash_attention_bf16": evals * attn0 if cfg.unet_bf16 else 0,
            "snake_aa": len(vcfg.upsample_rates) * snakes + 1,
            "snake_aa_bf16": 0}


def counted_call(eng):
    """One ``txt2audio_best`` call with every launch count set to 0 just
    before it and read just after; → (output, seconds, counts)."""
    import torch

    from audiogpt_tpu_torch.ops.flash_attention import flash_attention
    from audiogpt_tpu_torch.ops.snake_aa import snake_aa

    flash_attention.launches = flash_attention.bf16_launches = 0
    snake_aa.launches = snake_aa.bf16_launches = 0
    t = time.perf_counter()
    out = eng.txt2audio_best(TEXT, n_samples=3, seed=0)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, {
        "flash_attention": flash_attention.launches,
        "flash_attention_bf16": flash_attention.bf16_launches,
        "snake_aa": snake_aa.launches,
        "snake_aa_bf16": snake_aa.bf16_launches}


def drive(eng) -> dict:
    """A cold and 10 warm counted calls; the counts must match the configs
    and the output must be a finite, non-silent wav and a mel in [0, 1]."""
    import torch

    _, cold_s, cold_counts = counted_call(eng)
    torch.cuda.reset_peak_memory_stats()
    (mel, wav, scores), warm_s, counts = counted_call(eng)
    expected = expected_launches(eng)
    if counts != expected or cold_counts != expected:
        raise AssertionError(f"launch counts {cold_counts}, {counts}; "
                             f"expected {expected}")
    if wav.shape != (159744,) or not bool(torch.isfinite(
            torch.from_numpy(wav)).all()) or float(wav.std()) == 0.0:
        raise AssertionError(f"wav {wav.shape}, std {wav.std()}")
    if mel.shape != (624, 80) or not (0.0 <= mel.min() <= mel.max() <= 1.0):
        raise AssertionError(f"mel {mel.shape} in [{mel.min()}, {mel.max()}]")
    if scores.tolist() != [0.0, 0.0, 0.0]:
        raise AssertionError(f"scores {scores}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    warm = sorted([warm_s] + [counted_call(eng)[1]
                              for _ in range(WARM_CALLS - 1)])
    median = statistics.median(warm)
    return {"call": "txt2audio_best", "n_samples": 3, "sampler": "dpmpp",
            "steps": 12, "cold_s": cold_s, "warm_s": median,
            "warm_max_s": warm[-1], "warm_calls": len(warm),
            "rtf": median / CLIP_SECONDS, "clip_s": CLIP_SECONDS,
            "peak_mem_gb": peak, "launches": counts,
            "wav_std": float(wav.std()), "mel_mean": float(mel.mean()),
            "mel": mel}


def phase_main_path(gen) -> dict:
    import torch

    from audiogpt_tpu_torch.engines import T2AConfig, T2AEngine, VocoderEngine

    t0 = time.perf_counter()
    voc = VocoderEngine("bigvgan", buckets=(624,))
    eng = T2AEngine(T2AConfig(), vocoder=voc)
    for m in (eng.unet, eng.vae, eng.clap, voc.model):
        fill_random(m, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res = drive(eng)
    mel = res.pop("mel")
    emit({"phase": "main_path", "setup_s": setup_s, **res})
    return {"engine": eng, "launches": res["launches"],
            "warm_s": res["warm_s"], "mel": mel}


def phase_main_path_bf16(f32: dict) -> dict:
    """The f32 engine's weights under ``T2AConfig(unet_bf16=True)`` (the UNet
    cast to bf16 once), same vocoder, same call and seed."""
    import dataclasses

    import numpy as np

    from audiogpt_tpu_torch.engines import T2AEngine

    base = f32["engine"]
    eng = T2AEngine(dataclasses.replace(base.cfg, unet_bf16=True),
                    vocoder=base.vocoder)
    for name in ("unet", "vae", "clap"):
        getattr(eng, name).load_state_dict(getattr(base, name).state_dict())
    res = drive(eng)
    mel = res.pop("mel")
    res["mel_max_abs_diff_from_f32"] = float(np.abs(mel - f32["mel"]).max())
    res["warm_s_f32"] = f32["warm_s"]
    runs = [stage_ms(eng) for _ in range(STAGE_RUNS)]
    res["stages_ms"] = {k: statistics.median(r[k] for r in runs)
                        for k in runs[0]}
    emit({"phase": "main_path_bf16", "config": "unet_bf16", **res})
    return {"launches": res["launches"], "warm_s": res["warm_s"]}


def phase_small_reference() -> None:
    """A narrow engine on the card (kernels) against the same weights on the
    CPU (plain versions): the level-0 latent has 16 × 32 = 512 tokens, so
    the flash path is taken on the card."""
    import torch

    from audiogpt_tpu_torch.engines import T2AConfig, T2AEngine, VocoderEngine
    from audiogpt_tpu_torch.models.diffusion import UNetConfig, VAEConfig
    from audiogpt_tpu_torch.models.textenc import BertConfig, CLAPTextConfig
    from audiogpt_tpu_torch.models.vocoder import BigVGANConfig
    from audiogpt_tpu_torch.ops.flash_attention import flash_attention
    from audiogpt_tpu_torch.ops.snake_aa import snake_aa

    cfg = T2AConfig(
        unet=UNetConfig(model_channels=64, num_res_blocks=1, num_heads=2,
                        context_dim=64),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(), resolution=64),
        clap=CLAPTextConfig(bert=BertConfig(vocab_size=30522, hidden_size=64,
                                            num_layers=2, num_heads=2,
                                            intermediate_size=128),
                            d_proj=64),
        mel_bins=32, mel_len=64, timesteps=1000)
    vcfg = BigVGANConfig(num_mels=32, upsample_initial_channel=64,
                         upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8))
    outs = {}
    for dev in ("cpu", "cuda"):
        voc = VocoderEngine("bigvgan", cfg=vcfg, buckets=(64,), device=dev)
        eng = T2AEngine(cfg, vocoder=voc, device=dev)
        if dev == "cpu":
            g = torch.Generator().manual_seed(5)
            for m in (eng.unet, eng.vae, eng.clap, voc.model):
                fill_random(m, g)
            state = [m.state_dict() for m in (eng.unet, eng.vae, eng.clap,
                                              voc.model)]
            x_T = torch.randn(2, 4, 16, 32, generator=g)
        else:
            for m, sd in zip((eng.unet, eng.vae, eng.clap, voc.model), state):
                m.load_state_dict(sd)
        flash_attention.launches = snake_aa.launches = 0
        both = eng.encode_text([TEXT] * 2 + [""] * 2)
        mel = eng.sample_core(both[:2], both[2:], x_T.to(dev), 1.5,
                              cfg.tool_steps, cfg.tool_sampler)
        wav = voc.vocode(mel[:, 0])
        outs[dev] = (mel.cpu(), wav.cpu(), flash_attention.launches,
                     snake_aa.launches)
        expected = expected_launches(eng)
    mel_err = (outs["cpu"][0] - outs["cuda"][0]).abs().max().item()
    wav_err = (outs["cpu"][1] - outs["cuda"][1]).abs().max().item()
    res = {"phase": "small_reference", "mel_max_abs_err": mel_err,
           "wav_max_abs_err": wav_err, "cuda_launches": {
               "flash_attention": outs["cuda"][2], "snake_aa": outs["cuda"][3]},
           "cpu_launches": {"flash_attention": outs["cpu"][2],
                            "snake_aa": outs["cpu"][3]}}
    emit(res)
    # f32 on both sides, TF32 off; 12 sampler steps, the VAE and the vocoder
    # sum in other orders on the card: 1e-3 absolute on outputs in [-1, 1]
    if not (mel_err <= 1e-3 and wav_err <= 1e-3):
        raise AssertionError(f"card vs CPU: mel {mel_err}, wav {wav_err}")
    if (outs["cuda"][2], outs["cuda"][3]) != (expected["flash_attention"],
                                              expected["snake_aa"]):
        raise AssertionError(f"small-path launches {res['cuda_launches']}, "
                             f"expected {expected}")
    if outs["cpu"][2] or outs["cpu"][3]:
        raise AssertionError("a CPU run counted kernel launches")


def phase_profile(eng, warm_s: float) -> None:
    """One warm main-path call under torch.profiler: device time by kernel
    and the device's busy share, of the traced call (tracing slows the host)
    and of the untraced warm median ``warm_s``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.txt2audio_best(TEXT, n_samples=3, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    # device-side events only (kernels, copies): the operator rows above
    # them carry the same device time again
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    emit({"phase": "profile", "wall_s": wall, "device_s": busy_us / 1e6,
          "device_busy_share": busy_us / 1e6 / wall,
          "device_busy_share_untraced": busy_us / 1e6 / warm_s,
          "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                  for e in top]})
    runs = [stage_ms(eng) for _ in range(STAGE_RUNS)]
    emit({"phase": "stages", "runs": STAGE_RUNS,
          **{k: statistics.median(r[k] for r in runs) for k in runs[0]}})


def stage_ms(eng) -> dict:
    """Time of each layer of one warm ``txt2audio_best`` call, the engine's
    steps run one by one between CUDA events (device time plus any gap in
    which the host had not yet queued the work)."""
    import torch

    from audiogpt_tpu_torch.engines.t2a import SAMPLERS

    cfg = eng.cfg
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.inference_mode():
        marks[0].record()
        ctx, uc, x_T = eng._prep_candidates(TEXT, 3, 0)
        marks[1].record()
        z = SAMPLERS[cfg.tool_sampler](
            eng.eps, eng.schedule, x_T, ctx, uc, n_steps=cfg.tool_steps,
            guidance_scale=1.5)
        marks[2].record()
        mel = ((eng.vae.decode(z / cfg.scale_factor) + 1.0) / 2.0).clamp(0, 1)
        marks[3].record()
        eng.vocoder.vocode(mel[:, 0])
        marks[4].record()
    marks[4].synchronize()
    names = ("clap_text_ms", "unet_sampler_ms", "vae_decode_ms",
             "bigvgan_ms")
    return {n: a.elapsed_time(b) for n, a, b in zip(names, marks, marks[1:])}


def kernel_entry(k: dict, weights: dict, launches: int, source: str,
                 replaces: str, basis: str) -> dict:
    """One kernel of the JSON line: per-launch times at each shape, summed
    with ``weights`` (launches per call at each shape); ``launches`` is the
    count of the path's counted call."""
    by_case = {r["case"]: r for r in k["results"]}

    def total(key):
        if any(by_case[c].get(key) is None for c in weights):
            return None
        return sum(n * by_case[c][key] for c, n in weights.items())

    ops_bound = all(by_case[c]["bound_by"] == "operations" for c in weights)
    entry = {"name": k["name"], "route": "cuda", "source": source,
             "replaces": replaces, "tpu_kernel": replaces,
             "launches": launches, "launches_per_call": launches,
             "max_abs_err": max(r["max_abs_err"] for r in k["results"]),
             "ms": total("ms"), "kernel_ms": total("ms"),
             "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
             "bound_by": "operations" if ops_bound else "bytes",
             "library_ms": total("library_ms"), "ms_basis": basis,
             "path_shapes": weights}
    for key in ("ms_events", "fma_bound_ms", "copy_ms"):
        if key in k["results"][0]:
            entry[key] = total(key)
    return entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import audiogpt_tpu_torch  # noqa: F401  (fails outside the repo)

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "probe", "card": card,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    phase_build()
    gen = torch.Generator("cuda").manual_seed(0)
    flash = phase_flash(gen)
    snake = phase_snake(gen)
    main_path = phase_main_path(gen)
    bf16_path = phase_main_path_bf16(main_path)
    phase_small_reference()
    phase_profile(main_path["engine"], main_path["warm_s"])
    counts, counts_bf16 = main_path["launches"], bf16_path["launches"]
    flash_f32 = counts["flash_attention"] - counts["flash_attention_bf16"]
    snake_f32 = counts["snake_aa"] - counts["snake_aa_bf16"]
    stage_mix = snake["float32"]["path"]
    if sum(stage_mix.values()) != snake_f32:
        raise AssertionError(f"snake stages {stage_mix} vs {counts}")
    per_call = "sum over one main-path call's launches"
    flash_src = "audiogpt_tpu_torch/csrc/flash_attention.cu"
    flash_tpu = "audiogpt_tpu/ops/flash_attention.py:143"
    snake_src = "audiogpt_tpu_torch/csrc/snake_aa.cu"
    snake_tpu = "audiogpt_tpu/ops/snake_aa.py:117"
    emit({"kernels": [
        kernel_entry(flash["float32"], {"unet_level0": flash_f32}, flash_f32,
                     flash_src, flash_tpu, per_call),
        kernel_entry(flash["bfloat16"],
                     {"unet_level0": counts_bf16["flash_attention_bf16"]},
                     counts_bf16["flash_attention_bf16"], flash_src,
                     flash_tpu, "sum over one unet_bf16 main-path call's "
                     "launches"),
        kernel_entry(snake["float32"], stage_mix, snake_f32, snake_src,
                     snake_tpu, per_call),
        kernel_entry(snake["bfloat16"], stage_mix, counts["snake_aa_bf16"],
                     snake_src, snake_tpu, "no bf16 vocoder path yet (0 "
                     "launches): times summed over the f32 path's stage "
                     "mix")]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
