#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``audiogpt_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. probe: CUDA must be present; the card's name and power limit; TF32 off.
2. build: ``nvcc`` compiles ``audiogpt_tpu_torch/csrc/*.cu`` for sm_90a.
3. flash_attention: the kernel against its plain version at the UNet shape
   and two more; kernel, plain and ``scaled_dot_product_attention`` times.
4. snake_aa: the kernel against the plain up → snake → down chain at the four
   BigVGAN stage shapes; kernel and plain times.
5. main_path: ``T2AEngine(T2AConfig(), vocoder=VocoderEngine("bigvgan"))`` at
   full width with seeded random weights runs ``txt2audio_best`` (3
   candidates, DPM-Solver++(2M)-12, CFG); the launch counters show that it
   went through both kernels; the median and the slowest of 10 warm calls
   are reported (host clock, each call ending in a synchronise).
6. small_reference: a narrow engine on the card against the same engine on
   the CPU (plain versions), same weights and initial noise.
7. profile: one warm main-path call under ``torch.profiler`` (device time by
   kernel; the device's busy share of the traced call and of the untraced
   warm median), then the time of each layer (text tower, sampler, VAE
   decode, vocoder) between CUDA events, median of 5 runs.

Before the last line: ``{"kernels": [...]}`` and the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``. Times are
measured with CUDA events after a warmup; bounds use the H100 SXM peaks
(3.35 TB/s, 67 TFLOP/s f32 without tensor cores).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
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


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_build() -> None:
    from audiogpt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    ptxas = [line.strip() for line in
             (_build.BUILD_DIR / "build.log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib.name, "ptxas": ptxas})


def phase_flash(gen) -> dict:
    import torch
    import torch.nn.functional as F

    from audiogpt_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    cases = [("unet_level0", (6, 780, 8, 40), None, False),
             ("kv_mask", (2, 1500, 6, 64), (1500, 1100), False),
             ("causal", (1, 256, 2, 80), None, True)]
    results = []
    for name, (b, t, h, d), lens, causal in cases:
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                   for _ in range(3))
        mask = None
        if lens is not None:
            mask = (torch.arange(t, device="cuda")[None]
                    < torch.tensor(lens, device="cuda")[:, None]).float()
        out = flash_attention(q, k, v, kv_mask=mask, causal=causal)
        ref = flash_attention_reference(q, k, v, kv_mask=mask, causal=causal)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"flash_attention {name}: max abs err {err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_mask = None if mask is None else (mask > 0)[:, None, None, :]
        ms = time_ms(lambda: flash_attention(q, k, v, kv_mask=mask,
                                             causal=causal), 50)
        plain = time_ms(lambda: flash_attention_reference(
            q, k, v, kv_mask=mask, causal=causal), 20)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask, is_causal=causal), 50)
        # pairs this run's data needs: valid keys per row, or the triangle
        pairs = (t * (t + 1) / 2 * b if causal
                 else t * (sum(lens) if lens else b * t))
        n_bytes = 4 * 4 * b * t * h * d + (4 * b * t if lens else 0)
        bms, by = bound_ms(n_bytes, 4 * pairs * h * d)
        res = {"phase": "flash_attention", "case": name,
               "shape": [b, t, h, d], "max_abs_err": err, "ms": ms,
               "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
               "bound_by": by}
        emit(res)
        results.append(res)
    return {"name": "flash_attention", "results": results}


def phase_snake(gen) -> dict:
    import torch

    from audiogpt_tpu_torch.ops.snake_aa import snake_aa, snake_aa_reference

    # BigVGANConfig() stages at 624 mel frames, batch 3; each stage has 18
    # activations (3 AMP blocks x 3 dilations x 2), the last one also act_post
    stages = [("stage0", 256, 4992, 18), ("stage1", 128, 39936, 18),
              ("stage2", 64, 79872, 18), ("stage3", 32, 159744, 19)]
    results, path = [], {}
    for name, c, t, n in stages:
        x = torch.randn(3, c, t, generator=gen, device="cuda")
        alpha = torch.exp(0.1 * torch.randn(c, generator=gen, device="cuda"))
        beta = torch.exp(0.1 * torch.randn(c, generator=gen, device="cuda"))
        out = snake_aa(x, alpha, beta)
        ref = snake_aa_reference(x, alpha, beta)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"snake_aa {name}: max abs err {err}")
        ms = time_ms(lambda: snake_aa(x, alpha, beta), 50)
        plain = time_ms(lambda: snake_aa_reference(x, alpha, beta), 20)
        # per output: 2×6 up taps and 12 down taps as FMAs, snake 5 ops and
        # a sine per phase
        bms, by = bound_ms(4 * 2 * x.numel() + 4 * 2 * c,
                           (2 * 24 + 2 * 6) * x.numel())
        res = {"phase": "snake_aa", "case": name, "shape": [3, c, t],
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "library_ms": None, "bound_ms": bms, "bound_by": by}
        emit(res)
        results.append(res)
        path[name] = n
    return {"name": "snake_aa", "results": results, "path": path}


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
    activation (2 per dilation) plus ``act_post``."""
    cfg, vcfg = eng.cfg, eng.vocoder.cfg
    evals = len(eng.schedule.ddim_steps(cfg.tool_steps)[0])
    attn0 = 2 * cfg.unet.num_res_blocks + 1
    snakes = sum(2 * len(d) for d in vcfg.resblock_dilation_sizes)
    return {"flash_attention": evals * attn0,
            "snake_aa": len(vcfg.upsample_rates) * snakes + 1}


def phase_main_path(gen) -> dict:
    import torch

    from audiogpt_tpu_torch.engines import T2AConfig, T2AEngine, VocoderEngine
    from audiogpt_tpu_torch.ops.flash_attention import flash_attention
    from audiogpt_tpu_torch.ops.snake_aa import snake_aa

    t0 = time.perf_counter()
    voc = VocoderEngine("bigvgan", buckets=(624,))
    eng = T2AEngine(T2AConfig(), vocoder=voc)
    for m in (eng.unet, eng.vae, eng.clap, voc.model):
        fill_random(m, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def run():
        flash_attention.launches = snake_aa.launches = 0
        t = time.perf_counter()
        out = eng.txt2audio_best(TEXT, n_samples=3, seed=0)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, {
            "flash_attention": flash_attention.launches,
            "snake_aa": snake_aa.launches}

    _, cold_s, cold_counts = run()
    torch.cuda.reset_peak_memory_stats()
    (mel, wav, scores), warm_s, counts = run()
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
    warm = sorted([warm_s] + [run()[1] for _ in range(WARM_CALLS - 1)])
    median = statistics.median(warm)
    res = {"phase": "main_path", "call": "txt2audio_best", "n_samples": 3,
           "sampler": "dpmpp", "steps": 12, "setup_s": setup_s,
           "cold_s": cold_s, "warm_s": median, "warm_max_s": warm[-1],
           "warm_calls": len(warm), "rtf": median / CLIP_SECONDS,
           "clip_s": CLIP_SECONDS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "wav_std": float(wav.std()),
           "mel_mean": float(mel.mean())}
    emit(res)
    return {"engine": eng, "launches": counts, "warm_s": median}


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
    if (outs["cuda"][2], outs["cuda"][3]) != tuple(expected.values()):
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
            eng.unet, eng.schedule, x_T, ctx, uc, n_steps=cfg.tool_steps,
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


def kernel_entry(k: dict, path: dict, route: str, source: str,
                 replaces: str) -> dict:
    """One kernel of the JSON line: times summed over the main path's
    launches (per-launch time at each shape × launches at that shape)."""
    by_case = {r["case"]: r for r in k["results"]}
    launches = sum(path.values())

    def total(key):
        if any(by_case[c][key] is None for c in path):
            return None
        return sum(n * by_case[c][key] for c, n in path.items())

    ops_bound = all(by_case[c]["bound_by"] == "operations" for c in path)
    return {"name": k["name"], "route": route, "source": source,
            "replaces": replaces, "tpu_kernel": replaces,
            "launches": launches, "launches_per_call": launches,
            "max_abs_err": max(r["max_abs_err"] for r in k["results"]),
            "ms": total("ms"), "kernel_ms": total("ms"),
            "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "operations" if ops_bound else "bytes",
            "library_ms": total("library_ms"),
            "ms_basis": "sum over one main-path call's launches",
            "path_shapes": path}


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
    phase_small_reference()
    phase_profile(main_path["engine"], main_path["warm_s"])
    counts = main_path["launches"]
    if sum(snake["path"].values()) != counts["snake_aa"]:
        raise AssertionError(f"snake stages {snake['path']} vs {counts}")
    emit({"kernels": [
        kernel_entry(flash, {"unet_level0": counts["flash_attention"]},
                     "cuda",
                     "audiogpt_tpu_torch/csrc/flash_attention.cu",
                     "audiogpt_tpu/ops/flash_attention.py:143"),
        kernel_entry(snake, snake["path"], "cuda",
                     "audiogpt_tpu_torch/csrc/snake_aa.cu",
                     "audiogpt_tpu/ops/snake_aa.py:117")]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
