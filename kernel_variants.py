#!/usr/bin/env python3
"""Times the design alternatives the Hopper kernels turned down, against
the kernels as they are, on one card.

    python3 kernel_variants.py [--cases all] [--only NAME ...]
        [--baseline FILE.cu] [SOURCE ...]

Each variant is a kernel source of ``audiogpt_tpu_torch/csrc/`` with one
textual change, built by ``nvcc`` (all builds started together) into a
library of its own. Every variant runs at its kernel's cases in the dtypes
its source takes (``flash_attention_sm90_f32.cu``: f32;
``flash_attention_sm90.cu``: bf16; ``snake_aa.cu``: both), is checked
against the plain version, and is timed over a CUDA graph of 50 launches
(device time), in two rounds, the second in reverse order. Prints one JSON
line per variant and round (with the K1 paths' totals, launches times
per-launch ms, where its cases cover a path), then the card's name and
power limit. Names of sources limit the run to their variants, ``--only``
to variants of those names; ``--cases all`` takes ``chip_smoke.py``'s 24
flash cases in place of the nine below; ``--baseline`` builds another
f32 flash source (an earlier commit's, say) as the variant "baseline" of
the f32 entry, timed in the same turns. Needs the card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: both flash kernels' choice of consumer warpgroups a block
_CONSUMERS = "  return best;\n}"
#: source → variant → [(text in the source, replacement[, times the text
#: occurs, if not once])]
VARIANTS = {
    "flash_attention_sm90_f32.cu": {
        "as is": [],
        # a two-stage ring in place of as many stages as fit, up to 4
        "two stages": [("static constexpr int kStages = kFit < 4 ? kFit : 4;",
                        "static constexpr int kStages = 2;")],
        # 32-key tiles at DP <= 48 too (N = 32 for S)
        "32-key tiles to DP 48": [(
            "static constexpr int kBK = DP <= 48 ? 64 :",
            "static constexpr int kBK = DP <= 48 ? 32 :")],
        # 64-key tiles at DP = 64 too (fewer stages fit)
        "64-key tiles to DP 64": [(
            "static constexpr int kBK = DP <= 48 ? 64 :",
            "static constexpr int kBK = DP <= 64 ? 64 :")],
        # each tile's transform by all consumer threads before they use it
        "transform by consumers": [(
            "constexpr bool kTransformByProducer = true;",
            "constexpr bool kTransformByProducer = false;")],
        # hi and lo rounded to nearest TF32 (K's hi written in place)
        "rounded split": [("constexpr bool kRoundedSplit = false;",
                           "constexpr bool kRoundedSplit = true;")],
        "64-row blocks": [(_CONSUMERS, "  return 1;\n}")],
        "128-row blocks": [(_CONSUMERS, "  return 2;\n}")],
        "192-row blocks": [(_CONSUMERS, "  return 3;\n}")],
        # a block's consumer warpgroups issue their products without taking
        # turns
        "no turns": [
            ("  if (NC > 1 && wg == NC - 1) named_arrive(1, 256);\n", ""),
            ("    if (NC > 1) named_sync(1 + wg, 256);\n", ""),
            ("if (NC > 1) named_arrive(next_turn, 256);", ";", 4)],
        # O += P.V on each warp's mma.sync, S on wgmma
        "P.V on mma.sync": [("constexpr bool kPvMmaSync = false;",
                             "constexpr bool kPvMmaSync = true;")],
        # D = 40 padded to 48 (three 64-byte column blocks, P.V's N = 48)
        # instead of five 32-byte blocks at 40
        "D 40 at 48": [("  if (D <= 40) return f(std::integral_constant<int, "
                        "40>());\n", "")],
        "L2 256B": [("CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                     "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
        # where the time goes: each drops work and gives wrong results
        "timing only: S without its lo products": [
            ("        wgmma_ss<kBK>(s, desc_k<DP>(qlo_s, kRows, kk), kd, "
             "kk > 0);\n"
             "        wgmma_ss<kBK>(s, desc_k<DP>(q_s, kRows, kk), klo, 1);\n",
             "")],
        "timing only: P.V without its lo products": [(
            "      wgmma_rs<DP>(o, pl[kk], desc_vt<DP>(vt, kk), 1);\n"
            "      wgmma_rs<DP>(o, ph[kk], desc_vt<DP>(vtl, kk), 1);\n", "")],
        "timing only: no transform": [
            ("  for (int j = t / 32; j < kJobs; j += nt / 32) {",
             "  for (int j = t / 32; j < 0; j += nt / 32) {"),
            ("  for (int i = t; i < kT / 16; i += nt) {",
             "  for (int i = t; i < 0; i += nt) {")],
    },
    "flash_attention_sm90.cu": {
        "as is": [],
        "two stages": [("constexpr int kStages = 3;   // K/V tiles in flight",
                        "constexpr int kStages = 2;")],
        # a block's consumer warpgroups issue their products without taking
        # turns
        "no turns": [
            ("  if (NC > 1 && wg == NC - 1) named_arrive(1, 256);\n", ""),
            ("    if (NC > 1) named_sync(1 + wg, 256);\n", ""),
            ("if (NC > 1) named_arrive(next_turn, 256);", ";", 3)],
        # D = 40 padded to 64 (one 128-byte column block) instead of 48
        # (three of 32 bytes), D = 80 to 96 (three of 64) instead of 80
        "D 40 at 64": [("  if (D <= 48) return f(std::integral_constant<int, "
                        "48>());\n", "")],
        "D 80 at 96": [("  if (D <= 80) return f(std::integral_constant<int, "
                        "80>());\n", "")],
        "L2 256B": [("CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                     "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
        # the block's rows fixed, not chosen by the cost rule
        "64-row blocks": [(_CONSUMERS, "  return 1;\n}")],
        "128-row blocks": [(_CONSUMERS, "  return 2;\n}")],
        "192-row blocks": [(_CONSUMERS, "  return 3;\n}")],
    },
    "snake_aa.cu": {
        "as is": [],
        "rintf": [("  const float n = (arg * kInvTwoPi + kRound) - kRound;",
                   "  const float n = rintf(arg * kInvTwoPi);")],
    },
}
#: name, (B, Tq, Tk, H, D), key lengths or None (``chip_smoke.py``'s
#: cases of the same names, without a causal mask)
FLASH_CASES = [("unet_level0", (6, 780, 780, 8, 40), None),
               ("kv_mask", (2, 1500, 1500, 6, 64), (1500, 1100)),
               ("t2i_self_ds1", (2, 4096, 4096, 8, 40), None),
               ("t2i_cross_ds1", (2, 4096, 77, 8, 40), None),
               ("t2i_self_ds2", (2, 1024, 1024, 8, 80), None),
               ("asr_encoder", (1, 1500, 1500, 8, 64), None),
               ("asr_long_encoder", (4, 1500, 1500, 8, 64), None),
               ("t2a_mesh_level0", (4, 780, 780, 8, 40), None),
               ("i2a_unet_level0", (2, 780, 780, 8, 40), None)]
SNAKE_CASES = [("stage0", 256, 4992), ("stage1", 128, 39936)]
#: source → (kind, its entries by dtype name)
ENTRIES = {"flash_attention_sm90_f32.cu": (
               "flash", {"float32": "flash_attention_f32"}),
           "flash_attention_sm90.cu": (
               "flash", {"bfloat16": "flash_attention_bf16"}),
           "snake_aa.cu": ("snake", {"float32": "snake_aa_f32",
                                     "bfloat16": "snake_aa_bf16"})}


#: K1's paths and their launches a call by case (``chip_smoke.py``'s
#: ``kernels`` line): the main path's 65 UNet level-0 calls, T2I's 250 at
#: each of its five shapes
PATHS = {"main_path": {"unet_level0": 65},
         "t2i": {case: 250 for case in ("t2i_self_ds1", "t2i_cross_ds1",
                                        "t2i_self_ds2", "t2i_cross_ds2",
                                        "t2i_self_ds4")}}
def build(src: str, name: str, edits: list, out_dir: Path,
          path: Path | None = None) -> tuple[Path, int]:
    """Builds ``src`` (``csrc/`` or, given, ``path``) with ``edits`` into a
    library of its own; → (library, ptxas' largest spill of its kernels in
    bytes)."""
    from audiogpt_tpu_torch.ops import _build

    text = (path or _build.CSRC_DIR / src).read_text()
    for old, new, *count in edits:
        if text.count(old) != (count[0] if count else 1):
            raise RuntimeError(f"{src} / {name}: the source no longer has "
                               f"{old!r} as often")
        text = text.replace(old, new)
    stem = f"{Path(src).stem}_{re.sub(r'[^0-9A-Za-z]+', '_', name)}"
    cu, lib = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
    cu.write_text(text)
    done = subprocess.run(
        [_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
         "-I", str(_build.CSRC_DIR), "-shared", str(cu), "-o", str(lib)],
        capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"{src} / {name}: nvcc failed\n{done.stdout}"
                           f"{done.stderr}")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                         done.stdout + done.stderr)]
    return lib, max(spills, default=0)


def graph_ms(fn, iters: int = 50) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def inputs(gen, flash_cases: list) -> dict:
    """(kind, dtype name, case) → (tensors, causal, plain result)."""
    import torch

    from audiogpt_tpu_torch.ops.flash_attention import \
        flash_attention_reference
    from audiogpt_tpu_torch.ops.snake_aa import snake_aa_reference

    data = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for case, (b, tq, tk, h, d), lens, causal in flash_cases:
            q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                       .to(dtype) for t in (tq, tk, tk))
            mask = None if lens is None else (
                torch.arange(tk, device="cuda")[None]
                < torch.tensor(lens, device="cuda")[:, None]).float()
            ref = flash_attention_reference(q, k, v, kv_mask=mask,
                                            causal=causal)
            data["flash", dname, case] = ((q, k, v, mask), causal,
                                          ref.float())
        for case, c, t in SNAKE_CASES:
            x = torch.randn(3, c, t, generator=gen, device="cuda").to(dtype)
            alpha, beta = (torch.exp(0.1 * torch.randn(
                c, generator=gen, device="cuda")) for _ in range(2))
            data["snake", dname, case] = (
                (x, alpha, beta), False,
                snake_aa_reference(x, alpha, beta).float())
    return data


def run_variant(lib_path: Path, src: str, data: dict) -> dict:
    import torch

    from audiogpt_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(lib_path))
    stream = torch.cuda.current_stream
    kind, entries = ENTRIES[src]
    row = {}
    for (k, dname, case), (args, causal, ref) in data.items():
        if k != kind or dname not in entries:
            continue
        entry = entries[dname]
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        if kind == "flash":
            q, k_, v, mask = args
            b, tq, h, d = q.shape
            out = torch.empty_like(q)

            def call():
                return fn(q.data_ptr(), k_.data_ptr(), v.data_ptr(),
                          None if mask is None else mask.data_ptr(),
                          out.data_ptr(), b, tq, k_.shape[1], h, d,
                          d ** -0.5, int(causal), stream().cuda_stream)
        else:
            x, alpha, beta = args
            out = torch.empty_like(x)

            def call():
                return fn(x.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                          out.data_ptr(), *x.shape, stream().cuda_stream)
        _build.check(call(), entry)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        row[f"{dname}/{case}"] = {"ms": graph_ms(call), "max_abs_err": err}
    return row


def path_totals(row: dict) -> dict:
    """Each K1 path's ms a call (launches times per-launch ms) in each
    dtype whose cases cover it."""
    out = {}
    for path, launches in PATHS.items():
        for dname in ("float32", "bfloat16"):
            keys = [f"{dname}/{case}" for case in launches]
            if all(key in row for key in keys):
                out[f"{dname}/{path}"] = sum(
                    n * row[key]["ms"] for key, n in zip(keys,
                                                        launches.values()))
    return out


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("sources", nargs="*", default=list(VARIANTS))
    parser.add_argument("--cases", choices=("paths", "all"), default="paths")
    parser.add_argument("--only", action="append", default=[])
    parser.add_argument("--baseline", type=Path)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from audiogpt_tpu_torch.ops import _build

    flash_cases = [(name, shape, lens, False)
                   for name, shape, lens in FLASH_CASES]
    if args.cases == "all":
        flash_cases = [(name, shape, lens, causal) for name, (
            shape, lens, causal) in chip_smoke.FLASH_CASES.items()]
    jobs = [(src, name, edits, None) for src in args.sources
            for name, edits in VARIANTS[src].items()
            if not args.only or name in args.only]
    if args.baseline is not None:
        jobs.insert(0, ("flash_attention_sm90_f32.cu", "baseline", [],
                        args.baseline.resolve()))
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp, \
            ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: build(*j[:3], Path(tmp), j[3]),
                             jobs))
        data = inputs(torch.Generator("cuda").manual_seed(0), flash_cases)
        order = list(zip(jobs, libs))
        for rnd, seq in enumerate((order, order[::-1])):
            for (src, name, _, _), (lib, spills) in seq:
                row = run_variant(lib, src, data)
                print(json.dumps({"source": src, "variant": name,
                                  "round": rnd, "spill_bytes": spills,
                                  "paths": path_totals(row), **row}),
                      flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
