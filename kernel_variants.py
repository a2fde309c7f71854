#!/usr/bin/env python3
"""Times the design alternatives the two Hopper kernels turned down, against
the kernels as they are, on one card.

    python3 kernel_variants.py [SOURCE ...]

Each variant is a kernel source of ``audiogpt_tpu_torch/csrc/`` with one
textual change, built by ``nvcc`` (all builds started together) into a
library of its own. Every variant runs at its kernel's cases in the dtypes
its source takes (``flash_attention.cu``: f32; ``flash_attention_sm90.cu``:
bf16; ``snake_aa.cu``: both), is checked against the plain version, and is
timed over a CUDA graph of 50 launches (device time), in two rounds, the
second in reverse order. Prints one JSON line per variant and round, then
the card's name and power limit. Names of sources (``flash_attention_sm90.cu``)
limit the run to their variants. Needs the card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: the bf16 kernel's choice of consumer warpgroups a block
_CONSUMERS = "  return best;\n}"
#: source → variant → [(text in the source, replacement[, times the text
#: occurs, if not once])]
VARIANTS = {
    "flash_attention.cu": {
        "as is": [],
        # both TF32 halves rounded to nearest instead of truncated
        "rounded TF32 split": [(
            "  hi = __float_as_uint(x) & 0xffffe000u;\n"
            "  lo = __float_as_uint(x - __uint_as_float(hi));",
            '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
            "  const float rest = x - __uint_as_float(hi);\n"
            '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));')],
        # no minimum of resident blocks asked of ptxas
        "no min blocks": [("__launch_bounds__(kThreads, Layout<DP>::"
                           "kMinBlocks)", "__launch_bounds__(kThreads)")],
        "exp2f": [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : '
                   '"f"(x));', "  y = exp2f(x);")],
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
#: cases of the same names)
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
ENTRIES = {"flash_attention.cu": ("flash", {"float32": "flash_attention_f32"}),
           "flash_attention_sm90.cu": (
               "flash", {"bfloat16": "flash_attention_bf16"}),
           "snake_aa.cu": ("snake", {"float32": "snake_aa_f32",
                                     "bfloat16": "snake_aa_bf16"})}


def build(src: str, name: str, edits: list, out_dir: Path) -> Path:
    from audiogpt_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / src).read_text()
    for old, new, *count in edits:
        if text.count(old) != (count[0] if count else 1):
            raise RuntimeError(f"{src} / {name}: the source no longer has "
                               f"{old!r} as often")
        text = text.replace(old, new)
    stem = f"{Path(src).stem}_{name.replace(' ', '_')}"
    cu, lib = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
    cu.write_text(text)
    subprocess.run([_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
                    "-shared", str(cu), "-o", str(lib)], check=True,
                   capture_output=True, text=True)
    return lib


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


def inputs(gen) -> dict:
    """(kind, dtype name, case) → (tensors, plain result)."""
    import torch

    from audiogpt_tpu_torch.ops.flash_attention import \
        flash_attention_reference
    from audiogpt_tpu_torch.ops.snake_aa import snake_aa_reference

    data = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for case, (b, tq, tk, h, d), lens in FLASH_CASES:
            q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                       .to(dtype) for t in (tq, tk, tk))
            mask = None if lens is None else (
                torch.arange(tk, device="cuda")[None]
                < torch.tensor(lens, device="cuda")[:, None]).float()
            ref = flash_attention_reference(q, k, v, kv_mask=mask)
            data["flash", dname, case] = ((q, k, v, mask), ref.float())
        for case, c, t in SNAKE_CASES:
            x = torch.randn(3, c, t, generator=gen, device="cuda").to(dtype)
            alpha, beta = (torch.exp(0.1 * torch.randn(
                c, generator=gen, device="cuda")) for _ in range(2))
            data["snake", dname, case] = (
                (x, alpha, beta), snake_aa_reference(x, alpha, beta).float())
    return data


def run_variant(lib_path: Path, src: str, data: dict) -> dict:
    import torch

    from audiogpt_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(lib_path))
    stream = torch.cuda.current_stream
    kind, entries = ENTRIES[src]
    row = {}
    for (k, dname, case), (args, ref) in data.items():
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
                          d ** -0.5, 0, stream().cuda_stream)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from audiogpt_tpu_torch.ops import _build

    chosen = sys.argv[1:] or list(VARIANTS)
    jobs = [(src, name, edits) for src in chosen
            for name, edits in VARIANTS[src].items()]
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp, \
            ThreadPoolExecutor(
            len(jobs)) as pool:
        libs = list(pool.map(lambda j: build(*j, Path(tmp)), jobs))
        data = inputs(torch.Generator("cuda").manual_seed(0))
        order = list(zip(jobs, libs))
        for rnd, seq in enumerate((order, order[::-1])):
            for (src, name, _), lib in seq:
                print(json.dumps({"source": src, "variant": name,
                                  "round": rnd,
                                  **run_variant(lib, src, data)}),
                      flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
