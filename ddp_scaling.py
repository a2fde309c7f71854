#!/usr/bin/env python3
"""Data-parallel scaling of the LDM recipe: ``train_cli`` on
``configs/t2a/ldm.yaml`` under torchrun at each rank count, on the same
seeded records, global batch and seed.

    python ddp_scaling.py --ranks 1 4              # the cards
    python ddp_scaling.py --ranks 1 4 --hparams model.bf16_compute=false
    python ddp_scaling.py --ranks 1 4 --device cpu --frames 32 \\
        --mels 16 --hparams "model.unet.model_channels=32,..."

The yaml trains in bf16 (``model.bf16_compute``); the second line, in
f32. Each run is ``python -m torch.distributed.run --standalone
--nproc-per-node N -m audiogpt_tpu_torch.train_cli ... --report`` (NCCL
on the cards, with TF32 off through ``NVIDIA_TF32_OVERRIDE=0``; gloo with
``--device cpu``). Prints one JSON line a run (the median step time over
the steps after the first three, the gradient all-reduce's ms a step from
CUDA events, rank 0's peak device memory, the losses) and a last line
holding each run's largest loss difference from the first run's, relative,
and its step time against the first's. Its records and work dirs (each
run ends in a checkpoint: ≈ 2.6 GB at full width) go to a temporary
directory.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WARM = 3        # steps left out of the medians (FLOP count, first blocks)


def run(ranks: int, args, bin_dir: Path, out: Path) -> dict:
    work = out / f"ranks{ranks}"
    hp = ",".join(filter(None, [
        f"data.binary_dir={bin_dir}", "log_interval=1",
        "num_sanity_val_steps=0", "val_check_interval=1000000000",
        "use_tensorboard=false", args.hparams]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(ranks), "-m",
           "audiogpt_tpu_torch.train_cli", "--config",
           str(ROOT / "configs" / "t2a" / "ldm.yaml"), "--exp_name",
           str(work / "exp"), "--hparams", hp, "--max_updates",
           str(args.steps), "--report", str(work / "report.json")]
    if args.device:
        cmd += ["--device", args.device]
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT),
                                           os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True)
    wall = time.perf_counter() - t0
    if proc.returncode:
        sys.exit(f"{ranks} ranks: exit {proc.returncode}\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rep = json.loads((work / "report.json").read_text())
    tr = [line for line in map(json.loads, open(work / "exp" /
                                               "metrics.jsonl"))
          if line["prefix"] == "tr"]
    steady = tr[WARM:]
    from audiogpt_tpu_torch.config import load_config

    cfg = load_config(str(work / "exp" / "config.yaml"))
    return {"ranks": ranks, "world": rep["world"],
            "bf16_compute": cfg["model"]["bf16_compute"],
            "batch": cfg["batch_size"],
            "backend": rep["backend"], "steps": rep["steps"],
            "wall_s": wall,
            "step_ms": statistics.median(1e3 / line["steps_per_sec"]
                                         for line in steady),
            "allreduce_ms": statistics.median(rep["comm_ms"][WARM:])
            if rep["comm_ms"] else None,
            "allreduce_bytes": 4 * rep["grad_numel"]["unet"],
            "peak_mem_gb_rank0": rep["peak_mem_gb"],
            "k1_launches_rank0": rep["launches"]["flash_attention"],
            "losses": [line["diff"] for line in tr]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--records", type=int, default=64)
    ap.add_argument("--frames", type=int, default=624)
    ap.add_argument("--mels", type=int, default=80)
    ap.add_argument("--device", default=None)
    ap.add_argument("--hparams", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, train_fixture

    if args.device != "cpu":
        print(card_line(), flush=True)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        bin_dir = Path(train_fixture(out, args.records, args.frames,
                                     args.mels, 21))
        for ranks in args.ranks:
            runs.append(run(ranks, args, bin_dir, out))
            print(json.dumps(runs[-1]), flush=True)
    base = runs[0]
    print(json.dumps({"against_ranks": base["ranks"], "runs": [
        {"ranks": r["ranks"],
         "loss_max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                  zip(r["losses"], base["losses"])),
         "step_ms_ratio": r["step_ms"] / base["step_ms"]}
        for r in runs]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
