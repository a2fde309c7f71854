"""One of the two gloo ranks of ``tests/test_torch_ddp.py`` (torch and the
port only: no JAX).

    python tests/_torch_ddp_child.py --port P --rank R --out DIR

joins a two-process gloo group on 127.0.0.1:P and runs, writing its
results under DIR: (a) every recipe of ``_torch_ddp_tasks.RECIPES`` on a
2×1 mesh (``ddp_rank{R}.pt``); (b) the tensor-parallel FS2 forward on a
1×2 mesh (``tp_rank{R}.pt``); (c) three steps of the tiny FS2 of
``tests/test_multihost.py`` from the JAX tree and global batch that the
parent writes to ``DIR/jax_fs2.pkl`` (``fs2_rank{R}.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import torch


def wait_for(path: str, seconds: float) -> None:
    end = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.05)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--recipes", default="")
    args = ap.parse_args()
    torch.set_num_threads(1)

    from audiogpt_tpu_torch.models.tts.fastspeech2 import FastSpeech2Config
    from audiogpt_tpu_torch.parallel import (MeshSpec, apply_tp,
                                             distributed_init, make_mesh,
                                             param_sharding, shard_batch,
                                             tp_rules)
    from audiogpt_tpu_torch.train import OptimConfig, Trainer, TrainerConfig
    from audiogpt_tpu_torch.train.tasks import FS2Task, FS2TaskConfig

    import _torch_ddp_tasks as D

    distributed_init(f"127.0.0.1:{args.port}", 2, args.rank, backend="gloo")
    r = args.rank

    # (a) every recipe, data-parallel over both ranks
    mesh = make_mesh()
    names = args.recipes.split(",") if args.recipes else list(D.RECIPES)
    torch.save({name: D.run_recipe(name, os.path.join(
        args.out, f"{name}_rank{r}"), mesh) for name in names},
        os.path.join(args.out, f"ddp_rank{r}.pt"))

    # (b) the FS2 forward, column-parallel over both ranks
    tp_mesh = make_mesh(MeshSpec(data=1, model=2))
    model, inputs = D.tp_fs2_inputs()
    plan = param_sharding(model, tp_mesh, tp_rules(2, min_dim=16))
    apply_tp(model, tp_mesh, plan)
    with torch.no_grad():
        mel = model(inputs["tokens"], mel2ph=inputs["mel2ph"],
                    f0=inputs["f0"], uv=inputs["uv"])["mel_out"]
    torch.save({"mel_out": mel, "plan": plan},
               os.path.join(args.out, f"tp_rank{r}.pt"))

    # (c) JAX's tiny FS2 trainer steps on the same tree and global batch
    path = os.path.join(args.out, "jax_fs2.pkl")
    wait_for(path, 120.0)
    with open(path, "rb") as f:
        ref = pickle.load(f)
    task = FS2Task(FS2TaskConfig(
        model=FastSpeech2Config(**ref["model"]), lambda_ssim=0.5,
        optim=OptimConfig(schedule="constant", lr=2e-3)),
        params=ref["params"], device="cpu")
    trainer = Trainer(task, TrainerConfig(
        work_dir=os.path.join(args.out, f"fs2_rank{r}"),
        use_tensorboard=False), device="cpu", mesh=mesh)
    batch = trainer._to_device(shard_batch(ref["batch"], mesh))
    losses = [float(trainer.train_step("model", batch, 0)["total_loss"])
              for _ in range(ref["steps"])]
    with open(os.path.join(args.out, f"fs2_rank{r}.json"), "w") as f:
        json.dump({"losses": losses}, f)


if __name__ == "__main__":
    main()
