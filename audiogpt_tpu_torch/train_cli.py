"""Training entry point — the reference's ``python tasks/run.py --config
egs/... --exp_name ...`` convention (``BaseTask.start``,
``NeuralSeq/tasks/base_task.py:221``), driven by the yaml-inheritance Config.
Counterpart of ``audiogpt_tpu/train_cli.py``:

    python -m audiogpt_tpu_torch.train_cli --config configs/t2a/ldm.yaml \\
        --exp_name exp/ldm --hparams "optim.lr=2e-4,max_updates=100000"

trains on the card (``--device cpu`` for a run on the CPU). The resolved
config persists to ``<exp_name>/config.yaml`` (hparams.py:109 behaviour)
and the work dir holds checkpoints and ``metrics.jsonl``. The port's recipes
so far: ``ldm``. Every other task of the JAX CLI raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any

from audiogpt_tpu_torch.config import Config, load_config

#: the JAX CLI's other tasks → the ROADMAP.md §A item that ports them
_NOT_PORTED = {
    "fs2": "A1 (the fs2 recipe)",
    "vocoder_gan": "A2", "ps_adv": "A2", "synta_adv": "A2",
    "diffsinger": "A3", "pe": "A3", "generspeech": "A3",
    "portaspeech": "A3", "syntaspeech": "A3", "visinger": "A3",
    "audio2motion": "A3",
    "vae": "A4", "clap": "A4",
    "sed": "A5", "caption": "A5", "separation": "A5",
}


def _not_ported(name: str):
    return NotImplementedError(
        f"task {name!r} is not ported yet: ROADMAP.md §A item "
        f"{_NOT_PORTED[name]}")


def _fill(dc_cls, data: dict) -> Any:
    """Build a (nested) dataclass from a plain dict, keeping defaults for
    missing keys and descending into dataclass-typed fields."""
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(dc_cls)}
    for k, v in data.items():
        if k not in fields:
            continue
        f = fields[k]
        if dataclasses.is_dataclass(f.default) and isinstance(v, dict):
            kwargs[k] = _fill(type(f.default), v)
        elif isinstance(v, list):
            kwargs[k] = tuple(tuple(x) if isinstance(x, list) else x
                              for x in v)
        else:
            kwargs[k] = v
    return dc_cls(**kwargs)


def _optim_from(cfg: Config):
    from audiogpt_tpu_torch.train.optim import OptimConfig

    return _fill(OptimConfig, dict(cfg.get("optim", {})))


def build_task(cfg: Config, device=None):
    """task name → Task instance with model/loss hparams from the config,
    its modules on ``device`` (None: the card)."""
    name = cfg.get("task", "fs2")
    model = dict(cfg.get("model", {}))
    loss = dict(cfg.get("loss", {}))
    optim = _optim_from(cfg)
    if name == "ldm":
        # T2A latent diffusion (ddpm_audio.py:43 as pl.LightningModule)
        from audiogpt_tpu_torch.train.tasks import LDMTask, LDMTaskConfig

        return LDMTask(_fill(LDMTaskConfig, {
            **model, "optim": dataclasses.asdict(optim), **loss}),
            device=device)
    if name in _NOT_PORTED:
        raise _not_ported(name)
    raise ValueError(f"unknown task {name!r}")


def build_loaders(cfg: Config, task_name: str):
    """→ (an endless iterator of training batches, a function giving one
    pass over the validation split, or None without a ``valid`` split)."""
    import functools

    from audiogpt_tpu_torch.data import (ArrayDataLoader, collate_mel_image,
                                         load_split)

    if task_name != "ldm":
        if task_name in _NOT_PORTED:
            raise _not_ported(task_name)
        raise ValueError(f"unknown task {task_name!r}")
    d = cfg.get("data", {})
    bin_dir = d.get("binary_dir", "data/bin")
    train_ds = load_split(bin_dir, "train")
    has_valid = os.path.exists(os.path.join(bin_dir, "valid.idx"))
    # fixed-shape recipe: one static shape per run
    collate = functools.partial(collate_mel_image, width=d.get("width", 624),
                                text_len=d.get("text_len", 77))
    bs = cfg.get("batch_size", 16)
    train = ArrayDataLoader(train_ds, collate, batch_size=bs)

    def val_fn():
        return ArrayDataLoader(load_split(bin_dir, "valid"), collate,
                               batch_size=bs, shuffle=False).epoch(0)

    return iter(train), (val_fn if has_valid else None)


def trainer_config(cfg: Config, work_dir: str, max_updates: int | None = None):
    from audiogpt_tpu_torch.train import TrainerConfig

    return TrainerConfig(
        work_dir=work_dir,
        max_updates=max_updates or cfg.get("max_updates", 1_000_000),
        val_check_interval=cfg.get("val_check_interval", 2000),
        num_sanity_val_steps=cfg.get("num_sanity_val_steps", 5),
        log_interval=cfg.get("log_interval", 100),
        num_ckpt_keep=cfg.get("num_ckpt_keep", 3),
        seed=cfg.get("seed", 1234),
        use_tensorboard=cfg.get("use_tensorboard", True))


def main(argv=None):
    from audiogpt_tpu_torch.train import Trainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--exp_name", required=True)
    ap.add_argument("--hparams", default="", help='dot overrides "a.b=1,c=2"')
    ap.add_argument("--max_updates", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--export", default=None, metavar="DIR",
                    help="not ported yet: exporting inference params waits "
                         "for the checkpoint import (ROADMAP.md §A item 6), "
                         "which gives the port's app --ckpt; the flag "
                         "raises")
    args = ap.parse_args(argv)
    if args.export:
        raise NotImplementedError("--export waits for the checkpoint import "
                                  "(ROADMAP.md §A item 6)")

    cfg = load_config(args.config, overrides=args.hparams)
    cfg.save(os.path.join(args.exp_name, "config.yaml"))

    task = build_task(cfg, device=args.device)
    trainer = Trainer(task, trainer_config(cfg, args.exp_name,
                                           args.max_updates),
                      device=args.device)
    train_it, val_fn = build_loaders(cfg, cfg.get("task", "fs2"))
    trainer.fit(train_it, val_fn)
    trainer.logger.close()


if __name__ == "__main__":
    main()
