"""Training entry point — the reference's ``python tasks/run.py --config
egs/... --exp_name ...`` convention (``BaseTask.start``,
``NeuralSeq/tasks/base_task.py:221``), driven by the yaml-inheritance Config.
Counterpart of ``audiogpt_tpu/train_cli.py``:

    python -m audiogpt_tpu_torch.train_cli --config configs/t2a/ldm.yaml \\
        --exp_name exp/ldm --hparams "optim.lr=2e-4,max_updates=100000"

trains on the card (``--device cpu`` for a run on the CPU). Launched by
torchrun it trains data-parallel on every process, as the JAX CLI trains
over every local chip, with no other flag:

    python -m torch.distributed.run --nproc-per-node N \\
        -m audiogpt_tpu_torch.train_cli --config ... --exp_name ...

(NCCL between the cards; with ``--device cpu``, gloo). Every rank reads
the same batches and trains on its rows of each (``parallel/``); rank 0
logs, checkpoints and exports. The resolved config persists to
``<exp_name>/config.yaml`` (hparams.py:109 behaviour) and the work dir
holds checkpoints and ``metrics.jsonl``. The port's
recipes: the LDM family, ``ldm``, ``vae`` and ``clap``
(``configs/t2a/{ldm,vae,clap}.yaml``); ``fs2`` (``configs/tts/fs2.yaml``,
``fs2_cwt.yaml``) and ``vocoder_gan`` (``configs/vocoder/hifigan.yaml``);
``portaspeech``, ``syntaspeech``, ``ps_adv`` and ``synta_adv``
(``configs/tts/portaspeech.yaml``, ``syntaspeech.yaml``, ``ps_adv.yaml``;
``synta_adv`` is ``syntaspeech.yaml`` with ``--hparams task=synta_adv``),
``generspeech`` and ``pe``; the SVS recipes ``diffsinger`` and
``visinger`` (``configs/svs/``); ``audio2motion``
(``configs/face/audio2motion.yaml``). The TTS and SVS recipes train on
records written by ``data/binarizer.py`` (``TTSBinarizer``, the
PortaSpeech family with ``with_words`` and SyntaSpeech with
``with_graph``; ``EmotionBinarizer`` for GenerSpeech; ``SVSBinarizer`` for
the SVS recipes, VISinger's records with ``with_wav`` and a linear
``spec``), batched by the token-budget loader; ``ldm``, ``vae``, ``clap``
and ``audio2motion`` on fixed-shape batches (mel images, wav-and-text
records, mels with their motion or its pseudo-target), and so do the
analysis recipes ``sed`` (``configs/sed/panns.yaml``: tagged 10 s clips
at 32 kHz), ``caption`` (``configs/caption/cnn14rnn.yaml``: 10 s clips
and 22 tokens) and ``separation`` (``configs/separation/convtasnet.yaml``:
4 s mixtures at 16 kHz with their sources). Every task of the JAX CLI
trains here. ``--export PATH`` writes the weights after the run (each
group's EMA shadows where the recipe keeps them), which the app's
``--ckpt`` and ``infer_cli --params`` load.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any

from audiogpt_tpu_torch.config import Config, load_config

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
    if name == "fs2":
        from audiogpt_tpu_torch.train.tasks import FS2Task, FS2TaskConfig

        return FS2Task(_fill(FS2TaskConfig, {
            "model": model, "optim": dataclasses.asdict(optim), **loss}),
            device=device)
    if name == "vocoder_gan":
        # full-width discriminators: the CLI passes no ``disc`` section,
        # as JAX's does
        from audiogpt_tpu_torch.train.tasks import (VocoderGANTask,
                                                    VocoderGANTaskConfig)

        return VocoderGANTask(_fill(VocoderGANTaskConfig, {
            "gen": model, "segment_frames": cfg.get("segment_frames", 32),
            "optim_gen": dataclasses.asdict(optim),
            "optim_disc": dataclasses.asdict(optim), **loss}),
            device=device)
    if name == "generspeech":
        from audiogpt_tpu_torch.train.tasks import (GenerSpeechTask,
                                                    GenerSpeechTaskConfig)

        return GenerSpeechTask(_fill(GenerSpeechTaskConfig, {
            "model": model, "optim": dataclasses.asdict(optim), **loss}),
            device=device)
    if name in ("portaspeech", "syntaspeech", "ps_adv", "synta_adv"):
        from audiogpt_tpu_torch.train.tasks import (PortaSpeechAdvTask,
                                                    PortaSpeechAdvTaskConfig,
                                                    PortaSpeechTask,
                                                    PortaSpeechTaskConfig)

        if name in ("syntaspeech", "synta_adv"):
            model.setdefault("use_graph", True)
        ps_kw = {"model": model, "optim": dataclasses.asdict(optim), **loss}
        if name in ("ps_adv", "synta_adv"):
            return PortaSpeechAdvTask(_fill(PortaSpeechAdvTaskConfig, {
                "ps": ps_kw, **dict(cfg.get("adv", {}))}), device=device)
        return PortaSpeechTask(_fill(PortaSpeechTaskConfig, ps_kw),
                               device=device)
    if name == "pe":
        from audiogpt_tpu_torch.train.tasks import PETask, PETaskConfig

        return PETask(_fill(PETaskConfig, {
            "model": model, "optim": dataclasses.asdict(optim), **loss}),
            device=device)
    if name == "ldm":
        # T2A latent diffusion (ddpm_audio.py:43 as pl.LightningModule)
        from audiogpt_tpu_torch.train.tasks import LDMTask, LDMTaskConfig

        return LDMTask(_fill(LDMTaskConfig, {
            **model, "optim": dataclasses.asdict(optim), **loss}),
            device=device)
    if name == "diffsinger":
        from audiogpt_tpu_torch.train.tasks import (DiffSingerTask,
                                                    DiffSingerTaskConfig)

        return DiffSingerTask(_fill(DiffSingerTaskConfig, {
            "model": model, "optim": dataclasses.asdict(optim), **loss}),
            device=device)
    if name == "visinger":
        from audiogpt_tpu_torch.train.tasks import (VISingerTask,
                                                    VISingerTaskConfig)

        return VISingerTask(_fill(VISingerTaskConfig, {
            "model": model, "disc": dict(cfg.get("disc", {})),
            "optim_model": dataclasses.asdict(optim),
            "optim_disc": dataclasses.asdict(optim), **loss}),
            device=device)
    if name == "audio2motion":
        # GeneFace-class variational motion generator (models/face/)
        from audiogpt_tpu_torch.train.tasks import (Audio2MotionTask,
                                                    Audio2MotionTaskConfig)

        return Audio2MotionTask(_fill(Audio2MotionTaskConfig, {
            "model": model, "optim": dataclasses.asdict(optim), **loss}),
            device=device)
    if name == "vae":
        # first-stage AutoencoderKL GAN recipe (ldm/models/autoencoder.py:305)
        from audiogpt_tpu_torch.train.tasks import VAETask, VAETaskConfig

        return VAETask(_fill(VAETaskConfig, {
            **model, "optim_vae": dataclasses.asdict(optim),
            "optim_disc": dataclasses.asdict(optim), **loss}), device=device)
    if name == "clap":
        # contrastive audio-text pretraining (open_clap/loss.py:306)
        from audiogpt_tpu_torch.train.tasks import CLAPTask, CLAPTaskConfig

        return CLAPTask(_fill(CLAPTaskConfig, {
            **model, "optim": dataclasses.asdict(optim), **loss}),
            device=device)
    if name == "sed":
        # AudioSet tagging (audio_infer/pytorch/main.py:377)
        from audiogpt_tpu_torch.train.tasks import SEDTask, SEDTaskConfig

        return SEDTask(_fill(SEDTaskConfig, {
            "model": model, "optim": dataclasses.asdict(optim), **loss}),
            device=device)
    if name == "caption":
        from audiogpt_tpu_torch.train.tasks import (CaptionTask,
                                                    CaptionTaskConfig)

        return CaptionTask(_fill(CaptionTaskConfig, {
            "model": model, "optim": dataclasses.asdict(optim), **loss}),
            device=device)
    if name == "separation":
        from audiogpt_tpu_torch.train.tasks import (SeparationTask,
                                                    SeparationTaskConfig)

        return SeparationTask(_fill(SeparationTaskConfig, {
            "model": model, "optim": dataclasses.asdict(optim), **loss}),
            device=device)
    raise ValueError(f"unknown task {name!r}")


#: the token-budget TTS recipes → the vocab files of the binarized
#: corpus and the model field (default 100) that each one's ids must
#: stay below
_TTS_VOCABS = {
    "fs2": (("phone_set.json", "vocab_size"),),
    "generspeech": (("phone_set.json", "fs2.vocab_size"),),
    "pe": (),
    "diffsinger": (("phone_set.json", "fs2.vocab_size"),),
    "visinger": (("phone_set.json", "vocab_size"),),
    **{name: (("phone_set.json", "ph_vocab_size"),
              ("word_set.json", "word_vocab_size"))
       for name in ("portaspeech", "syntaspeech", "ps_adv", "synta_adv")},
}


def check_vocabs(cfg: Config, task_name: str, bin_dir: str) -> None:
    """Refuse a binarized phone or word set with more ids than the model's
    embedding holds: on the card an id past an embedding is a device-side
    assert (JAX's gather clamps it silently)."""
    from audiogpt_tpu_torch.text.encoder import TokenTextEncoder

    for fname, field in _TTS_VOCABS[task_name]:
        path = os.path.join(bin_dir, fname)
        if not os.path.exists(path):
            continue
        node = cfg.get("model", {})
        *outer, leaf = field.split(".")
        for key in outer:
            node = node.get(key, {})
        limit = node.get(leaf, 100)
        n = len(TokenTextEncoder.from_file(path))
        if n > limit:
            raise ValueError(f"{path} holds {n} ids, more than "
                             f"model.{field}={limit}")


def build_loaders(cfg: Config, task_name: str):
    """→ (an endless iterator of training batches, a function giving one
    pass over the validation split, or None without a ``valid`` split).
    ``ldm``, ``vae``, ``clap``, ``audio2motion``, ``sed``, ``caption`` and
    ``separation``: fixed-shape batches of ``batch_size``; the TTS and SVS recipes (``fs2``, the PortaSpeech
    family, ``generspeech``, ``pe``, ``diffsinger``, ``visinger``):
    token-budget batches on the dyadic (batch, length) ladder of
    ``data.max_len`` / ``max_batch`` / ``min_batch``, VISinger's with the
    sample-level wav at the hop of its decoder (the product of its
    upsample rates); ``vocoder_gan``: endless random crops, no
    validation."""
    import functools

    import numpy as np

    from audiogpt_tpu_torch.data import (ArrayDataLoader, BucketSpec,
                                         TTSDataLoader, VocoderDataLoader,
                                         collate_audio_text,
                                         collate_mel_image, collate_mixture,
                                         collate_motion, collate_tagging,
                                         collate_tts, load_split)

    model = cfg.get("model", {})
    d = cfg.get("data", {})
    # fixed-shape recipes: one static shape per run
    fixed_collates = {
        "ldm": lambda: functools.partial(
            collate_mel_image, width=d.get("width", 624),
            text_len=d.get("text_len", 77)),
        "vae": lambda: functools.partial(
            collate_mel_image, width=d.get("width", 624)),
        "sed": lambda: functools.partial(
            collate_tagging,
            n_samples=int(d.get("sample_rate", 32000)
                          * d.get("clip_seconds", 10.0))),
        "caption": lambda: functools.partial(
            collate_audio_text,
            n_samples=int(d.get("sample_rate", 32000)
                          * d.get("clip_seconds", 10.0)),
            text_len=d.get("text_len", 22), schema="caption"),
        "clap": lambda: functools.partial(
            collate_audio_text,
            n_samples=int(d.get("sample_rate", 16000)
                          * d.get("clip_seconds", 10.0)),
            text_len=d.get("text_len", 77), schema="clap"),
        "separation": lambda: functools.partial(
            collate_mixture,
            n_samples=int(d.get("sample_rate", 8000)
                          * d.get("clip_seconds", 4.0))),
        "audio2motion": lambda: functools.partial(
            collate_motion, mel_len=d.get("mel_len", 512),
            video_len=d.get("mel_len", 512) * model.get("fps", 25)
            * model.get("hop", 256) // model.get("sample_rate", 16000)),
    }
    if task_name not in ("vocoder_gan", *fixed_collates, *_TTS_VOCABS):
        raise ValueError(f"unknown task {task_name!r}")
    bin_dir = d.get("binary_dir", "data/bin")
    train_ds = load_split(bin_dir, "train")
    has_valid = os.path.exists(os.path.join(bin_dir, "valid.idx"))

    if task_name == "vocoder_gan":
        rates = model.get("upsample_rates", (8, 8, 2, 2))
        loader = VocoderDataLoader(
            train_ds, segment_frames=cfg.get("segment_frames", 32),
            hop=int(np.prod(tuple(rates))),
            batch_size=cfg.get("batch_size", 16))
        return iter(loader), None

    if task_name in fixed_collates:
        collate = fixed_collates[task_name]()
        bs = cfg.get("batch_size", 16)
        train = ArrayDataLoader(train_ds, collate, batch_size=bs)

        def val_fn():
            return ArrayDataLoader(load_split(bin_dir, "valid"), collate,
                                   batch_size=bs, shuffle=False).epoch(0)

        return iter(train), (val_fn if has_valid else None)

    # the token-budget bucketed TTS and SVS recipes
    check_vocabs(cfg, task_name, bin_dir)
    spec = BucketSpec.dyadic(d.get("max_len", 2048), d.get("max_batch", 64),
                             min_batch=d.get("min_batch", 8))
    collate_fn = None
    if task_name == "visinger":
        # end-to-end SVS reads the wav too, at the decoder's hop
        rates = model.get("decoder", {}).get("upsample_rates", (8, 8, 2, 2))
        collate_fn = functools.partial(collate_tts,
                                       wav_hop=int(np.prod(tuple(rates))))

    def loader(split, ds, shuffle=True):
        # the binarizer's lengths sidecar spares reading every record
        lengths = os.path.join(bin_dir, f"{split}_lengths.npy")
        return TTSDataLoader(ds, max_tokens=d.get("max_tokens", 30000),
                             max_sentences=d.get("max_sentences", 100),
                             spec=spec, shuffle=shuffle,
                             sizes=np.load(lengths) if os.path.exists(lengths)
                             else None, collate_fn=collate_fn)

    def val_fn():
        return loader("valid", load_split(bin_dir, "valid"),
                      shuffle=False).epoch(0)

    return iter(loader("train", train_ds)), (val_fn if has_valid else None)


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


def export_weights(trainer, out: str) -> str:
    """Write a ``Trainer``'s weights (each group's params, its EMA shadows
    where the recipe keeps them, and the step) to ``out`` (a ``.pt`` file,
    or a directory that gets ``params.pt``) → the file's path, which
    ``app.py --ckpt`` and ``infer_cli --params`` load."""
    import torch

    from audiogpt_tpu_torch.import_ckpt import weights_file

    state = trainer.state()
    path = weights_file(out)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: state[k] for k in ("params", "ema", "step")}, path)
    return path


def main(argv=None):
    from audiogpt_tpu_torch.train import Trainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--exp_name", required=True)
    ap.add_argument("--hparams", default="", help='dot overrides "a.b=1,c=2"')
    ap.add_argument("--max_updates", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="after training, write a JSON run report to PATH "
                         "(rank 0): steps, ranks, backend, each kernel's "
                         "launches during the run, peak device memory and "
                         "the gradient all-reduce's ms a step")
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="after training, write the weights (each group's "
                         "EMA shadows where the recipe keeps them) to PATH "
                         "(a .pt file, or a directory that gets params.pt); "
                         "load with app.py --ckpt or infer_cli --params")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from audiogpt_tpu_torch.parallel import distributed_init, is_main

    # torchrun's environment joins the group (NCCL on the card, gloo for
    # the CPU); a plain run stays one process
    joined = not dist.is_initialized()
    distributed_init(backend="gloo" if args.device == "cpu" else None)
    joined = joined and dist.is_initialized()

    cfg = load_config(args.config, overrides=args.hparams)
    if is_main():
        cfg.save(os.path.join(args.exp_name, "config.yaml"))

    task = build_task(cfg, device=args.device)
    trainer = Trainer(task, trainer_config(cfg, args.exp_name,
                                           args.max_updates),
                      device=args.device)
    train_it, val_fn = build_loaders(cfg, cfg.get("task", "fs2"))
    if args.report:
        trainer.time_comm = True
        _reset_counts(trainer.device)
    trainer.fit(train_it, val_fn)
    trainer.logger.close()
    if args.report and is_main():
        write_report(trainer, args.report)
    if args.export and is_main():
        print(f"| exported weights -> {export_weights(trainer, args.export)}")
    if joined:
        dist.destroy_process_group()


def _reset_counts(device) -> None:
    """Every kernel's launch count to 0 and the device's peak memory to
    what it holds, just before the run."""
    import torch

    from audiogpt_tpu_torch.ops import _build
    from audiogpt_tpu_torch.ops.flash_attention import flash_attention
    from audiogpt_tpu_torch.ops.snake_aa import snake_aa

    _build.reset_counts(flash_attention)
    _build.reset_counts(snake_aa)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def write_report(trainer, path: str) -> None:
    """The run report of ``--report``: this rank's view of the run just
    ended (``launches`` counted from ``_reset_counts`` on)."""
    import json

    import torch
    import torch.distributed as dist

    from audiogpt_tpu_torch.ops.flash_attention import flash_attention
    from audiogpt_tpu_torch.ops.snake_aa import snake_aa

    dev = trainer.device
    report = {
        "steps": trainer.step, "data_size": trainer.data_size,
        "world": dist.get_world_size() if dist.is_initialized() else 1,
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "device": str(dev),
        "launches": {"flash_attention": flash_attention.launches,
                     "flash_attention_bf16": flash_attention.bf16_launches,
                     "snake_aa": snake_aa.launches,
                     "snake_aa_bf16": snake_aa.bf16_launches},
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
        if dev.type == "cuda" else None,
        "comm_ms": trainer.comm_ms,
        "grad_numel": {g: sum(p.numel() for p in trainer.params[g])
                       for g in trainer.groups}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
