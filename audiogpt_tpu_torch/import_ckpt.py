"""Checkpoint import CLI: reference PyTorch weights → the port's engines.

Counterpart of ``audiogpt_tpu/import_ckpt.py``:

    python -m audiogpt_tpu_torch.import_ckpt --family hifigan \\
        --ckpt checkpoints/hifigan/model_ckpt_steps_*.ckpt --out params/hifigan

covers the 24 converter families of :mod:`audiogpt_tpu_torch.utils.
torch_import` (weight-norm folding, GRU layouts, EMA entries). The
reference stores trainer dicts (``{'state_dict': ...}``,
``pl_utils.py:743``) or bare state dicts; both load. The output is the
family's flax-layout tree (numpy leaves), which ``utils/jax_params.py``
``load_jax_params`` carries into the port's module, so the app's
``--ckpt ENGINE=PATH`` and ``infer_cli --params PATH`` load it.

Layout on disk (in place of JAX's orbax directory): :func:`save_params`
writes one ``torch.save`` file of the tree with tensor leaves, at ``out``
when it ends in ``.pt``, else at ``out/params.pt``; :func:`restore_params`
reads such a file, or a directory that holds ``params.pt``, with
``weights_only=True`` and gives the tree back leaf for leaf (names,
shapes, dtypes, values) with numpy leaves. :func:`restore_weights` also
reads a trainer checkpoint (``train/checkpoint.py``'s ``<step>.pt``).
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Mapping

import numpy as np

#: the file :func:`save_params` writes inside a directory
PARAMS_FILE = "params.pt"


def load_torch_state_dict(path: str, prefix: str | None = None
                          ) -> dict[str, np.ndarray]:
    """torch ckpt → {name: np.ndarray}. Unwraps a trainer's ``state_dict``,
    ``model`` or ``generator`` entry (the first that is a dict) and keeps
    EMA (``model_ema.``-prefixed) entries; ``prefix`` filters and strips
    (e.g. ``model.`` for NeuralSeq tasks, ``ckpt_utils.load_ckpt``)."""
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "generator"):
        if isinstance(raw, dict) and key in raw and isinstance(raw[key], dict):
            raw = raw[key]
            break
    sd = {}
    for k, v in raw.items():
        if not hasattr(v, "numpy"):
            continue
        if prefix:
            if not k.startswith(prefix):
                continue
            k = k[len(prefix):]
        sd[k] = v.numpy()
    return sd


def convert(family: str, sd: Mapping[str, np.ndarray], cfg: Any) -> dict:
    """The family's converter on ``sd`` at ``cfg``; an unknown family is a
    ``KeyError`` that names the known ones."""
    from audiogpt_tpu_torch.utils import torch_import as ti

    table = {
        "hifigan": ti.convert_hifigan,
        "bigvgan": ti.convert_bigvgan,
        "whisper": ti.convert_whisper,
        "fastspeech2": ti.convert_fastspeech2,
        "ldm_unet": ti.convert_ldm_unet,
        "vae": ti.convert_vae,
        "bert": ti.convert_bert,
        "clap_text": ti.convert_clap_text,
        "diffnet": ti.convert_diffnet,
        "cnn14": ti.convert_cnn14,
        "pwg": ti.convert_pwg,
        "caption": ti.convert_caption,
        "pvt": ti.convert_pvt,
        "lassnet": ti.convert_lassnet,
        "tsd": ti.convert_tsd,
        "binaural": ti.convert_binaural,
        "clip_vision": ti.convert_clip_vision,
        "clip_text_tower": ti.convert_clip_text_tower,
        "diffsinger": ti.convert_diffsinger,
        "htsat": ti.convert_htsat,
        "t5": ti.convert_t5,
        "clip_text_hf": ti.convert_clip_text_hf,
        "blip": ti.convert_blip,
        "gpt2": ti.convert_gpt2,
    }
    if family not in table:
        raise KeyError(f"unknown family {family!r}; have {sorted(table)}")
    return table[family](sd, cfg)


def default_config(family: str) -> Any:
    """The family's default config, the port's config dataclasses (JAX's
    table: ``htsat`` and ``clip_text_hf`` have none)."""
    if family == "hifigan":
        from audiogpt_tpu_torch.models.vocoder import HifiGANConfig

        return HifiGANConfig()
    if family == "bigvgan":
        from audiogpt_tpu_torch.models.vocoder import BigVGANConfig

        return BigVGANConfig()
    if family == "whisper":
        from audiogpt_tpu_torch.models.asr.whisper import WhisperConfig

        return WhisperConfig()
    if family == "fastspeech2":
        from audiogpt_tpu_torch.models.tts.fastspeech2 import \
            FastSpeech2Config

        return FastSpeech2Config()
    if family == "ldm_unet":
        from audiogpt_tpu_torch.models.diffusion import UNetConfig

        return UNetConfig()
    if family == "vae":
        from audiogpt_tpu_torch.models.diffusion import VAEConfig

        return VAEConfig()
    if family in ("bert", "clap_text"):
        from audiogpt_tpu_torch.models.textenc.bert import BertConfig
        from audiogpt_tpu_torch.models.textenc.clap import CLAPTextConfig

        return CLAPTextConfig() if family == "clap_text" else BertConfig()
    if family == "diffnet":
        from audiogpt_tpu_torch.models.svs.diffsinger import DiffNetConfig

        return DiffNetConfig()
    if family == "t5":
        from audiogpt_tpu_torch.models.textenc.t5 import T5Config

        return T5Config()
    if family == "cnn14":
        from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config

        return Cnn14Config()
    if family == "pwg":
        from audiogpt_tpu_torch.models.vocoder.pwg import PWGConfig

        return PWGConfig(upsample="conv_in")
    if family == "caption":
        from audiogpt_tpu_torch.models.caption.captioner import CaptionConfig

        return CaptionConfig()
    if family == "pvt":
        from audiogpt_tpu_torch.models.sed.pvt import PVTConfig

        return PVTConfig()
    if family == "lassnet":
        from audiogpt_tpu_torch.models.extraction.lassnet import \
            LASSNetConfig

        return LASSNetConfig()
    if family == "tsd":
        from audiogpt_tpu_torch.models.sed.tsd import TSDConfig

        return TSDConfig()
    if family == "binaural":
        from audiogpt_tpu_torch.models.binaural.binaural import \
            BinauralConfig

        return BinauralConfig()
    if family in ("clip_vision", "clip_text_tower"):
        from audiogpt_tpu_torch.models.textenc.clip import (CLIPTextConfig,
                                                            CLIPVisionConfig)

        return (CLIPVisionConfig() if family == "clip_vision"
                else CLIPTextConfig())
    if family == "blip":
        from audiogpt_tpu_torch.models.caption.blip import BlipConfig

        return BlipConfig()
    if family == "diffsinger":
        from audiogpt_tpu_torch.models.svs.diffsinger import DiffSingerConfig

        return DiffSingerConfig()
    if family == "gpt2":
        from audiogpt_tpu_torch.models.textenc.gpt2 import GPT2Config

        return GPT2Config()
    raise KeyError(family)


def weights_file(path: str) -> str:
    """``path`` itself when it ends in ``.pt``, else ``path/params.pt``."""
    return path if path.endswith(".pt") else os.path.join(path, PARAMS_FILE)


def _map_leaves(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def save_params(params: Mapping, out: str) -> str:
    """Write the tree (numpy leaves) to ``out`` (a ``.pt`` file, or a
    directory that gets ``params.pt``) → the file's path."""
    import torch

    path = weights_file(out)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # np.array copies into a contiguous array and keeps a 0-d leaf 0-d
    tree = _map_leaves(params, lambda x: torch.from_numpy(np.array(x)))
    torch.save(tree, path + ".part")
    os.replace(path + ".part", path)
    return path


def restore_params(path: str) -> dict:
    """The tree :func:`save_params` wrote, with numpy leaves."""
    import torch

    tree = torch.load(weights_file(path), map_location="cpu",
                      weights_only=True)
    return _map_leaves(tree, lambda t: t.numpy())


def _is_trainer_checkpoint(raw) -> bool:
    return (isinstance(raw, Mapping) and "step" in raw
            and isinstance(raw.get("params"), Mapping)
            and all(isinstance(g, Mapping) for g in raw["params"].values()))


def restore_weights(path: str) -> dict:
    """What ``--ckpt`` and ``infer_cli --params`` load: a tree written by
    :func:`save_params` (numpy leaves, the flax layout), or a trainer
    checkpoint (``<work_dir>/ckpt/<step>.pt``, or ``train_cli --export``'s
    file) as ``{group: {name: tensor}}``, each group's EMA shadows where
    the checkpoint keeps them (the reference samples under ``ema_scope``)
    and its params elsewhere."""
    import torch

    raw = torch.load(weights_file(path), map_location="cpu",
                     weights_only=True)
    if _is_trainer_checkpoint(raw):
        ema = raw.get("ema") or {}
        return {g: dict(ema.get(g) or p) for g, p in raw["params"].items()}
    return _map_leaves(raw, lambda t: t.numpy())


def count_params(tree: Mapping) -> int:
    n = 0
    for v in tree.values():
        n += count_params(v) if isinstance(v, Mapping) else np.asarray(v).size
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True,
                    help="a .pt file, or a directory that gets params.pt")
    ap.add_argument("--prefix", default=None,
                    help="state-dict key prefix to filter+strip "
                         "(e.g. 'model.')")
    args = ap.parse_args(argv)

    sd = load_torch_state_dict(args.ckpt, args.prefix)
    params = convert(args.family, sd, default_config(args.family))
    path = save_params({"params": params} if "params" not in params
                       else params, args.out)
    print(f"| imported {args.family}: {len(sd)} tensors -> {path} "
          f"({count_params(params) / 1e6:.1f} M params)")


if __name__ == "__main__":
    main()
