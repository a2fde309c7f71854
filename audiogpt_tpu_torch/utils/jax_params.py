"""Carry a JAX (flax) parameter tree into a port module.

The tree arrives as numpy arrays (``jax.tree.map(np.asarray, params)`` on
the JAX side), so this module never sees JAX. The port's submodules carry
the flax scope names, so the mapping is mechanical: flatten the tree to
dotted keys, rename the leaf, and lay out each kernel for the module type
that owns it. Recurrent layers are packed: a GRU's ``{fwd,bwd}_w_ih`` /
``_w_hh`` / ``_b_ih`` / ``_b_hh`` (``ops/rnn.py``) and a flax
``OptimizedLSTMCell``'s per-gate denses (``ii if ig io`` on the input, ``hi
hf hg ho`` with the bias on the state; torch's gate order i, f, g, o) become
the ``weight_ih_l0`` / ``weight_hh_l0`` / ``bias_ih_l0`` / ``bias_hh_l0`` of
the ``nn.GRU`` / ``nn.LSTM`` of that name. A raw ``self.param`` keeps
its name and layout: Glow's ``actnorm_logs`` and ``inv1x1_w``, HTSAT's
``rel_pos_bias`` ``[(2w − 1)², heads]`` and ``bn0_{mean,var,scale,bias}``,
the relative-window encoder's ``emb_rel_k`` / ``emb_rel_v`` and its channel
LayerNorm's ``gamma`` / ``beta``, the GGNN's ``etype_kernel`` ``[E, H, H]``
(the port's modules hold ``nn.Parameter``s of those names and shapes),
and so does GenerSpeech's ``vq_ema=False`` codebook ``embedding`` (an
``embedding`` leaf stays so where the owner holds a parameter of that
name, and is an ``nn.Embedding``'s ``weight`` elsewhere). A
2-D kernel of any window, HTSAT's ``(c_freq_bin, 3)`` ``tscam_conv`` and
the period discriminators' ``(5, 1)`` among them, goes HWIO → OIHW; a
grouped 1-D kernel ``[k, in/g, out]`` (the scale discriminators') takes
the same transpose as any 1-D one, to ``[out, in/g, k]``. The GGNN's GRU cell is four denses, not an
``nn.GRU``, and loads as denses. The training trees load the same way:
Audio2Motion's with ``motion_enc`` and ``post_head`` (the model built with
its posterior), VISinger's ``{"model", "disc"}``, the VAE task's
``PatchDiscriminator`` (4×4 HWIO kernels to OIHW, its LayerNorms as they
are) and CLAP's ``{text, audio, logit_scale}`` with Cnn14's
``batch_stats`` (the 0-d ``logit_scale`` a raw parameter). Loading is
strict: a missed or extra parameter raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from audiogpt_tpu_torch.ops.conv import ConvTranspose1d, FlaxConvTranspose1d

#: flax leaf name → torch parameter name
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
#: flax BatchNorm statistic → torch buffer name
_STAT = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, name + "."))
        else:
            flat[name] = np.asarray(val)
    return flat


def _kernel_layout(owner: nn.Module, kernel: np.ndarray) -> np.ndarray:
    """A flax kernel in the layout of the torch module that owns it."""
    if isinstance(owner, nn.Linear):
        return kernel.T                         # [in, out] → [out, in]
    if isinstance(owner, nn.Conv2d):
        return kernel.transpose(3, 2, 0, 1)     # HWIO → OIHW
    if isinstance(owner, nn.ConvTranspose2d):
        # the JAX ConvTranspose2d's [Kh, Kw, O, I] (torch semantics) → torch
        # [I, O, Kh, Kw], no flip
        return kernel.transpose(3, 2, 0, 1)
    if isinstance(owner, (nn.Conv1d, ConvTranspose1d)):
        # Conv1d WIO → OIW; ConvTranspose1d [W, O, I] → [I, O, W], no flip
        return kernel.transpose(2, 1, 0)
    if isinstance(owner, FlaxConvTranspose1d):
        # flax nn.ConvTranspose [W, I, O], applied unflipped → [I, O, W]
        return np.ascontiguousarray(kernel[::-1].transpose(1, 2, 0))
    raise TypeError(f"no kernel layout for {type(owner).__name__}")


#: flax OptimizedLSTMCell gate denses in torch's packed order (i, f, g, o)
_LSTM_IN, _LSTM_HID = ("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho")


def _pack_recurrent(module: nn.Module, flat: dict) -> dict:
    """Pop the leaves of each ``nn.GRU`` / ``nn.LSTM`` in ``module`` from
    ``flat`` and return them as that layer's torch parameters."""
    packed = {}
    for name, mod in module.named_modules():
        parent, _, direction = name.rpartition(".")
        if isinstance(mod, nn.GRU):
            stem = f"{parent}.{direction}_" if parent else f"{direction}_"
            w_ih, w_hh, b_ih, b_hh = (flat.pop(stem + leaf) for leaf in
                                      ("w_ih", "w_hh", "b_ih", "b_hh"))
            arrs = (w_ih.T, w_hh.T, b_ih, b_hh)
        elif isinstance(mod, nn.LSTM):
            def gate(g, leaf):
                return flat.pop(f"{name}.{g}.{leaf}")

            b_hh = np.concatenate([gate(g, "bias") for g in _LSTM_HID])
            arrs = (np.concatenate([gate(g, "kernel").T for g in _LSTM_IN]),
                    np.concatenate([gate(g, "kernel").T for g in _LSTM_HID]),
                    np.zeros_like(b_hh), b_hh)
        else:
            continue
        for leaf, arr in zip(("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                              "bias_hh_l0"), arrs):
            packed[f"{name}.{leaf}"] = torch.tensor(np.ascontiguousarray(arr),
                                                    dtype=torch.float32)
    return packed


def load_jax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy a flax variable tree (numpy leaves) into ``module``, strictly.

    ``tree`` is a param tree, ``{"params": ...}``, or a model with more
    collections: BatchNorm's ``batch_stats`` (``mean`` / ``var`` become the
    ``running_mean`` / ``running_var`` buffers; ``num_batches_tracked`` is
    set to 0, which eval mode never reads) and GenerSpeech's ``vq_stats``
    (buffers of the same names; a ``vq_ema=False`` tree has no such
    collection and its codebooks are params)."""
    stats, buffers = {}, {}
    if "params" in tree and set(tree) <= {"params", "batch_stats",
                                          "vq_stats"}:
        stats = tree.get("batch_stats", {})
        buffers = tree.get("vq_stats", {})
        tree = tree["params"]
    state = {key: torch.tensor(arr, dtype=torch.float32)
             for key, arr in _flatten(buffers).items()}
    for key, arr in _flatten(stats).items():
        prefix, _, leaf = key.rpartition(".")
        state[f"{prefix}.{_STAT[leaf]}"] = torch.tensor(arr,
                                                        dtype=torch.float32)
        state[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    flat = _flatten(tree)
    state.update(_pack_recurrent(module, flat))
    for key, arr in flat.items():
        prefix, _, leaf = key.rpartition(".")
        try:
            owner = module.get_submodule(prefix)
        except AttributeError:
            owner = None   # no such submodule: strict loading reports it
        torch_leaf = _LEAF.get(leaf, leaf)
        if leaf == "embedding" and owner is not None and isinstance(
                getattr(owner, leaf, None), nn.Parameter):
            torch_leaf = leaf   # a raw codebook param (the VQ's)
        name = f"{prefix}.{torch_leaf}" if prefix else torch_leaf
        if leaf == "kernel" and owner is not None:
            arr = _kernel_layout(owner, arr)
        state[name] = torch.tensor(arr, dtype=torch.float32)
    module.load_state_dict(state, strict=True)
