"""Tensor-parallel rules — counterpart of
``audiogpt_tpu/parallel/tp_rules.py``, and the column-parallel
application that XLA derives from JAX's annotations.

``tp_rules(tp)`` makes JAX's decisions (``tp_rules.py:30-51``) on the
flax scope names that the port's parameters carry
(``utils/jax_params.py``): a ≥2-D kernel, or any leaf under a ``conv`` or
``dense`` scope, shards its flax output (last) axis over ``model`` when
that axis divides by ``tp`` and is at least ``min_dim`` wide; an
``embed`` leaf shards its feature axis; 1-D leaves and ``tp <= 1``
replicate. The decision lands on the port's layout: ``nn.Linear`` and
``nn.Conv*`` shard their output channels on dim 0, an embedding its
feature dim on −1 (a raw parameter keeps the flax layout). Packed
recurrent layers (``nn.GRU`` / ``nn.LSTM``, four flax gate denses in one
tensor) replicate: a gate-wise shard is no contiguous slice of the packed
weight (``ROADMAP.md`` §C).

:func:`apply_tp` runs the plan: each planned layer keeps its rank's slice
of the output channels, computes its share without bias, all-gathers the
channels (autograd-aware: the backward keeps the rank's slice, and the
layer's input gradient is summed over the ``model`` ranks) and adds the
whole bias. Outside the layer every tensor is an ordinary replicated one.
"""

from __future__ import annotations

import types

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from audiogpt_tpu_torch.ops.conv import ConvTranspose1d, FlaxConvTranspose1d
from audiogpt_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size

#: a torch parameter name → its flax leaf, by the owner's type
_KERNEL_OWNERS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d,
                  ConvTranspose1d, FlaxConvTranspose1d)
_SCALE_OWNERS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d)


def _flax_leaf(leaf: str, owner: nn.Module) -> str:
    if leaf == "weight":
        if isinstance(owner, _KERNEL_OWNERS):
            return "kernel"
        if isinstance(owner, nn.Embedding):
            return "embedding"
        if isinstance(owner, _SCALE_OWNERS):
            return "scale"
    return leaf


def _flax_last_dim(param: torch.Tensor, owner: nn.Module, leaf: str) -> int:
    """The port dim that holds the flax leaf's last axis (the inverse of
    ``load_jax_params``' layouts)."""
    if leaf == "weight" and isinstance(owner, FlaxConvTranspose1d):
        return 1                    # flax [W, I, O] → [I, O, W]
    if leaf == "weight" and isinstance(owner, _KERNEL_OWNERS):
        return 0                    # [.., out] → [out, ..]; transposes: I
    return param.dim() - 1


def tp_rules(tp: int, min_dim: int = 64, axis: str = "model"):
    """→ ``rules(name, param, owner) -> dim | None`` for
    :func:`~audiogpt_tpu_torch.parallel.mesh.param_sharding`: the port dim
    sharded over ``axis``, or None to replicate."""

    def rules(name: str, param: torch.Tensor, owner: nn.Module):
        if tp <= 1 or param.dim() < 2 or isinstance(owner,
                                                    (nn.GRU, nn.LSTM)):
            return None
        prefix, _, leaf = name.rpartition(".")
        path = "/".join([*prefix.split("."), _flax_leaf(leaf, owner)]
                        if prefix else [_flax_leaf(leaf, owner)]).lower()
        dim = _flax_last_dim(param, owner, leaf)
        last = param.shape[dim]
        if last % tp or last < min_dim:
            return None
        if "embed" in path:
            return dim
        if path.endswith("kernel") or "conv" in path or "dense" in path:
            return dim
        return None

    return rules


class _ToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    ``model`` ranks (each rank's layer saw only its channels)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """All ranks' channel slices concatenated along ``dim`` in rank order;
    the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.dim, ctx.rank, ctx.size = dim, rank, size
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.size, ctx.dim)[ctx.rank], None, None, None, \
            None


def _column_forward(owner: nn.Module, group, rank: int, size: int):
    gather = lambda y, dim: _GatherChannels.apply(  # noqa: E731
        y, dim, group, rank, size)
    to_model = lambda x: _ToModel.apply(x, group)  # noqa: E731
    if isinstance(owner, nn.Linear):
        def forward(self, x):
            y = gather(F.linear(to_model(x), self.weight), -1)
            return y if self.bias is None else y + self.bias
    elif isinstance(owner, (nn.Conv1d, nn.Conv2d)):
        def forward(self, x):
            y = gather(self._conv_forward(to_model(x), self.weight, None), 1)
            if self.bias is None:
                return y
            return y + self.bias.reshape(-1, *([1] * (y.dim() - 2)))
    else:                                              # nn.Embedding
        def forward(self, idx):
            return gather(F.embedding(idx, self.weight, self.padding_idx,
                                      self.max_norm, self.norm_type,
                                      self.scale_grad_by_freq, self.sparse),
                          -1)
    return types.MethodType(forward, owner)


def apply_tp(module: nn.Module, mesh, plan: dict, axis: str = "model"
             ) -> nn.Module:
    """Shard ``module`` in place by ``plan`` (``param_sharding``'s
    ``{name: dim | None}``) over ``mesh``'s ``axis``: each planned weight
    keeps this rank's slice and its layer runs column-parallel. The
    column-parallel forms are ``nn.Linear`` and ungrouped ``nn.Conv1d`` /
    ``nn.Conv2d`` on dim 0 and ``nn.Embedding`` on its last dim; a plan
    that shards anything else raises. → ``module``."""
    size = axis_size(mesh, axis)
    if size == 1:
        return module
    group, rank = axis_group(mesh, axis), axis_rank(mesh, axis)
    for name, dim in plan.items():
        if dim is None:
            continue
        prefix, _, leaf = name.rpartition(".")
        owner = module.get_submodule(prefix) if prefix else module
        param = getattr(owner, leaf)
        dim = dim % param.dim()
        ok = (leaf == "weight" and (
            (isinstance(owner, nn.Linear) and dim == 0)
            or (isinstance(owner, (nn.Conv1d, nn.Conv2d)) and dim == 0
                and owner.groups == 1)
            or (isinstance(owner, nn.Embedding) and dim == param.dim() - 1)))
        if not ok:
            raise NotImplementedError(
                f"{name}: no column-parallel form for dim {dim} of "
                f"{type(owner).__name__}")
        shard = param.detach().chunk(size, dim)[rank].clone()
        setattr(owner, leaf, nn.Parameter(shard,
                                          requires_grad=param.requires_grad))
        owner.forward = _column_forward(owner, group, rank, size)
    return module
