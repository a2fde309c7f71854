"""Process mesh and batch sharding — counterpart of
``audiogpt_tpu/parallel/mesh.py`` in ``torch.distributed``'s idiom.

The JAX package runs one process per host over a ``jax.sharding.Mesh`` of
every chip, axes ``('data', 'model')``; XLA inserts the gradient ``psum``.
The port runs one process per card (``torchrun``), NCCL between cards and
gloo for runs on the CPU:

* :func:`distributed_init` joins the process group (torchrun's environment
  or explicit arguments) and pins the rank's card;
* :func:`make_mesh` lays the group's ranks out as a ``DeviceMesh`` with
  dims ``("data", "model")`` (a group-less :class:`LocalMesh` for one
  process);
* :func:`shard_batch` gives a rank its contiguous rows of the global
  batch, as ``NamedSharding(mesh, P("data"))`` places them on the chips;
* :func:`replicate` broadcasts the parameters (JAX: ``P()``);
* :func:`bind_data_axis` points ``parallel/reduce.py``'s collectives at
  the ``data`` axis, which is how a loss reduces over the global batch.

Only rank 0 logs and writes (``jax.process_index() == 0`` in JAX).

Serving keeps JAX's other mesh: one process over its own chips, the
engines' ``mesh=`` (``audiogpt_tpu/engines/t2a.py:92-118``), where the
candidates of one call shard over ``data``. :func:`device_mesh` is its
counterpart, an ordered tuple of the process's cards; the engines run one
replica of their modules on each (``engines/base.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist
from torch import nn

from audiogpt_tpu_torch.parallel import reduce

#: torchrun's variables, all of which the zero-argument init needs
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. ``data=-1`` means 'all remaining ranks'."""

    data: int = -1
    model: int = 1
    axis_names: tuple[str, str] = ("data", "model")

    def resolve(self, n_devices: int) -> tuple[int, int]:
        d, m = self.data, self.model
        if d == -1 and m == -1:
            raise ValueError("at most one mesh axis may be -1")
        if d == -1:
            d = n_devices // m
        if m == -1:
            m = n_devices // d
        if d * m != n_devices:
            raise ValueError(
                f"mesh {d}x{m} != {n_devices} devices (spec={self})"
            )
        return d, m


class LocalMesh:
    """The 1×1 mesh of a process that joined no group: each axis has one
    rank and no process group, so every collective is the identity."""

    shape = (1, 1)

    def __init__(self, axis_names: tuple[str, str] = ("data", "model")):
        self.mesh_dim_names = tuple(axis_names)

    def get_local_rank(self, mesh_dim: int | str | None = None) -> int:
        return 0

    def get_group(self, mesh_dim: int | str | None = None):
        return None

    def __repr__(self) -> str:
        return f"LocalMesh({self.mesh_dim_names})"


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0 logs, saves and exports."""
    return process_index() == 0


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> None:
    """Join the process group once (a second call returns at once).

    ``backend`` None is NCCL between cards, and raises without CUDA; runs
    on the CPU pass ``"gloo"``. With NCCL the rank's card is pinned
    (``torch.cuda.set_device(LOCAL_RANK)``), so ``torch.device("cuda")``
    is the rank's own card.

    With ``coordinator_address`` (``host:port``) the group is the given
    ``num_processes`` with this one as ``process_id``, and a failure
    raises, as JAX's explicit init does (``mesh.py:87-95``). Without it
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) names the group; a process without
    that environment is a single-process run and nothing happens (JAX's
    auto-detect, ``mesh.py:96-101``). Unlike JAX, a failure with that
    environment present raises: the job was launched as a group."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if not all(k in os.environ for k in TORCHRUN_ENV):
            return                      # a single process: nothing to join
        init = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        init = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs CUDA; pass backend='gloo' to "
                               "run on the CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)


def make_mesh(spec: MeshSpec | None = None):
    """The group's ranks as a ``DeviceMesh`` of dims ``spec.axis_names``
    (rank order: ``data`` outer, ``model`` inner, as JAX reshapes
    ``jax.devices()``); without a group, a :class:`LocalMesh`, which a
    spec that needs more than one rank refuses. Every rank of the group
    must call it (the axes' groups are made collectively)."""
    spec = spec or MeshSpec()
    n = process_count()
    d, m = spec.resolve(n)
    if not dist.is_initialized():
        return LocalMesh(spec.axis_names)
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(d, m),
                      mesh_dim_names=tuple(spec.axis_names))


class ReplicaMesh(tuple):
    """One process's cards, in order, as a JAX ``Mesh`` of one process's
    chips with axes ``data`` (one entry a card) and ``model`` (1). A card
    may appear more than once: each entry is one replica, so one card can
    hold two (each on a stream of its own)."""

    @property
    def shape(self) -> dict:
        return {"data": len(self), "model": 1}

    def __repr__(self) -> str:
        return f"ReplicaMesh({', '.join(map(str, self))})"


def device_mesh(devices) -> ReplicaMesh:
    """The mesh of ``devices`` (``torch.device``s or their names, all CUDA
    or all CPU). ``"cuda"`` without an index is the current card. A card
    the machine lacks, CUDA without a card, or a mix of types raises:
    nothing falls back to the CPU or to fewer cards."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("device_mesh: no devices")
    types = {d.type for d in devs}
    if len(types) > 1 or types - {"cuda", "cpu"}:
        raise ValueError(f"device_mesh: all CUDA or all CPU, not {devs}")
    if "cuda" in types:
        if not torch.cuda.is_available():
            raise RuntimeError("device_mesh: CUDA is not available; name "
                               "'cpu' devices to run on the CPU")
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", torch.cuda.current_device()
                             if d.index is None else d.index) for d in devs]
        missing = [d for d in devs if d.index >= count]
        if missing:
            raise ValueError(f"device_mesh: {missing} not on this machine "
                             f"({count} cards)")
    else:
        devs = [torch.device("cpu")] * len(devs)
    return ReplicaMesh(devs)


def _dim(mesh, axis: str) -> int:
    return list(mesh.mesh_dim_names).index(axis)


def axis_size(mesh, axis: str = "data") -> int:
    return mesh.shape[_dim(mesh, axis)]


def axis_rank(mesh, axis: str = "data") -> int:
    return mesh.get_local_rank(_dim(mesh, axis))


def axis_group(mesh, axis: str = "data"):
    """The process group of this rank's ``axis`` (None for a
    :class:`LocalMesh`)."""
    return mesh.get_group(_dim(mesh, axis))


def bind_data_axis(mesh, axis: str = "data") -> None:
    """Make ``parallel/reduce.py`` reduce over ``mesh``'s ``axis``."""
    size = axis_size(mesh, axis)
    reduce.bind(axis_group(mesh, axis) if size > 1 else None, size,
                axis_rank(mesh, axis))


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh, axis: str = "data") -> Any:
    """This rank's contiguous rows ``[r·B/D, (r+1)·B/D)`` of every array
    (numpy or torch) with a leading batch axis; a 0-d entry or a number is
    kept whole. B must be a multiple of the ``axis`` size, as JAX's
    ``NamedSharding`` requires."""
    d, r = axis_size(mesh, axis), axis_rank(mesh, axis)

    def cut(x):
        shape = getattr(x, "shape", ())
        if not shape or d == 1:
            return x
        if shape[0] % d:
            raise ValueError(f"batch of {shape[0]} rows does not split "
                             f"over {d} '{axis}' ranks")
        b = shape[0] // d
        return x[r * b:(r + 1) * b]

    return _map(cut, batch)


def replicate(module_or_tensors: Any, mesh, axis: str = "data") -> Any:
    """Every parameter and buffer of a module (or every tensor of a
    container) broadcast in place from the first rank of this rank's
    ``axis`` group (rank 0 when the ``model`` axis is 1), so the ranks
    start equal (JAX: ``device_put`` with ``P()``); → its argument."""
    if axis_size(mesh, axis) == 1:
        return module_or_tensors
    group = axis_group(mesh, axis)
    src = dist.get_process_group_ranks(group)[0]
    if isinstance(module_or_tensors, nn.Module):
        tensors = [*module_or_tensors.parameters(),
                   *module_or_tensors.buffers()]
    else:
        tensors = []
        _map(lambda t: tensors.append(t) if torch.is_tensor(t) else None,
             module_or_tensors)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)
    return module_or_tensors


def _owner(module: nn.Module, name: str) -> nn.Module:
    prefix = name.rpartition(".")[0]
    return module.get_submodule(prefix) if prefix else module


def param_sharding(module: nn.Module, mesh, rules=None) -> dict:
    """``{parameter name: the dim sharded over 'model', or None}``.
    ``rules(name, param, owner) -> dim | None`` decides each (TP:
    ``tp_rules``); without rules every parameter replicates (pure data
    parallelism, the reference's DDP)."""
    del mesh        # the decision is the rules'; the mesh applies it
    return {name: None if rules is None else rules(name, p,
                                                    _owner(module, name))
            for name, p in module.named_parameters()}


def local_batch_slice(global_batch: int, mesh, axis: str = "data") -> slice:
    """The slice of the global batch this process feeds (JAX's arithmetic,
    ``mesh.py:140-150``: the batch over the processes, by process index;
    replaces ``DistributedSampler``, ``pl_utils.py:1318``)."""
    del mesh, axis
    per_proc = global_batch // process_count()
    start = process_index() * per_proc
    return slice(start, start + per_proc)
