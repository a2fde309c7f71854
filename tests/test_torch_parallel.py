"""The port's ``parallel/`` in one process: the counterparts of
``tests/test_mesh.py``'s mesh, sharding and TP-plan checks, the
collectives at a data size of 1, and the trainer in a one-rank gloo
group."""

import json
import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from audiogpt_tpu.models.tts.fastspeech2 import FastSpeech2 as JaxFS2
from audiogpt_tpu.models.tts.fastspeech2 import \
    FastSpeech2Config as JaxFS2Config
from audiogpt_tpu.parallel import MeshSpec as JaxMeshSpec
from audiogpt_tpu.parallel import make_mesh as jax_make_mesh
from audiogpt_tpu.parallel.mesh import param_sharding as jax_param_sharding
from audiogpt_tpu.parallel.tp_rules import tp_rules as jax_tp_rules
from audiogpt_tpu_torch.models.tts.fastspeech2 import (FastSpeech2,
                                                       FastSpeech2Config)
from audiogpt_tpu_torch.parallel import (LocalMesh, MeshSpec, apply_tp,
                                         distributed_init, gather_rows,
                                         global_mean, global_sum,
                                         local_batch_slice, local_rows,
                                         make_mesh, param_sharding, reduce,
                                         replicate, shard_batch, tp_rules)
from audiogpt_tpu_torch.parallel import mesh as pmesh
from audiogpt_tpu_torch.utils import jax_params

torch.set_num_threads(2)

#: ``tests/test_mesh.py``'s TP model
TP_FS2 = dict(vocab_size=30, hidden_size=64, enc_layers=1, dec_layers=1,
              num_heads=2, enc_ffn_kernel_size=3, dec_ffn_kernel_size=3,
              n_mels=16, dur_predictor_layers=1, predictor_layers=1,
              predictor_hidden=64, max_frames=32)


class FakeMesh:
    """A ``data`` × ``model`` mesh seen from one rank, without a group:
    what ``shard_batch`` and ``local_batch_slice`` read."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data: int, rank: int):
        self.shape = (data, 1)
        self.rank = rank

    def get_local_rank(self, dim):
        return self.rank if dim == 0 else 0

    def get_group(self, dim):
        return None


def test_mesh_spec_resolves_as_jax():
    for spec, n in ((MeshSpec(), 8), (MeshSpec(data=2, model=4), 8),
                    (MeshSpec(data=-1, model=2), 8), (MeshSpec(data=4,
                                                               model=-1), 8),
                    (MeshSpec(), 1)):
        jspec = JaxMeshSpec(data=spec.data, model=spec.model)
        assert spec.resolve(n) == jspec.resolve(n)
    for bad in (MeshSpec(data=3, model=1), MeshSpec(data=-1, model=-1)):
        with pytest.raises(ValueError):
            bad.resolve(8)


def test_make_mesh_without_a_group_is_one_local_rank():
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert isinstance(mesh, LocalMesh)
    assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError):
        make_mesh(MeshSpec(data=2, model=1))


@pytest.mark.parametrize("data", [2, 4])
def test_shard_batch_gives_each_rank_its_contiguous_rows(data):
    b = 8
    batch = {"x": np.arange(b * 3, dtype=np.float32).reshape(b, 3),
             "y": torch.arange(b), "step": 5,
             "scalar": np.float32(1.5), "t0": torch.tensor(2.0)}
    seen = []
    for r in range(data):
        out = shard_batch(batch, FakeMesh(data, r))
        rows = slice(r * b // data, (r + 1) * b // data)
        np.testing.assert_array_equal(out["x"], batch["x"][rows])
        assert torch.equal(out["y"], batch["y"][rows])
        assert out["step"] == 5 and out["scalar"] == batch["scalar"]
        assert out["t0"] is batch["t0"]
        seen.append(out["y"])
    assert torch.equal(torch.cat(seen), batch["y"])


def test_shard_batch_refuses_rows_that_do_not_split():
    with pytest.raises(ValueError):
        shard_batch({"x": np.zeros((6, 2))}, FakeMesh(4, 0))


def test_local_batch_slice_is_jax_arithmetic(monkeypatch):
    assert local_batch_slice(8, make_mesh()) == slice(0, 8)
    monkeypatch.setattr(pmesh, "process_count", lambda: 4)
    for r in range(4):
        monkeypatch.setattr(pmesh, "process_index", lambda r=r: r)
        assert local_batch_slice(16, FakeMesh(4, r)) == slice(4 * r,
                                                              4 * r + 4)


def test_collectives_are_the_identity_at_a_data_size_of_one():
    x = torch.randn(4, 3)
    assert reduce.world() == 1
    assert global_sum(x) is x and gather_rows(x) is x and local_rows(x) is x
    assert torch.equal(global_mean(x), x.mean())
    with pytest.raises(ValueError):
        reduce.bind(None, 2, 0)
    mod = torch.nn.Linear(3, 2)
    assert replicate(mod, make_mesh()) is mod
    plan = {n: 0 for n, _ in mod.named_parameters()}
    assert apply_tp(mod, make_mesh(), plan) is mod


def test_distributed_init_without_a_launcher_is_one_process(monkeypatch):
    for key in pmesh.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    distributed_init()
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        distributed_init("127.0.0.1:1")
    if not torch.cuda.is_available():
        # NCCL is the card's: no path carries on on the CPU
        with pytest.raises(RuntimeError):
            distributed_init("127.0.0.1:1", 1, 0)
        for key, value in zip(pmesh.TORCHRUN_ENV,
                              ("0", "1", "0", "127.0.0.1", "1")):
            monkeypatch.setenv(key, value)
        with pytest.raises(RuntimeError):
            distributed_init()
    assert not dist.is_initialized()


def _flax_to_port(path, owner_of) -> tuple:
    """A flax param path → (the port's name, ``load_jax_params``'
    renaming; the owning port module; the flax leaf name)."""
    keys = [str(getattr(k, "key", k)) for k in path]
    if keys[0] == "params":
        keys = keys[1:]
    *prefix, leaf = keys
    owner = owner_of(".".join(prefix))
    torch_leaf = jax_params._LEAF.get(leaf, leaf)
    if leaf == "embedding" and isinstance(getattr(owner, leaf, None),
                                          torch.nn.Parameter):
        torch_leaf = leaf
    return ".".join([*prefix, torch_leaf]), owner, leaf


def test_tp_plan_is_jax_partition_specs_on_the_port_layout():
    """``tp_rules(2, min_dim=16)`` on the port's FS2 against JAX's
    ``param_sharding(tree, mesh, tp_rules(tp=2, min_dim=16))`` on the same
    tree: name for name, the sharded flax axis landing on the port dim
    that ``load_jax_params`` moves it to."""
    cfg = JaxFS2Config(**TP_FS2)
    tokens = jax.numpy.asarray([[3, 5, 7, 9]] * 4, jax.numpy.int32)
    shapes = jax.eval_shape(lambda: JaxFS2(cfg).init(
        jax.random.PRNGKey(0), tokens, infer=True))
    mesh = jax_make_mesh(JaxMeshSpec(data=4, model=2))
    specs = jax_param_sharding(shapes, mesh,
                               rules=jax_tp_rules(tp=2, min_dim=16))
    model = FastSpeech2(FastSpeech2Config(**TP_FS2))
    plan = param_sharding(model, None, tp_rules(2, min_dim=16))
    leaves = jax.tree_util.tree_flatten_with_path(specs)[0]
    shape_of = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    want = {}
    for path, sharding in leaves:
        name, owner, leaf = _flax_to_port(path, model.get_submodule)
        spec = sharding.spec
        if spec == P():
            want[name] = None
            continue
        axis = [i for i, a in enumerate(spec) if a == "model"]
        assert len(axis) == 1, (name, spec)
        shape = shape_of[path].shape
        if leaf == "kernel":
            # where the flax axis lands: lay out a probe of distinct sizes
            probe = np.zeros((2, 3, 5, 7)[:len(shape)])
            moved = jax_params._kernel_layout(owner, probe).shape
            want[name] = moved.index(probe.shape[axis[0]])
        else:
            want[name] = axis[0]
    assert plan == want
    assert any(d is not None for d in plan.values())


def test_trainer_in_a_one_rank_gloo_group_matches_no_group(tmp_path):
    """torchrun's one-process group (gloo here): ``distributed_init`` is
    idempotent, the mesh is a 1×1 ``DeviceMesh``, and the trainer's flat
    gradient all-reduce and stop-flag all-reduce leave the run bitwise
    what it is without a group."""
    from audiogpt_tpu_torch.train import Trainer, TrainerConfig
    from audiogpt_tpu_torch.train.tasks import FS2Task, FS2TaskConfig
    from test_torch_ddp import TINY_FS2

    import _torch_ddp_tasks as D

    def fit(work):
        task = FS2Task(FS2TaskConfig(model=FastSpeech2Config(**TINY_FS2)),
                       device="cpu")
        trainer = Trainer(task, TrainerConfig(
            work_dir=str(tmp_path / work), log_interval=1,
            num_sanity_val_steps=0, use_tensorboard=False), device="cpu")
        batches = [D.fs2_batch(s, n_mels=20) for s in range(2)]
        trainer.fit(batches, max_updates=2)
        trainer.logger.close()
        return trainer

    alone = fit("alone")
    assert alone._grad_group is None
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed_init(f"127.0.0.1:{port}", 1, 0, backend="gloo")
    try:
        distributed_init(f"127.0.0.1:{port}", 1, 0, backend="gloo")
        mesh = make_mesh()
        assert not isinstance(mesh, LocalMesh)
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        grouped = fit("grouped")
        assert grouped._grad_group is not None and grouped.data_size == 1
        for (n, a), (_, b) in zip(alone.named["model"],
                                  grouped.named["model"]):
            assert torch.equal(a, b), n
        logs = [open(tmp_path / w / "metrics.jsonl").read().splitlines()
                for w in ("alone", "grouped")]
        strip = lambda line: {k: v for k, v in  # noqa: E731
                              json.loads(line).items() if k not in D.TIMED}
        assert [strip(x) for x in logs[0]] == [strip(x) for x in logs[1]]
    finally:
        dist.destroy_process_group()
        reduce.bind(None, 1, 0)
    assert not dist.is_initialized()
