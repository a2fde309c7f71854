"""The port's training substrate against the JAX package's on the CPU: the
config loader (against ``yaml.safe_load`` and JAX's ``load_config`` for every
file under ``configs/``), the record format both ways, the fixed-shape
loader's batches, the schedules and optimizer steps against optax, and the
checkpoint store's retention against the orbax store's."""

import dataclasses
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from audiogpt_tpu import config as jconfig
from audiogpt_tpu.data import records as jrecords
from audiogpt_tpu.data.loader import ArrayDataLoader as JaxArrayDataLoader
from audiogpt_tpu.data.loader import collate_mel_image as jax_collate
from audiogpt_tpu.train import optim as joptim
from audiogpt_tpu.train.checkpoint import CheckpointStore as JaxStore
from audiogpt_tpu_torch import config as pconfig
from audiogpt_tpu_torch.data import (ArrayDataLoader, RecordDataset,
                                     RecordWriter, collate_mel_image,
                                     load_split)
from audiogpt_tpu_torch.train import optim as poptim
from audiogpt_tpu_torch.train.checkpoint import CheckpointStore

torch.set_num_threads(2)

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs")
                 .rglob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_matches_yaml_and_jax(path, tmp_path):
    """Every repository config: the resolved tree equals JAX's, a file
    without ``base_config`` equals ``yaml.safe_load``, overrides apply the
    same way, and the saved config reads back equal."""
    raw = yaml.safe_load(path.read_text()) or {}
    got = pconfig.load_config(str(path))
    assert got.to_dict() == jconfig.load_config(str(path)).to_dict()
    if "base_config" not in raw:
        assert got.to_dict() == raw
    spec = "optim.lr=0.5,model.extra=[1, 2],name=run,flag=true"
    assert pconfig.load_config(str(path), overrides=spec).to_dict() == \
        jconfig.load_config(str(path), overrides=spec).to_dict()
    got.save(str(tmp_path / "config.yaml"))
    assert pconfig.load_config(str(tmp_path / "config.yaml")) == got
    assert hash(got) == hash(pconfig.Config(got.to_dict()))


def _records(n, seed):
    rng = np.random.default_rng(seed)
    return [{"mel": rng.random((int(rng.integers(20, 40)), 16),
                               dtype=np.float32),
             "text_ids": rng.integers(1, 100, int(rng.integers(3, 12)))
             .astype(np.int32), "name": f"item{i}", "dur": 1.5 * i}
            for i in range(n)]


def _equal_records(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_records_cross_read(tmp_path, writer):
    """A split written by either package reads back equal in both; the
    index files are the same bytes."""
    recs = _records(7, seed=1)
    prefixes = {}
    for name, cls in (("jax", jrecords.RecordWriter), ("port", RecordWriter)):
        prefixes[name] = str(tmp_path / name / "train")
        with cls(prefixes[name]) as w:
            for r in recs:
                w.add(r)
    src = prefixes[writer]
    for ds in (RecordDataset(src), jrecords.RecordDataset(src),
               load_split(str(Path(src).parent), "train")):
        assert len(ds) == len(recs)
        for r, back in zip(recs, ds):
            _equal_records(r, back)
    assert Path(prefixes["jax"] + ".idx").read_bytes() == \
        Path(prefixes["port"] + ".idx").read_bytes()


def test_collate_and_loader_batches_equal_jax(tmp_path):
    """``collate_mel_image`` and ``ArrayDataLoader`` (shuffled epochs, the
    validation pass, the padded short batch with weight 0) give JAX's
    batches."""
    prefix = str(tmp_path / "train")
    with RecordWriter(prefix) as w:
        for r in _records(11, seed=2):
            w.add(r)
    ds = RecordDataset(prefix)
    kw = dict(width=32, text_len=8)
    for a, b in ((collate_mel_image, jax_collate),):
        _equal_records(a([ds[0], ds[5]], **kw), b([ds[0], ds[5]], **kw))
        _equal_records(a([ds[1]], width=24), b([ds[1]], width=24))
    port = ArrayDataLoader(ds, functools.partial(collate_mel_image, **kw),
                           batch_size=4, seed=7)
    ref = JaxArrayDataLoader(ds, functools.partial(jax_collate, **kw),
                             batch_size=4, seed=7)
    it, jit = iter(port), iter(ref)
    for _ in range(7):                       # two epochs and a bit
        _equal_records(next(it), next(jit))
    val = list(ArrayDataLoader(ds, functools.partial(collate_mel_image, **kw),
                               batch_size=4, shuffle=False).epoch(0))
    jval = list(JaxArrayDataLoader(ds, functools.partial(jax_collate, **kw),
                                   batch_size=4, shuffle=False).epoch(0))
    assert len(val) == len(jval) == 3
    for a, b in zip(val, jval):
        _equal_records(a, b)
    np.testing.assert_array_equal(val[-1]["weight"], [1, 1, 1, 0])
    assert val[-1]["mels"].shape == (4, 16, 32, 1)
    assert not val[-1]["mels"][3].any()


@pytest.mark.parametrize("kind", ["rsqrt", "constant", "exponential"])
def test_schedules_match_optax(kind):
    cfg = poptim.OptimConfig(schedule=kind, lr=0.7, warmup_steps=10,
                             hidden_size=64, lr_decay=0.5, lr_decay_every=3)
    got = poptim.make_schedule(cfg)
    ref = joptim.make_schedule(joptim.OptimConfig(**dataclasses.asdict(cfg)))
    for step in (0, 1, 2, 3, 7, 9, 10, 11, 50):
        np.testing.assert_allclose(got(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6, atol=0)


#: each case: OptimConfig fields, and which of the 6 gradient feeds are the
#: NaN guard's zeros
OPTIM_CASES = {
    "adam": (dict(optimizer="adam", lr=0.1, schedule="rsqrt",
                  warmup_steps=4, hidden_size=16, clip_grad_norm=0.0), ()),
    "adamw": (dict(optimizer="adamw", lr=0.05, schedule="constant",
                   beta2=0.999, weight_decay=0.1, clip_grad_norm=0.0), ()),
    "clip": (dict(optimizer="adamw", lr=0.05, schedule="constant",
                  weight_decay=0.01, clip_grad_norm=0.5), ()),
    "accumulate_2": (dict(optimizer="adam", lr=0.1, schedule="exponential",
                          lr_decay=0.5, lr_decay_every=1,
                          clip_grad_norm=1.0, accumulate_steps=2), ()),
    "nonfinite": (dict(optimizer="adam", lr=0.1, schedule="constant",
                       clip_grad_norm=1.0), (1,)),
}


@pytest.mark.parametrize("case", OPTIM_CASES)
def test_optimizer_steps_match_optax(case):
    """The port's update on two tensors, fed the same gradients as optax's
    chain (clip, Adam or AdamW, MultiSteps); under ``nonfinite`` one feed
    is the zeros of the NaN guard, which still moves the params by
    momentum. f32 throughout: 1e-6 relative."""
    fields, zero_feeds = OPTIM_CASES[case]
    cfg = poptim.OptimConfig(**fields)
    rng = np.random.RandomState(4)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    feeds = [{k: (3.0 * rng.randn(*v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(6)]
    for i in zero_feeds:
        feeds[i] = {k: np.zeros_like(v) for k, v in feeds[i].items()}
    tx = joptim.make_optimizer(joptim.OptimConfig(**fields))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [torch.tensor(params[k]) for k in ("a", "b")]
    opt = poptim.make_optimizer(cfg, tp)
    moved = []
    for feed in feeds:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in feed.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        before = [t.clone() for t in tp]
        opt.step([torch.tensor(feed[k]) for k in ("a", "b")])
        moved.append(any(not torch.equal(a, b) for a, b in zip(before, tp)))
        for k, t in zip(("a", "b"), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    k = cfg.accumulate_steps
    assert moved == [(i + 1) % k == 0 for i in range(6)]
    assert opt.count == 6 // k


@pytest.mark.parametrize("monitor,keep", [("total_loss", 2), (None, 2),
                                          ("total_loss", 3)])
def test_checkpoint_retention_matches_orbax(tmp_path, monitor, keep):
    """The same saves with metrics (ties, the 1e30 sentinel, one save
    without metrics) leave the orbax store and the port's with the same
    steps, the same best and the same latest; a restore gives the saved
    state back."""
    saves = [(2, 0.5), (4, 0.3), (6, 0.3), (8, 1e30), (10, None), (12, 0.4),
             (14, 0.2), (15, 1e30)]
    jstore = JaxStore(str(tmp_path / "jax"), keep, monitor=monitor)
    store = CheckpointStore(str(tmp_path / "port"), keep, monitor=monitor)
    for step, metric in saves:
        metrics = None if metric is None else {"total_loss": metric}
        jstore.save(step, {"w": jnp.full((2,), float(step))}, metrics)
        store.save(step, {"w": torch.full((2,), float(step)),
                          "ema": {}, "step": step}, metrics)
        assert store.all_steps() == jstore.all_steps()
        assert store.latest_step() == jstore.latest_step()
        assert store.best_step() == jstore.best_step()
    jstore.close()
    latest = store.latest_step()     # with a monitor, the 1e30 save went
    back = store.restore()
    assert back["step"] == latest and torch.equal(
        back["w"], torch.full((2,), float(latest)))
    assert store.saved_ema_groups(latest) == set()
    assert not list((tmp_path / "port").rglob("*.part"))
