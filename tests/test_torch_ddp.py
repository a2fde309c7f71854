"""Data parallelism of the port against one process, and against JAX.

Two gloo children (``tests/_torch_ddp_child.py``: torch and the port only)
join a group on a free loopback port and run, in one spawn:

(a) every recipe of the training CLI at tiny widths (``_torch_ddp_tasks``)
    for two steps on a 2×1 mesh, each rank on its rows of the global
    batch; this process runs the same recipes as one process on the whole
    batch. JAX's step computes each loss on the whole sharded batch, so
    the two must agree: the logged metrics, every gradient the optimizer
    consumed and every updated parameter, and the two ranks bitwise;
(b) the FS2 forward of ``tests/test_mesh.py``'s TP test, column-parallel
    over a 1×2 mesh, against the unsharded forward;
(c) the tiny FS2 of ``tests/test_multihost.py`` over two port ranks
    against JAX's ``Trainer`` on the conftest's 8-device CPU mesh, from
    the same tree and global batch (three steps of ``total_loss``).
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ddp_tasks as D
from audiogpt_tpu_torch.parallel import param_sharding, tp_rules

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_ddp_child.py")
CHILD_TIMEOUT = 240
#: a logged metric while both runs hold the parameters they started with
#: (the sanity validation; step 1 of a one-group recipe): sums of the same
#: f32 terms in another order. Once an optimizer step has moved them, Adam
#: has normalised the gradients' rounding noise (an element of a gradient
#: whose true value is 0 moves by up to lr either way), so the metrics of
#: later steps agree to 1e-5
METRIC_RTOL, METRIC_RTOL_MOVED = 1e-6, 1e-5
#: the first step's gradients and the parameters after the run against
#: each tensor's largest (PR 13's gradient tolerance); an element whose
#: first gradient is within 1e-7 of its group's largest holds rounding
#: noise (an attention's key bias, a conv bias before a one-channel
#: GroupNorm: a true gradient of 0), which Adam's steps normalise into a
#: move of up to the rate a step either way
PARAM_RTOL, GRAD_RTOL, ZERO_GRAD_TOL = 5e-5, 5e-5, 1e-7
#: JAX's tolerances: the TP forward (``tests/test_mesh.py``), the
#: multi-process losses (``tests/test_multihost.py``)
TP_TOL, JAX_LOSS_RTOL = 2e-5, 1e-5
JAX_STEPS = 3
#: ``tests/test_train.py``'s tiny FS2 task
TINY_FS2 = dict(vocab_size=30, hidden_size=16, enc_layers=1, dec_layers=1,
                num_heads=2, enc_ffn_kernel_size=3, dec_ffn_kernel_size=3,
                n_mels=20, dur_predictor_layers=1, predictor_layers=1,
                predictor_hidden=8, max_frames=32)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_fs2(out) -> list:
    """JAX's tiny FS2 trainer: its initial tree (seeded numpy leaves, as
    the training tests fill one, placed by ``Trainer.init_state``) and
    global batch go to ``out/jax_fs2.pkl`` for the children; → its
    ``total_loss`` of each step on the 8-device mesh
    (``test_multihost._single_process_losses``'s steps)."""
    import jax

    from audiogpt_tpu.parallel.mesh import make_mesh, shard_batch
    from audiogpt_tpu.train import Trainer, TrainerConfig
    from test_torch_t2a import _random_params
    from test_train import _fs2_batch, _tiny_fs2_task

    mesh = make_mesh()
    task = _tiny_fs2_task()
    assert {k: getattr(task.cfg.model, k) for k in TINY_FS2} == TINY_FS2
    # seeded numpy leaves: cheaper than flax's init run eagerly
    tree = _random_params(jax.eval_shape(task.init_params,
                                         jax.random.PRNGKey(0)), seed=9)
    task.init_params = lambda rng: tree
    trainer = Trainer(task, TrainerConfig(
        work_dir=str(out / "jax"), use_tensorboard=False), mesh=mesh)
    state = trainer.init_state()
    full = _fs2_batch(np.random.default_rng(0), b=8)
    part = out / "jax_fs2.part"
    with open(part, "wb") as f:
        pickle.dump({"model": TINY_FS2, "batch": full, "steps": JAX_STEPS,
                     "params": jax.tree.map(np.asarray, state["params"])},
                    f)
    os.replace(part, out / "jax_fs2.pkl")
    step_fn = trainer.train_step("model")
    rng = jax.random.PRNGKey(0)
    losses = []
    for _ in range(JAX_STEPS):
        state, metrics = step_fn(state, shard_batch(full, mesh), rng)
        losses.append(float(jax.device_get(metrics["total_loss"])))
    return losses


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ddp")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, CHILD, "--port", str(port), "--rank", str(r),
         "--out", str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        # this process's side, while the children run
        jax_losses = _jax_fs2(out)
        single = {name: D.run_recipe(name, str(out / f"{name}_single"))
                  for name in D.RECIPES}
        model, inputs = D.tp_fs2_inputs()
        with torch.no_grad():
            tp_ref = model(inputs["tokens"], mel2ph=inputs["mel2ph"],
                           f0=inputs["f0"], uv=inputs["uv"])["mel_out"]
        logs = []
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    load = lambda f: torch.load(out / f, weights_only=False)  # noqa: E731
    return {"single": single,
            "ranks": [load(f"ddp_rank{r}.pt") for r in range(2)],
            "tp": [load(f"tp_rank{r}.pt") for r in range(2)],
            "tp_ref": tp_ref, "tp_model": model, "jax": jax_losses,
            "fs2": [json.loads((out / f"fs2_rank{r}.json").read_text())
                    for r in range(2)]}


#: the 17 recipes by family, one test each (a file of more tests than
#: ``tests/test_train_cli.py``'s 16 queues before it under ``--dist
#: loadfile``, which delays the longest file of the run)
FAMILIES = {
    "ldm_vae_clap": ("ldm", "vae", "clap"),
    "fs2_vocoder_gan": ("fs2", "vocoder_gan"),
    "portaspeech_syntaspeech": ("portaspeech", "syntaspeech"),
    "ps_adv_synta_adv": ("ps_adv", "synta_adv"),
    "generspeech_pe": ("generspeech", "pe"),
    "diffsinger_visinger_audio2motion": ("diffsinger", "visinger",
                                         "audio2motion"),
    "sed_caption_separation": ("sed", "caption", "separation"),
}


def test_the_families_hold_every_recipe():
    names = [n for family in FAMILIES.values() for n in family]
    assert sorted(names) == sorted(D.RECIPES) and len(names) == 17


@pytest.mark.parametrize("family", list(FAMILIES))
def test_two_ranks_train_as_one_process_on_the_global_batch(run, family):
    """Two gloo ranks, each on half of every global batch, against one
    process on the whole batch, for each recipe of ``family``: the logged
    lines (sanity validation and both steps), each group's first mean
    gradient, the parameters after the run; the ranks bitwise equal to
    each other."""
    for name in FAMILIES[family]:
        _check_recipe(run, name)


def _check_recipe(run, name: str) -> None:
    single = run["single"][name]
    ranks = [rank[name] for rank in run["ranks"]]
    assert ranks[1]["log"] == [], f"{name}: only rank 0 logs"
    for group, params in ranks[0]["params"].items():
        for n, p in params.items():
            assert torch.equal(p, ranks[1]["params"][group][n]), \
                (name, group, n)
        for a, b in zip(ranks[0]["grads"][group], ranks[1]["grads"][group]):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), \
                (name, group)

    got, ref = ranks[0]["log"], single["log"]
    assert [(line["prefix"], line["step"]) for line in got] == \
        [(line["prefix"], line["step"]) for line in ref] == \
        [("sanity", 0), ("tr", 1), ("tr", 2)]
    groups = list(single["params"])
    for g_line, r_line in zip(got, ref):
        assert sorted(g_line) == sorted(r_line)
        still = r_line["prefix"] == "sanity" or (
            r_line["step"] == 1 and len(groups) == 1)
        rtol = METRIC_RTOL if still else METRIC_RTOL_MOVED
        for k, v in r_line.items():
            if k in ("prefix", "step"):
                continue
            np.testing.assert_allclose(
                g_line[k], v, rtol=rtol,
                err_msg=f"{name} {r_line['prefix']} {r_line['step']} {k}")

    for group in groups:
        names = list(single["params"][group])
        s_grads, d_grads = single["grads"][group], ranks[0]["grads"][group]
        assert len(s_grads) == len(d_grads) == D.STEPS
        # each group's first step: both runs on the parameters they started
        # with (a second group's after the first group's update)
        top = max(float(g.abs().max()) for g in s_grads[0])
        for n, s, d in zip(names, s_grads[0], d_grads[0]):
            bound = max(GRAD_RTOL * float(s.abs().max()), ZERO_GRAD_TOL * top)
            err = float((d - s).abs().max())
            assert err <= bound, (name, group, n, err, bound)
        adam_bound = 2.0 * sum(single["lr"][group])
        for n, grad in zip(names, s_grads[0]):
            s, d = single["params"][group][n], ranks[0]["params"][group][n]
            noise = grad.abs() <= ZERO_GRAD_TOL * top
            bound = torch.where(noise, adam_bound,
                                PARAM_RTOL * float(s.abs().max()))
            err = (d - s).abs()
            assert bool((err <= bound).all()), \
                (name, group, n, float(err.max()))


def test_column_parallel_fs2_forward_matches_the_unsharded_one(run):
    """``tp_rules(2, min_dim=16)`` shards FS2's kernels and embeddings;
    ``apply_tp`` runs them column-parallel over two ranks: the mel equals
    the unsharded forward within JAX's 2e-5 (``test_mesh.py:97-98``), on
    both ranks."""
    ref = run["tp_ref"]
    plan = run["tp"][0]["plan"]
    assert plan == param_sharding(run["tp_model"], None,
                                  tp_rules(2, min_dim=16))
    assert any(dim is not None for dim in plan.values())
    for rank in run["tp"]:
        np.testing.assert_allclose(rank["mel_out"].numpy(), ref.numpy(),
                                   atol=TP_TOL, rtol=TP_TOL)
    assert torch.equal(run["tp"][0]["mel_out"], run["tp"][1]["mel_out"])


def test_two_port_ranks_match_the_jax_trainer_on_eight_devices(run):
    """The tiny FS2 of ``tests/test_multihost.py`` from JAX's initial tree
    on the same global batch of 8: two port ranks of 4 rows each give the
    ``total_loss`` of JAX's ``Trainer`` on the 8-device mesh at each of
    three steps, both ranks the same."""
    assert run["fs2"][0] == run["fs2"][1]
    np.testing.assert_allclose(run["fs2"][0]["losses"], run["jax"],
                               rtol=JAX_LOSS_RTOL)
