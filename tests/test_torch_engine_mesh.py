"""The T2A and T2I engines' candidate sharding over a one-process mesh
(``parallel.device_mesh``, ``engines/base.py`` ``Replicated``) on the CPU:
two replicas of the port's ranked core against the JAX engine's
``_sample_vocode_rank_fn`` on a two-device mesh of the virtual CPU devices,
with the candidates placed under ``P("data")``; the rounding of n to the
``data`` axis; two replicas against one, T2A and T2I; a worker's exception
at the caller; a weight load after construction on every replica; the
mesh's own checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import test_torch_t2i as t2i
from audiogpt_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from audiogpt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audiogpt_tpu_torch.engines import T2IConfig, T2IEngine
from audiogpt_tpu_torch.engines.base import ReplicaRunner
from audiogpt_tpu_torch.models.textenc.clip import CLIPTextConfig
from audiogpt_tpu_torch.parallel import device_mesh
from test_torch_clap_scorer import make_scorers
from test_torch_t2a import (
    BERT,
    RANK_T2A,
    RANK_VOC,
    UNET,
    VAE,
    BertConfig,
    BigVGANConfig,
    CLAPTextConfig,
    JaxBertConfig,
    JaxCLAPConfig,
    JaxT2AConfig,
    JaxT2AEngine,
    JaxUNetConfig,
    JaxVAEConfig,
    JaxVocConfig,
    JaxVocoderEngine,
    T2AConfig,
    T2AEngine,
    UNetConfig,
    VAEConfig,
    VocoderEngine,
    _random_params,
)

torch.set_num_threads(2)

TEXT = "a dog barks in the rain"
CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def engines():
    """``test_torch_t2a.py``'s ranked fixture (a JAX engine with BigVGAN
    and the CLAP scorer on seeded numpy params), and the port's engine on
    those weights over two CPU replicas."""
    jvoc = JaxVocoderEngine("bigvgan", cfg=JaxVocConfig(aa_impl="literal",
                                                        **RANK_VOC),
                            params={}, buckets=(RANK_T2A["mel_len"],))
    jvoc.params = _random_params(jax.eval_shape(
        jvoc.model.init, jax.random.PRNGKey(1),
        jnp.zeros((1, 16, RANK_VOC["num_mels"]))), seed=3)
    jsc, sc = make_scorers(seed=4)
    jeng = JaxT2AEngine(JaxT2AConfig(
        unet=JaxUNetConfig(use_checkpoint=False, **UNET),
        vae=JaxVAEConfig(**VAE),
        clap=JaxCLAPConfig(bert=JaxBertConfig(**BERT), d_proj=32,
                           max_length=16), **RANK_T2A), params={},
        vocoder=jvoc, scorer=jsc)
    jeng.params = _random_params(
        jax.eval_shape(jeng.init_params, jax.random.PRNGKey(0)), seed=5)
    voc = VocoderEngine("bigvgan", cfg=BigVGANConfig(**RANK_VOC),
                        params=jvoc.params, buckets=(RANK_T2A["mel_len"],),
                        device="cpu")
    eng = T2AEngine(T2AConfig(
        unet=UNetConfig(**UNET), vae=VAEConfig(**VAE),
        clap=CLAPTextConfig(bert=BertConfig(**BERT), d_proj=32,
                            max_length=16), **RANK_T2A),
        params=jeng.params, vocoder=voc, scorer=sc, mesh=device_mesh(CPU2),
        device="cpu")
    return jeng, eng


def _candidates(eng, n, seed):
    """Seeded ctx, uncond [n, 16, 32] and x_T [n, h, w, 4] (NHWC)."""
    rng = np.random.RandomState(seed)
    h, w = eng.cfg.latent_hw
    return (rng.randn(n, 16, 32).astype(np.float32),
            rng.randn(n, 16, 32).astype(np.float32),
            rng.randn(n, h, w, 4).astype(np.float32))


def _torch(ctx, unc, x_T):
    return (torch.from_numpy(ctx), torch.from_numpy(unc),
            torch.from_numpy(x_T.transpose(0, 3, 1, 2).copy()))


def test_two_replicas_match_the_jax_mesh(engines):
    """The ranked core sharded over two replicas against JAX's, its
    candidates ``device_put`` under ``P("data")`` on two CPU devices."""
    jeng, eng = engines
    ctx, unc, x_T = _candidates(eng, 4, seed=10)
    mesh = jax_make_mesh(JaxMeshSpec(data=2, model=1), jax.devices()[:2])
    rows = NamedSharding(mesh, PartitionSpec("data"))
    sc = jeng.scorer
    ids, mask = sc.tokenizer.encode(TEXT, sc.cfg.max_length)
    h, w = eng.cfg.latent_hw
    mel_ref, wav_ref, scores_ref = jeng._sample_vocode_rank_fn(
        jeng.params, jeng.vocoder.params, sc.text_params, sc.audio_params,
        jnp.asarray(ids)[None], jnp.asarray(mask)[None],
        jax.device_put(ctx, rows), jax.device_put(unc, rows),
        jax.random.PRNGKey(0), jax.device_put(x_T, rows), 1.5, 3, h, w,
        "dpmpp")
    mel, wav, scores = eng.sample_vocode_rank(
        TEXT, *_torch(ctx, unc, x_T), 1.5, 3, "dpmpp")
    scores_ref = np.asarray(scores_ref)
    # the one-card parity's bounds (test_torch_t2a.py): 1e-5 on the
    # cosines, 2e-4 on the mel and wav at the end of the f32 chain
    np.testing.assert_allclose(scores.numpy(), scores_ref, atol=1e-5, rtol=0)
    assert np.ptp(scores_ref) > 1e-4
    assert int(scores.argmax()) == int(scores_ref.argmax())
    np.testing.assert_allclose(mel.numpy(), np.asarray(mel_ref)[..., 0],
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(wav.numpy(), np.asarray(wav_ref), atol=2e-4,
                               rtol=0)


def test_candidates_round_up_to_the_data_axis(engines):
    """n = 3 on two replicas is 4 candidates, as JAX's
    ``test_sharded_candidates`` asserts for 8 devices."""
    _, eng = engines
    mels, wavs = eng.txt2audio(TEXT, n_samples=3, ddim_steps=2, seed=0,
                               sampler="dpmpp")
    cfg = eng.cfg
    assert mels.shape == (4, cfg.mel_len, cfg.mel_bins)
    assert wavs.shape == (4, cfg.mel_len * eng.vocoder.hop_size)
    _, _, scores = eng.txt2audio_best(TEXT, n_samples=3, ddim_steps=2,
                                      seed=0)
    assert scores.shape == (4,) and np.isfinite(scores).all()


def test_t2a_two_replicas_match_one(engines):
    """The same seed and rounded n on one replica (the first, run alone as
    a one-replica engine): the same initial noise split into rows, the same
    candidates, scores and winner."""
    _, eng = engines
    one = eng.replica(0).txt2audio_best(TEXT, n_samples=4, ddim_steps=3,
                                        seed=2)
    two = eng.txt2audio_best(TEXT, n_samples=3, ddim_steps=3, seed=2)
    # the same f32 kernels on the same rows, at another batch: 1e-5
    for a, b in zip(one, two):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    assert np.ptp(one[2]) > 1e-4
    assert int(two[2].argmax()) == int(one[2].argmax())


def _filled(module, seed):
    """Seeded noise in every parameter (weights · fan_in^-½, vectors
    0.1·N, norm scales 1 + 0.1·N), so no zero-initialised output conv
    hides the UNet from the images."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.ndim >= 2:
                p.copy_(noise / np.sqrt(p[0].numel()))
            elif "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)


def _t2i_config():
    return T2IConfig(unet=UNetConfig(**t2i.UNET), vae=VAEConfig(**t2i.VAE),
                     text=CLIPTextConfig(**t2i.TEXT), **t2i.SIZE)


def test_t2i_two_replicas_match_one():
    one = T2IEngine(_t2i_config(), tokenizer=None, device="cpu")
    for name in ("unet", "vae", "text"):
        _filled(getattr(one, name), seed=len(name))
    two = T2IEngine(_t2i_config(), tokenizer=None, mesh=device_mesh(CPU2),
                    device="cpu")
    two.load_state_dict({name: getattr(one, name).state_dict()
                         for name in ("unet", "vae", "text")})
    a = one.txt2img("", n_samples=2, steps=3, seed=4)
    b = two.txt2img("", n_samples=1, steps=3, seed=4)     # rounded to 2
    assert b.shape == a.shape == (2, 8, 8, 3)
    assert np.ptp(a[0] - a[1]) > 1e-3                     # rows differ
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


def test_a_workers_exception_reaches_the_caller(engines):
    """A replica fed a latent of the wrong channel count: the UNet's error
    in the worker is the caller's, and the engine runs on after it."""
    _, eng = engines
    ctx, unc, x_T = _torch(*_candidates(eng, 2, 12))
    with pytest.raises(RuntimeError):
        eng.sample_vocode_rank(TEXT, ctx, unc, x_T[:, :3], 1.5, 1, "ddim")
    _, wav, scores = eng.sample_vocode_rank(TEXT, ctx, unc, x_T, 1.5, 1,
                                            "ddim")
    assert scores.shape == (2,) and torch.isfinite(wav).all()


def test_runner_waits_for_every_worker_then_raises():
    runner = ReplicaRunner(device_mesh(CPU2))
    done = []

    def fail():
        raise ValueError("replica 0")

    def work():
        done.append(torch.is_inference_mode_enabled())
        return torch.ones(2)

    with pytest.raises(ValueError, match="replica 0"):
        runner.run([fail, work])
    assert done == [True]            # the worker entered inference_mode
    out = runner.run([work, work])
    assert [o.tolist() for o in out] == [[1.0, 1.0]] * 2
    with pytest.raises(ValueError, match="functions"):
        runner.run([work])


def test_device_mesh():
    mesh = device_mesh(CPU2)
    assert mesh.shape == {"data": 2, "model": 1}
    assert list(mesh) == [torch.device("cpu")] * 2
    for bad in ([], ["cpu", "meta"]):
        with pytest.raises(ValueError):
            device_mesh(bad)


def test_device_mesh_refuses_cards_the_machine_lacks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mesh(["cuda:0", "cuda:1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="not on this machine"):
        device_mesh(["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        device_mesh(["cuda:0", "cpu"])


def test_engine_device_must_be_the_meshs_first():
    with pytest.raises(ValueError, match="mesh's first"):
        T2IEngine(_t2i_config(), tokenizer=None, mesh=device_mesh(CPU2),
                  device="meta")


def test_a_weight_load_reaches_every_replica(engines):
    """``load_jax_params`` after construction, on the engine, its vocoder
    and its scorer: every replica's output moves, and the replicas agree
    bitwise (the first is the engine's own modules, which the loaders
    load). Last: it changes the module's engine."""
    jeng, eng = engines
    voc, sc = eng.vocoder, eng.scorer

    def other(tree):                     # every leaf moved, none zeroed
        return jax.tree.map(lambda a: np.asarray(a) * 1.25, tree)

    ctx, unc, x_T = _torch(*_candidates(eng, 1, 11))

    def outputs(i):
        rep = eng.replica(i)
        t = sc.text_embedding(TEXT).to(rep.device)
        with torch.inference_mode():
            mel = rep.sample_core(ctx, unc, x_T, 1.5, 2, "dpmpp")[:, 0]
            wav = rep.vocoder.vocode(mel)
            return mel, wav, rep.scorer.audio_similarity(t, wav)

    before = outputs(1)
    eng.load_jax_params(other(jeng.params))
    voc.load_jax_params(other(jeng.vocoder.params))
    sc.load_jax_params(other(jeng.scorer.text_params),
                       other(jeng.scorer.audio_params))
    first, second = outputs(0), outputs(1)
    assert eng.replica(1).unet is not eng.unet
    for old, new, ref in zip(before, second, first):
        assert (old - new).abs().max() > 1e-3
        torch.testing.assert_close(new, ref, atol=0, rtol=0)
