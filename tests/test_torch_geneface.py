"""Port GeneFace (``audiogpt_tpu_torch/engines/face.py``,
``models/face/``, ``utils/video_io.py``) against the JAX package on shared
parameters and replayed draws, through one compiled JAX program a piece:
the antialiased time resize against ``jax.image.resize`` (down and up),
the energy articulation prior, ``Audio2MotionVAE.generate``, the landmark
warp, the AVI writer's bytes, and ``GeneFaceEngine`` (its landmarks on its
bucket and on a clip cut to it, and its video of a wav file). Also
the JAX fault the port does not copy: a relative audio path is read under
the media root, never against the working directory.

Tolerances: module outputs within 1e-4 absolute, landmark offsets within
1e-5 (f32 through two thin conv stacks), rendered frames at most one
uint8 level off on at most 0.1 % of the values (a sample position that
lands on a floor or truncation edge may round the other way), and the
writer's bytes exactly equal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines.face import GeneFaceEngine as JaxGeneFaceEngine
from audiogpt_tpu.models.face import audio2motion as ja
from audiogpt_tpu.models.face import renderer as jr
from audiogpt_tpu.utils import audio_io as _jax_audio_io  # noqa: F401
from audiogpt_tpu.utils import video_io as jvideo
from audiogpt_tpu_torch.engines.face import GeneFaceEngine
from audiogpt_tpu_torch.models.face import audio2motion as pa
from audiogpt_tpu_torch.models.face import renderer as pr
from audiogpt_tpu_torch.utils import video_io as pvideo
from audiogpt_tpu_torch.utils.audio_io import save_wav
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_torch_svs import ATOL, init_params, to_torch

torch.set_num_threads(2)
# ``_jax_audio_io`` (scipy.signal, seconds to import) is imported at
# collection, as the suite's other JAX tests import it, not inside the
# first test that calls the JAX engine's ``audio_to_video``.

#: landmark offsets (f32 through two thin conv stacks)
LM_ATOL = 1e-5
#: the engine's config: 80 mel bins (the LDM mel), a narrow net
CFG = dict(hidden=16, latent=4, conv_layers=1)
BUCKETS = (64,)
SIZE = 32


def render_close(ref, got):
    """At most one uint8 level off on at most 0.1 % of the values."""
    diff = np.abs(np.asarray(ref, np.int16) - got.astype(np.int16))
    assert ref.shape == got.shape and ref.dtype == got.dtype == np.uint8
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, \
        (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("t,tv", [(625, 250), (37, 16), (40, 100)],
                         ids=["down-10s", "down-odd", "up"])
def test_resize_time_matches_jax(t, tv):
    x = np.random.RandomState(t).randn(2, t, 5).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, tv, 5), "linear")
    got = pa.resize_time(to_torch(x), tv)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def params():
    """The JAX inference tree of ``Audio2MotionVAE.generate`` (no
    ``motion_enc`` / ``post_head``), every leaf random."""
    cfg = ja.Audio2MotionConfig(**CFG)
    p = init_params(ja.Audio2MotionVAE(cfg), jnp.zeros((1, 64, 80)),
                    rng=jax.random.PRNGKey(0),
                    method=ja.Audio2MotionVAE.generate, seed=3)
    assert sorted(p["params"]) == ["audio_enc", "decoder", "out_head",
                                   "prior_head"]
    return p


def test_generate_and_energy_prior_match_jax(params):
    jcfg, pcfg = ja.Audio2MotionConfig(**CFG), pa.Audio2MotionConfig(**CFG)
    mel = np.random.RandomState(4).rand(1, 64, 80).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref, ref_energy = jax.jit(lambda p, m: (
        ja.Audio2MotionVAE(jcfg).apply(p, m, key,
                                       method=ja.Audio2MotionVAE.generate),
        ja.energy_articulation(m[0], jcfg)))(params, mel)
    noise = jax.random.normal(key, (1, jcfg.video_len(64), CFG["latent"]))
    model = pa.Audio2MotionVAE(pcfg).eval()
    load_jax_params(model, params)
    with torch.no_grad():
        got = model.generate(to_torch(mel), to_torch(noise))
    assert got.shape == (1, 25, 136)
    np.testing.assert_allclose(got.numpy(), ref, atol=LM_ATOL, rtol=0)
    energy = pa.energy_articulation(to_torch(mel[0]), pcfg)
    np.testing.assert_allclose(energy.numpy(), ref_energy, atol=ATOL,
                               rtol=0)
    assert float(energy.abs().max()) > 0.0


def sample_taps(warper, portrait: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """The four portrait values each output value of the port's warp
    samples: [T, H, W, 3, 4]."""
    H, W = warper.height, warper.width
    off = warper.offsets(torch.from_numpy(lm)).numpy()
    fx = np.clip((warper._xs.numpy() + off[..., 0]) * W - 0.5, 0, W - 1.001)
    fy = np.clip((warper._ys.numpy() + off[..., 1]) * H - 0.5, 0, H - 1.001)
    i = (np.floor(fy) * W + np.floor(fx)).astype(np.int64)
    p = portrait.reshape(H * W, 3)
    return np.stack([p[i], p[i + 1], p[i + W], p[i + W + 1]],
                    -1).reshape(*lm.shape[:1], H, W, 3, 4)


@pytest.mark.parametrize("kind", ["default", "random", "uint8"])
def test_render_matches_jax(kind):
    """The engine's default portrait and a random one in [0, 1]; and a
    uint8 portrait (a photo), whose flat regions sample to k / 255 exactly
    and so sit on the truncation's edges, where the last ulp of the 4-tap
    sum decides the level: XLA's fused code and PyTorch round that ulp
    differently (about 10 % of the values here). That case is held to one
    level, and every value that differs must be such a tie: all four taps
    hold the higher of the two levels, the exact value."""
    rng = np.random.RandomState(6)
    lm = (jr.template_landmarks()[None]
          + 0.03 * rng.randn(4, 68, 2)).astype(np.float32)
    portrait = {"default": jr.default_portrait(SIZE, SIZE),
                "random": rng.rand(SIZE, SIZE, 3).astype(np.float32),
                "uint8": (255 * jr.default_portrait(SIZE, SIZE)).astype(
                    np.uint8)}[kind]
    ref = jr.LandmarkWarper(SIZE, SIZE).render(portrait, lm)
    got = pr.LandmarkWarper(SIZE, SIZE).render(portrait, lm)
    if kind == "uint8":
        off = np.abs(ref.astype(np.int16) - got) > 0
        taps = sample_taps(pr.LandmarkWarper(SIZE, SIZE), portrait, lm)
        assert np.abs(ref.astype(np.int16) - got).max() <= 1
        level = np.maximum(ref, got)[off][:, None]
        assert (taps[off] == level).all(), \
            "a value off the truncation edge differs"
    else:
        render_close(ref, got)
    np.testing.assert_array_equal(pr.default_portrait(SIZE, SIZE),
                                  jr.default_portrait(SIZE, SIZE))


@pytest.mark.parametrize("with_audio", [False, True])
def test_avi_writer_bytes_equal_jax(tmp_path, with_audio):
    frames = np.random.RandomState(7).randint(0, 255, (5, 16, 24, 3),
                                              dtype=np.uint8)
    audio = 0.3 * np.sin(np.arange(3201) / 5.0) if with_audio else None
    a, b = str(tmp_path / "jax.avi"), str(tmp_path / "port.avi")
    jvideo.write_mjpeg_avi(a, frames, fps=25, audio=audio)
    pvideo.write_mjpeg_avi(b, frames, fps=25, audio=audio)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    info = pvideo.read_avi_info(b)
    assert info == jvideo.read_avi_info(b)
    assert (info["n_frames"], info["n_video_chunks"], info["fps"],
            info["n_streams"]) == (5, 5, 25, 1 + with_audio)


@pytest.fixture(scope="module")
def engines(params, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("media"))
    jeng = JaxGeneFaceEngine(ja.Audio2MotionConfig(**CFG), params=params,
                             media_root=root, video_size=SIZE,
                             buckets=BUCKETS)
    eng = GeneFaceEngine(pa.Audio2MotionConfig(**CFG), params=params,
                         media_root=root, video_size=SIZE, buckets=BUCKETS,
                         device="cpu")
    return jeng, eng, root


def next_draws(jeng, frames: int) -> torch.Tensor:
    """The noise of the JAX engine's next call: its key split, then a
    normal draw of the prior's shape at the bucket of ``frames``."""
    cfg = jeng.cfg
    b = jeng.bucketer.bucket(frames)
    key = jax.random.split(jeng._rng)[1]
    return to_torch(jax.random.normal(key, (1, cfg.video_len(b),
                                            cfg.latent)))


@pytest.mark.parametrize("frames", [50, 100], ids=["bucket", "cut"])
def test_engine_landmarks_match_jax(engines, frames):
    """On the bucket, and a clip past the largest bucket (cut to it)."""
    jeng, eng, _ = engines
    mel = np.random.RandomState(frames).rand(frames, 80).astype(np.float32)
    draws = next_draws(jeng, frames)
    ref = jeng.landmarks(mel)
    got = eng.landmarks(mel, draws)
    assert got.shape == ref.shape == (
        eng.cfg.video_len(min(frames, BUCKETS[-1])), 68, 2)
    np.testing.assert_allclose(got, ref, atol=LM_ATOL, rtol=0)


def test_engine_without_energy_prior_matches_jax(params, tmp_path):
    """``use_energy_prior=False``: the template plus the prior's sample."""
    kw = dict(params=params, media_root=str(tmp_path), video_size=SIZE,
              buckets=BUCKETS, use_energy_prior=False)
    jeng = JaxGeneFaceEngine(ja.Audio2MotionConfig(**CFG), **kw)
    eng = GeneFaceEngine(pa.Audio2MotionConfig(**CFG), device="cpu", **kw)
    mel = np.random.RandomState(3).rand(50, 80).astype(np.float32)
    draws = next_draws(jeng, 50)
    np.testing.assert_allclose(eng.landmarks(mel, draws),
                               jeng.landmarks(mel), atol=LM_ATOL, rtol=0)


def _chunks(data: bytes, fourcc: bytes) -> list[bytes]:
    """The payloads of the ``fourcc`` chunks of an AVI's ``movi`` list."""
    i = data.index(b"movi") + 4
    end = data.index(b"idx1")
    out = []
    while i < end:
        tag, n = data[i:i + 4], int.from_bytes(data[i + 4:i + 8], "little")
        if tag == fourcc:
            out.append(data[i + 8:i + 8 + n])
        i += 8 + n + n % 2
    return out


def test_engine_video_matches_jax(engines):
    """A 1 s wav under the media root, named relative to it: the same
    frames (the landmarks replayed), the same AVI layout, the same muxed
    audio bytes."""
    jeng, eng, root = engines
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    wav = (0.3 * np.sin(np.arange(16000) / 3.0)
           * np.sin(np.arange(16000) / 900.0)).astype(np.float32)
    save_wav(wav, os.path.join(root, "audio", "clip.wav"), 16000)
    mel = eng.mel(wav)
    draws = next_draws(jeng, mel.shape[0])
    ref_rel = jeng.audio_to_video(os.path.join(root, "audio", "clip.wav"))
    got_rel = eng.audio_to_video("audio/clip.wav", draws=draws)
    assert got_rel.startswith("video/") and got_rel.endswith(".avi")
    with open(os.path.join(root, ref_rel), "rb") as f:
        ref = f.read()
    with open(os.path.join(root, got_rel), "rb") as f:
        got = f.read()
    info = pvideo.read_avi_info(os.path.join(root, got_rel))
    assert info == jvideo.read_avi_info(os.path.join(root, ref_rel))
    assert (info["n_frames"], info["fps"], info["n_streams"],
            info["width"]) == (eng.cfg.video_len(mel.shape[0]), 25, 2, SIZE)
    assert _chunks(got, b"01wb") == _chunks(ref, b"01wb")
    # the frames the two engines encoded, from the replayed landmarks
    lm = eng.landmarks(mel, draws)
    render_close(jeng.warper.render(jeng.portrait, lm),
                 eng.warper.render(eng.portrait, lm))


def test_relative_path_is_read_under_the_media_root(engines, tmp_path,
                                                    monkeypatch):
    """A relative path that exists in the working directory but not under
    the media root is not read (the JAX engine reads it)."""
    _, eng, root = engines
    monkeypatch.chdir(tmp_path)
    os.makedirs("audio", exist_ok=True)
    save_wav(np.zeros(4000, np.float32), "audio/only_here.wav", 16000)
    with pytest.raises(FileNotFoundError):
        eng("audio/only_here.wav")
    assert not os.path.exists(os.path.join(root, "audio", "only_here.wav"))


@pytest.mark.parametrize("how", ["absolute", "dotdot"])
def test_path_outside_the_media_root_is_refused(engines, tmp_path, how):
    """A wav that exists outside the media root, named by its absolute path
    or through ``..``, is not read (the JAX engine takes an absolute path
    as given and does not check a ``..`` one)."""
    _, eng, root = engines
    outside = tmp_path / "outside.wav"
    save_wav(np.zeros(4000, np.float32), str(outside), 16000)
    name = {"absolute": str(outside),
            "dotdot": os.path.relpath(outside, root)}[how]
    assert how != "dotdot" or name.startswith("..")
    with pytest.raises(ValueError, match="outside the media root"):
        eng(name)
