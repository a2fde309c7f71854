"""The port's checkpoint and vocab flags and its inference CLI on the CPU:
``app.load_engine_ckpts`` with a tree that ``import_ckpt`` wrote and with a
trainer checkpoint (``<work_dir>/ckpt/<step>.pt``) reaches the engine,
whose output then equals the JAX engine's on the same tree, and a
``clip_vision`` import tree reaches the I2A engine's vision tower;
``load_engine_vocabs`` reaches the engine and its CLAP scorer; an engine
that is not enabled is a ``SystemExit``; ``infer_cli --device cpu`` writes
the wav of ``tts`` and ``enhance`` (with ``--params``) and exits 2 for an
engine without a mapping. The engines are tiny (the app's factories are
replaced by tiny ones on the requested device)."""

import functools

import jax
import numpy as np
import pytest
import torch

from audiogpt_tpu.engines.transform import \
    SeparationEngine as JaxSeparationEngine
from audiogpt_tpu.models.separation.convtasnet import ConvTasNet
from audiogpt_tpu.models.separation.convtasnet import \
    ConvTasNetConfig as JaxConvTasNetConfig
from audiogpt_tpu_torch import app, infer_cli
from audiogpt_tpu_torch.engines.transform import SeparationEngine
from audiogpt_tpu_torch.import_ckpt import restore_weights, save_params
from audiogpt_tpu_torch.models.separation import ConvTasNetConfig
from audiogpt_tpu_torch.train import Trainer, TrainerConfig
from audiogpt_tpu_torch.train.tasks import (SeparationTask,
                                            SeparationTaskConfig)
from audiogpt_tpu_torch.utils.audio_io import load_wav, save_wav
from test_torch_cnn14 import random_variables

torch.set_num_threads(2)

TASNET = dict(n_src=1, enc_dim=32, bottleneck=8, hidden=16, skip=8,
              n_blocks=2, n_repeats=1)
SR = 16000


def _wav(n=8000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * 330 * t)
            + 0.1 * rng.normal(size=n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def reference():
    """A seeded Conv-TasNet tree, the JAX enhancer on it (its compiled
    program serves every clip of one length) and its output."""
    cfg = JaxConvTasNetConfig(**TASNET)
    shapes = jax.eval_shape(lambda: ConvTasNet(cfg).init(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, SR))))
    tree = jax.tree.map(np.asarray, random_variables(shapes, seed=41))
    # given its params, the engine compiles no init
    jeng = JaxSeparationEngine(cfg, params=tree)
    return tree, np.asarray(jeng.separate(_wav())), jeng


def tiny_enhancer(device=None):
    return SeparationEngine(ConvTasNetConfig(**TASNET), rng_seed=7,
                            device=device)


def test_ckpt_tree_reaches_the_engine_and_matches_jax(tmp_path):
    """``--ckpt enhance=DIR`` (the tree ``import_ckpt`` writes): the
    engine's enhanced wav equals the JAX engine's on the same tree."""
    tree, want, _ = reference()
    save_params(tree, str(tmp_path / "tasnet"))
    eng = tiny_enhancer("cpu")
    before = eng.separate(_wav())
    app.load_engine_ckpts({"enhance": eng}, [f"enhance={tmp_path}/tasnet"])
    got = eng.separate(_wav())
    assert np.abs(before - want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_ckpt_trainer_checkpoint_reaches_the_engine(tmp_path):
    """A trainer checkpoint of the ``separation`` recipe on the same tree
    (``Trainer.save`` → ``ckpt/0.pt``) loads through the same flag and
    gives the same wav; weights that do not fit the engine raise."""
    tree, want, _ = reference()
    task = SeparationTask(SeparationTaskConfig(
        model=ConvTasNetConfig(**TASNET)), params={"model": tree},
        device="cpu")
    trainer = Trainer(task, TrainerConfig(work_dir=str(tmp_path),
                                          use_tensorboard=False),
                      device="cpu")
    trainer.save()
    path = str(tmp_path / "ckpt" / "0.pt")
    eng = tiny_enhancer("cpu")
    app.load_engine_ckpts({"enhance": eng}, [f"enhance={path}"])
    np.testing.assert_allclose(eng.separate(_wav()), want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    two = SeparationEngine(ConvTasNetConfig(**{**TASNET, "n_src": 2}),
                           device="cpu")
    with pytest.raises(Exception):
        two.load_params(restore_weights(path))


def test_disabled_engines_are_a_system_exit(tmp_path):
    with pytest.raises(SystemExit, match="not enabled"):
        app.load_engine_ckpts({}, [f"tts={tmp_path}"])
    with pytest.raises(SystemExit, match="not enabled"):
        app.load_engine_vocabs({}, [f"t2a={tmp_path}/vocab.txt"])
    with pytest.raises(SystemExit, match="takes no vocab"):
        app.load_engine_vocabs({"enhance": tiny_enhancer("cpu")},
                               [f"enhance={tmp_path}/vocab.txt"])


def tiny_t2a(with_scorer=False):
    from audiogpt_tpu_torch.engines.t2a import T2AConfig, T2AEngine
    from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config
    from audiogpt_tpu_torch.models.diffusion import UNetConfig, VAEConfig
    from audiogpt_tpu_torch.models.textenc.bert import BertConfig
    from audiogpt_tpu_torch.models.textenc.clap import (CLAPScorer,
                                                        CLAPTextConfig)

    bert = BertConfig(vocab_size=100, hidden_size=16, num_layers=1,
                      num_heads=2, intermediate_size=32)
    text = CLAPTextConfig(bert=bert, d_proj=32)
    scorer = CLAPScorer(text, audio_cfg=Cnn14Config(
        channels=(4, 4, 8, 8, 16, 16)), sample_rate=16000,
        device="cpu") if with_scorer else None
    return T2AEngine(T2AConfig(
        unet=UNetConfig(model_channels=32, num_res_blocks=1,
                        channel_mult=(1, 2), num_heads=4, context_dim=32),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=()), clap=text),
        scorer=scorer, device="cpu")


def test_vocab_reaches_the_engine_and_its_clap_scorer(tmp_path):
    """``--vocab t2a=vocab.txt``: a WordPiece tokenizer of that file on the
    engine and the same object on its CLAP scorer."""
    from audiogpt_tpu_torch.models.textenc.clap import WordPieceTokenizer

    eng = tiny_t2a(with_scorer=True)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a",
                                "dog", "barks", "##s"]) + "\n")
    app.load_engine_vocabs({"t2a": eng}, [f"t2a={vocab}"])
    assert isinstance(eng.tokenizer, WordPieceTokenizer)
    assert eng.scorer.tokenizer is eng.tokenizer
    ids, _ = eng.tokenizer.encode("a dog barks", 8)
    assert list(ids[:5]) == [2, 4, 5, 6, 3]


def test_ckpt_clip_vision_import_reaches_the_i2a_engine(tmp_path):
    """``--ckpt i2a=DIR`` with the tree of ``import_ckpt --family
    clip_vision`` loads the I2A engine's vision tower; a CLIP text tower's
    tree does not fit it and raises."""
    from audiogpt_tpu_torch.engines.i2a import I2AEngine
    from audiogpt_tpu_torch.import_ckpt import convert
    from test_torch_import_ckpt import FAMILIES, reference_state_dict

    vision_cfg, text_cfg = (FAMILIES[f][0] for f in ("clip_vision",
                                                      "clip_text_tower"))
    eng = I2AEngine(tiny_t2a(), vision_cfg=vision_cfg, text_cfg=text_cfg,
                    device="cpu")
    eng.uncond  # noqa: B018 -- cached; a load drops it
    module, sd = reference_state_dict("clip_vision")
    save_params(convert("clip_vision", sd, vision_cfg),
                str(tmp_path / "vision"))
    app.load_engine_ckpts({"i2a": eng}, [f"i2a={tmp_path}/vision"])
    assert eng._uncond is None
    got = eng.vision.state_dict()
    for key, want in module.state_dict().items():
        torch.testing.assert_close(got[key], want, rtol=0, atol=0, msg=key)
    _, sd = reference_state_dict("clip_text_tower")
    save_params(convert("clip_text_tower", sd, text_cfg),
                str(tmp_path / "text"))
    with pytest.raises(RuntimeError, match="CLIPVisionEncoder"):
        app.load_engine_ckpts({"i2a": eng}, [f"i2a={tmp_path}/text"])


@pytest.fixture()
def tiny_factories(monkeypatch):
    """The app's ``tts``, ``enhance`` and ``sed`` factories at tiny sizes;
    the TTS durations ≈ 4 frames a phone."""
    from audiogpt_tpu_torch.engines.analysis import SEDEngine
    from audiogpt_tpu_torch.engines.tts import TTSEngine
    from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
    from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config
    from audiogpt_tpu_torch.models.sed.panns_sed import SEDConfig
    from audiogpt_tpu_torch.models.tts.fastspeech2 import FastSpeech2Config
    from audiogpt_tpu_torch.models.vocoder import HifiGANConfig
    from audiogpt_tpu_torch.text import default_arpabet_vocab

    def tts(device=None):
        voc = VocoderEngine("hifigan", HifiGANConfig(
            upsample_initial_channel=16, upsample_rates=(4, 4),
            upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),)), buckets=(128, 512),
            device=device)
        eng = TTSEngine(FastSpeech2Config(
            vocab_size=len(default_arpabet_vocab()) + 3, hidden_size=16,
            enc_layers=1, dec_layers=1, predictor_layers=2, max_frames=512),
            vocoder=voc, token_buckets=(64,), device=device)
        with torch.no_grad():
            eng.model.dur_predictor.out.weight.mul_(1e-3)
            eng.model.dur_predictor.out.bias.fill_(float(np.log(5.0)))
        return eng

    monkeypatch.setitem(app._FACTORIES, "tts", tts)
    monkeypatch.setitem(app._FACTORIES, "enhance", tiny_enhancer)
    monkeypatch.setitem(app._FACTORIES, "sed", lambda device=None: SEDEngine(
        SEDConfig(cnn14=Cnn14Config(channels=(4, 4, 8, 8, 16, 16))),
        max_sec=4.0, device=device))


def test_infer_cli_writes_tts_and_enhance_wavs(tiny_factories, tmp_path,
                                               capsys):
    """``--engine tts --text`` writes a wav at the engine's rate; ``--engine
    enhance --in --params`` writes the enhanced wav that the JAX engine
    gives on the tree; an engine without a mapping exits 2."""
    out = str(tmp_path / "speech.wav")
    assert infer_cli.main(["--engine", "tts", "--text", "hello world",
                           "--out", out, "--device", "cpu"]) == 0
    wav, sr = load_wav(out)
    assert sr == 22050 and wav.size > 16 * 8 and np.isfinite(wav).all()
    tree, _, jeng = reference()
    save_params(tree, str(tmp_path / "tasnet"))
    noisy, clean = str(tmp_path / "noisy.wav"), str(tmp_path / "clean.wav")
    save_wav(_wav(), noisy, SR)
    assert infer_cli.main(["--engine", "enhance", "--in", noisy, "--out",
                           clean, "--params", str(tmp_path / "tasnet"),
                           "--device", "cpu"]) == 0
    got, sr = load_wav(clean)
    noisy_in, _ = load_wav(noisy)
    want16 = np.asarray(jeng.separate(noisy_in))[0]
    # the file holds int16 (× 32767, truncated; read back / 32768): the
    # frameworks' f32 difference may move a sample by one step
    want_q = np.trunc(np.clip(want16, -1, 1) * 32767) / 32768
    np.testing.assert_allclose(got, want_q, rtol=0, atol=1.0 / 32768)
    assert "wrote" in capsys.readouterr().out
    assert infer_cli.main(["--engine", "sed", "--in", noisy,
                           "--device", "cpu"]) == 2
    assert "no CLI mapping" in capsys.readouterr().err
