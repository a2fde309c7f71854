"""The port stands alone: importing every module of ``audiogpt_tpu_torch``
loads neither JAX nor any module of the JAX package, and its entry points
refuse to run without CUDA unless the caller asks for the CPU."""

import ast
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from audiogpt_tpu_torch.agent.tools import merge_audio
from audiogpt_tpu_torch.engines import (
    ASREngine,
    BinauralEngine,
    CaptionEngine,
    ExtractionEngine,
    GeneFaceEngine,
    I2AEngine,
    ImageCaptionEngine,
    PortaSpeechTTSEngine,
    SEDEngine,
    SeparationEngine,
    StyleTransferEngine,
    SVSEngine,
    T2AEngine,
    T2IEngine,
    TSDEngine,
    TTSEngine,
    VISingerEngine,
    VocoderEngine,
    resolve_device,
)
from audiogpt_tpu_torch.models.textenc import CLAPScorer
from audiogpt_tpu_torch.serving.inpaint import compute_mel
from audiogpt_tpu_torch.utils.audio_io import save_wav

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import audiogpt_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "audiogpt_tpu"))
print(json.dumps({"modules": names, "bad": bad,
                  "regex": "regex" in sys.modules,
                  "images": sorted(m for m in ("PIL", "matplotlib")
                                   if m in sys.modules)}))
"""


def test_import_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "audiogpt_tpu_torch.engines.t2a" in result["modules"]
    assert "audiogpt_tpu_torch.ops.flash_attention" in result["modules"]
    assert "audiogpt_tpu_torch.dsp.mel" in result["modules"]
    assert "audiogpt_tpu_torch.models.caption.cnn14" in result["modules"]
    for name in ("models.asr.whisper", "engines.asr", "text.bpe",
                 "dsp.resample", "utils.audio_io", "serving.batcher",
                 "text.encoder", "text.norm_en", "text.en_g2p",
                 "text.frontend", "models.tts.fastspeech2",
                 "models.vocoder.hifigan", "models.vocoder.pwg",
                 "engines.tts", "utils.profiling", "agent.tools",
                 "agent.llm", "agent.agent", "agent.toolset",
                 "serving.inpaint", "serving.server",
                 "models.textenc.clip", "engines.i2a", "app", "serve",
                 "engines.t2i", "engines.analysis", "models.caption.blip",
                 "ops.rnn", "models.caption.captioner",
                 "models.sed.panns_sed", "models.sed.pvt", "models.sed.tsd",
                 "models.extraction.lassnet",
                 "models.separation.convtasnet", "models.separation.skim",
                 "models.binaural.binaural", "engines.transform",
                 "text.zh", "dsp.f0", "models.svs.diffsinger",
                 "models.svs.visinger", "models.tts.pitch_extractor",
                 "models.tts.generspeech", "engines.svs",
                 "engines.tts_ood", "utils.video_io",
                 "models.face.renderer", "models.face.audio2motion",
                 "engines.face", "models.textenc.htsat", "text.syntax",
                 "ops.rel_attention", "models.tts.portaspeech",
                 "utils.media", "config", "data.records", "data.loader",
                 "data.binarizer", "train.optim", "train.checkpoint",
                 "train.metrics", "train.trainer", "train.tasks.ldm",
                 "train_cli", "data.batching", "data.textgrid",
                 "data.wav_processors", "train.losses", "train.ssim",
                 "train.stft_loss", "train.tasks.fs2",
                 "train.tasks.vocoder_gan", "models.vocoder.discriminators",
                 "train.tasks.portaspeech", "train.tasks.tts_adv",
                 "train.tasks.generspeech", "train.tasks.pe",
                 "train.tasks.diffusion", "train.tasks.visinger",
                 "train.tasks.audio2motion", "train.tasks.vae",
                 "train.tasks.clap", "train.tasks.sed",
                 "train.tasks.caption", "train.tasks.separation",
                 "utils.torch_import", "import_ckpt", "infer_cli",
                 "models.textenc.gpt2", "models.textenc.t5",
                 "text.sentencepiece", "utils.flops", "dsp.dtw",
                 "registry"):
        assert f"audiogpt_tpu_torch.{name}" in result["modules"]
    assert result["bad"] == []
    # the BPE word splitters use the standard library's re: the card's
    # machine has no third-party regex package
    assert not result["regex"]
    # the image helpers import PIL and matplotlib only when called: the
    # card's machine may lack them
    assert result["images"] == []


def test_entry_points_need_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T2AEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        VocoderEngine("bigvgan")
    with pytest.raises(RuntimeError, match="CUDA"):
        VocoderEngine("bigvgan", bf16=True)
    for tower in ("pann", "htsat"):
        with pytest.raises(RuntimeError, match="CUDA"):
            CLAPScorer(audio_tower=tower)
    with pytest.raises(RuntimeError, match="CUDA"):
        ASREngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        ASREngine(bf16=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTSEngine()
    for kind in ("hifigan", "pwg", "melgan"):
        with pytest.raises(RuntimeError, match="CUDA"):
            VocoderEngine(kind)
    with pytest.raises(RuntimeError, match="CUDA"):
        I2AEngine(types.SimpleNamespace(device=torch.device("cpu")))
    with pytest.raises(RuntimeError, match="CUDA"):
        T2IEngine(tokenizer=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ImageCaptionEngine()
    for engine in (CaptionEngine, SEDEngine, TSDEngine, ExtractionEngine,
                   SeparationEngine, BinauralEngine, SVSEngine,
                   VISingerEngine, StyleTransferEngine, GeneFaceEngine,
                   PortaSpeechTTSEngine):
        with pytest.raises(RuntimeError, match="CUDA"):
            engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_mel(np.zeros(256, np.float32), types.SimpleNamespace(
            inpaint_mel_len=1, hop=256, sample_rate=16000, mel_bins=80))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from audiogpt_tpu_torch.data import (EmotionBinarizer, SVSBinarizer,
                                         TTSBinarizer, ZhBinarizer)
    from audiogpt_tpu_torch.data.wav_processors import apply_processors
    from audiogpt_tpu_torch.train import Trainer
    from audiogpt_tpu_torch.train import tasks

    for task in ("LDMTask", "FS2Task", "VocoderGANTask", "PortaSpeechTask",
                 "PortaSpeechAdvTask", "AdvTTSTask", "GenerSpeechTask",
                 "PETask", "DiffSingerTask", "VISingerTask",
                 "Audio2MotionTask", "VAETask", "CLAPTask", "SEDTask",
                 "CaptionTask", "SeparationTask"):
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(tasks, task)(getattr(tasks, task + "Config")())
    for binarizer in (TTSBinarizer, EmotionBinarizer, SVSBinarizer,
                      ZhBinarizer):
        with pytest.raises(RuntimeError, match="CUDA"):
            binarizer()
    with pytest.raises(RuntimeError, match="CUDA"):
        apply_processors(["resample"], np.zeros(441, np.float32), 44100)
    from audiogpt_tpu_torch.models.textenc.gpt2 import (GPT2Config,
                                                        MagicPromptRefiner)

    with pytest.raises(RuntimeError, match="CUDA"):
        MagicPromptRefiner(GPT2Config(vocab_size=8, n_positions=4, width=8,
                                      layers=1, heads=1))
    from audiogpt_tpu_torch.models.textenc.t5 import T5Conditioner, T5Config

    with pytest.raises(RuntimeError, match="CUDA"):
        T5Conditioner(T5Config(vocab_size=8, d_model=8, d_kv=4, d_ff=8,
                               num_layers=1, num_heads=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        from audiogpt_tpu_torch import infer_cli

        infer_cli.main(["--engine", "enhance", "--in", "x.wav"])
    toy = types.SimpleNamespace(modules={}, loss_fns={}, optim_cfgs={})
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(toy)


def test_merge_across_rates_needs_cuda_without_device(tmp_path, monkeypatch):
    """``merge_audio`` resamples on the card unless the caller asks for the
    CPU; two files at one rate need no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b, c = (str(tmp_path / n) for n in ("a.wav", "b.wav", "c.wav"))
    save_wav(np.zeros(800, np.float32), a, 22050)
    save_wav(np.zeros(800, np.float32), b, 16000)
    save_wav(np.zeros(800, np.float32), c, 16000)
    with pytest.raises(RuntimeError, match="CUDA"):
        merge_audio(a, b, root=str(tmp_path))
    assert merge_audio(c, b, root=str(tmp_path)).endswith(".wav")


def _code_strings(tree):
    """The string constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            docs.add(id(node.body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_port_code_names_the_jax_package():
    """No port module, not ``chip_smoke.py`` and not ``mesh_scaling.py``
    names the JAX package in its code (an import by string, a path under
    ``audiogpt_tpu/``): its docstrings may cite the JAX counterpart."""
    files = sorted((REPO / "audiogpt_tpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py", REPO / "mesh_scaling.py"]
    bad = []
    for path in files:
        for text in _code_strings(ast.parse(path.read_text())):
            if re.search(r"\baudiogpt_tpu\b(?!_torch)", text) \
                    and not re.search(r"audiogpt_tpu/[\w/]+\.py:\d", text):
                bad.append((path.name, text[:60]))
    assert bad == []


def test_audioset_labels_read_the_ports_own_copy(monkeypatch):
    from audiogpt_tpu_torch.models.sed import panns_sed

    opened = []
    real_open = open

    def recording_open(path, *args, **kw):
        opened.append(str(path))
        return real_open(path, *args, **kw)

    monkeypatch.setattr("builtins.open", recording_open)
    panns_sed.audioset_labels.cache_clear()
    try:
        labels = panns_sed.audioset_labels()
    finally:
        panns_sed.audioset_labels.cache_clear()
    assert len(labels) == 527 and labels[0] == "Speech"
    assert opened == [str(REPO / "audiogpt_tpu_torch" / "data"
                          / "audioset_labels.csv")]
