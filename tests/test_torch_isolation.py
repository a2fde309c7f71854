"""The port stands alone: importing every module of ``audiogpt_tpu_torch``
loads neither JAX nor any module of the JAX package, and its entry points
refuse to run without CUDA unless the caller asks for the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from audiogpt_tpu_torch.engines import (
    ASREngine,
    T2AEngine,
    TTSEngine,
    VocoderEngine,
    resolve_device,
)
from audiogpt_tpu_torch.models.textenc import CLAPScorer

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import audiogpt_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "audiogpt_tpu"))
print(json.dumps({"modules": names, "bad": bad,
                  "regex": "regex" in sys.modules}))
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
                 "engines.tts"):
        assert f"audiogpt_tpu_torch.{name}" in result["modules"]
    assert result["bad"] == []
    # the BPE word splitters use the standard library's re: the card's
    # machine has no third-party regex package
    assert not result["regex"]


def test_entry_points_need_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T2AEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        VocoderEngine("bigvgan")
    with pytest.raises(RuntimeError, match="CUDA"):
        VocoderEngine("bigvgan", bf16=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        CLAPScorer()
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
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
