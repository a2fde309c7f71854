"""The port's FLOP accounting (``utils/flops.py``), DTW
(``dsp/dtw.py``) and registries (``registry.py``) against the JAX
package's on the CPU.

``hifigan_flops`` equals JAX's exactly (an integer count in floats);
``dtw`` gives JAX's path and, in float64, its costs within 1e-12
relative; ``mel_cepstral_distortion`` the same. The three registries that
JAX fills (engines, vocoders, text processors) hold JAX's names, and each
name maps to the port's class of the same name. The card's peaks live in
``utils/flops.py`` alone: no other file of the port, nor
``chip_smoke.py`` or ``train_flops.py``, holds one of their values."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from audiogpt_tpu.dsp import dtw as jdtw
from audiogpt_tpu.models.vocoder.hifigan import HifiGANConfig as JaxHifiCfg
from audiogpt_tpu.utils import flops as jflops
from audiogpt_tpu_torch.dsp import dtw as pdtw
from audiogpt_tpu_torch.models.vocoder.hifigan import HifiGANConfig
from audiogpt_tpu_torch.utils import flops

REPO = Path(__file__).resolve().parent.parent
ENGINE_MODULES = ("analysis", "asr", "face", "i2a", "svs", "t2a",
                  "transform", "tts", "tts_ood", "vocoder")


@pytest.mark.parametrize("kw", [
    {}, dict(resblock="2", resblock_kernel_sizes=(3, 5),
             resblock_dilation_sizes=((1, 2), (2, 6)),
             upsample_rates=(5, 4, 4), upsample_kernel_sizes=(10, 8, 8),
             upsample_initial_channel=128)], ids=["v1", "resblock2"])
def test_hifigan_flops_equal_jax(kw):
    for frames, batch in ((1, 1), (624, 3)):
        got = flops.hifigan_flops(HifiGANConfig(**kw), frames, batch)
        assert got == jflops.hifigan_flops(JaxHifiCfg(**kw), frames, batch)
        assert got > 0


def test_peaks_mfu_and_the_step_count(monkeypatch):
    """The trainer's rules: no peak on the CPU or an unknown card; bf16,
    else TF32 where matmuls or cuDNN may use it, else f32; ``mfu`` is
    FLOP/s over that peak and None without FLOPs or a peak;
    ``count_flops`` gives aten's count of a matmul (2·M·N·K)."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert flops.peak_flops(cpu, torch.float32) is None
    assert flops.mfu(1e12, 1.0, cpu) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert flops.peak_flops(cuda, torch.float32) == flops.F32_FLOPS
    assert flops.peak_flops(cuda, torch.bfloat16) == flops.BF16_FLOPS
    torch.backends.cudnn.allow_tf32 = True
    assert flops.peak_flops(cuda, torch.float32) == flops.TF32_FLOPS
    assert flops.mfu(flops.TF32_FLOPS, 2.0, cuda) == 0.5
    assert flops.mfu(0.0, 2.0, cuda) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Some Other Card")
    assert flops.peak_flops(cuda, torch.bfloat16) is None
    a, b = torch.ones(3, 4), torch.ones(4, 5)
    out, n = flops.count_flops(lambda: a @ b)
    assert n == 2 * 3 * 4 * 5 and out.shape == (3, 5)


def _literals(path: Path) -> set:
    return {node.value for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Constant)
            and isinstance(node.value, (int, float))}


def test_the_cards_peaks_live_in_utils_flops_alone():
    peaks = {flops.HBM_BYTES_PER_S, flops.BF16_FLOPS, flops.TF32_FLOPS,
             flops.F32_FLOPS}
    home = REPO / "audiogpt_tpu_torch" / "utils" / "flops.py"
    assert peaks <= _literals(home)
    files = sorted((REPO / "audiogpt_tpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py", REPO / "train_flops.py"]
    held = {str(p.relative_to(REPO)): sorted(peaks & _literals(p))
            for p in files if p != home}
    assert {k: v for k, v in held.items() if v} == {}


@pytest.mark.parametrize("case", ["equal", "unequal", "custom-dist"])
def test_dtw_equals_jax(case):
    rng = np.random.default_rng(["equal", "unequal", "custom-dist"]
                                .index(case))
    tx, ty = (12, 12) if case == "equal" else (9, 14)
    x = rng.normal(size=(tx, 5)).astype(np.float32)
    y = rng.normal(size=(ty, 5)).astype(np.float32)
    dist = (lambda a, b: float(np.abs(a - b).sum())) \
        if case == "custom-dist" else None
    cost, acc, path = pdtw.dtw(x, y, dist)
    jcost, jacc, jpath = jdtw.dtw(x, y, dist)
    np.testing.assert_array_equal(path, jpath)
    np.testing.assert_allclose(acc, jacc, rtol=1e-12, atol=0)
    np.testing.assert_allclose(cost, jcost, rtol=1e-12, atol=0)
    assert path[0].tolist() == [0, 0] and path[-1].tolist() == [tx - 1,
                                                               ty - 1]


def test_mel_cepstral_distortion_equals_jax():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(20, 8))
    b = np.concatenate([a[:5], a[5:] + 0.1 * rng.normal(size=(15, 8)),
                        a[-3:]])
    got = pdtw.mel_cepstral_distortion(a, b)
    np.testing.assert_allclose(got, jdtw.mel_cepstral_distortion(a, b),
                               rtol=1e-12)
    assert pdtw.mel_cepstral_distortion(a, a) == 0.0


@pytest.fixture(scope="module")
def registries():
    """(the port's registry module, JAX's), each filled by importing the
    modules that register into it."""
    regs = []
    for pkg in ("audiogpt_tpu_torch", "audiogpt_tpu"):
        for name in ENGINE_MODULES:
            importlib.import_module(f"{pkg}.engines.{name}")
        importlib.import_module(f"{pkg}.models.vocoder")
        importlib.import_module(f"{pkg}.text.frontend")
        regs.append(importlib.import_module(f"{pkg}.registry"))
    return regs


@pytest.mark.parametrize("name", ["ENGINES", "VOCODERS", "TEXT_PROCESSORS"])
def test_registry_names_equal_jax(registries, name):
    port, jax_reg = (getattr(r, name) for r in registries)
    assert port.names() == jax_reg.names()
    assert len(port.names()) == {"ENGINES": 17, "VOCODERS": 4,
                                 "TEXT_PROCESSORS": 1}[name]
    for key in port:
        cls = port.get(key)
        assert cls.__module__.startswith("audiogpt_tpu_torch.")
        assert cls.__name__ == jax_reg.get(key).__name__, key


def test_registry_class_behaves_as_jax_s(registries):
    """Names are case-folded; a second object under a taken name and an
    unknown name are ``KeyError``s; the other three registries are empty
    in both packages."""
    port, jax_reg = registries
    for mod in registries:
        reg = mod.Registry("thing")

        @reg.register("Foo")
        class Foo:
            pass

        assert reg.get("FOO") is Foo and "foo" in reg and list(reg) == ["foo"]
        reg.register("foo")(Foo)
        with pytest.raises(KeyError, match="already registered"):
            reg.register("foo")(object)
        with pytest.raises(KeyError, match="unknown thing 'bar'"):
            reg.get("bar")
        assert mod.Registry("x").register()(Foo) is Foo
    for name in ("MODELS", "TOOLS", "TASKS"):
        assert getattr(port, name).names() == getattr(jax_reg, name).names()
        assert getattr(port, name).kind == getattr(jax_reg, name).kind
