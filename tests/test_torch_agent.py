"""Port agent (``audiogpt_tpu_torch/agent``): the ReAct loop, history, the
speech loop and media paths with ``ScriptedLLM`` (the engine-agnostic cases
of ``tests/test_agent.py``), the default toolset over stub engines against
the JAX ``build_toolset`` (``tests/test_toolset.py``'s cases, with every
engine key), and ``merge_audio`` across two sample rates against the JAX
``merge_audio``. ``OpenAICompatLLM`` is never called: it needs an
endpoint."""

import types

import numpy as np
import pytest
import torch

from audiogpt_tpu.agent.tools import merge_audio as jax_merge_audio
from audiogpt_tpu.agent.toolset import build_toolset as jax_build_toolset
from audiogpt_tpu_torch.agent import (ConversationAgent, ScriptedLLM, Tool,
                                      ToolRegistry)
from audiogpt_tpu_torch.agent.agent import cut_dialogue_history
from audiogpt_tpu_torch.agent.llm import LLMUnavailable
from audiogpt_tpu_torch.agent.tools import (TOOL_STATS, merge_audio,
                                            new_media_path)
from audiogpt_tpu_torch.agent.toolset import build_toolset
from audiogpt_tpu_torch.utils.audio_io import load_wav, save_wav

torch.set_num_threads(2)

T2A_NAME = "Generate Audio From User Input Text"


def _tools():
    calls = []

    def t2a(text):
        calls.append(("t2a", text))
        return "audio/deadbeef.wav"

    def asr(path):
        calls.append(("asr", path))
        return "hello there"

    reg = ToolRegistry([
        Tool(T2A_NAME, "Input: a text description. Output: generated audio "
                       "file path.", t2a),
        Tool("Transcribe Speech", "Input: an audio path. Output: the text.",
             asr, media_kind="text"),
    ])
    return reg, calls


def _act(tool, arg):
    return (f"Thought: Do I need to use a tool? Yes\nAction: {tool}\n"
            f"Action Input: {arg}")


def _answer(text):
    return f"Thought: Do I need to use a tool? No\nAI: {text}"


# -- the ReAct loop ---------------------------------------------------------

def test_tool_call_then_answer():
    reg, calls = _tools()
    llm = ScriptedLLM([_act(T2A_NAME, "a dog barking"),
                       _answer("Generated audio/deadbeef.wav for you.")])
    agent = ConversationAgent(llm, reg)
    result = agent.run_text("make me a dog bark sound")
    assert calls == [("t2a", "a dog barking")]
    assert result.steps[0][0] == T2A_NAME
    assert result.steps[0][2] == "audio/deadbeef.wav"
    assert result.last_file == "audio/deadbeef.wav"
    assert "audio/deadbeef.wav" in result.response
    # the observation is fed back into the next prompt
    assert "Observation: audio/deadbeef.wav" in llm.prompts[1]


@pytest.mark.parametrize("script,response", [
    ([_answer("Just chatting!")], "Just chatting!"),
    # an unknown tool falls through to the final-answer path
    ([_act("Nonexistent Tool", "x")], None),
])
def test_turn_without_a_tool_call(script, response):
    reg, calls = _tools()
    agent = ConversationAgent(ScriptedLLM(script), reg)
    result = agent.run_text("hi")
    assert calls == [] and result.steps == []
    if response is not None:
        assert result.response == response
    assert "Human: hi" in agent.history


def test_tool_error_becomes_observation():
    def boom(_):
        raise RuntimeError("kaput")

    reg = ToolRegistry([Tool("Boom", "explodes", boom)])
    llm = ScriptedLLM([_act("Boom", "x"), _answer("tool failed.")])
    result = ConversationAgent(llm, reg).run_text("go")
    assert "Tool error: kaput" in result.steps[0][2]


def test_step_limit():
    reg, _ = _tools()
    agent = ConversationAgent(ScriptedLLM([_act(T2A_NAME, "x")] * 99), reg,
                              max_steps=3)
    result = agent.run_text("loop forever")
    assert len(result.steps) == 3
    assert result.response == "I could not finish within the step limit."


def test_unavailable_llm_becomes_chat_visible_message(tmp_path):
    class DownLLM:
        def complete(self, prompt, stop=None):
            raise LLMUnavailable("endpoint unreachable")

    agent = ConversationAgent(DownLLM(), build_toolset({}, root=str(tmp_path)))
    result = agent.run_text("hello")
    assert "unavailable" in result.response
    assert agent.history == ""  # turn not recorded: it can be retried


@pytest.mark.parametrize("history,keep,words", [
    ("\n".join(f"line {i} with some words here" for i in range(200)), 50, 56),
    ("short", 500, 1),
])
def test_history_truncation(history, keep, words):
    out = cut_dialogue_history(history, keep_last_n_words=keep)
    assert len(out.split()) <= words
    assert out.split("\n")[-1] == history.split("\n")[-1]
    if len(history.split()) < keep:
        assert out == history


def test_speech_loop_merges_speech_and_generated_audio(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    reg, _ = _tools()
    gen_path = new_media_path("audio")
    save_wav(np.zeros(1600, np.float32), gen_path, 16000)
    reg.get(T2A_NAME).fn = lambda t: gen_path
    llm = ScriptedLLM([_act(T2A_NAME, "a bark"), _answer("Done, see audio.")])
    speech_path = new_media_path("audio")
    save_wav(np.ones(800, np.float32) * 0.1, speech_path, 16000)
    resp, out = ConversationAgent(llm, reg).speech(
        "in.wav", lambda p: "make a bark", lambda t: speech_path,
        merge=lambda a, b: merge_audio(a, b, device="cpu"))
    assert resp == "Done, see audio."
    wav, sr = load_wav(out)
    assert sr == 16000 and len(wav) == 800 + 1600


def test_new_media_path_convention(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    p = new_media_path("audio")
    assert p.startswith("audio/") and p.endswith(".wav")
    assert len(p.split("/")[1].split(".")[0]) == 8


def test_tool_meters_rtf_of_its_audio(tmp_path):
    out = str(tmp_path / "a.wav")
    save_wav(np.zeros(8000, np.float32), out, 16000)
    tool = Tool("RTF probe", "writes half a second", lambda t: out,
                media_root=str(tmp_path))
    TOOL_STATS.pop(tool.name, None)
    tool("x")
    meter = TOOL_STATS[tool.name]
    assert meter.calls == 1 and meter.audio == 0.5 and meter.wall > 0


# -- merge_audio against JAX --------------------------------------------------

def test_merge_audio_across_rates_matches_jax(tmp_path):
    """A 22.05 kHz reply merged with a 16 kHz clip: both packages resample
    the first to the second's rate (their resamplers agree within 1.7e-6)
    and write int16, so the files agree within one int16 step."""
    rs = np.random.RandomState(30)
    a, b = str(tmp_path / "reply.wav"), str(tmp_path / "clip.wav")
    save_wav(0.3 * rs.randn(11025).astype(np.float32), a, 22050)
    save_wav(0.3 * rs.randn(4000).astype(np.float32), b, 16000)
    got, sr = load_wav(merge_audio(a, b, root=str(tmp_path / "port"),
                                   device="cpu"))
    ref, ref_sr = load_wav(jax_merge_audio(a, b, root=str(tmp_path / "jax")))
    assert sr == ref_sr == 16000 and got.shape == ref.shape == (8000 + 4000,)
    np.testing.assert_allclose(got, ref, atol=1.5 / 32768, rtol=0)


# -- the toolset over stub engines ------------------------------------------

SR = 16000


def _wav(n=SR // 2):
    return (0.1 * np.sin(np.arange(n) / 7.0)).astype(np.float32)


def stub_engines():
    """Every engine key of the toolset, duck-typed, on the CPU."""
    ns = types.SimpleNamespace
    cfg = ns(sample_rate=SR, hop=256, inpaint_mel_len=64)

    def plot(wav, out):
        with open(out, "wb") as f:
            f.write(b"\x89PNG")
        return out

    def inpaint(wav, mask):
        # the tool's time mask: 1 = keep, 0.1-0.3 s regenerated
        assert mask.shape == (64,) and mask[6:18].max() == 0 == mask.sum() - 52
        return wav

    return {
        "t2a": ns(device="cpu", cfg=cfg, inpaint=inpaint,
                  txt2audio_best=lambda text: (None, _wav(), None)),
        "tts": _Callable(_wav(), 22050),
        "tts_ood": ns(device="cpu", sample_rate=SR,
                      synthesize=lambda text, ref: ref[: SR // 4]),
        "svs": ns(device="cpu", sample_rate=SR,
                  synthesize=lambda text, notes, durs: _wav(len(text) * 10)),
        "i2a": lambda path: (_wav(), SR),
        "asr": ns(device="cpu", transcribe=lambda wav: f"{len(wav)} samples"),
        "caption": ns(device="cpu", sr=SR,
                      caption=lambda wav: f"a clip of {len(wav)}"),
        "sed": ns(device="cpu", cfg=cfg, plot=plot),
        "tsd": ns(device="cpu", mel=ns(sr=SR),
                  detect=lambda wav, text: [(0.1, 0.25)] if "siren" in text
                  else []),
        "extraction": ns(device="cpu", sr=SR, extract=lambda wav, t: wav / 2),
        "enhance": ns(device="cpu", cfg=cfg, enhance=lambda wav: wav / 2),
        "separate": ns(device="cpu", cfg=cfg,
                       separate=lambda wav: [wav / 2, wav / 4]),
        "binaural": ns(device="cpu", cfg=cfg,
                       binauralize=lambda wav: np.stack([wav, -wav])),
        "t2i": lambda text: "image/00000000.png",
        "i2t": lambda path: "a photo",
        "geneface": lambda path: "video/00000000.mp4",
    }


class _Callable:
    """A TTS engine's surface: ``engine(text)`` → wav at ``sample_rate``."""

    def __init__(self, wav, sample_rate):
        self.wav, self.sample_rate, self.device = wav, sample_rate, "cpu"

    def __call__(self, text):
        return self.wav


@pytest.mark.parametrize("mode", ["text", "speech"])
def test_toolset_names_match_jax(tmp_path, mode):
    """The same tools, in the same order, as the JAX ``build_toolset`` on
    the same engines; and only the tools whose engine key is present."""
    engines = stub_engines()
    names = build_toolset(engines, root=str(tmp_path), mode=mode).names()
    assert names == jax_build_toolset(engines, root=str(tmp_path),
                                      mode=mode).names()
    assert len(names) == {"text": 17, "speech": 9}[mode]
    few = build_toolset({"tts": engines["tts"], "asr": engines["asr"]},
                        root=str(tmp_path), mode="text").names()
    assert few == ["Synthesize Speech Given the User Input Text",
                   "Transcribe Speech"]


@pytest.mark.parametrize("tool,arg,check", [
    (T2A_NAME, "a dog barks", "wav:16000"),
    ("Synthesize Speech Given the User Input Text", "hello", "wav:22050"),
    ("Style Transfer", "{src}, hello", "wav:16000"),
    ("Generate Singing Voice From User Input Text, Note and Duration "
     "Sequence", "", "wav:16000"),               # the default song
    ("Generate Audio From The Image", "image/cat.png", "wav:16000"),
    ("Audio Inpainting", "{src}, 0.1, 0.3", "wav:16000"),
    ("Transcribe Speech", "{src}", "8000 samples"),
    ("Generate Text From The Audio", "{src}", "a clip of 8000"),
    ("Detect The Sound Event From The Audio", "{src}", "png"),
    ("Target Sound Detection", "{src}, a siren", "(0.10s, 0.25s)"),
    ("Target Sound Detection", "{src}, a bell",
     "no occurrence of 'a bell' detected"),
    ("Extract Sound Event From Mixture Audio Based On Language "
     "Description", "{src}, a dog", "wav:16000"),
    ("Speech Enhancement In Single-Channel", "{src}", "wav:16000"),
    ("Speech Separation In Single-Channel", "{src}", "wav:16000"),
    ("Sythesize Binaural Audio From A Mono Audio Input", "{src}", "wav:16000"),
    ("Get Photo Description", "image/cat.png", "a photo"),
])
def test_tool_roundtrip(tmp_path, tool, arg, check):
    """String in, string out: media tools save a wav or an image under the
    media root, text tools answer in text."""
    src = str(tmp_path / "in.wav")
    save_wav(_wav(), src, SR)
    reg = build_toolset(stub_engines(), root=str(tmp_path), mode="text")
    out = reg.get(tool)(arg.format(src=src))
    if check.startswith("wav:"):
        assert out.startswith(str(tmp_path)) and out.endswith(".wav")
        wav, sr = load_wav(out)
        assert sr == int(check[4:]) and len(wav) > 0
        if tool == "Speech Separation In Single-Channel":
            assert len(wav) == 2 * len(_wav())   # the two stems merged
    elif check == "png":
        assert out.endswith(".png") and reg.get(tool).media_kind == "image"
    else:
        assert out == check
