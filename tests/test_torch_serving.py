"""Port serving (``audiogpt_tpu_torch/serving``) over HTTP on the CPU: the
engine-agnostic cases of ``tests/test_serving.py`` with stub engines and
``ScriptedLLM``; served agent turns through small port engines (T2A, I2A,
TTS, inpaint, the T2I → I2T image round trip, the seven audio analysis
and transform tools, SVS and Style Transfer) that must give what the
engine gives when called directly; the GeneFace tool's served video;
the reference defects the port does not copy (a negative ``chunk_phones``
is a 400; the speech loop merges the generated file from the media root;
a client's path cannot leave the media root); engine calls that run while
a turn waits on its LLM; and the sketch-mask helpers against the JAX
package's."""

import base64
import concurrent.futures
import http.client
import io
import json
import math
import os
import re
import struct
import threading
import types
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.io import wavfile

from audiogpt_tpu.serving import inpaint as jinpaint
from audiogpt_tpu_torch.agent import ScriptedLLM
from audiogpt_tpu_torch.app import build_engines, speech_callables
from audiogpt_tpu_torch.dsp.resample import output_length
from audiogpt_tpu_torch.engines import (I2AEngine, ImageCaptionEngine,
                                        T2AConfig, T2AEngine, T2IConfig,
                                        T2IEngine, TTSEngine, VocoderEngine)
from audiogpt_tpu_torch.models.caption import (BlipConfig, BlipTextConfig,
                                               BlipVisionConfig)
from audiogpt_tpu_torch.models.diffusion import UNetConfig, VAEConfig
from audiogpt_tpu_torch.models.textenc import BertConfig, CLAPTextConfig
from audiogpt_tpu_torch.models.textenc.clip import (CLIPTextConfig,
                                                    CLIPVisionConfig)
from audiogpt_tpu_torch.models.tts.fastspeech2 import FastSpeech2Config
from audiogpt_tpu_torch.models.vocoder import BigVGANConfig, HifiGANConfig
from audiogpt_tpu_torch.serving import AppServer, BatchedTTS, make_server
from audiogpt_tpu_torch.serving import inpaint as pinpaint
from audiogpt_tpu_torch.utils.audio_io import load_wav, save_wav
from test_torch_agent import _act, _answer, stub_engines
from test_torch_t2a import BERT, T2A, UNET, VAE, VOC

torch.set_num_threads(2)

ENHANCE = "Speech Enhancement In Single-Channel"
T2A_TOOL = "Generate Audio From User Input Text"
TTS_TOOL = "Synthesize Speech Given the User Input Text"
#: two int16 quantisations of one f32 wav: the file's and the reference's
LSB = 1.0 / 32767 + 1e-6


def _req(port, path, data=None, headers=None, method=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _post(port, path, obj):
    return _req(port, path, json.dumps(obj).encode(),
                {"Content-Type": "application/json"})


class Served:
    """An AppServer behind ``make_server`` on an OS-chosen port, served
    from a thread until ``close``."""

    def __init__(self, llm, engines, root, **kw):
        self.app = AppServer(llm, engines, media_root=str(root), **kw)
        self.httpd = make_server(self.app, port=0)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.app.close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("media")
    src = str(root / "noisy.wav")
    save_wav(0.2 * np.sin(np.arange(16000) / 7.0).astype(np.float32), src,
             16000)
    llm = ScriptedLLM([_act(ENHANCE, src), _answer("Enhanced audio ready."),
                       _answer("You are welcome!")])
    s = Served(llm, {"enhance": stub_engines()["enhance"]}, root,
               device="cpu")
    yield s, src
    s.close()


def test_health_and_ui(server):
    s, _ = server
    code, body, _ = _req(s.port, "/health")
    data = json.loads(body)
    assert code == 200 and data["status"] == "ok" and data["mode"] == "text"
    assert data["tools"] == [ENHANCE]
    code, body, headers = _req(s.port, "/")
    assert code == 200 and b"AudioGPT" in body
    assert "text/html" in headers["Content-Type"]


def test_chat_tool_turn_and_media(server):
    s, src = server
    code, body, _ = _post(s.port, "/chat", {"text": "enhance " + src})
    data = json.loads(body)
    assert code == 200 and data["response"] == "Enhanced audio ready."
    assert data["steps"][0]["tool"] == ENHANCE
    assert data["media"] and data["media"][0]["kind"] == "audio"
    code, wav, headers = _req(s.port, data["media"][0]["url"])
    assert code == 200 and headers["Content-Type"] == "audio/wav"
    assert len(wav) > 1000
    code, body, _ = _post(s.port, "/chat", {"text": "thanks"})
    data = json.loads(body)
    assert data["response"] == "You are welcome!" and not data["media"]
    # /stats: the tool's calls, wall time, audio seconds and RTF
    stats = json.loads(_req(s.port, "/stats")[1])[ENHANCE]
    assert stats["calls"] >= 1 and stats["wall_s"] > 0
    assert stats["audio_s"] > 0 and stats["rtf"] is not None


@pytest.mark.parametrize("method,path,body,code", [
    ("POST", "/chat", {}, 400),
    # ``..`` enough to reach / from any media root, and an absolute path
    pytest.param("GET", "/media/" + "../" * 40 + "etc/passwd", None, 404,
                 id="media-dotdot-to-root"),
    pytest.param("GET", "/media//etc/passwd", None, 404,
                 id="media-absolute"),
    ("GET", "/tts/stream?text=hi", None, 404),          # no tts engine
    ("POST", "/inpaint", {}, 400),
    ("POST", "/inpaint/show", {}, 400),
    ("POST", "/mode", {"mode": "bogus"}, 500),
    ("GET", "/nowhere", None, 404),
])
def test_error_answers(server, method, path, body, code):
    s, _ = server
    got, raw, _ = (_post(s.port, path, body) if method == "POST"
                   else _req(s.port, path))
    assert got == code and "error" in json.loads(raw)


def test_upload_and_clear(server):
    s, _ = server
    buf = io.BytesIO()
    wavfile.write(buf, 16000, np.zeros(16000, np.int16))
    code, body, _ = _req(s.port, "/upload", buf.getvalue(),
                         {"X-Filename": "clip.wav"})
    assert code == 200 and json.loads(body)["kind"] == "audio"
    assert "provide a new audio file" in s.app.agent.history
    code, _, _ = _req(s.port, "/clear", b"", method="POST")
    assert code == 200 and s.app.agent.history == ""


def test_mode_switch(server):
    s, _ = server
    code, body, _ = _post(s.port, "/mode", {"mode": "speech"})
    assert code == 200 and json.loads(body)["mode"] == "speech"
    # enhancement is a text-mode tool (audio-chatgpt.py:1153+)
    assert ENHANCE not in s.app.tools.names()
    _post(s.port, "/mode", {"mode": "text"})
    assert s.app.tools.names() == [ENHANCE]


def test_concurrent_chat_requests(tmp_path):
    """The threading server and the agent lock serialise turns without
    dropping or interleaving conversations."""
    llm = ScriptedLLM([_answer(f"answer-{i}") for i in range(8)])
    s = Served(llm, {}, tmp_path, device="cpu")
    try:
        def ask(i):
            code, body, _ = _post(s.port, "/chat", {"text": f"q{i}"})
            return code, json.loads(body)["response"]

        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            results = list(ex.map(ask, range(8)))
        assert all(code == 200 for code, _ in results)
        assert sorted(r for _, r in results) == [f"answer-{i}"
                                                 for i in range(8)]
    finally:
        s.close()


def test_engine_calls_share_one_thread(tmp_path):
    """Every tool call runs on the server's one engine thread, whichever
    handler thread took the request, so PyTorch's per-thread state
    (cuDNN's execution plans) is built once, not once per request."""
    seen = []

    class Recorder:
        """A TTS engine's surface that notes the thread of each call."""
        sample_rate, device = 16000, "cpu"

        def __call__(self, text):
            seen.append(threading.get_ident())
            return np.zeros(160, np.float32)

    llm = ScriptedLLM([_act(TTS_TOOL, "hi"), _answer("ok")] * 3)
    s = Served(llm, {"tts": Recorder()}, tmp_path, device="cpu")
    try:
        for i in range(3):
            assert _post(s.port, "/chat", {"text": f"q{i}"})[0] == 200
    finally:
        s.close()
    assert len(seen) == 3 and len(set(seen)) == 1
    assert seen[0] not in (threading.get_ident(), s.thread.ident)


def test_engines_answer_while_a_turn_waits_on_its_llm(tmp_path,
                                                      small_engines):
    """The agent and its LLM call run on the request's thread, only the
    engine calls on the engine thread: a ``/tts/stream`` is answered while
    a chat turn waits on a slow LLM."""
    entered, release = threading.Event(), threading.Event()

    class SlowLLM(ScriptedLLM):
        def complete(self, prompt, stop=None):
            entered.set()
            assert release.wait(60)
            return super().complete(prompt, stop)

    s = Served(SlowLLM([_answer("ok")]), {"tts": small_engines["tts"]},
               tmp_path, device="cpu")
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            turn = ex.submit(_post, s.port, "/chat", {"text": "hi"})
            assert entered.wait(60)
            conn = http.client.HTTPConnection("127.0.0.1", s.port,
                                              timeout=20)
            conn.request("GET", "/tts/stream?text=hello")
            r = conn.getresponse()
            raw = r.read()
            conn.close()
            assert r.status == 200 and len(raw) > 44
            assert not turn.done()
            release.set()
            code, body, _ = turn.result()
        assert code == 200 and json.loads(body)["response"] == "ok"
    finally:
        release.set()
        s.close()


@pytest.mark.parametrize("endpoint", ["/inpaint/show", "/inpaint"])
@pytest.mark.parametrize("audio", ["../" * 40 + "etc/passwd", "/etc/passwd",
                                   "audio/missing.wav"],
                         ids=["dotdot-to-root", "absolute", "missing"])
def test_inpaint_endpoints_refuse_paths_outside_the_media_root(
        tmp_path, small_engines, endpoint, audio):
    """The inpaint endpoints read ``audio`` only from a file under the
    media root, ``..`` resolved: anything else is a 404."""
    s = Served(ScriptedLLM([]), {"t2a": small_engines["t2a"]}, tmp_path,
               device="cpu")
    try:
        code, body, _ = _post(s.port, endpoint,
                              {"audio": audio, "mask": "AAAA"})
        assert code == 404, body
        assert "no media file" in json.loads(body)["error"]
    finally:
        s.close()


@pytest.mark.parametrize("tool_turn", [False, True])
def test_speech_endpoint(tmp_path, tool_turn):
    """ASR → agent → TTS over HTTP (reference ``speech``, 1294). With a tool
    turn, the 22.05 kHz reply is merged with the tool's 16 kHz clip, which
    the agent names relative to the media root (the server is run from
    another directory)."""
    root = tmp_path / "media"
    engines = stub_engines()
    asr_fn, tts_fn = speech_callables(engines, str(root))
    script = [_act(T2A_TOOL, "a bark")] if tool_turn else []
    llm = ScriptedLLM(script + [_answer("Sunny, probably.")])
    s = Served(llm, engines, root, mode="speech", asr=asr_fn, tts=tts_fn,
               device="cpu")
    try:
        buf = io.BytesIO()
        wavfile.write(buf, 16000, np.zeros(12000, np.int16))
        code, body, _ = _req(s.port, "/speech", buf.getvalue())
        assert code == 200, body
        data = json.loads(body)
        assert data["transcript"] == "12000 samples"
        assert data["response"] == "Sunny, probably."
        code, wav_bytes, _ = _req(s.port, data["audio"])
        assert code == 200
        wav, sr = load_wav(io.BytesIO(wav_bytes))
        speech = output_length(8000, 22050, 16000)   # the reply at 16 kHz
        n = speech + 8000 if tool_turn else 8000
        assert (sr, len(wav)) == ((16000, n) if tool_turn else (22050, n))
    finally:
        s.close()


# -- served turns through small port engines --------------------------------

def _t2a_engine():
    gen = torch.Generator().manual_seed(40)
    voc = VocoderEngine("bigvgan", cfg=BigVGANConfig(**VOC),
                        buckets=(T2A["mel_len"],), device="cpu")
    eng = T2AEngine(T2AConfig(
        unet=UNetConfig(**UNET), vae=VAEConfig(**VAE),
        clap=CLAPTextConfig(bert=BertConfig(**BERT), d_proj=32,
                            max_length=16), inpaint_mel_len=32, **T2A),
        vocoder=voc, device="cpu")
    with torch.no_grad():
        for p in eng.unet.parameters():     # the zero-initialised out convs
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return eng


@pytest.fixture(scope="module")
def small_engines():
    t2a = _t2a_engine()
    i2a = I2AEngine(t2a, CLIPVisionConfig(image_size=32, patch_size=8,
                                          width=16, layers=1, heads=2,
                                          embed_dim=32),
                    CLIPTextConfig(vocab_size=100, context_length=16,
                                   width=16, layers=1, heads=2,
                                   embed_dim=32), device="cpu")
    voc = VocoderEngine("hifigan", HifiGANConfig(
        upsample_initial_channel=32, resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3),)), buckets=(64, 128), device="cpu")
    tts = TTSEngine(FastSpeech2Config(
        vocab_size=128, hidden_size=32, enc_layers=1, dec_layers=1,
        predictor_layers=2, max_frames=128), vocoder=voc,
        token_buckets=(16, 32), device="cpu")
    return build_engines({"t2a": t2a, "i2a": i2a, "tts": tts})


def test_build_engines_passes_a_mapping_through(small_engines):
    again = build_engines(small_engines)
    assert again == small_engines and again is not small_engines
    with pytest.raises(KeyError):
        build_engines("vggish,t2a")     # no such engine


def test_app_has_every_engine_of_the_jax_app():
    from audiogpt_tpu import app as japp
    from audiogpt_tpu_torch import app

    assert app.ALL_ENGINES == japp.ALL_ENGINES and len(app.ALL_ENGINES) == 19


def test_served_turns_equal_direct_engine_calls(tmp_path, small_engines):
    """One /chat turn per tool through the small engines; each saved file
    holds what the engine returns when called directly (the int16 file
    within two quantisations of it). The image and the clip lie under the
    media root and are named relative to it."""
    root = tmp_path / "media"
    (root / "image").mkdir(parents=True)
    (root / "audio").mkdir()
    image = str(root / "image" / "photo.png")
    Image.fromarray(np.random.RandomState(41).randint(
        0, 255, (40, 56, 3)).astype(np.uint8)).save(image)
    save_wav(0.2 * np.sin(np.arange(32 * 256) / 9.0).astype(np.float32),
             str(root / "audio" / "clip.wav"), 16000)
    t2a, i2a, tts = (small_engines[k] for k in ("t2a", "i2a", "tts"))
    turns = [
        (T2A_TOOL, "a dog barks", lambda: t2a.txt2audio_best(
            "a dog barks", seed=0)[1], 16000),
        ("Generate Audio From The Image", "image/photo.png",
         lambda: i2a.img2audio(image)[0], 16000),
        (TTS_TOOL, "hello there", lambda: tts("hello there"),
         tts.sample_rate),
        ("Audio Inpainting", "audio/clip.wav, 0.1, 0.3", None, 16000),
    ]
    script = []
    for tool, arg, _, _ in turns:
        script += [_act(tool, arg), _answer("done")]
    s = Served(ScriptedLLM(script), small_engines, root, device="cpu")
    t2a._generator.manual_seed(0)          # the tool's draws: seed 0
    try:
        for tool, arg, direct, sr in turns:
            code, body, _ = _post(s.port, "/chat", {"text": tool})
            assert code == 200, body
            data = json.loads(body)
            assert data["steps"][0]["tool"] == tool
            assert data["media"][0]["kind"] == "audio"
            got, got_sr = load_wav(data["steps"][0]["observation"])
            assert got_sr == sr and np.isfinite(got).all()
            if direct is None:     # inpaint: the canvas, 0.1-0.3 s redrawn
                assert got.shape == (32 * t2a.vocoder.hop_size,)
                continue
            ref = np.clip(direct(), -1.0, 1.0)
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, atol=2 * LSB, rtol=0)
    finally:
        s.close()


T2I_TOOL = "Generate Image From User Input Text"
I2T_TOOL = "Get Photo Description"


class ImagePathLLM(ScriptedLLM):
    """Replays the script with ``{image}`` replaced by the last
    ``image/<file>.png`` that the prompt names, as an LLM copies the T2I
    tool's observation into its answer and the next turn's tool input."""

    def complete(self, prompt, stop=None):
        out = super().complete(prompt, stop)
        names = re.findall(r"image/[\w.-]+\.png", prompt)
        return out.replace("{image}", names[-1]) if names else out


def test_served_image_round_trip(tmp_path):
    """A T2I turn writes its PNG under the media root, ``/media/`` serves
    it, and an I2T turn describes the file the T2I turn named (a path
    relative to the media root); both equal the direct calls."""
    t2i = T2IEngine(T2IConfig(
        unet=UNetConfig(**UNET),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(), in_channels=3, out_ch=3,
                      resolution=32),
        text=CLIPTextConfig(context_length=16, width=32, layers=1, heads=2,
                            embed_dim=32), height=32, width=32),
        device="cpu")
    i2t = ImageCaptionEngine(BlipConfig(
        vision=BlipVisionConfig(image_size=32, patch_size=16, width=32,
                                layers=1, heads=2, mlp_dim=64),
        text=BlipTextConfig(vocab_size=60, width=32, layers=1, heads=2,
                            mlp_dim=64, encoder_width=32, bos_id=58,
                            eos_id=59)), max_tokens=5, device="cpu")
    root = tmp_path / "media"
    llm = ImagePathLLM([_act(T2I_TOOL, "a red bicycle"),
                        _answer("Here it is: {image}"),
                        _act(I2T_TOOL, "{image}"), _answer("described")])
    s = Served(llm, build_engines({"t2i": t2i, "i2t": i2t}), root,
               device="cpu")
    assert t2i.media_root == i2t.media_root == s.app.media_root
    try:
        t2i._generator.manual_seed(0)
        code, body, _ = _post(s.port, "/chat", {"text": "draw a bicycle"})
        data = json.loads(body)
        assert code == 200 and data["steps"][0]["tool"] == T2I_TOOL
        rel = data["steps"][0]["observation"]
        assert rel.startswith("image/") and rel.endswith(".png")
        assert data["media"] == [{"kind": "image", "url": f"/media/{rel}",
                                  "tool": T2I_TOOL}]
        code, png, headers = _req(s.port, f"/media/{rel}")
        assert code == 200 and headers["Content-Type"] == "image/png"
        assert png == (root / rel).read_bytes()
        with Image.open(io.BytesIO(png)) as img:
            served = np.asarray(img)
        t2i._generator.manual_seed(0)
        direct = (t2i.txt2img("a red bicycle")[0] * 255).astype(np.uint8)
        assert served.shape == (32, 32, 3)
        np.testing.assert_array_equal(served, direct)

        code, body, _ = _post(s.port, "/chat", {"text": "what is in it?"})
        data = json.loads(body)
        assert code == 200 and data["steps"][0]["tool"] == I2T_TOOL
        assert data["steps"][0]["input"] == rel and not data["media"]
        caption = data["steps"][0]["observation"]
        assert caption and caption == i2t(str(root / rel))
    finally:
        s.close()


def _analysis_transform_engines():
    """Tiny CPU engines of the seven audio analysis and transform tools."""
    from audiogpt_tpu_torch.engines import (BinauralEngine, CaptionEngine,
                                            ExtractionEngine, SEDEngine,
                                            SeparationEngine, TSDEngine)
    from audiogpt_tpu_torch.models.binaural import BinauralConfig
    from audiogpt_tpu_torch.models.caption import Cnn14Config
    from audiogpt_tpu_torch.models.caption.captioner import CaptionConfig
    from audiogpt_tpu_torch.models.extraction import LASSNetConfig
    from audiogpt_tpu_torch.models.sed import SEDConfig, TSDConfig
    from audiogpt_tpu_torch.models.separation import ConvTasNetConfig

    cnn = Cnn14Config(channels=(4, 4, 8, 8, 16, 16))
    bert = BertConfig(hidden_size=16, num_layers=1, num_heads=2,
                      intermediate_size=32)
    tasnet = dict(enc_dim=32, bottleneck=8, hidden=16, skip=8, n_blocks=2,
                  n_repeats=1)
    return {
        "caption": CaptionEngine(CaptionConfig(
            cnn14=cnn, rnn_hidden=8, vocab_size=40, emb_dim=16, nhead=2,
            nlayers=1, dim_feedforward=32, max_caption_len=8),
            vocab=[f"w{i}" for i in range(40)], max_sec=4.0, device="cpu"),
        "sed": SEDEngine(SEDConfig(cnn14=cnn), max_sec=4.0, device="cpu"),
        "tsd": TSDEngine(TSDConfig(embedding_dim=8, gru_hidden=8,
                                   channels=(4, 4, 8, 8)),
                         CLAPTextConfig(bert=bert, d_proj=16, max_length=16),
                         max_sec=4.0, device="cpu"),
        "extraction": ExtractionEngine(LASSNetConfig(
            bert=bert, cond_dim=16, enc_channels=(4, 8, 8)), max_sec=4.0,
            device="cpu"),
        "enhance": SeparationEngine(ConvTasNetConfig(n_src=1, **tasnet),
                                    device="cpu"),
        "separate": SeparationEngine(ConvTasNetConfig(n_src=2, **tasnet),
                                     device="cpu"),
        "binaural": BinauralEngine(BinauralConfig(warpnet_channels=8),
                                   device="cpu"),
    }


def test_served_analysis_and_transform_tools(tmp_path):
    """One ``/chat`` turn per audio analysis and transform tool, on one
    16 kHz clip: each answers what the engine gives called directly on the
    file at its rate; the SED figure comes back from ``/media/image/...``,
    ``tsd`` and ``extraction`` parse their ``path, text`` input, and
    ``separate``'s merged file lies under the media root."""
    engines = _analysis_transform_engines()
    root = tmp_path / "media"
    (root / "audio").mkdir(parents=True)
    clip = str(root / "audio" / "clip.wav")
    t = np.arange(16000) / 16000
    save_wav((0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * np.random.RandomState(
        0).randn(16000)).astype(np.float32), clip, 16000)
    turns = [
        ("caption", "Generate Text From The Audio", clip),
        ("sed", "Detect The Sound Event From The Audio", clip),
        ("tsd", "Target Sound Detection", f"{clip}, a dog barking"),
        ("extraction", "Extract Sound Event From Mixture Audio Based On "
                       "Language Description", f"{clip}, the tone"),
        ("enhance", ENHANCE, clip),
        ("separate", "Speech Separation In Single-Channel", clip),
        ("binaural", "Sythesize Binaural Audio From A Mono Audio Input",
         clip),
    ]
    script = []
    for _, tool, arg in turns:
        script += [_act(tool, arg), _answer("Done.")]
    s = Served(ScriptedLLM(script), build_engines(engines), root,
               device="cpu")
    try:
        for key, tool, arg in turns:
            code, body, _ = _post(s.port, "/chat", {"text": f"use {key}"})
            data = json.loads(body)
            step = data["steps"][0]
            assert code == 200 and step["tool"] == tool, (key, data)
            obs = step["observation"]
            eng = engines[key]
            if key == "caption":
                wav, _ = load_wav(clip, 32000, device="cpu")
                assert obs == eng.caption(wav) and obs.startswith("w")
            elif key == "sed":
                rel = os.path.relpath(obs, str(root))
                assert rel.startswith("image/") and rel.endswith(".png")
                assert data["media"] == [{"kind": "image",
                                          "url": f"/media/{rel}",
                                          "tool": tool}]
                code, png, headers = _req(s.port, f"/media/{rel}")
                assert code == 200 and headers["Content-Type"] == "image/png"
                assert png == (root / rel).read_bytes()
                with Image.open(io.BytesIO(png)) as img:
                    assert img.size == (1000, 400)
            elif key == "tsd":
                wav, _ = load_wav(clip, 22050, device="cpu")
                spans = eng.detect(wav, "a dog barking")
                assert obs == ("; ".join(f"({a:.2f}s, {b:.2f}s)"
                                         for a, b in spans) if spans else
                               "no occurrence of 'a dog barking' detected")
            else:
                assert os.path.dirname(obs) == str(root / "audio")
                out, sr = load_wav(obs)
                assert data["media"][0]["kind"] == "audio"
                assert np.isfinite(out).all() and out.std() > 0
                if key == "extraction":
                    wav, _ = load_wav(clip, 32000, device="cpu")
                    ref = str(tmp_path / "direct.wav")
                    save_wav(eng.extract(wav, "the tone"), ref, 32000)
                    direct, _ = load_wav(ref)
                    assert sr == 32000 and out.shape == direct.shape
                    np.testing.assert_allclose(out, direct, atol=LSB, rtol=0)
                elif key == "separate":
                    # the two stems, merged into one file
                    assert sr == 16000 and out.size == 2 * 16000
                elif key == "binaural":
                    file_sr, stereo = wavfile.read(obs)
                    assert file_sr == 48000 and stereo.shape == (48000, 2)
                else:
                    assert sr == 16000 and out.size == 16000
        for key, eng in engines.items():
            assert eng.timings, key
    finally:
        s.close()


def _singing_and_style_engines():
    """Tiny CPU engines of the SVS and Style Transfer tools, each with a
    HiFi-GAN of hop 256 at 22.05 kHz and ≈ 3 frames a phone."""
    from audiogpt_tpu_torch.engines import SVSEngine, StyleTransferEngine
    from audiogpt_tpu_torch.models.svs import DiffNetConfig, DiffSingerConfig
    from audiogpt_tpu_torch.models.tts.generspeech import GenerSpeechConfig

    voc = dict(upsample_initial_channel=16, upsample_rates=(8, 8, 4),
               upsample_kernel_sizes=(16, 16, 8), resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1,),))
    fs2 = dict(hidden_size=16, enc_layers=1, dec_layers=1,
               enc_ffn_kernel_size=3, dec_ffn_kernel_size=3,
               predictor_layers=1, predictor_hidden=8, max_frames=256)
    svs = SVSEngine(DiffSingerConfig(
        fs2=FastSpeech2Config(use_midi=True, rel_pos=True,
                              use_pitch_embed=False, **fs2),
        net=DiffNetConfig(encoder_hidden=16, residual_layers=2,
                          residual_channels=8), timesteps=40, K_step=40),
        vocoder=VocoderEngine("hifigan", HifiGANConfig(**voc),
                              device="cpu"), device="cpu")
    tts_ood = StyleTransferEngine(GenerSpeechConfig(
        fs2=FastSpeech2Config(**fs2), n_vq=8, emb_dim=16, glow_hidden=16,
        glow_steps=2, glow_wn_layers=2),
        vocoder=VocoderEngine("hifigan", HifiGANConfig(**voc),
                              device="cpu"), device="cpu")
    with torch.no_grad():
        for dur in (svs.model.fs2.dur_predictor, tts_ood.model.dur_predictor):
            dur.out.weight.mul_(1e-3)
            dur.out.bias.fill_(math.log(4.0))
    return {"svs": svs, "tts_ood": tts_ood}


def test_served_singing_and_style_transfer_tools(tmp_path):
    """Both tools register once their engines are given; a served SVS turn
    gives the direct call's wav, on the default song for an empty input
    and for two malformed scores (window counts that differ, a duration
    that is not a number); a Style Transfer turn on a 10 s reference
    (past the largest 512-frame bucket, which the JAX engine refuses) gives
    a mono file at 22 050 Hz, the direct call's wav. A vocoder-less engine
    (the JAX app's) would write an 80-channel file of mel values."""
    from audiogpt_tpu_torch.agent.toolset import DEFAULT_SONG, build_toolset

    svs_tool = ("Generate Singing Voice From User Input Text, Note and "
                "Duration Sequence")
    engines = _singing_and_style_engines()
    names = build_toolset(engines, root=str(tmp_path)).names()
    assert names == ["Style Transfer", svs_tool]
    root = tmp_path / "media"
    (root / "audio").mkdir(parents=True)
    ref = str(root / "audio" / "voice.wav")
    t = np.arange(10 * 22050) / 22050
    save_wav((0.3 * np.sin(2 * np.pi * 160 * t) * np.sin(2 * np.pi * 3 * t)
              ).astype(np.float32), ref, 22050)
    svs, tts_ood = engines["svs"], engines["tts_ood"]
    turns = [("svs", svs_tool, '""'),
             ("svs", svs_tool, "ni hao, C4, 0.1 | 0.2"),
             ("svs", svs_tool, "ni, C4, abc"),
             ("tts_ood", "Style Transfer", f"{ref}, Hello from a new voice.")]
    script = []
    for _, tool, arg in turns:
        script += [_act(tool, arg), _answer("Done.")]
    s = Served(ScriptedLLM(script), build_engines(engines), root,
               device="cpu")
    try:
        for key, tool, arg in turns:
            engines[key]._gen.manual_seed(0)
            code, body, _ = _post(s.port, "/chat", {"text": f"use {key}"})
            data = json.loads(body)
            step = data["steps"][0]
            assert code == 200 and step["tool"] == tool, (key, data)
            file_sr, pcm = wavfile.read(step["observation"])
            assert file_sr == 22050 and pcm.ndim == 1     # mono
            out, _ = load_wav(step["observation"])
            engines[key]._gen.manual_seed(0)
            if key == "svs":
                direct = svs.synthesize(*DEFAULT_SONG)
            else:
                direct = tts_ood.synthesize("Hello from a new voice.",
                                            load_wav(ref, 22050)[0])
                assert len(direct) % 256 == 0
            ref_file = str(tmp_path / "direct.wav")
            save_wav(direct, ref_file, 22050)
            direct, _ = load_wav(ref_file)
            assert out.shape == direct.shape and out.std() > 0
            np.testing.assert_allclose(out, direct, atol=LSB, rtol=0)
    finally:
        s.close()


def test_served_geneface_tool(tmp_path):
    """The GeneFace tool registers once its engine is given; a served turn
    on a clip named relative to the media root writes
    ``video/<file>.avi`` there (the frames of the clip at 25 fps, the
    audio muxed in), ``GET /media/`` answers it as ``video/x-msvideo``
    with the file's bytes, and the direct call's landmarks drive it."""
    from audiogpt_tpu_torch.agent.toolset import build_toolset
    from audiogpt_tpu_torch.engines import GeneFaceEngine
    from audiogpt_tpu_torch.models.face import Audio2MotionConfig
    from audiogpt_tpu_torch.utils.video_io import read_avi_info

    tool = "Generate a talking human portrait video given a input Audio"
    eng = GeneFaceEngine(Audio2MotionConfig(hidden=8, latent=4,
                                            conv_layers=1), video_size=32,
                         buckets=(64,), device="cpu")
    for mode in ("text", "speech"):
        assert build_toolset({"geneface": eng}, root=str(tmp_path),
                             mode=mode).names() == [tool]
    root = tmp_path / "media"
    (root / "audio").mkdir(parents=True)
    save_wav((0.3 * np.sin(np.arange(16000) / 4.0)).astype(np.float32),
             str(root / "audio" / "speech.wav"), 16000)
    s = Served(ScriptedLLM([_act(tool, "audio/speech.wav"),
                            _answer("Here is the video.")]),
               build_engines({"geneface": eng}), root, device="cpu")
    try:
        code, body, _ = _post(s.port, "/chat", {"text": "animate it"})
        data = json.loads(body)
        step = data["steps"][0]
        assert code == 200 and step["tool"] == tool, data
        rel = step["observation"]
        assert rel.startswith("video/") and rel.endswith(".avi")
        assert data["media"] == [{"kind": "video", "url": f"/media/{rel}",
                                  "tool": tool}]
        info = read_avi_info(str(root / rel))
        assert (info["n_frames"], info["fps"], info["n_streams"]) == (
            eng.cfg.video_len(63), 25, 2)
        code, avi, headers = _req(s.port, f"/media/{rel}")
        assert code == 200 and headers["Content-Type"] == "video/x-msvideo"
        assert avi == (root / rel).read_bytes()
        assert eng.timings["geneface"] > 0
    finally:
        s.close()


def test_tts_stream_endpoint(tmp_path, small_engines):
    """GET /tts/stream: the streaming RIFF header, then int16 PCM per
    clause chunk, equal to the engine's whole synthesis within one int16
    step; an empty text and a negative ``chunk_phones`` are 400s (the JAX
    server answers the latter with a 500)."""
    tts = small_engines["tts"]
    s = Served(ScriptedLLM([]), {"tts": tts}, tmp_path, device="cpu")
    try:
        text = "hello there. this is a second clause for chunking."
        conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=120)
        conn.request("GET", "/tts/stream?text=" + urllib.parse.quote(text))
        r = conn.getresponse()
        assert r.status == 200 and r.headers["Content-Type"] == "audio/wav"
        assert r.headers.get("Content-Length") is None    # EOF-delimited
        raw = r.read()
        conn.close()
        assert raw[:4] == b"RIFF" and raw[8:12] == b"WAVE"
        assert struct.unpack("<I", raw[24:28])[0] == tts.sample_rate
        pcm = np.frombuffer(raw[44:], "<i2").astype(np.float32) / 32767.0
        ref = tts(text)
        assert pcm.shape == ref.shape
        assert np.abs(pcm - ref).max() <= 1.5 / 32767.0
        for query in ("text=%20", "text=hi&chunk_phones=-1"):
            code, body, _ = _req(s.port, "/tts/stream?" + query)
            assert code == 400, body
    finally:
        s.close()


def test_microbatched_tts_server(tmp_path, small_engines):
    """The ``--microbatch`` shape: the TTS engine behind ``BatchedTTS``
    answers concurrent tool turns, and every turn rides the batcher."""
    proxy = BatchedTTS(small_engines["tts"], window_ms=20.0)
    n = 3
    llm = ScriptedLLM([_act(TTS_TOOL, "microbatched hello"),
                       _answer("spoken.")] * n)
    s = Served(llm, {"tts": proxy}, tmp_path, device="cpu")
    try:
        with concurrent.futures.ThreadPoolExecutor(n) as ex:
            results = list(ex.map(lambda i: _post(
                s.port, "/chat", {"text": f"say hi {i}"}), range(n)))
        for code, raw, _ in results:
            assert code == 200 and json.loads(raw)["steps"]
        assert proxy.batcher.items == n
    finally:
        s.close()
        proxy.batcher.close()


def test_sketch_mask_inpaint_roundtrip(tmp_path, small_engines):
    """The drawn-mask inpaint loop (audio-chatgpt.py:418-540, 1351-1374)
    over HTTP: /inpaint/show returns a drawable mel PNG; POST /inpaint with
    a sketch PNG (alpha = regenerate) returns the regenerated wav."""
    t2a = small_engines["t2a"]
    cfg = t2a.cfg
    s = Served(ScriptedLLM([]), {"t2a": t2a}, tmp_path, device="cpu")
    try:
        os.makedirs(tmp_path / "audio", exist_ok=True)
        save_wav(0.2 * np.sin(np.arange(cfg.inpaint_mel_len * cfg.hop) / 9.0)
                 .astype(np.float32), str(tmp_path / "audio/clip.wav"), 16000)
        code, body, _ = _post(s.port, "/inpaint/show",
                              {"audio": "audio/clip.wav"})
        assert code == 200, body
        meta = json.loads(body)
        assert (meta["mel_bins"], meta["frames"]) == (cfg.mel_bins,
                                                      cfg.inpaint_mel_len)
        code, png, hdrs = _req(s.port, meta["image"])
        assert code == 200 and hdrs["Content-Type"] == "image/png"
        img = Image.open(io.BytesIO(png))
        assert img.size == (cfg.inpaint_mel_len, cfg.mel_bins)
        mask = Image.new("RGBA", img.size, (0, 0, 0, 0))
        for x in range(8, 16):
            for y in range(4, 12):
                mask.putpixel((x, y), (255, 255, 255, 255))
        buf = io.BytesIO()
        mask.save(buf, format="PNG")
        url = "data:image/png;base64," + base64.b64encode(
            buf.getvalue()).decode()
        code, body, _ = _post(s.port, "/inpaint", {
            "audio": "audio/clip.wav", "mask": url, "text": "birds",
            "ddim_steps": 3})
        assert code == 200, body
        code, wav_bytes, _ = _req(s.port, json.loads(body)["audio"])
        wav, sr = load_wav(io.BytesIO(wav_bytes))
        assert code == 200 and sr == 16000
        assert wav.shape == (cfg.inpaint_mel_len * t2a.vocoder.hop_size,)
    finally:
        s.close()


def test_compute_mel_matches_jax():
    cfg = types.SimpleNamespace(inpaint_mel_len=40, hop=256,
                                sample_rate=16000, mel_bins=80)
    wav = 0.3 * np.random.RandomState(42).randn(9000).astype(np.float32)
    got = pinpaint.compute_mel(wav, cfg, device="cpu")
    ref = jinpaint.compute_mel(wav, cfg)
    assert got.shape == ref.shape == (40, 80)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def _png(img):
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _strokes(mode, background, stroke):
    img = Image.new(mode, (32, 16), background)
    for x in range(4, 8):
        for y in range(2, 6):
            img.putpixel((x, y), stroke)
    return img


@pytest.mark.parametrize("png", [
    _png(_strokes("RGBA", (0, 0, 0, 0), (255, 255, 255, 255))),   # overlay
    _png(_strokes("RGBA", (0, 0, 0, 255), (255, 255, 255, 255))),  # opaque
    _png(_strokes("L", 0, 255)),                                   # gray
    _png(_strokes("L", 0, 255).resize((32, 8))),                   # scaled
], ids=["overlay", "opaque", "gray", "scaled"])
def test_decode_mask_png_matches_jax(png):
    """Alpha is the mask only where it varies; an opaque upload and a
    grayscale one use luminance; a canvas of another height is resized."""
    got = pinpaint.decode_mask_png(png, mel_bins=16)
    np.testing.assert_array_equal(got, jinpaint.decode_mask_png(png,
                                                                mel_bins=16))
    assert got.shape == (32, 16) and got[5, 3] == 1.0 and got[0, 0] == 0.0


def test_render_mel_png_matches_jax():
    mel = np.random.RandomState(43).rand(40, 16).astype(np.float32)
    assert pinpaint.render_mel_png(mel) == jinpaint.render_mel_png(mel)


#: every tool that reads a clip, and I2A, with its input around the clip
#: or image that an upload named (the stub engines' answers)
UPLOADED_TURNS = [
    ("Transcribe Speech", "{clip}"),
    ("Generate Text From The Audio", "{clip}"),
    ("Detect The Sound Event From The Audio", "{clip}"),
    ("Target Sound Detection", "{clip}, a siren"),
    ("Extract Sound Event From Mixture Audio Based On Language "
     "Description", "{clip}, a dog"),
    (ENHANCE, "{clip}"),
    ("Speech Separation In Single-Channel", "{clip}"),
    ("Sythesize Binaural Audio From A Mono Audio Input", "{clip}"),
    ("Audio Inpainting", "{clip}, 0.1, 0.3"),
    ("Style Transfer", "{clip}, hello"),
    ("Generate Audio From The Image", "{image}"),
]


def _upload(port, name, data):
    code, body, _ = _req(port, "/upload", data, {"X-Filename": name})
    assert code == 200, body
    return json.loads(body)["path"]


def test_uploads_reach_every_tool_from_another_working_directory(
        tmp_path, monkeypatch):
    """``/upload`` names the file relative to the media root; with the
    server run from another directory, each tool that reads a clip (and
    I2A an image) still reads the upload (``utils/media.py``)."""
    root = tmp_path / "media"
    elsewhere = tmp_path / "elsewhere"
    elsewhere.mkdir()
    monkeypatch.chdir(elsewhere)
    names = {}

    class UploadLLM(ScriptedLLM):
        """The script with the uploads' names filled in."""

        def complete(self, prompt, stop=None):
            return super().complete(prompt, stop).format(**names)

    script = []
    for tool, arg in UPLOADED_TURNS:
        script += [_act(tool, arg), _answer("done")]
    engines = stub_engines()
    s = Served(UploadLLM(script), engines, root, device="cpu")
    try:
        buf = io.BytesIO()
        wavfile.write(buf, 16000, (3000 * np.sin(np.arange(8000) / 5.0))
                      .astype(np.int16))
        clip = _upload(s.port, "clip.wav", buf.getvalue())
        png = io.BytesIO()
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(png, "PNG")
        image = _upload(s.port, "photo.png", png.getvalue())
        assert not os.path.isabs(clip) and not os.path.exists(clip)
        names.update(clip=clip, image=image)
        for tool, arg in UPLOADED_TURNS:
            code, body, _ = _post(s.port, "/chat", {"text": tool})
            assert code == 200, body
            step = json.loads(body)["steps"][0]
            assert step["tool"] == tool
            assert step["input"] == arg.format(clip=clip, image=image)
            assert not step["observation"].startswith("Tool error"), step
        assert step["observation"].startswith(str(root))
    finally:
        s.close()


@pytest.mark.parametrize("tool", [ENHANCE, "Generate Audio From The Image"])
@pytest.mark.parametrize("how", ["absolute", "dotdot"])
def test_tool_paths_outside_the_media_root_are_refused(tmp_path, tool, how):
    """A file that exists outside the media root, named by its absolute
    path or by ``..``, is refused: the tool's turn observes the error and
    the engine never sees the file."""
    root = tmp_path / "media"
    root.mkdir()
    outside = tmp_path / "outside.wav"
    save_wav(np.zeros(4000, np.float32), str(outside), 16000)
    name = {"absolute": str(outside),
            "dotdot": os.path.relpath(outside, root)}[how]
    seen = []
    engines = stub_engines()
    engines["i2a"] = lambda path: seen.append(path) or (np.zeros(8), 16000)
    s = Served(ScriptedLLM([_act(tool, name), _answer("done")]), engines,
               root, device="cpu")
    try:
        code, body, _ = _post(s.port, "/chat", {"text": "go"})
        assert code == 200, body
        obs = json.loads(body)["steps"][0]["observation"]
        assert obs.startswith("Tool error") and "outside the media root" \
            in obs, obs
        assert not seen
    finally:
        s.close()
