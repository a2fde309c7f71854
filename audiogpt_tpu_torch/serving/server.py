"""HTTP serving for the conversational audio agent.

Counterpart of ``audiogpt_tpu/serving/server.py:1-386`` over the port's
agent and engines. Three reference defects are not copied: a negative
``chunk_phones`` on ``/tts/stream`` is a 400 (the JAX server answers 500,
``server.py:284-288``); ``BatchedTTS`` frontend errors reach the caller
(``serving/batcher.py``); the speech loop merges the generated file
from the media root (the JAX server reads its media-root-relative name
against the working directory, ``server.py:144``); and a path that a
client names (``/media/<rel>``, the inpaint endpoints' ``audio``) is
resolved before it is checked, so ``..`` cannot leave the media root
(``AppServer.media_file``; the JAX server checks the joined path
unresolved, ``server.py:251-256``). Every engine call runs on one thread
that the server owns, not on the request's own thread
(``AppServer.run_on_engine_thread``); the agent and its LLM call stay on
the request's thread. The server's own signal work (the speech loop's
``merge_audio``) runs on ``device``, the card unless the caller asks for
the CPU; the inpaint endpoints use the T2A engine's device.

API surface mirrors the reference Gradio event handlers
(``audio-chatgpt.py``): text turns (``run_text``:1197), audio/image upload
with auto-captioning into agent memory (``run_image_or_audio``:1250), the
speech loop ASR→agent→TTS (``speech``:1294), inpainting
(``inpainting``:1351), mode switch (``init_tools``:1075), and history clear.

Endpoints (JSON unless noted):
  GET  /              → chat UI (single-page HTML)
  GET  /health        → {"status": "ok", "tools": [...]}
  POST /mode          {"mode": "text"|"speech"} — rebuilds the toolset
  POST /chat          {"text": ...} → {response, steps, media}
  POST /upload        multipart or raw body w/ X-Filename — saves + ingests
  POST /speech        raw wav body → {transcript, response, audio}
  POST /inpaint/show  {"audio": rel} → {image, frames, mel_bins} — drawable
                      mel PNG (show_mel_fn:495)
  POST /inpaint       {"audio": rel, "mask": b64/dataURL PNG, "text"?,
                      "ddim_steps"?} → {audio} — sketch-mask regenerate
                      (inpainting:1351)
  POST /clear         → resets agent memory
  GET  /stats         → per-tool calls, wall time, audio seconds and RTF
  GET  /tts/stream?text=...&chunk_phones=64 → progressive WAV
  GET  /media/<kind>/<file> → served artifact (audio/image/video)

Media routing: each tool result whose tool's ``media_kind`` is audio/image/
video is surfaced in ``media`` with a ``/media/...`` URL — the equivalent of
``run_text`` branching on the tool name to pick a UI pane (1210-1248).
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import os
import shutil
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Mapping

import numpy as np
import torch

from audiogpt_tpu_torch.agent.agent import ConversationAgent
from audiogpt_tpu_torch.agent.llm import LLMClient
from audiogpt_tpu_torch.agent.tools import merge_audio, tool_stats_report
from audiogpt_tpu_torch.agent.toolset import build_toolset
from audiogpt_tpu_torch.utils.audio_io import load_wav, save_wav
from audiogpt_tpu_torch.utils.media import resolve_media

_HTML_PATH = os.path.join(os.path.dirname(__file__), "webui.html")


class MediaNotFound(LookupError):
    """A client named a path that is no file under the media root."""


class AppServer:
    """Holds the agent + engines; request handlers delegate here (the
    ``ConversationBot`` equivalent — state confined to one object, not
    globals).

    Two rules, one for each kind of state. ``_lock`` guards the agent's
    (its history, toolset and mode): a turn, an ingest, a mode switch and
    a clear each hold it, as in JAX. Every engine call, a tool's among
    them, runs on the one engine thread, which serialises them; so a
    ``/tts/stream`` chunk or an upload's caption runs while a turn waits
    on its LLM."""

    def __init__(self, llm: LLMClient, engines: Mapping[str, Any],
                 media_root: str = ".", mode: str = "text",
                 asr: Callable | None = None, tts: Callable | None = None,
                 max_steps: int = 6,
                 device: str | torch.device | None = None):
        self.llm = llm
        self.device = device
        self.engines = dict(engines)
        self.media_root = os.path.abspath(media_root)
        for eng in self.engines.values():
            # engines that save their own artifacts (e.g. t2i) write into
            # the server's media root so /media/<rel> URLs resolve
            if hasattr(eng, "media_root"):
                eng.media_root = self.media_root
        self.max_steps = max_steps
        self._lock = threading.Lock()
        self._engine_thread = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engines")
        self.asr = asr
        self.tts = tts
        self.set_mode(mode)

    def run_on_engine_thread(self, fn: Callable, *args):
        """``fn(*args)`` on the server's one engine thread. PyTorch keeps
        state per thread (cuDNN's execution plans among it), and the first
        call on a new thread builds it again, which slows a warm call by
        half (``chip_smoke.py``'s ``served_thread_cost``); the HTTP server
        starts a thread per request."""
        return self._engine_thread.submit(fn, *args).result()

    def _on_engine_thread(self, fn: Callable) -> Callable:
        return functools.partial(self.run_on_engine_thread, fn)

    def media_file(self, rel: str) -> str:
        """The file that ``rel`` names under the media root, its links and
        ``..`` resolved first; :class:`MediaNotFound` for a path that
        leaves the root or is no file."""
        try:
            full = resolve_media(rel, self.media_root)
        except ValueError:
            full = None
        if full is None or not os.path.isfile(full):
            raise MediaNotFound(f"no media file {rel!r}")
        return full

    def close(self) -> None:
        """Stop the engine thread; call after the HTTP server stopped."""
        self._engine_thread.shutdown()

    # -- bot operations ----------------------------------------------------
    def set_mode(self, mode: str) -> None:
        if mode not in ("text", "speech"):
            raise ValueError(f"mode must be text|speech, got {mode!r}")
        tools = build_toolset(self.engines, root=self.media_root, mode=mode)
        for name in tools.names():
            tool = tools.get(name)
            tool.fn = self._on_engine_thread(tool.fn)
        with self._lock:
            self.mode, self.tools = mode, tools
            self.agent = ConversationAgent(self.llm, tools,
                                           max_steps=self.max_steps)

    def _media_entry(self, tool_name: str, path: str) -> dict | None:
        kind = self.tools.get(tool_name).media_kind
        if kind not in ("audio", "image", "video"):
            return None
        rel = os.path.relpath(os.path.join(self.media_root, path),
                              self.media_root) if not os.path.isabs(path) \
            else os.path.relpath(path, self.media_root)
        return {"kind": kind, "url": f"/media/{rel}", "tool": tool_name}

    def chat(self, text: str) -> dict:
        with self._lock:
            result = self.agent.run_text(text)
        media = []
        for tool_name, _arg, obs in result.steps:
            if isinstance(obs, str) and os.path.exists(
                    os.path.join(self.media_root, obs)):
                entry = self._media_entry(tool_name, obs)
                if entry:
                    media.append(entry)
        return {"response": result.response,
                "steps": [{"tool": t, "input": a, "observation": str(o)}
                          for t, a, o in result.steps],
                "media": media}

    def upload(self, filename: str, data: bytes) -> dict:
        ext = os.path.splitext(filename)[1].lower() or ".bin"
        kind = "audio" if ext in (".wav", ".flac", ".mp3") else "image"
        os.makedirs(os.path.join(self.media_root, kind), exist_ok=True)
        rel = os.path.join(kind, f"{str(uuid.uuid4())[:8]}{ext}")
        with open(os.path.join(self.media_root, rel), "wb") as f:
            f.write(data)
        describe = None
        if kind == "audio" and "caption" in self.engines:
            def describe(p):
                cap = self.engines["caption"]
                wav, _ = load_wav(os.path.join(self.media_root, p),
                                  sr=cap.sr, device=getattr(cap, "device",
                                                            None))
                return self.engines["caption"].caption(wav)
        elif kind == "image" and "i2t" in self.engines:
            describe = self.engines["i2t"]
        desc = self.run_on_engine_thread(describe, rel) if describe else None
        with self._lock:
            # injects synthetic Human/AI turns (run_image_or_audio:1261-1264)
            self.agent.ingest_audio(rel, lambda _p: desc or
                                    ("an audio clip" if kind == "audio"
                                     else "an image"))
        return {"path": rel, "url": f"/media/{rel}", "kind": kind,
                "description": desc}

    def speech_turn(self, wav_bytes: bytes) -> dict:
        """ASR → agent → TTS of the response (reference ``speech``:1294)."""
        if self.asr is None or self.tts is None:
            raise RuntimeError("speech mode needs asr= and tts= callables")
        os.makedirs(os.path.join(self.media_root, "audio"), exist_ok=True)
        rel = os.path.join("audio", f"{str(uuid.uuid4())[:8]}.wav")
        full = os.path.join(self.media_root, rel)
        with open(full, "wb") as f:
            f.write(wav_bytes)

        def merge(a, b):
            # the generated file is named relative to the media root
            # (``AgentResult.last_file``), not to the working directory
            return merge_audio(a, os.path.join(self.media_root, b),
                               root=self.media_root, device=self.device)

        with self._lock:
            transcript = self.run_on_engine_thread(self.asr, full)
            response, audio_path = self.agent.speech(
                full, lambda _p: transcript,
                self._on_engine_thread(self.tts),
                merge=self._on_engine_thread(merge))
        rel_audio = audio_path if not os.path.isabs(audio_path) \
            else os.path.relpath(audio_path, self.media_root)
        return {"transcript": transcript, "response": response,
                "audio": f"/media/{rel_audio}"}

    def inpaint_show(self, audio_rel: str) -> dict:
        """Render the clip's mel as a drawable PNG (``show_mel_fn``,
        audio-chatgpt.py:495-503)."""
        from audiogpt_tpu_torch.serving.inpaint import (CROP_LEN,
                                                        compute_mel,
                                                        render_mel_png)

        eng = self.engines.get("t2a")
        if eng is None:
            raise RuntimeError("inpainting needs the 't2a' engine")
        path = self.media_file(audio_rel)

        def mel_of_clip():
            wav, _ = load_wav(path, sr=eng.cfg.sample_rate,
                              device=eng.device)
            return compute_mel(wav, eng.cfg, eng.device)

        mel = self.run_on_engine_thread(mel_of_clip)
        png = render_mel_png(mel)
        os.makedirs(os.path.join(self.media_root, "image"), exist_ok=True)
        rel = os.path.join("image", f"{str(uuid.uuid4())[:8]}.png")
        with open(os.path.join(self.media_root, rel), "wb") as f:
            f.write(png)
        return {"image": f"/media/{rel}", "path": rel,
                "frames": min(CROP_LEN, mel.shape[0]),  # rendered width
                "mel_bins": eng.cfg.mel_bins}

    def inpaint(self, audio_rel: str, mask_png: bytes, text: str = "",
                ddim_steps: int = 100) -> dict:
        """Sketch-drawn mask → regenerated audio (``inpainting``,
        audio-chatgpt.py:1351-1374). Drawn pixels (mask 1) are REGENERATED;
        the engine wants 1 = KEEP, so invert here."""
        from audiogpt_tpu_torch.serving.inpaint import decode_mask_png

        eng = self.engines.get("t2a")
        if eng is None:
            raise RuntimeError("inpainting needs the 't2a' engine")
        path = self.media_file(audio_rel)
        regen = decode_mask_png(mask_png, mel_bins=eng.cfg.mel_bins)

        def regenerate():
            wav, _ = load_wav(path, sr=eng.cfg.sample_rate,
                              device=eng.device)
            return eng.inpaint(wav, 1.0 - regen, text=text,
                               ddim_steps=ddim_steps)

        out = self.run_on_engine_thread(regenerate)
        os.makedirs(os.path.join(self.media_root, "audio"), exist_ok=True)
        rel = os.path.join("audio", f"{str(uuid.uuid4())[:8]}.wav")
        if out.ndim == 2 and out.shape[-1] == eng.cfg.mel_bins:
            # no vocoder attached: return the inpainted mel as an artifact
            from audiogpt_tpu_torch.serving.inpaint import render_mel_png

            rel = os.path.join("image", f"{str(uuid.uuid4())[:8]}.png")
            os.makedirs(os.path.join(self.media_root, "image"), exist_ok=True)
            with open(os.path.join(self.media_root, rel), "wb") as f:
                f.write(render_mel_png(out, crop=out.shape[0]))
            return {"image": f"/media/{rel}", "path": rel}
        save_wav(np.asarray(out).ravel(),
                 os.path.join(self.media_root, rel), eng.cfg.sample_rate)
        return {"audio": f"/media/{rel}", "path": rel}

    def clear(self) -> None:
        with self._lock:
            self.agent.history = ""


class _Handler(BaseHTTPRequestHandler):
    app: AppServer  # injected by make_server

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            with open(_HTML_PATH, "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/health":
            self._json({"status": "ok", "mode": self.app.mode,
                        "tools": self.app.tools.names()})
        elif self.path == "/stats":
            # per-tool RTF/latency counters (SURVEY.md §5: first-class
            # per-tool RTF metrics, replacing the reference's ad-hoc
            # profile_infer timers, vocoders/hifigan.py:59)
            self._json(tool_stats_report())
        elif self.path.startswith("/tts/stream"):
            self._tts_stream()
        elif self.path.startswith("/media/"):
            try:
                full = self.app.media_file(self.path[len("/media/"):])
            except MediaNotFound:
                self._json({"error": "not found"}, 404)
                return
            # avi: the GeneFace tool's MJPEG video (the JAX server maps
            # no type for it and sends application/octet-stream)
            ctype = {"wav": "audio/wav", "png": "image/png",
                     "jpg": "image/jpeg", "mp4": "video/mp4",
                     "avi": "video/x-msvideo"}.get(
                full.rsplit(".", 1)[-1], "application/octet-stream")
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(os.path.getsize(full)))
            self.end_headers()
            with open(full, "rb") as f:
                shutil.copyfileobj(f, self.wfile)
        else:
            self._json({"error": "not found"}, 404)

    def _tts_stream(self):
        """``GET /tts/stream?text=...`` → progressive WAV: the streaming
        header goes out immediately, then int16 PCM per synthesized clause
        chunk (``engines.tts.synthesize_stream``) — time-to-first-audio is
        one chunk's latency, not the whole utterance's. HTTP/1.0 close
        delimits the stream (no Content-Length)."""
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(self.path).query)
        text = (q.get("text") or [""])[0]
        # per-chunk phone cap: streaming defaults to ~one clause (64) so
        # TTFA is the first clause's latency, not the packed utterance's;
        # chunk_phones=0 restores greedy max-bucket packing
        try:
            chunk_phones = int((q.get("chunk_phones") or ["64"])[0]) or None
        except ValueError:
            chunk_phones = 64
        eng = self.app.engines.get("tts")
        if eng is None:
            self._json({"error": "tts engine not enabled"}, 404)
            return
        if not text.strip():
            self._json({"error": "missing text"}, 400)
            return
        if chunk_phones is not None and chunk_phones < 0:
            self._json({"error": f"chunk_phones must be >= 0, got "
                                 f"{chunk_phones}"}, 400)
            return
        from audiogpt_tpu_torch.engines.tts import synthesize_stream
        from audiogpt_tpu_torch.utils.audio_io import wav_stream_header

        # Pull the FIRST chunk before committing to a 200: the generator is
        # lazy, so frontend/bucket errors (e.g. an unsplittable token) would
        # otherwise surface after the header — a truncated HTTP-200 WAV the
        # client can't tell from success (ADVICE r3).
        gen = synthesize_stream(eng, text, max_phones=chunk_phones)
        try:
            first = self.app.run_on_engine_thread(next, gen)
        except StopIteration:
            self._json({"error": "empty synthesis"}, 400)
            return
        except Exception as e:
            self._json({"error": f"{type(e).__name__}: {e}"}, 500)
            return
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.end_headers()
        self.wfile.write(wav_stream_header(eng.sample_rate))
        self.wfile.flush()
        try:
            chunk = first
            while True:
                pcm = (np.clip(chunk, -1.0, 1.0) * 32767.0).astype("<i2")
                self.wfile.write(pcm.tobytes())
                self.wfile.flush()
                chunk = self.app.run_on_engine_thread(next, gen)
        except StopIteration:
            pass
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-stream
        except Exception as e:
            # mid-stream engine failure: the 200 is already committed, so
            # log and close — EOF truncation is the only signal HTTP allows
            import sys

            print(f"| /tts/stream aborted: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)

    def do_POST(self):
        try:
            if self.path == "/chat":
                req = json.loads(self._read_body() or b"{}")
                if not req.get("text"):
                    self._json({"error": "missing 'text'"}, 400)
                    return
                self._json(self.app.chat(req["text"]))
            elif self.path == "/mode":
                req = json.loads(self._read_body() or b"{}")
                self.app.set_mode(req.get("mode", "text"))
                self._json({"mode": self.app.mode,
                            "tools": self.app.tools.names()})
            elif self.path == "/upload":
                filename = self.headers.get("X-Filename", "upload.bin")
                self._json(self.app.upload(filename, self._read_body()))
            elif self.path == "/speech":
                self._json(self.app.speech_turn(self._read_body()))
            elif self.path == "/inpaint/show":
                req = json.loads(self._read_body() or b"{}")
                if not req.get("audio"):
                    self._json({"error": "missing 'audio'"}, 400)
                    return
                self._json(self.app.inpaint_show(req["audio"]))
            elif self.path == "/inpaint":
                import base64

                req = json.loads(self._read_body() or b"{}")
                if not req.get("audio") or not req.get("mask"):
                    self._json({"error": "missing 'audio' or 'mask'"}, 400)
                    return
                mask_b64 = req["mask"].split(",", 1)[-1]  # allow data: URL
                self._json(self.app.inpaint(
                    req["audio"], base64.b64decode(mask_b64),
                    text=req.get("text", ""),
                    ddim_steps=int(req.get("ddim_steps", 100))))
            elif self.path == "/clear":
                self.app.clear()
                self._json({"status": "cleared"})
            else:
                self._json({"error": "not found"}, 404)
        except MediaNotFound as e:
            self._json({"error": str(e)}, 404)
        except Exception as e:  # surface handler errors as JSON, not tracebacks
            self._json({"error": f"{type(e).__name__}: {e}"}, 500)


def make_server(app: AppServer, host: str = "127.0.0.1",
                port: int = 7860) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; call ``serve_forever()`` or use in
    a thread. Port 7860 = the reference's Gradio default."""
    handler = type("BoundHandler", (_Handler,), {"app": app})
    return ThreadingHTTPServer((host, port), handler)
