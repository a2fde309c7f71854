"""Video file output: Motion-JPEG frames in a RIFF AVI, with an optional
mono 16-bit PCM stream.

Copy of ``audiogpt_tpu/utils/video_io.py:1-132``: PIL encodes each frame as
a JPEG and the container is assembled by hand, so no ffmpeg is needed. The
same frames and audio give the same bytes as the JAX writer.
"""

from __future__ import annotations

import io
import struct

import numpy as np


def _jpeg(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def write_mjpeg_avi(path: str, frames, fps: int = 25,
                    audio: np.ndarray | None = None, sample_rate: int = 16000,
                    quality: int = 90) -> str:
    """Write ``frames`` (iterable of [H, W, 3] uint8) as an MJPEG AVI.

    ``audio``: optional mono float waveform in [-1, 1] (or int16), muxed as
    an uncompressed PCM stream chunked per video frame."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("need at least one frame")
    h, w = frames[0].shape[:2]
    jpegs = [_jpeg(f, quality) for f in frames]

    pcm = None
    if audio is not None:
        a = np.asarray(audio)
        if a.dtype != np.int16:
            a = (np.clip(a, -1.0, 1.0) * 32767.0).astype(np.int16)
        pcm = a.tobytes()

    n_streams = 1 + (pcm is not None)
    max_jpeg = max(len(j) for j in jpegs)

    def strh(kind: bytes, handler: bytes, scale: int, rate: int, length: int,
             sample_size: int) -> bytes:
        return _chunk(b"strh", struct.pack(
            "<4s4sIHHIIIIIIIIhhhh", kind, handler, 0, 0, 0, 0,
            scale, rate, 0, length, max_jpeg, 0xFFFFFFFF, sample_size,
            0, 0, w, h))

    vids = _list(b"strl", strh(b"vids", b"MJPG", 1, fps, len(jpegs), 0)
                 + _chunk(b"strf", struct.pack(
                     "<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                     w * h * 3, 0, 0, 0, 0)))
    streams = [vids]
    if pcm is not None:
        block = 2  # mono int16
        auds = _list(b"strl", strh(b"auds", b"\x00\x00\x00\x00", block,
                                   sample_rate * block, len(pcm) // block,
                                   block)
                     + _chunk(b"strf", struct.pack(
                         "<HHIIHH", 1, 1, sample_rate, sample_rate * block,
                         block, 16)))
        streams.append(auds)

    avih = _chunk(b"avih", struct.pack(
        "<IIIIIIIIIIIIII", 1_000_000 // fps, 0, 0, 0x10, len(jpegs), 0,
        n_streams, max_jpeg, w, h, 0, 0, 0, 0))
    hdrl = _list(b"hdrl", avih + b"".join(streams))

    samples_per_frame = (len(pcm) // 2 // len(jpegs) + 1) if pcm else 0
    movi = []
    movi_len = 0
    idx = []
    apos = 0
    for i, j in enumerate(jpegs):
        idx.append(struct.pack("<4sIII", b"00dc", 0x10, movi_len + 4,
                               len(j)))
        movi.append(_chunk(b"00dc", j))
        movi_len += len(movi[-1])
        if pcm is not None:
            nxt = min((i + 1) * samples_per_frame * 2, len(pcm))
            seg = pcm[apos:nxt]
            apos = nxt
            if seg:
                idx.append(struct.pack("<4sIII", b"01wb", 0x10,
                                       movi_len + 4, len(seg)))
                movi.append(_chunk(b"01wb", seg))
                movi_len += len(movi[-1])
    riff = _chunk(b"RIFF", b"AVI " + hdrl + _list(b"movi", b"".join(movi))
                  + _chunk(b"idx1", b"".join(idx)))
    with open(path, "wb") as f:
        f.write(riff)
    return path


def read_avi_info(path: str) -> dict:
    """Parse the AVI header back: frame count, fps, size, stream count and
    the video chunks in the ``movi`` list."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not an AVI file")
    i = data.index(b"avih") + 8
    (usec, _, _, _, n_frames, _, n_streams, _, w, h) = struct.unpack(
        "<IIIIIIIIII", data[i:i + 40])
    movi = data[:data.index(b"idx1")] if b"idx1" in data else data
    return {"n_frames": n_frames, "fps": round(1_000_000 / usec),
            "width": w, "height": h, "n_streams": n_streams,
            "n_video_chunks": movi.count(b"00dc")}
