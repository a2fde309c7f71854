"""Default toolset — ConversationBot parity.

Copy of ``audiogpt_tpu/agent/toolset.py:1-318`` over the port's engines, which
it takes by duck typing: a tool registers only when its engine key is in
the dict, so the tools of engines not ported yet are absent. A file at
another rate than the engine's is resampled on the engine's device. The
reference hand-wires 17 text-mode / 9 speech-mode LangChain tools in
``ConversationBot.init_tools`` (``audio-chatgpt.py:1075-1186``). This module
builds the same registry (same tool names, same string-path I/O surface) from
this framework's engines. Engines are passed in explicitly — nothing loads
lazily behind a global (the reference's global-hparams reentrancy bug,
``audio-chatgpt.py:286-291``, stays fixed).

Engine-key → reference tool mapping:

  t2a        → "Generate Audio From User Input Text" (T2A:140) + "Audio
               Inpainting" (Inpaint:418)
  i2a        → "Generate Audio From The Image" (I2A:214); any callable
               ``(image_path) -> wav`` works (the CLIP-conditioned engine)
  tts        → "Synthesize Speech Given the User Input Text" (TTS:275)
  tts_ood    → "Style Transfer" (TTS_OOD:383, GenerSpeech)
  svs        → "Generate Singing Voice From User Input Text, Note and
               Duration Sequence" (T2S:298)
  asr        → "Transcribe Speech" (ASR:560)
  caption    → "Generate Text From The Audio" (A2T:578)
  sed        → "Detect The Sound Event From The Audio" (SoundDetection:612)
  tsd        → "Target Sound Detection" (TargetSoundDetection:775)
  extraction → "Extract Sound Event From Mixture Audio Based On Language
               Description" (SoundExtraction:675)
  enhance    → "Speech Enhancement In Single-Channel" (Speech_Enh_SS_SC:957)
  separate   → "Speech Separation In Single-Channel" (Speech_SS:1009)
  binaural   → "Sythesize Binaural Audio From A Mono Audio Input"
               (Binaural:713; reference's spelling preserved)
  t2i / i2t  → image tools (reference: external StableDiffusion/BLIP —
               pass callables; not part of the audio framework)
  geneface   → "Generate a talking human portrait video given a input
               Audio" (GeneFace:589; ``engines/face.py`` ``GeneFaceEngine``:
               the audio path → ``video/<file>.avi`` under the media root)
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from audiogpt_tpu_torch.agent.tools import (Tool, ToolRegistry, merge_audio,
                                            new_media_path)
from audiogpt_tpu_torch.utils.audio_io import load_wav, save_wav
from audiogpt_tpu_torch.utils.media import resolve_media


#: the SVS tool's song when its input does not parse: the toneless pinyin
#: form of the reference's default score (audio-chatgpt.py:323-329) as
#: (text, notes, durations), 14 words and 4.04 s of notes
DEFAULT_SONG = (
    "ni shuo ni bu SP dong wei he zai zhe shi qian shou AP",
    "D#4/Eb4 | D#4/Eb4 | D#4/Eb4 | D#4/Eb4 | rest | D#4/Eb4 | "
    "D4 | D4 | D4 | D#4/Eb4 | F4 | D#4/Eb4 | D4 | rest",
    "0.113740 | 0.329060 | 0.287950 | 0.133480 | 0.150900 | "
    "0.484730 | 0.242010 | 0.180820 | 0.343570 | 0.152050 | "
    "0.266720 | 0.280310 | 0.633300 | 0.444590")


def _load(path: str, sr: int, engine: Any, root: str) -> np.ndarray:
    """The file that ``path`` names under the media root ``root``
    (``utils/media.py``: a path that resolves outside it raises
    ``ValueError``) at ``sr``, resampled on ``engine``'s device (the card
    when it names none)."""
    wav, _ = load_wav(resolve_media(path, root), sr=sr,
                      device=getattr(engine, "device", None))
    return wav


def _save(wav: np.ndarray, sr: int, root: str) -> str:
    path = new_media_path("audio", root=root)
    save_wav(np.asarray(wav), path, sr)
    return path


def build_toolset(engines: Mapping[str, Any], root: str = ".",
                  mode: str = "text") -> ToolRegistry:
    """``mode``: 'text' (17 tools) or 'speech' (9 tools) — the reference's
    ``init_tools(interaction_type)`` split (``audio-chatgpt.py:1075,1153``)."""
    reg = ToolRegistry()
    e = engines

    def add(key, name, description, fn, media_kind="audio",
            modes=("text",)):
        if mode in modes and key in e:
            reg.add(Tool(name, description, fn, media_kind=media_kind,
                         media_root=root))

    # ---- generation ------------------------------------------------------
    if "t2a" in e:
        def t2a_fn(text: str) -> str:
            eng = e["t2a"]
            cfg = eng.cfg
            if hasattr(eng, "txt2audio_best"):
                # sample + vocode + CLAP best-of-3 in ONE device roundtrip
                _, wav, _ = eng.txt2audio_best(text)
                if wav is None:
                    raise ValueError("t2a tool requires a vocoder-equipped "
                                     "T2AEngine")
                return _save(wav, cfg.sample_rate, root)
            mels, wavs = eng.txt2audio(
                text, sampler=getattr(cfg, "tool_sampler", "ddim"),
                ddim_steps=getattr(cfg, "tool_steps", 100))
            best = eng.select_best(text, wavs) \
                if hasattr(eng, "select_best") else 0
            return _save(wavs[best], cfg.sample_rate, root)
    add("t2a", "Generate Audio From User Input Text",
        "useful for when you want to generate an audio from a user input "
        "text and it saved it to a file. The input to this tool should be "
        "a string, representing the text used to generate audio.",
        t2a_fn if "t2a" in e else None, modes=("text", "speech"))

    if "tts" in e:
        def tts_fn(text: str) -> str:
            wav = e["tts"](text)
            return _save(wav, e["tts"].sample_rate, root)
    add("tts", "Synthesize Speech Given the User Input Text",
        "useful for when you want to convert a user input text into speech "
        "audio it saved it to a file. The input to this tool should be a "
        "string, representing the text used to be converted to speech.",
        tts_fn if "tts" in e else None, modes=("text", "speech"))

    if "tts_ood" in e:
        def tts_ood_fn(inputs: str) -> str:
            ref_path, text = [s.strip() for s in inputs.split(",", 1)]
            wav = e["tts_ood"].synthesize(text, _load(
                ref_path, e["tts_ood"].sample_rate, e["tts_ood"], root))
            return _save(wav, e["tts_ood"].sample_rate, root)
    add("tts_ood", "Style Transfer",
        "useful for when you want to generate speech samples with styles "
        "(e.g., timbre, emotion, and prosody) derived from a reference "
        "custom voice. The input to this tool should be a comma seperated "
        "string of two, representing reference audio path and input text.",
        tts_ood_fn if "tts_ood" in e else None, modes=("text", "speech"))

    if "svs" in e:
        def svs_fn(inputs: str) -> str:
            # reference falls back to a default song on any parse error
            # (audio-chatgpt.py:323-329) — same contract, explicit here
            default = DEFAULT_SONG
            try:
                text, notes, durs = [s.strip() for s in inputs.split(",", 2)]
                if not (text and notes and durs):
                    raise ValueError("empty field")
            except ValueError:
                text, notes, durs = default
            try:
                wav = e["svs"].synthesize(text, notes, durs)
            except (ValueError, KeyError):
                wav = e["svs"].synthesize(*default)
            return _save(wav, e["svs"].sample_rate, root)
    add("svs", "Generate Singing Voice From User Input Text, Note and "
               "Duration Sequence",
        "useful for when you want to generate a piece of singing voice "
        "(Optional: from User Input Text, Note and Duration Sequence) and "
        "save it to a file. The input to this tool should be a comma "
        "seperated string of three, representing text, note and duration "
        "sequence; or \"\" for the default song.",
        svs_fn if "svs" in e else None, modes=("text", "speech"))

    if "i2a" in e:
        def i2a_fn(image_path: str) -> str:
            image = resolve_media(image_path, root)
            wav, sr = e["i2a"](image) if callable(e["i2a"]) \
                else e["i2a"].img2audio(image)
            return _save(wav, sr, root)
    add("i2a", "Generate Audio From The Image",
        "useful for when you want to generate an audio based on an image. "
        "The input to this tool should be a string, representing the "
        "image_path.",
        i2a_fn if "i2a" in e else None, modes=("text",))

    if "inpaint" in e or "t2a" in e:
        eng = e.get("inpaint", e.get("t2a"))

        def inpaint_fn(inputs: str) -> str:
            parts = [s.strip() for s in inputs.split(",")]
            path = parts[0]
            t0, t1 = (float(parts[1]), float(parts[2])) if len(parts) >= 3 \
                else (1.0, 3.0)
            wav = _load(path, eng.cfg.sample_rate, eng, root)
            fps = eng.cfg.sample_rate / eng.cfg.hop
            frames = eng.cfg.inpaint_mel_len
            mask = np.ones(frames, np.float32)       # 1 = keep
            mask[int(t0 * fps): int(t1 * fps)] = 0.0  # regenerate this span
            out = eng.inpaint(wav, mask)
            return _save(out, eng.cfg.sample_rate, root)

        if mode == "text":
            reg.add(Tool("Audio Inpainting",
                         "useful for when you want to inpaint a mel "
                         "spectrogram of an audio and predict this masked "
                         "content. The input should be a comma separated "
                         "string of audio path and the start/end seconds to "
                         "regenerate.",
                         inpaint_fn, media_kind="audio"))

    # ---- understanding ---------------------------------------------------
    if "asr" in e:
        def asr_fn(path: str) -> str:
            wav = _load(path, 16000, e["asr"], root)
            return e["asr"].transcribe(wav) if hasattr(e["asr"], "transcribe") \
                else str(e["asr"].transcribe_tokens(wav)[0].tolist())
    add("asr", "Transcribe Speech",
        "useful for when you want to know the text corresponding to a human "
        "speech, receives audio_path as input. The input to this tool "
        "should be a string, representing the audio_path.",
        asr_fn if "asr" in e else None, media_kind="text", modes=("text",))

    if "caption" in e:
        def caption_fn(path: str) -> str:
            return e["caption"].caption(_load(path, e["caption"].sr,
                                                e["caption"], root))
    add("caption", "Generate Text From The Audio",
        "useful for when you want to describe an audio in text, receives "
        "audio_path as input. The input to this tool should be a string, "
        "representing the audio_path.",
        caption_fn if "caption" in e else None, media_kind="text",
        modes=("text", "speech"))

    if "sed" in e:
        def sed_fn(path: str) -> str:
            # reference returns an image artifact (audio-chatgpt.py:658-673)
            wav = _load(path, e["sed"].cfg.sample_rate, e["sed"], root)
            out = new_media_path("image", ext="png", root=root)
            return e["sed"].plot(wav, out)
    add("sed", "Detect The Sound Event From The Audio",
        "useful for when you want to know what event in the audio and the "
        "sound event start or end time, this tool will generate an image of "
        "all predict events, receives audio_path as input. The input to "
        "this tool should be a string, representing the audio_path.",
        sed_fn if "sed" in e else None, media_kind="image", modes=("text",))

    if "tsd" in e:
        def tsd_fn(inputs: str) -> str:
            path, text = [s.strip() for s in inputs.split(",", 1)]
            spans = e["tsd"].detect(_load(path, e["tsd"].mel.sr, e["tsd"],
                                          root),
                                    text)
            if not spans:
                return f"no occurrence of '{text}' detected"
            return "; ".join(f"({s:.2f}s, {t:.2f}s)" for s, t in spans)
    add("tsd", "Target Sound Detection",
        "useful for when you want to know when the target sound event in "
        "the audio happens. The input to this tool should be a comma "
        "seperated string of two, representing audio path and the text "
        "description of the target sound.",
        tsd_fn if "tsd" in e else None, media_kind="text",
        modes=("text", "speech"))

    # ---- transformation --------------------------------------------------
    if "extraction" in e:
        def extraction_fn(inputs: str) -> str:
            path, text = [s.strip() for s in inputs.split(",", 1)]
            out = e["extraction"].extract(
                _load(path, e["extraction"].sr, e["extraction"], root),
                text)
            return _save(out, e["extraction"].sr, root)
    add("extraction", "Extract Sound Event From Mixture Audio Based On "
                      "Language Description",
        "useful for when you extract target sound from a mixture audio, you "
        "can describe the target sound by text. The input to this tool "
        "should be a comma seperated string of two, representing mixture "
        "audio path and input text.",
        extraction_fn if "extraction" in e else None,
        modes=("text", "speech"))

    if "enhance" in e:
        def enhance_fn(path: str) -> str:
            sr = e["enhance"].cfg.sample_rate
            out = e["enhance"].enhance(_load(path, sr, e["enhance"], root))
            return _save(out, sr, root)
    add("enhance", "Speech Enhancement In Single-Channel",
        "useful for when you want to enhance the quality of the speech "
        "signal by reducing background noise (single-channel), receives "
        "audio_path as input. The input to this tool should be a string, "
        "representing the audio_path.",
        enhance_fn if "enhance" in e else None, modes=("text",))

    if "separate" in e:
        def separate_fn(path: str) -> str:
            sr = e["separate"].cfg.sample_rate
            stems = e["separate"].separate(_load(path, sr, e["separate"],
                                                  root))
            paths = [_save(s, sr, root) for s in stems]
            return merge_audio(paths[0], paths[1], root=root,
                               device=getattr(e["separate"], "device",
                                              None)) \
                if len(paths) > 1 else paths[0]
    add("separate", "Speech Separation In Single-Channel",
        "useful for when you want to separate each speech from the speech "
        "mixture, receives audio_path as input. The input to this tool "
        "should be a string, representing the audio_path.",
        separate_fn if "separate" in e else None, modes=("text",))

    if "binaural" in e:
        def binaural_fn(path: str) -> str:
            sr = e["binaural"].cfg.sample_rate
            stereo = e["binaural"].binauralize(_load(path, sr,
                                                     e["binaural"], root))
            out = new_media_path("audio", root=root)
            save_wav(stereo.T, out, sr)
            return out
        name = ("Sythesize Binaural Audio From A Mono Audio Input"
                if mode == "text" else
                "Generate Binaural Audio From A Mono Audio Input")
        reg.add(Tool(name,
                     "useful for when you want to transfer your mono audio "
                     "into binaural audio, receives audio_path as input. "
                     "The input to this tool should be a string, "
                     "representing the audio_path.",
                     binaural_fn, media_kind="audio", media_root=root))

    # ---- external / video (callables only) -------------------------------
    for key, name, desc, kind, modes_ in (
        ("t2i", "Generate Image From User Input Text",
         "useful for when you want to generate an image from a user input "
         "text and it saved it to a file. The input to this tool should be "
         "a string, representing the text used to generate image.",
         "image", ("text",)),
        ("i2t", "Get Photo Description",
         "useful for when you want to know what is inside the photo. "
         "receives image_path as input. The input to this tool should be a "
         "string, representing the image_path.",
         "text", ("text",)),
        ("geneface", "Generate a talking human portrait video given a input "
                     "Audio",
         "useful for when you want to generate a talking human portrait "
         "video given a input audio. The input to this tool should be a "
         "string, representing the audio_path.",
         "video", ("text", "speech")),
    ):
        if key in e and mode in modes_:
            reg.add(Tool(name, desc, e[key], media_kind=kind,
                         media_root=root))

    return reg
