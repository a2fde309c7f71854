"""Application assembly: build the engine set and launch the chat app.

Counterpart of ``audiogpt_tpu/app.py:1-362``, with every engine factory
of the JAX app (19: ``tts``, ``tts_portaspeech``, ``syntaspeech``,
``tts_ood``, ``svs``, ``visinger``, ``asr``, ``t2a``, ``i2a``, ``t2i``,
``i2t``, ``caption``, ``sed``, ``tsd``, ``extraction``, ``enhance``,
``separate``, ``binaural``, ``geneface``). Engines are built per requested
capability with seeded random weights (no checkpoint is loaded yet), on
the card. ``--ckpt ENGINE=PATH`` loads weights into an engine: a tree that
``import_ckpt`` wrote or a trainer checkpoint (``<work_dir>/ckpt/<step>.pt``),
through the engine's one weight entry (``engines/base.py``
``ParamsEntry.load_params``); ``--ckpt t2i_refiner=DIR`` builds the T2I
prompt refiner from a ``gpt2``-family tree and the GPT-2 vocab in the same
directory. ``--vocab ENGINE=PATH`` wires a tokenizer vocab. Unlike the JAX
app's, the ``tts_ood`` engine has a vocoder (the TTS engine's HiFi-GAN), so
the Style Transfer tool writes audio. The JAX app's ``--compile-cache`` (an
XLA cache) has no counterpart.

CLI:  python -m audiogpt_tpu_torch.serve --engines t2a,asr,tts,i2a,t2i,i2t \
          --asr-fast
      python -m audiogpt_tpu_torch.serve \
          --engines caption,sed,tsd,extraction,enhance,separate,binaural
      python -m audiogpt_tpu_torch.serve --engines tts,svs,tts_ood
      python -m audiogpt_tpu_torch.serve \
          --engines geneface,tts_portaspeech,syntaspeech
      python -m audiogpt_tpu_torch.serve --engines tts,t2i \
          --ckpt tts=params/fs2 --ckpt t2i_refiner=params/magicprompt \
          --vocab t2a=vocab.txt
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Mapping

#: capability name → factory of one keyword, ``device`` (None: the card).
#: Lazy so `--engines tts` doesn't build the diffusion stack. Extend via
#: register_engine().
_FACTORIES: dict[str, Callable[[], Any]] = {}


def register_engine(name: str):
    def deco(fn):
        _FACTORIES[name] = fn
        return fn

    return deco


@register_engine("tts")
def _tts(device=None):
    from audiogpt_tpu_torch.engines.tts import TTSEngine

    return TTSEngine(device=device)


@register_engine("tts_portaspeech")
def _tts_portaspeech(device=None):
    from audiogpt_tpu_torch.engines.tts import PortaSpeechTTSEngine

    return PortaSpeechTTSEngine(device=device)


@register_engine("syntaspeech")
def _syntaspeech(device=None):
    from audiogpt_tpu_torch.engines.tts import PortaSpeechTTSEngine
    from audiogpt_tpu_torch.models.tts import PortaSpeechConfig

    return PortaSpeechTTSEngine(cfg=PortaSpeechConfig(use_graph=True),
                                device=device)


@register_engine("tts_ood")
def _tts_ood(device=None):
    from audiogpt_tpu_torch.engines.tts_ood import StyleTransferEngine
    from audiogpt_tpu_torch.engines.vocoder import VocoderEngine

    return StyleTransferEngine(
        vocoder=VocoderEngine("hifigan", device=device), device=device)


@register_engine("svs")
def _svs(device=None):
    from audiogpt_tpu_torch.engines.svs import SVSEngine
    from audiogpt_tpu_torch.engines.vocoder import VocoderEngine

    return SVSEngine(vocoder=VocoderEngine("hifigan", device=device),
                     device=device)


@register_engine("visinger")
def _visinger(device=None):
    from audiogpt_tpu_torch.engines.svs import VISingerEngine

    return VISingerEngine(device=device)


@register_engine("asr")
def _asr(device=None):
    from audiogpt_tpu_torch.engines.asr import ASREngine

    return ASREngine(device=device)


@register_engine("t2a")
def _t2a(device=None):
    from audiogpt_tpu_torch.engines.t2a import T2AEngine
    from audiogpt_tpu_torch.engines.vocoder import VocoderEngine
    from audiogpt_tpu_torch.models.textenc.clap import CLAPScorer

    # buckets = the two diffusion canvases (10 s generation + inpaint)
    return T2AEngine(vocoder=VocoderEngine("bigvgan", buckets=(624, 848),
                                           device=device),
                     scorer=CLAPScorer(sample_rate=16000, device=device),
                     device=device)


@register_engine("i2a")
def _i2a(device=None):
    from audiogpt_tpu_torch.engines.i2a import I2AEngine

    return I2AEngine(_FACTORIES["t2a"](device=device), device=device)


@register_engine("t2i")
def _t2i(device=None):
    from audiogpt_tpu_torch.engines.t2i import T2IEngine

    return T2IEngine(device=device)


@register_engine("i2t")
def _i2t(device=None):
    from audiogpt_tpu_torch.engines.analysis import ImageCaptionEngine

    return ImageCaptionEngine(device=device)


@register_engine("caption")
def _caption(device=None):
    from audiogpt_tpu_torch.engines.analysis import CaptionEngine

    return CaptionEngine(device=device)


@register_engine("sed")
def _sed(device=None):
    from audiogpt_tpu_torch.engines.analysis import SEDEngine

    return SEDEngine(device=device)


@register_engine("tsd")
def _tsd(device=None):
    from audiogpt_tpu_torch.engines.analysis import TSDEngine

    return TSDEngine(device=device)


@register_engine("extraction")
def _extraction(device=None):
    from audiogpt_tpu_torch.engines.transform import ExtractionEngine

    return ExtractionEngine(device=device)


@register_engine("enhance")
def _enhance(device=None):
    from audiogpt_tpu_torch.engines.transform import SeparationEngine
    from audiogpt_tpu_torch.models.separation import ConvTasNetConfig

    return SeparationEngine(ConvTasNetConfig(n_src=1), device=device)


@register_engine("separate")
def _separate(device=None):
    from audiogpt_tpu_torch.engines.transform import SeparationEngine
    from audiogpt_tpu_torch.models.separation import ConvTasNetConfig

    return SeparationEngine(ConvTasNetConfig(n_src=2), device=device)


@register_engine("binaural")
def _binaural(device=None):
    from audiogpt_tpu_torch.engines.transform import BinauralEngine

    return BinauralEngine(device=device)


@register_engine("geneface")
def _geneface(device=None):
    from audiogpt_tpu_torch.engines.face import GeneFaceEngine

    return GeneFaceEngine(device=device)


ALL_ENGINES = tuple(sorted(_FACTORIES))


def build_engines(names: Mapping[str, Any] | list[str] | str = "all",
                  device=None) -> dict[str, Any]:
    """Build engines by capability name on ``device`` (None: the card).
    ``names`` may be 'all', a list, or a mapping name→already-constructed
    engine (passed through)."""
    if isinstance(names, str):
        names = list(ALL_ENGINES) if names == "all" else \
            [n.strip() for n in names.split(",") if n.strip()]
    if isinstance(names, Mapping):
        return dict(names)
    out: dict[str, Any] = {}
    for n in names:
        if n not in _FACTORIES:
            raise KeyError(f"unknown engine {n!r}; have {ALL_ENGINES}")
        out[n] = _FACTORIES[n](device=device)
    return out


def load_engine_ckpts(engines: Mapping[str, Any], specs: list[str]) -> None:
    """Apply ``ENGINE=PATH`` checkpoint specs to built engines: ``PATH`` is
    a tree that ``import_ckpt`` wrote or a trainer checkpoint
    (``import_ckpt.restore_weights``), loaded by the engine's
    ``load_params``. The name ``t2i_refiner`` builds the MagicPrompt GPT-2
    prompt refiner (``audio-chatgpt.py:112-125``) from a ``gpt2``-family
    tree in the directory ``PATH`` and the vocab files beside it, on the
    T2I engine's device. An engine that is not enabled is a
    ``SystemExit``."""
    from audiogpt_tpu_torch.import_ckpt import restore_params, restore_weights

    for spec in specs:
        name, _, path = spec.partition("=")
        if name == "t2i_refiner":
            if "t2i" not in engines:
                raise SystemExit(f"--ckpt {spec}: t2i engine not enabled")
            from audiogpt_tpu_torch.models.textenc.gpt2 import (
                GPT2Config, MagicPromptRefiner)
            from audiogpt_tpu_torch.text.bpe import load_bpe_dir

            tree = restore_params(path)
            engines["t2i"].text_refiner = MagicPromptRefiner(
                GPT2Config.from_tree(tree), params=tree,
                codec=load_bpe_dir(path), device=engines["t2i"].device)
            print(f"| loaded t2i prompt refiner from {path}", flush=True)
            continue
        if name not in engines:
            raise SystemExit(f"--ckpt {spec}: engine {name!r} not enabled")
        engines[name].load_params(restore_weights(path))
        print(f"| loaded {name} params from {path}", flush=True)


def load_engine_vocabs(engines: Mapping[str, Any], specs: list[str]) -> None:
    """Apply ``ENGINE=PATH`` vocab specs. By the artifact: ``set_vocab``
    where the engine has one (ASR: a whisper BPE dir or file), else ``.txt``
    → a BERT WordPiece vocab (the CLAP, BLIP, TSD and LASSNet towers),
    ``.gz`` → CLIP merges, anything else → a GPT-2-family BPE dir. The
    tokenizer also goes to an attached CLAP scorer (T2A's best-of-n
    ranking tokenizes through ``scorer.tokenizer``). An engine that is not
    enabled, or takes no vocab, is a ``SystemExit``."""
    for spec in specs:
        name, _, path = spec.partition("=")
        if name not in engines:
            raise SystemExit(f"--vocab {spec}: engine {name!r} not enabled")
        eng = engines[name]
        if hasattr(eng, "set_vocab"):
            eng.set_vocab(path)
        elif hasattr(eng, "tokenizer"):
            if path.endswith(".txt"):
                from audiogpt_tpu_torch.models.textenc.clap import \
                    WordPieceTokenizer

                eng.tokenizer = WordPieceTokenizer(path)
            elif path.endswith(".gz"):
                from audiogpt_tpu_torch.text.bpe import ClipTokenizer

                eng.tokenizer = ClipTokenizer(path)
            else:
                from audiogpt_tpu_torch.text.bpe import load_bpe_dir

                eng.tokenizer = load_bpe_dir(path)
        else:
            raise SystemExit(f"--vocab {spec}: engine {name!r} takes no vocab")
        scorer = getattr(eng, "scorer", None)
        if (scorer is not None and hasattr(scorer, "tokenizer")
                and hasattr(eng, "tokenizer")):
            scorer.tokenizer = eng.tokenizer
        print(f"| loaded {name} vocab from {path}", flush=True)


def speech_callables(engines: Mapping[str, Any], media_root: str):
    """The speech loop's ``(asr, tts)`` callables over ``engines`` (each
    ``None`` without its engine): ``asr(path)`` → transcript of the file
    loaded at 16 kHz on the ASR engine's device; ``tts(text)`` → the path
    of the spoken reply under ``media_root``."""
    from audiogpt_tpu_torch.agent.tools import new_media_path
    from audiogpt_tpu_torch.utils.audio_io import load_wav, save_wav

    asr_fn = tts_fn = None
    if "asr" in engines:
        def asr_fn(path):
            eng = engines["asr"]
            wav, _ = load_wav(path, sr=16000, device=eng.device)
            return eng.transcribe(wav)
    if "tts" in engines:
        def tts_fn(text):
            eng = engines["tts"]
            out = new_media_path("audio", root=media_root)
            save_wav(eng(text), out, eng.sample_rate)
            return out
    return asr_fn, tts_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--engines", default="t2a,asr,tts",
                    help=f"comma list or 'all' of {ALL_ENGINES}")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--media-root", default=".")
    ap.add_argument("--llm-base-url", default=None,
                    help="OpenAI-compatible endpoint; scripted echo otherwise")
    ap.add_argument("--llm-model", default="gpt-3.5-turbo")
    ap.add_argument("--llm-api-key", default=None)
    ap.add_argument("--warmup", action="store_true",
                    help="run each engine's warmup (every bucket once) "
                         "before accepting traffic")
    ap.add_argument("--microbatch", type=float, default=None, metavar="MS",
                    help="enable cross-request micro-batching for the tts "
                         "and asr engines with the given linger window in "
                         "ms. Coalescing happens when multiple sessions "
                         "(AppServers) share engine objects — within ONE "
                         "chat conversation the agent turn is serialized, "
                         "so requests reach the batcher one at a time and "
                         "the flag only adds the linger window")
    ap.add_argument("--asr-fast", action="store_true",
                    help="single-pass ASR decode (temperatures=(0.0,)): "
                         "skips whisper's temperature-fallback ladder. Use "
                         "for demos on random/untrained weights, where "
                         "every decode fails the trained-model logprob bar "
                         "by construction and the default ladder pays all "
                         "6 rungs per speech turn")
    ap.add_argument("--ckpt", action="append", default=[],
                    metavar="ENGINE=PATH",
                    help="load weights into an engine: an import_ckpt tree "
                         "or a trainer checkpoint (<work_dir>/ckpt/<step>.pt)"
                         ", e.g. --ckpt tts=params/fs2; t2i_refiner=DIR "
                         "builds the T2I prompt refiner (repeatable)")
    ap.add_argument("--vocab", action="append", default=[],
                    metavar="ENGINE=PATH",
                    help="wire a tokenizer vocab into an engine: whisper "
                         "BPE dir/tiktoken file for asr, BERT vocab.txt "
                         "for t2a/tsd/extraction/i2t towers, CLIP merges "
                         ".gz for t2i (t2i already bundles one) "
                         "(repeatable)")
    args = ap.parse_args(argv)

    from audiogpt_tpu_torch.serving import AppServer, make_server

    if args.llm_base_url:
        from audiogpt_tpu_torch.agent.llm import OpenAICompatLLM

        llm = OpenAICompatLLM(base_url=args.llm_base_url,
                              model=args.llm_model,
                              api_key=args.llm_api_key or "")
    else:
        from audiogpt_tpu_torch.agent.llm import ScriptedLLM

        llm = ScriptedLLM([])  # echo/demo mode: always answers directly
    engines = build_engines(args.engines)
    if args.asr_fast and "asr" in engines:
        engines["asr"].temperatures = (0.0,)
    load_engine_ckpts(engines, args.ckpt)
    load_engine_vocabs(engines, args.vocab)
    if args.microbatch is not None:
        from audiogpt_tpu_torch.serving.batcher import BatchedASR, BatchedTTS

        if "tts" in engines:
            engines["tts"] = BatchedTTS(engines["tts"],
                                        window_ms=args.microbatch)
        if "asr" in engines:
            engines["asr"] = BatchedASR(engines["asr"],
                                        window_ms=args.microbatch)
    asr_fn, tts_fn = speech_callables(engines, args.media_root)
    app = AppServer(llm, engines, media_root=args.media_root,
                    asr=asr_fn, tts=tts_fn)
    if args.warmup:
        for name, eng in engines.items():
            if hasattr(eng, "warmup"):
                print(f"| warmup: {name}", flush=True)
                # on the thread the requests' engine calls will run on
                app.run_on_engine_thread(eng.warmup)
    httpd = make_server(app, args.host, args.port)
    print(f"| serving {sorted(app.engines)} on http://{args.host}:{args.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
