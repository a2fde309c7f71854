"""One-shot inference CLI: the reference's per-model ``__main__`` demos
(``NeuralSeq/inference/svs/ds_e2e.py:50``, ``inference/tts/*.py``) as one
entry point over the app's engine factories, on the card. Counterpart of
``audiogpt_tpu/infer_cli.py``:

    python -m audiogpt_tpu_torch.infer_cli --engine tts --text "here we go" \\
        --out out.wav
    python -m audiogpt_tpu_torch.infer_cli --engine svs \\
        --text "xiao jiu wo" --notes "C#4/Db4 | F#4/Gb4 | G#4/Ab4" \\
        --notes_duration "0.4 | 0.37 | 0.24" --out sing.wav
    python -m audiogpt_tpu_torch.infer_cli --engine t2a --text "a dog barks" \\
        --params params/t2a --out dog.wav
    python -m audiogpt_tpu_torch.infer_cli --engine asr --in speech.wav
    python -m audiogpt_tpu_torch.infer_cli --engine enhance --in noisy.wav \\
        --out clean.wav

``--params`` loads a tree written by ``import_ckpt`` or a trainer
checkpoint (``<work_dir>/ckpt/<step>.pt``) through the engine's
``load_params``. Only the requested engine is built, on ``--device`` (the
card by default). ``t2a`` samples one candidate with PLMS-25;
``asr`` / ``caption`` resample the input to 16 / 32 kHz on the device
(``dsp/resample.py``); ``tts_ood`` reads its reference voice from
``--in`` (the JAX CLI calls the engine without one, which its engine
does not take). An engine without a mapping exits with 2.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    from audiogpt_tpu_torch.app import ALL_ENGINES, build_engines
    from audiogpt_tpu_torch.import_ckpt import restore_weights
    from audiogpt_tpu_torch.utils.audio_io import load_wav, save_wav

    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", required=True,
                    help=f"one of {', '.join(ALL_ENGINES)}")
    ap.add_argument("--text", default=None)
    ap.add_argument("--notes", default=None)
    ap.add_argument("--notes_duration", default=None)
    ap.add_argument("--in", dest="in_path", default=None, help="input wav")
    ap.add_argument("--out", default="out.wav")
    ap.add_argument("--params", default=None,
                    help="import_ckpt output or a trainer checkpoint")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    name = args.engine
    eng = build_engines([name], device=args.device)[name]
    if args.params:
        eng.load_params(restore_weights(args.params))

    if name in ("svs", "visinger"):
        wav = eng.synthesize(args.text, args.notes, args.notes_duration)
        save_wav(wav, args.out, eng.sample_rate)
    elif name in ("tts", "tts_portaspeech", "syntaspeech"):
        save_wav(eng(args.text), args.out, eng.sample_rate)
    elif name == "tts_ood":
        ref, _ = load_wav(args.in_path, sr=eng.sample_rate,
                          device=eng.device)
        save_wav(eng.synthesize(args.text, ref), args.out, eng.sample_rate)
    elif name == "t2a":
        res = eng.txt2audio(args.text, n_samples=1, ddim_steps=25,
                            sampler="plms")
        if isinstance(res, tuple):
            save_wav(res[1][0], args.out, eng.cfg.sample_rate)
        else:
            path = args.out.replace(".wav", ".npy")
            np.save(path, res[0])
            print(f"| no vocoder attached; wrote mel to {path}")
    elif name in ("asr", "caption"):
        wav, _ = load_wav(args.in_path, sr=16000 if name == "asr" else 32000,
                          device=eng.device)
        print(eng.transcribe(wav) if name == "asr" else eng.caption(wav))
        return 0
    elif name in ("enhance", "separate"):
        wav, sr = load_wav(args.in_path)
        out = np.atleast_2d(eng.separate(wav))
        for i, stem in enumerate(out):
            path = args.out if out.shape[0] == 1 else \
                args.out.replace(".wav", f"_{i}.wav")
            save_wav(stem, path, sr)
            print(f"| wrote {path}")
        return 0
    else:
        print(f"engine {name!r} has no CLI mapping yet; use the python API",
              file=sys.stderr)
        return 2
    print(f"| wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
