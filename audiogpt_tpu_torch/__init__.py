"""audiogpt_tpu_torch — the PyTorch/CUDA port of ``audiogpt_tpu`` for an
NVIDIA H100.

The JAX package stays the reference; this package grows beside it slice by
slice and imports nothing from it (nor JAX). Plain tensor code is PyTorch;
each Pallas kernel of the JAX package is a CUDA C++ kernel written for
Hopper (``csrc/``), built with ``nvcc`` at first use (``ops/_build.py``) and
launched through a wrapper that keeps a plain PyTorch version beside it.
Engines run on the card unless the caller passes ``device="cpu"``.

Ported so far: the T2A engine (``engines/t2a.py``): the ranked
text-to-audio call and inpainting, with the CLAP text tower and scorer
(Cnn14 audio tower, ``dsp/`` log-mel frontend), UNet, VAE, samplers and the
BigVGAN vocoder (f32 or bf16); the ASR engine (``engines/asr.py``):
whisper with its KV-cache decode and fallback ladder, the BPE
detokenizer (``text/``), wav I/O with resampling (``utils/audio_io.py``)
and ``BatchedASR`` (``serving/``); the TTS engine (``engines/tts.py``): the
English frontend (``text/``), FastSpeech2 and HiFi-GAN, with
``BatchedTTS``; every ``VocoderEngine`` kind (HiFi-GAN with NSF, BigVGAN,
PWG, MelGAN) and ``denoise``; the I2A engine (``engines/i2a.py``: CLIP
ViT-H/14 on the T2A engine's sampler); the image tools (``engines/t2i.py``,
SD-1.x text-to-image; ``ImageCaptionEngine``, BLIP); the audio analysis
tools (``engines/analysis.py``: the Cnn14 + GRU captioner, sound-event
detection with PANN or the PVT net, target-sound detection) and transform
tools (``engines/transform.py``: LASSNet extraction, Conv-TasNet or SkiM
enhancement and separation, binaural rendering); and the agent
(``agent/``: tools, LLM clients, the ReAct loop, the toolset over these
engines) served over HTTP (``serving/server.py``, ``app.py``, ``python -m
audiogpt_tpu_torch.serve``); and training (``train/``, ``data/``,
``config.py``, ``python -m audiogpt_tpu_torch.train_cli``): the trainer
substrate, the T2A latent-diffusion recipe, and the TTS pipeline: the
binarizer, the token-budget loader, FastSpeech2 and the HiFi-GAN GAN.
"""

__version__ = "0.1.0"
