#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``audiogpt_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. probe: CUDA must be present; the card's name and power limit; TF32 off.
2. build: ``nvcc`` compiles ``audiogpt_tpu_torch/csrc/*.cu`` for sm_90a;
   ptxas' registers and spills per flash kernel instance, and its warnings;
   ``cuobjdump -sass`` must show HGMMA (``wgmma``) and no HMMA in both
   flash kernels, HGMMA TF32 in the f32 one.
3. flash_attention: both entries (f32, bf16) against their plain versions at
   the T2A UNet shape, the three inpaint shapes (level-0 self- and
   cross-attention, level-1 self-attention at D = 80), whisper-base's
   encoder shape at batch 1 and 4, the I2A call's CLIP ViT-H/14 shape
   [1, 257, 16, 80] and UNet shape [2, 780, 8, 40], the T2I call's five
   UNet shapes (self- and cross-attention at ds 1 and 2, [2, 256, 8, 160]
   at ds 4), BLIP-base's [1, 577, 12, 64], PVT SED's five (one head,
   Tq >> Tk: [1, 6400, 100, 1, 64] and [1, 1600, 100, 2, 64] at 10 s,
   three more at 32 s), and two more (a key
   mask, causal); kernel, plain and ``scaled_dot_product_attention`` (same
   dtype) times; the grid's blocks and waves; bounds at the route's rate
   (3xTF32 or bf16 tensor cores) and at the f32 FMA rate.
4. snake_aa: both entries against the plain up → snake → down chain at the
   four BigVGAN stage shapes of the T2A call (624 frames, batch 3), the
   inpaint call (848 frames, batch 1) and the I2A call (624 frames, batch
   1); kernel, plain and ``x.clone()`` times.
5. main_path: the JAX app's engine, ``T2AEngine(T2AConfig(),
   vocoder=VocoderEngine("bigvgan", buckets=(624, 848)),
   scorer=CLAPScorer(sample_rate=16000))``, at full width with seeded
   random weights runs ``txt2audio_best`` (3 candidates,
   DPM-Solver++(2M)-12, CFG, CLAP best-of-3); the launch counters show that
   it went through both kernels; the scores must be finite and not all
   equal, and the wav must be the argmax candidate of an unranked
   ``txt2audio`` at the same seed; the median and the slowest of 10 warm
   calls are reported (host clock, each call ending in a synchronise).
6. main_path_bf16: the same weights in ``T2AConfig(unet_bf16=True)``: the
   flash kernel's bf16 entry on the same ranked call, its counts, warm
   median and the mel's distance from the f32 call's.
7. inpaint: the agent tool's call (``agent/toolset.py``'s ``inpaint_fn``) on
   the main path's winning wav: regenerate 1.0–3.0 s of the 848-frame
   canvas with DDIM-100 at scale 1; launch counts derived from the configs;
   cold time, warm median of 3, peak memory, RTF; one traced call (device
   busy share) and the time of each layer.
8. vocoder_bf16: ``VocoderEngine(bf16=True)`` with the f32 vocoder's weights
   on the main path's three candidate mels: snake-AA's bf16 entry only, the
   SNR against the f32 wav, warm times of both vocoders.
9. small_reference: a narrow engine and scorer on the card against the same
   on the CPU (plain versions), same weights and draws: the sampler → VAE →
   vocoder core, the ranked core and the inpaint core.
10. profile: one warm main-path call under ``torch.profiler`` (device time
   by kernel; the device's busy share of the traced call and of the
   untraced warm median), then the time of each layer (text tower, sampler,
   VAE decode, vocoder, CLAP ranking) between CUDA events, and the host's
   time to queue the sampler, median of 5 runs.
11. asr: the agent's "Transcribe Speech" tool at whisper-base width
   (``ASREngine(WhisperConfig())``, seeded random weights): a 30 s seeded
   speech-like signal written as a 44.1 kHz wav, loaded with
   ``load_wav(path, 16000)`` and transcribed with ``temperatures=(0.0,)``;
   cold and warm (median of 5) times, RTF, peak memory, one call of the
   six-rung fallback ladder, one ``return_segments`` call, one
   ``detect_language`` (encoder + prime only); flash launches checked
   against 6 per encoder pass; then the layer times (mel, encoder, prime,
   decode per token), the launches per decode step and one traced call.
12. asr_long: a 60 s clip, three windows in one batch of 4, warm median of
   3.
13. asr_bf16: ``ASREngine(bf16=True)`` with the same weights: K1's bf16
   entry, warm median of 3, the encoder output's distance from the f32
   one.
14. asr_batched: ``BatchedASR`` with 4 concurrent calls riding one decode.
15. asr_small_reference: a narrow whisper on the card (its encoder takes
   K1) against the same weights on the CPU.
16. tts: the agent's "Synthesize Speech" tool at the app's width
   (``TTSEngine()``: FastSpeech2 hidden 256, 4 + 4 layers, ``max_frames``
   1024; HiFi-GAN V1; seeded random weights, the duration predictor's
   output set to ≈ 6 frames a phone) on a 113-phone sentence: the fused
   pass (FS2 on the 128 bucket, HiFi-GAN on the whole canvas, int16, the
   valid samples copied); neither kernel may launch; cold and warm
   (median of 10) times, RTF, set-up, peak memory, device launches per
   call; the layer times (``tts_stages``) and one traced call
   (``tts_profile``).
17. tts_long: ``synthesize_long`` on a 446-phone text (two chunks, each
   overrunning the canvas, whose tail is cut as in JAX).
18. tts_batched: ``BatchedTTS`` with 4 concurrent requests (one batch of 4)
   against the 4 texts as single calls.
19. tts_vocoders: ``VocoderEngine`` kinds ``hifigan`` with NSF, ``pwg`` and
   ``melgan`` at default widths on the 1024-frame canvas; the NSF source
   on the card against the CPU; ``denoise`` of the TTS wav.
20. tts_small_reference: a narrow FS2 + HiFi-GAN on the card against the
   same weights on the CPU.
21. i2a: the agent's "Generate Audio From The Image" tool at full width:
   ``I2AEngine`` (CLIP ViT-H/14, seeded random weights) on the main path's
   T2A engine, one seeded 224 × 224 PNG by path, DDIM-100 at scale 3; K1
   at [1, 257, 16, 80] (32 per image) and [2, 780, 8, 40] (500), K2 73,
   all derived from the configs; the embedding's norm; cold and warm
   (median of 3) times, RTF, set-up, peak memory; the time of each layer
   (``i2a_stages``).
22. i2a_small_reference: a narrow CLIP (257 tokens) and T2A engine on the
   card against the same weights and draws on the CPU.
23. t2i: the agent's "Generate Image From User Input Text" tool at full
   width: ``T2IEngine(T2IConfig())`` (the SD-1.x UNet, the f8 RGB VAE at
   512 × 512, CLIP ViT-L/14's text tower; seeded random weights), text →
   PNG path with DDIM-50 at scale 7.5 and the CFG pair; K1 1 250 a call
   (250 at D = 160), by shape, K2 none; cold and warm (median of 3) times,
   set-up, peak memory; the layer times (``t2i_stages``) and one traced
   call (``t2i_profile``: the device's busy share).
24. t2i_bf16: the same weights under ``unet_bf16``: the same 1 250 on K1's
   bf16 entry, and the image's distance from the f32 engine's.
25. t2i_small_reference: a narrow T2I engine (D = 40, 80, 160) on the card
   against the same weights on the CPU.
26. i2t: the agent's "Get Photo Description" tool at BLIP-base width
   (``ImageCaptionEngine()``, seeded random weights) on a seeded 512 × 512
   PNG by path: K1 12 a call at [1, 577, 12, 64]; cold and warm (median
   of 5) times, set-up, peak memory; the decode per token and the
   launches of one decode step (``i2t_stages``).
27. i2t_small_reference: a narrow BLIP (577 tokens) on the card against the
   same weights on the CPU, equal greedy tokens.
28. sed: the agent's "Detect The Sound Event From The Audio" tool at the
   app's width (``SEDEngine()``: PANN-SED, Cnn14 2048 wide) on a 10 s
   seeded events clip: ``framewise``, ``detect`` and ``plot`` (the PNG
   drawn with PIL), cold and warm (median of 5), set-up, peak memory,
   RTF, neither kernel; ``sed_stages`` (the net, the copy, the figure's
   data, its drawing and PNG write).
29. caption: "Generate Text From The Audio" (``CaptionEngine()``: Cnn14,
   a bidirectional GRU of 512, a 2-layer decoder over 4 981 words) on the
   events clip, greedy and beam-3; neither kernel; ``caption_stages``
   (Cnn14, GRU, decode per position, launches per position).
30. tsd: "Target Sound Detection" (``TSDEngine()`` with BERT-base's CLAP
   text tower) at 22.05 kHz with a text query; the split between the
   text tower and the TSD net; neither kernel.
31. extraction: "Extract Sound Event From Mixture Audio Based On Language
   Description" (``ExtractionEngine()``: LASSNet) at 32 kHz; the split
   between STFT, BERT-mini, U-Net and iSTFT; neither kernel.
32. sed_pvt, sed_pvt_32s: ``SEDEngine(model=PVTSED(PVTConfig()))``, the
   reference's PVT net, on a 10 s and a 32 s clip: K1 launches by
   recorded shape equal to the config's (7 and 13), no K2; K1's time in
   the call.
33. enhance, separate, separate_skim: ``SeparationEngine`` with
   Conv-TasNet at ``n_src`` 1 and 2 and with ``SkiM()`` on a 10 s
   speech-like clip at 16 kHz (11 chunks in one batch of 16); neither
   kernel.
34. binaural: ``BinauralEngine()`` at 48 kHz on 10 s (10 chunks); the
   time a chunk; neither kernel.
35. analysis_small_reference, transform_small_reference: narrow nets on
   the card against the same weights on the CPU: caption ids, SED, PVT
   (K1 taken), TSD spans; LASSNet, Conv-TasNet, SkiM, binaural.
36. svs: the "Generate Singing Voice" tool at the app's width
   (``SVSEngine(vocoder=VocoderEngine("hifigan"))``: DiffSinger, FS2-MIDI
   256 wide on the 2048-frame canvas, DiffNet 20 × 256, PLMS-10 over
   K_step 1000 = 101 DiffNet evals; HiFi-GAN V1) on the toolset's default
   song (26 phones, the duration head set to ≈ 13 frames a phone); cold,
   warm (median of 3), RTF against the valid seconds, set-up, peak
   memory, neither kernel; ``svs_stages`` (FS2, the PLMS loop and the
   host's time to queue it, one DiffNet eval between events and over a
   CUDA graph, the vocoder) and ``svs_profile`` (device-only trace).
37. visinger: ``VISingerEngine()`` (24 kHz, ``max_frames`` 1024) on the
   same song, frames from the note durations; neither kernel.
38. tts_ood, tts_ood_10s_ref: the Style Transfer tool at the app's width
   (``StyleTransferEngine(vocoder=VocoderEngine("hifigan"))``: GenerSpeech
   with the Glow post-flow, every layer filled, the 1×1s orthogonal) on
   the TTS sentence with a 5 s and a 10 s (cut to 512 frames) speech-like
   reference at 22.05 kHz; neither kernel; ``tts_ood_stages`` (style
   encoders, the FS2 body with the aligners, the Glow reverse, the
   vocoder).
39. speech_small_reference: narrow DiffSinger (DDPM over 8 cosine steps,
   replayed draws), the pitch extractor, FS2's ``cwt`` branch, VISinger
   and GenerSpeech (mel and wav) on the card against the CPU.
40. geneface: the agent's last tool, "Generate a talking human portrait
   video given a input Audio", at the app's width (``GeneFaceEngine()``:
   Audio2Motion hidden 256, latent 16, 3 conv layers; the 256 × 256
   landmark warp at 25 fps) on a 10 s seeded speech-like clip at 16 kHz
   named relative to the media root: 626 mel frames on the 1024 bucket,
   an MJPEG AVI of 250 frames with the audio muxed in, read back; cold,
   warm (median of 3), RTF, set-up, peak memory, neither kernel;
   ``geneface_stages`` (mel, motion, warp, the frames' copy, the AVI
   write and its JPEG encodes).
41. htsat: ``CLAPScorer(audio_tower="htsat", sample_rate=16000)``
   (HTSAT-tiny: a 256² image, embed 96, depths (2, 2, 6, 2), ``d_proj``
   1024) scoring three seeded 10 s clips: the tower's ms a batch of 3,
   its FLOPs against the f32 bound, its device launches; neither kernel.
42. t2a_htsat: the main path's ``txt2audio_best`` with the HTSAT scorer in
   place of the PANN one: K1 65 and K2 73, as on the main path; the
   winner the argmax of an unranked call's HTSAT scores; warm median of
   3, RTF.
43. tts_portaspeech, syntaspeech: ``PortaSpeechTTSEngine()`` and with
   ``PortaSpeechConfig(use_graph=True)`` (the app's factories; HiFi-GAN
   V1) on the TTS sentence, the duration head set to ≈ 6 frames a phone;
   cold, warm (median of 3), RTF against the valid seconds, set-up, peak
   memory, neither kernel; ``*_stages`` (encoders, prior flow, FVAE
   decoder, vocoder).
44. face_small_reference: narrow Audio2Motion and warp, HTSAT (256²)
   and SyntaSpeech on the card against the same weights and draws on the
   CPU.
45. served: the agent behind ``AppServer`` and ``make_server`` on
   127.0.0.1 with the engines above passed as a mapping: one HTTP
   ``/chat`` turn per tool (t2a, inpaint, asr, tts, i2a, t2i, i2t on
   the PNG the t2i turn wrote, caption, sed with its PNG fetched from
   ``/media/``, tsd, extraction, enhance, separate, binaural, svs on the
   default song, tts_ood on the 10 s reference, its file mono at
   22 050 Hz, geneface on a clip named relative to the media root, its
   AVI fetched from ``/media/`` as ``video/x-msvideo``), a
   ``/speech`` turn, ``/stats``, one ``/tts/stream``; each turn's wall
   time and launches, equal to the direct call's; and what a warm T2A
   call costs as the first call of a new thread
   (``served_thread_cost``). The app must have all 19 factories of the
   JAX app.
46. train_ldm: training on the card. ``configs/t2a/ldm.yaml`` read by the
   port's ``load_config`` at its full widths (UNet 320 channels, mult
   (1, 2), 8 heads, context 1024; VAE ch 128, mult (1, 2, 2, 4); the
   default CLAP text tower; batch 16, width 624) with
   ``model.bf16_compute=false``, on a fixture of 64 seeded records written
   by the port's ``RecordWriter`` (mel [624, 80] in [0, 1], BERT ids),
   driven through ``train_cli.build_task``, ``build_loaders`` and
   ``Trainer.fit`` for 20 steps: the trainable and frozen parameter counts,
   the median step time over the steady steps (each step ends in the
   metrics' copy to the host), samples/s, peak memory, K1 launches a step
   by shape (5 at [16, 780, 780, 8, 40]) and K2's (0), the mean loss of
   the first and last 10 steps (it must fall), MFU and the step's bound.
47. train_ldm_bf16: the same with the yaml's ``bf16_compute: true`` (the
   UNet in bf16 on f32 masters): K1's bf16 entry.
48. train_grad_check: one full-width batch, forward and backward, with K1
   and with the plain attention path forced: the UNet's gradients agree
   within 1e-4 of their largest (f32, TF32 off); ``FlashAttention``'s dq,
   dk and dv at [16, 780, 8, 40] in f32 and bf16 against the plain
   version's autograd, the recompute's time per step and SDPA's backward.
49. train_resume: a tiny config with a valid split (sanity and periodic
   validation on the card) stops after a checkpoint; a second ``fit`` on
   the same work dir continues at the saved step, with the saved params.
50. binarize_tts: a seeded LJSpeech-like corpus (256 items of 1.5–10 s
   at 22 050 Hz, ARPAbet phones with durations summing to each item's
   frames, voiced phones on a moving f0) through the port's
   ``TTSBinarizer`` with ``with_wav`` and ``with_f0`` (mel and f0 on the
   card), and 64 of its items with ``with_f0cwt``: items/s, the mel's and
   the f0's device time over the corpus, the f0 against the pitch each
   item was made with and against a 220 Hz sine, the phone set's ids
   against FS2's ``vocab_size``.
51. train_fs2: ``configs/tts/fs2.yaml`` at its full widths on those
   records through ``train_cli.build_task`` / ``build_loaders`` (30 000
   tokens, 100 sentences, the 128–2048 × 8–64 ladder) and
   ``Trainer.fit``, 40 steps and a validation at the last: the median
   step time over steps whose batch shape was seen before (the first of
   each shape counts its FLOPs), the count of shapes, valid mel
   frames/s, MFU at the f32 FMA peak, peak memory, neither kernel, the
   loss falling, no non-finite step, the validation figure's PNG; then,
   on the run's largest batch, what a step allocates at its peak (a warm
   step and one under ``FlopCounterMode``, the allocator's sites live at
   the peak), the tensors a forward saves for the backward, and each
   ``Conv1d`` alone at its input with what it asks beyond its tensors.
52. train_fs2_cwt: ``configs/tts/fs2_cwt.yaml`` on the CWT split, 10
   steps: the ``cwt``, ``uv``, ``f0_mean`` and ``f0_std`` terms finite.
53. train_vocoder_gan: ``configs/vocoder/hifigan.yaml`` at full width
   (HiFi-GAN V1; MPD + MSD), batch 16 × 32 frames, 30 steps of ``disc``
   then ``gen``: each group's step time, peak memory, ``d_loss``,
   ``g_mel`` falling, both groups' parameters moved, neither kernel.
54. train_tts_small_reference: the CPU tests' tiny FS2, vocoder-GAN,
   PortaSpeech (graph off and on), ``ps_adv``, GenerSpeech and pitch
   extractor tasks on the card and on the CPU with the same draws: each
   group's losses within 1e-5 relative, gradients within 1e-4 of each
   tensor's largest.
55. binarize_tts_words: a seeded fixture of 128 LJSpeech-like items with
   text (1.5–10 s, durations over the port's frontend phones) through
   ``TTSBinarizer`` with ``with_f0``, ``with_words`` and ``with_graph``,
   and 64 of them with emotion tags through ``EmotionBinarizer`` with
   ``with_style_embed``: items/s, the phone and word sets and the emotion
   map against the configs' vocab sizes.
56. train_portaspeech: ``configs/tts/portaspeech.yaml`` at full width on
   the word split, 30 steps and a validation at the last: parameters,
   shapes, the median step time at seen shapes, valid frames/s, MFU, peak
   memory, ``mel``, ``ssim``, ``kl_v``, ``kl``, ``wdur`` over the first
   and last 10 steps (the total falling, ``kl`` on its ramp), neither
   kernel, the figure; each ``Conv1d`` alone on the largest batch.
57. train_syntaspeech: ``syntaspeech.yaml`` with the word graphs, 10
   steps, every term finite.
58. train_ps_adv: ``ps_adv.yaml``, 20 steps of ``disc`` then ``model``:
   each group's step alone, ``d_loss``, ``adv``, both groups moved.
59. train_generspeech: ``generspeech.yaml`` at full width on the emotion
   split, 20 steps: step time, peak, MFU, ``mel`` first and last,
   ``commit``, ``guided``, ``postflow`` finite; each ``Conv1d`` alone.
60. train_pe: ``pe.yaml``, 20 steps, its warm-up cut to 100: ``f0`` and
   ``uv`` falling.
61. binarize_svs: a seeded sung corpus in Opencpop's score format (128
   items of 2–5 s at 24 kHz, under 512 frames at hop 256: pinyin words,
   note names with slurs and rests, note durations; voiced tones at the
   notes' pitches) through
   ``SVSBinarizer`` at ``opencpop.yaml``'s mel (hop 128), a second pass at
   hop 256 with the wav for VISinger plus the fixture's linear spec (n_fft
   1024, 513 bins, on the mel's frames), and a seeded Mandarin corpus
   through ``ZhBinarizer``: items/s, the phone and note counts.
62. train_diffsinger: ``configs/svs/diffsinger.yaml`` at full width (K_step
   1000, FS2-MIDI 256 wide with ``rel_pos``, DiffNet 20 × 256), 12 steps:
   step time, MFU, peak, shapes, ``diff`` and ``pdur`` first and last.
63. train_visinger: ``configs/svs/visinger.yaml`` at full width, 4 steps
   of ``disc`` then ``model`` at ``data.max_tokens`` 1 500 (the decoder
   and both critics see the whole F · 256 wav; the yaml's 30 000 does not
   fit): each group's step alone, the peak, both groups moved.
64. train_audio2motion: ``configs/face/audio2motion.yaml`` at full width
   (512 mel frames → 204 video frames, batch 16) on the TTS fixture's
   mels and their pseudo-targets, 12 steps.
65. train_vae: ``configs/t2a/vae.yaml`` at full width (ch 128, ch_mult
   1-2-2-4, batch 8, 624 frames) on ``train_ldm``'s mel images, 8 steps
   of ``disc`` then ``model``: each group's step alone, the peak.
66. train_clap: ``configs/t2a/clap.yaml`` at full width (BERT-base, Cnn14,
   ``d_proj`` 1024, batch 32 of 10 s at 16 kHz, 77 tokens), 8 steps:
   step time, MFU, ``acc``, ``scale``, Cnn14's BatchNorm buffers unmoved.
67. train_svs_small_reference: the CPU tests' tiny DiffSinger (pitch
   embedding off and on), VISinger (both groups), Audio2Motion, VAE (both
   groups) and CLAP tasks on the card and on the CPU with the same
   weights, batch and draws, all in f32: losses within 1e-6 relative,
   gradients within 5e-5 of each tensor's largest. CLAP's Cnn14 holds the
   running statistics of one forward on the batch, so its embeddings are
   not collinear (their cosines are printed).
68. train_sed: ``configs/sed/panns.yaml`` at full width (PANN-SED on
   Cnn14, 527 classes), batch 32 of 10 s at 32 kHz on seeded tagged
   clips, mixup drawn on the card, 6 steps: step time, MFU, peak,
   ``clip_bce`` first and last, neither kernel, the BatchNorm buffers
   unmoved.
69. train_caption: ``configs/caption/cnn14rnn.yaml`` (Cnn14, the
   bidirectional GRU of 512 on cuDNN under autograd, a 2-layer decoder
   over 4 981 words), batch 32, 22 tokens, 6 steps.
70. train_separation: ``configs/separation/convtasnet.yaml`` (two
   sources, 512/128/512 × 8 × 3), batch 8 of 4 s mixtures at 16 kHz of
   two speech-like sources, PIT SI-SNR, 8 steps.
71. train_analysis_small_reference: the CPU tests' tiny SED (mixup's λ
   and permutation replayed), caption and Conv-TasNet (one and two
   sources) tasks on the card and on the CPU, f32: losses within 1e-6
   relative, gradients within 5e-5.
72. import_cli: synthetic reference ``.ckpt`` files at full width for
   ``hifigan`` and ``bigvgan`` through ``python -m
   audiogpt_tpu_torch.import_ckpt`` in two subprocesses, loaded into
   engines by ``app.load_engine_ckpts``: the vocoded wav equals the
   engine's with the tree loaded directly; the import seconds and the
   files' sizes; ``infer_cli --engine separate --params`` on the weights
   ``train_separation`` exported, through the app's own factory: its
   stems equal a directly loaded engine's within one int16 step;
   ``infer_cli`` for ``tts``, ``enhance`` and ``t2a`` on the app's
   engines of the earlier phases, ``t2a``'s K1 and K2 launches
   (PLMS-25 with CFG: 125 and 73) against the configs'.
73. gpt2_refiner: the refiner's LM at GPT-2 small's width on a 16-token
   prompt with 40 new tokens: wall times, prefill, ms per decode token,
   device launches per decode step, K1 launches (0: a 16-token prefill
   is under 256² pairs); at a tiny config the card's greedy ids equal the
   CPU's.
74. train_ldm_bf16_ckpt: ``train_ldm_bf16`` with ``model.unet.use_checkpoint``
   (each block recomputed in the backward on the bf16 parameters of its
   forward): step time, peak, K1 launches a step (10 at [16, 780, 780, 8,
   40]: the five level-0 attentions' forwards and their recomputes).
75. train_portaspeech_spk: ``configs/tts/portaspeech.yaml`` with
   ``model.num_spk`` 400 on 48 word-level items of 16 speakers binarized
   with their ids, 10 steps: step time, peak, neither kernel; the speaker
   table's gradient non-zero exactly on the rows of one batch's speakers.
76. t5: FLAN-T5-large's text tower at full width (seeded, HF-named) through
   ``python -m audiogpt_tpu_torch.import_ckpt --family t5``, loaded into
   ``T5Conditioner`` with a ``spiece.model`` written from the bundled
   WordPiece vocabulary: 8 prompts at 77 tokens, cold and warm (CUDA
   events), K1 0, peak, FLOPs and the bound; the first prompt's row is
   within 4× the CPU's own f32 error of a float64 CPU encode.
77. t5_vq_small_reference: a tiny T5 conditioner and GenerSpeech's EMA
   quantizer (two training calls: the ``vq_ema`` path of the ``kernels``
   line, no launch) on the card and on the CPU, TF32 off.
78. train_ddp_ldm: ``configs/t2a/ldm.yaml`` at full width through
   ``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
   audiogpt_tpu_torch.train_cli`` (one rank on NCCL, TF32 off by
   ``NVIDIA_TF32_OVERRIDE=0``) on ``train_ldm``'s records, 8 steps: each
   step's loss against ``train_ldm``'s (the same seed, in process, no
   group) within 1e-6 relative, both step times, the flat gradient
   all-reduce's time a step (CUDA events; 160.2 M × 4 B), both peaks, K1's
   launches (5 a step at [16, 780, 780, 8, 40], from the run's report).
79. train_ddp_gloo_small: two processes on the one card over gloo (NCCL
   refuses two ranks on one GPU), each on half of every batch of a tiny
   LDM task (level 0 at 256 tokens: K1 on both ranks) and a tiny FS2
   task, 3 steps, against one process on the whole batch: losses within
   1e-6 relative, the first step's gradients and the updated parameters
   within 5e-5 of each tensor's largest, the ranks' parameters equal;
   each rank's K1 launches.
80. t2a_mesh (after profile): the main path's weights in ``T2AEngine(...,
   mesh=device_mesh(["cuda:0", "cuda:0"]))``, two replicas of the one card
   with their own streams: ``txt2audio_best`` with the tool's sampler, n = 3
   rounded up to 4; each replica's K1 (65 at [4, 780, 780, 8, 40]) and K2
   (73 at batch 2) launches by stream, against the one-replica engine at
   n = 4 and the same seed (``MESH_TOL``); both warm walls.
81. t2i_mesh (after t2i_bf16): the T2I phase's weights on two replicas of
   the card, ``txt2img`` at 512² with n = 2, DDIM-10 (cut from the tool's
   DDIM-50 for the time limit): K1 250 a replica (50 at each of five
   shapes), the images against the one-replica engine's; both warm walls.

The ``unet_bf16`` engine of phase 6 also inpaints (``inpaint_unet_bf16``):
its f32 UNet gives the f32 engine's wav with the same draws.

Before the last line: ``{"kernels": [...]}`` (each kernel with every path
that launches it: its launches and per-call times) and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``. Times are
measured with CUDA events after a warmup: a kernel's ``ms`` (and the
library call's and the copy's) over a CUDA graph of 50 launches, the device
time alone; ``ms_events`` over 50 launches from Python, host cost included,
as ``plain_ms`` is; bounds use the H100 SXM peaks
(3.35 TB/s; 495 TFLOP/s TF32 and 989 bf16 on the tensor cores, 67 TFLOP/s
f32 without them).
"""

from __future__ import annotations

import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from collections import Counter
from pathlib import Path

from audiogpt_tpu_torch.utils.flops import (BF16_FLOPS, F32_FLOPS,
                                           HBM_BYTES_PER_S, TF32_FLOPS)

ROOT = Path(__file__).resolve().parent
#: the f32 flash entry does three TF32 products per product (3xTF32)
FLASH_FLOPS = {"float32": TF32_FLOPS / 3, "bfloat16": BF16_FLOPS}
CLIP_SECONDS = 624 * 256 / 16000      # T2AConfig.mel_len · hop / sample_rate
INPAINT_SECONDS = 848 * 256 / 16000   # T2AConfig.inpaint_mel_len · hop / sr
TEXT = "a dog barks in the rain"
WARM_CALLS = 10                       # warm main-path calls timed
INPAINT_WARM_CALLS = 3                # warm inpaint calls timed
STAGE_RUNS = 5                        # per-layer timings, median taken
ASR_SECONDS = 30.0                    # whisper's window: RTF is against it
ASR_WARM_CALLS = 5                    # warm ASR tool calls timed
ASR_LONG_WARM_CALLS = 3               # warm 60 s calls timed
ASR_BF16_WARM_CALLS = 3               # warm bf16 ASR calls timed
#: the TTS tool's sentence: 113 phones (token bucket 128)
TTS_TEXT = ("The quick brown fox jumps over the lazy dog near the old river "
            "bank, while the children sing songs about the long summer days.")
#: 446 phones: two clause chunks (205 and 242 phones) in the 256 bucket
TTS_LONG_TEXT = (
    "Once upon a time, in a small village at the edge of a great forest, "
    "there lived an old clockmaker and his daughter. Every morning, before "
    "the sun had risen over the hills, the clockmaker would open his shop, "
    "light the lamps, and wind each of the hundred clocks that hung upon the "
    "walls. The daughter swept the floor, fed the cat, and listened to the "
    "ticking, which she said sounded like rain on the roof; and when the "
    "bells of the church rang at noon, every clock in the shop answered "
    "them at once.")
TTS_BATCH_TEXTS = (TTS_TEXT,
                   "Hello, how can I help you with your audio today?",
                   "The weather will be sunny with a light breeze.",
                   "Please speak after the tone, then wait for the reply.")
TTS_WARM_CALLS = 10                   # warm TTS tool calls timed
I2A_STEPS = 100                       # the I2A tool's DDIM steps
I2A_WARM_CALLS = 3                    # warm I2A tool calls timed
#: the T2I tool's prompt; its call is DDIM-50 at scale 7.5
T2I_TEXT = "a watercolor painting of a lighthouse on a cliff at dawn"
T2I_STEPS = 50
T2I_WARM_CALLS = 3                    # warm T2I tool calls timed
I2T_WARM_CALLS = 5                    # warm I2T tool calls timed
#: the audio analysis and transform tools' clip, and PVT's long clip (its
#: largest bucket)
TOOL_SECONDS, PVT_LONG_SECONDS = 10.0, 32.0
TOOL_WARM_CALLS = 5                   # warm calls of each of those tools
TSD_TEXT = "a dog barking"            # the TSD tool's query
EXTRACT_TEXT = "a dog barking"        # the extraction tool's query
#: the duration predictor's output layer: its weights scaled by 0.25 and
#: its bias 1.9, so round(exp(d) − 1) ≈ 6 frames a phone (untouched random
#: weights round most phones to 0 frames)
TTS_DUR_SCALE, TTS_DUR_BIAS = 0.25, 1.9
#: DiffSinger's duration head: ≈ 13.4 frames a phone (exp(2.67) − 1), so
#: the default song's 26 phones get about its 4.04 s of notes (348 frames)
SVS_DUR_SCALE, SVS_DUR_BIAS = 0.25, 2.67
SVS_WARM_CALLS = 3                    # warm SVS, VISinger, Style Transfer
FACE_SECONDS = 10.0                   # the GeneFace clip: 626 mel frames
FACE_WARM_CALLS = 3                   # warm GeneFace, HTSAT-ranked T2A,
                                      # PortaSpeech and SyntaSpeech calls
#: PortaSpeech's duration head (softplus frames a phone, summed per word):
#: its weights scaled by 0.25 and its bias softplus⁻¹(6), ≈ 6 frames a
#: phone (untouched random weights give ≈ 0.7)
PS_DUR_SCALE, PS_PHONE_FRAMES = 0.25, 6.0
#: the mesh phases: two replicas on the one card (a mesh that names it
#: twice); T2A's n = 3 rounds up to 4, 2 rows a replica; T2I's n = 2, one
#: image a replica, with the sampler cut from DDIM-50 to DDIM-10
MESH_REPLICAS, MESH_N, MESH_ROWS = 2, 3, 2
T2I_MESH_N, T2I_MESH_STEPS = 2, 10
MESH_WARM_CALLS = 3
#: two replicas against one at the same seed and rounded n: each replica
#: runs its rows at half the batch, and cuBLAS / cuDNN may pick other
#: algorithms (another summation order) at another batch, TF32 off
MESH_TOL = {"mel": 1e-3, "wav": 1e-3, "scores": 1e-4, "image": 1e-3}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3, graph: bool = False) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls between CUDA
    events. With ``graph`` the calls are captured in one CUDA graph and the
    replay is timed: the device time alone, without the host's cost of each
    launch (which exceeds a 20 µs kernel's own time when the launches come
    from Python). Without, the host's launch rate is part of the time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    if graph:
        run()
    else:
        for _ in range(iters):
            run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float,
             rate: float = F32_FLOPS) -> tuple[float, str]:
    """The least time for ``n_bytes`` of device memory traffic and ``flops``
    at ``rate``, and which of the two sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / rate
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


#: the flash kernels' function names in the SASS and ptxas' report
FLASH_KERNELS = {"flash_fwd_sm90_f32": "float32", "flash_fwd_sm90": "bfloat16"}
#: a flash kernel's name as it stands, mangled, before its template
#: arguments (``flash_fwd_sm90_f32ILi40ELi3EE``)
FLASH_KERNEL_RE = re.compile(r"(flash_fwd_sm90(?:_f32)?)I((?:Li\d+E)+)")


def tensor_core_sass(lib: Path) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each flash kernel's SASS
    (``flash_fwd_sm90_f32``: the f32 entry's, ``flash_fwd_sm90``: the bf16
    entry's), counted by opcode from ``cuobjdump -sass``; → {dtype name:
    {opcode: count}}."""
    from audiogpt_tpu_torch.ops import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts: dict = {dtype: {} for dtype in FLASH_KERNELS.values()}
    kernel = None
    for line in sass.splitlines():
        if "Function :" in line:
            m = FLASH_KERNEL_RE.search(line)
            kernel = m and FLASH_KERNELS[m.group(1)]
        elif kernel and (m := re.search(r"\b(HGMMA|HMMA)[\w.]*", line)):
            counts[kernel][m.group(0)] = counts[kernel].get(m.group(0), 0) + 1
    return counts


def ptxas_report(log: str) -> dict:
    """ptxas' registers and spill stores of each flash kernel instance,
    named by its template arguments (``flash_fwd_sm90<48, 2>``: head dim
    48, two consumer warpgroups)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = FLASH_KERNEL_RE.search(line)
            name = m and (f"{m.group(1)}<"
                          + ", ".join(re.findall(r"Li(\d+)E", m.group(2)))
                          + ">")
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            out.setdefault(name, {})["spill_stores"] = int(m.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def phase_build() -> None:
    from audiogpt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    log = (_build.BUILD_DIR / "build.log").read_text()
    ptxas = [line.strip() for line in log.splitlines()
             if "entry function" in line or "registers" in line
             or "spill" in line]
    warnings = sorted({line.strip() for line in log.splitlines()
                       if "warning" in line.lower()
                       or "performance loss" in line.lower()})
    sass = tensor_core_sass(lib)
    emit({"phase": "build", "seconds": seconds, "library": lib.name,
          "ptxas": ptxas, "ptxas_warnings": warnings,
          "flash_instances": ptxas_report(log),
          "flash_sass_tensor_core": sass})
    bf16, f32 = sass["bfloat16"], sass["float32"]
    if not any(op.startswith("HGMMA") for op in bf16) or any(
            op.startswith("HMMA") for op in bf16):
        raise AssertionError(f"the bf16 flash kernel's SASS: {bf16}")
    if not any(op.startswith("HGMMA") and "TF32" in op for op in f32) or any(
            op.startswith("HMMA") for op in f32):
        raise AssertionError(f"the f32 flash kernel's SASS: {f32}")


#: bf16 kernel vs bf16 plain version: both round the output to bf16 (2^-7
#: of the value) and p to bf16 at other points (2^-9 of each weight)
BF16_FLASH_TOL = (1e-2, 2 ** -7)          # absolute, relative


#: flash cases: name → ((B, Tq, Tk, H, D), key lengths or None, causal). The
#: T2A UNet's level-0 self-attention; the inpaint call's level-0 self- and
#: cross-attention (77 keys: one partial key tile) and level-1
#: self-attention (D = 80); whisper-base's encoder self-attention for one
#: 30 s window and for the 4-window batch of a 60 s clip; the I2A call's
#: CLIP ViT-H/14 self-attention (257 tokens, D = 80) and its UNet's level-0
#: self-attention (the CFG pair of one candidate); the T2I call's UNet at
#: 512 x 512 (64 x 64 latents, the CFG pair): self- and cross-attention (77
#: CLIP tokens) at ds 1 and 2, self-attention at ds 4 (D = 160); BLIP-base's
#: vision self-attention (577 tokens); PVT SED's spatial-reduction attention
#: (one head at stage 0, Tq >> Tk, 100 or 200 keys) on a 10 s clip (stages
#: 0, 1) and a 32 s clip (stages 0-2); the LDM recipe's training step at
#: batch 16 (level-0 self-attention); a replica's level 0 in ``t2a_mesh``
#: (2 of 4 candidates and their CFG pair); one rank's level 0 of
#: ``train_ddp_gloo_small``'s tiny LDM; the key-mask and causal code no path
#: reaches
FLASH_CASES = {
    "unet_level0": ((6, 780, 780, 8, 40), None, False),
    "inpaint_self_l0": ((1, 1060, 1060, 8, 40), None, False),
    "inpaint_cross_l0": ((1, 1060, 77, 8, 40), None, False),
    "inpaint_self_l1": ((1, 265, 265, 8, 80), None, False),
    "asr_encoder": ((1, 1500, 1500, 8, 64), None, False),
    "asr_long_encoder": ((4, 1500, 1500, 8, 64), None, False),
    "clip_vision": ((1, 257, 257, 16, 80), None, False),
    "i2a_unet_level0": ((2, 780, 780, 8, 40), None, False),
    "t2i_self_ds1": ((2, 4096, 4096, 8, 40), None, False),
    "t2i_cross_ds1": ((2, 4096, 77, 8, 40), None, False),
    "t2i_self_ds2": ((2, 1024, 1024, 8, 80), None, False),
    "t2i_cross_ds2": ((2, 1024, 77, 8, 80), None, False),
    "t2i_self_ds4": ((2, 256, 256, 8, 160), None, False),
    "blip_vision": ((1, 577, 577, 12, 64), None, False),
    "pvt_s0_10s": ((1, 6400, 100, 1, 64), None, False),
    "pvt_s1_10s": ((1, 1600, 100, 2, 64), None, False),
    "pvt_s0_32s": ((1, 12800, 200, 1, 64), None, False),
    "pvt_s1_32s": ((1, 3200, 200, 2, 64), None, False),
    "pvt_s2_32s": ((1, 800, 200, 5, 64), None, False),
    "train_level0": ((16, 780, 780, 8, 40), None, False),
    "t2a_mesh_level0": ((4, 780, 780, 8, 40), None, False),
    "ddp_small_level0": ((2, 256, 256, 4, 40), None, False),
    "kv_mask": ((2, 1500, 1500, 6, 64), (1500, 1100), False),
    "causal": ((1, 256, 256, 2, 80), None, True),
}


def phase_flash(gen) -> dict:
    """Both flash entries at every case; → {dtype name: kernel record}."""
    import torch
    import torch.nn.functional as F

    from audiogpt_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
        launch_grid,
    )

    kernels = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        results = []
        for name, ((b, tq, tk, h, d), lens, causal) in FLASH_CASES.items():
            q = (torch.randn(b, tq, h, d, generator=gen, device="cuda")
                 .to(dtype))
            k, v = (torch.randn(b, tk, h, d, generator=gen, device="cuda")
                    .to(dtype) for _ in range(2))
            mask = None
            if lens is not None:
                mask = (torch.arange(tk, device="cuda")[None]
                        < torch.tensor(lens, device="cuda")[:, None]).float()
            out = flash_attention(q, k, v, kv_mask=mask, causal=causal)
            ref = flash_attention_reference(q, k, v, kv_mask=mask,
                                            causal=causal)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if dtype == torch.float32:
                ok = err <= 1e-4
            else:
                atol, rtol = BF16_FLASH_TOL
                ok = bool((diff <= atol + rtol * ref.float().abs()).all())
            if not ok:
                raise AssertionError(f"flash_attention {dname} {name}: max "
                                     f"abs err {err}")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa_mask = None if mask is None else (mask > 0)[:, None, None, :]

            def kernel():
                return flash_attention(q, k, v, kv_mask=mask, causal=causal)

            ms = time_ms(kernel, 50, graph=True)
            ms_events = time_ms(kernel, 50)
            plain = time_ms(lambda: flash_attention_reference(
                q, k, v, kv_mask=mask, causal=causal), 20)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, is_causal=causal), 50,
                graph=True)
            # the (query, key) pairs this run's data needs: valid keys per
            # row, or the top-left triangle
            if causal:
                pairs = b * sum(min(i + 1, tk) for i in range(tq))
            else:
                pairs = tq * (sum(lens) if lens else b * tk)
            flops = 4 * pairs * h * d
            n_bytes = 2 * q.element_size() * b * h * d * (tq + tk) \
                + (4 * b * tk if lens else 0)
            bms, by = bound_ms(n_bytes, flops, FLASH_FLOPS[dname])
            fma_bms, _ = bound_ms(n_bytes, flops, F32_FLOPS)
            res = {"phase": "flash_attention", "dtype": dname, "case": name,
                   "shape": [b, tq, tk, h, d], "max_abs_err": err, "ms": ms,
                   "ms_events": ms_events, "plain_ms": plain,
                   "library_ms": lib, "bound_ms": bms,
                   "bound_by": by, "bound_share": bms / ms,
                   "fma_bound_ms": fma_bms,
                   **launch_grid(q)}
            emit(res)
            results.append(res)
        kernels[dname] = {"name": f"flash_attention_{dname}",
                          "results": results}
    return kernels


def phase_snake(gen) -> dict:
    """Both snake entries at the BigVGAN stage shapes of the T2A call, the
    inpaint call, the I2A call and a ``t2a_mesh`` replica's rows; →
    {dtype name: kernel record}."""
    import torch

    from audiogpt_tpu_torch.models.vocoder import BigVGANConfig
    from audiogpt_tpu_torch.ops.snake_aa import snake_aa, snake_aa_reference

    cases = {}
    for prefix, batch, frames in (("stage", 3, 624),
                                  ("inpaint_stage", 1, 848),
                                  ("i2a_stage", 1, 624),
                                  ("mesh_stage", MESH_ROWS, 624)):
        for i, shape in enumerate(snake_shapes(BigVGANConfig(), batch,
                                               frames)):
            cases[f"{prefix}{i}"] = shape
    kernels = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        results = []
        for name, (b, c, t) in cases.items():
            x = torch.randn(b, c, t, generator=gen, device="cuda").to(dtype)
            alpha = torch.exp(0.1 * torch.randn(c, generator=gen,
                                                device="cuda"))
            beta = torch.exp(0.1 * torch.randn(c, generator=gen,
                                               device="cuda"))
            out = snake_aa(x, alpha, beta)
            ref = snake_aa_reference(x, alpha, beta)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if dtype == torch.float32:
                ok = err <= 1e-5
            else:
                # both compute in f32 and round once to bf16: one step apart
                ok = bool((diff <= 2 ** -7 * ref.float().abs() + 1e-3).all())
            if not ok:
                raise AssertionError(f"snake_aa {dname} {name}: max abs err "
                                     f"{err}")
            ms = time_ms(lambda: snake_aa(x, alpha, beta), 50, graph=True)
            ms_events = time_ms(lambda: snake_aa(x, alpha, beta), 50)
            plain = time_ms(lambda: snake_aa_reference(x, alpha, beta), 20)
            copy = time_ms(lambda: x.clone(), 50, graph=True)
            # per output: 2×6 up taps and 12 down taps as FMAs, snake 5 ops
            # and a sine per phase, in f32 for both entries
            bms, by = bound_ms(2 * x.element_size() * x.numel() + 4 * 2 * c,
                               (2 * 24 + 2 * 6) * x.numel())
            res = {"phase": "snake_aa", "dtype": dname, "case": name,
                   "shape": [b, c, t], "max_abs_err": err, "ms": ms,
                   "ms_events": ms_events, "plain_ms": plain,
                   "library_ms": None, "copy_ms": copy,
                   "bound_ms": bms, "bound_by": by, "bound_share": bms / ms}
            emit(res)
            results.append(res)
        kernels[dname] = {"name": f"snake_aa_{dname}", "results": results}
    return kernels


def fill_random(module, gen) -> None:
    """Seeded noise in every parameter: weights normal · fan_in^-½, norm
    scales (LayerNorm, GroupNorm, BatchNorm) 1 + 0.1·N, biases and snake
    log-α/β 0.1·N. BatchNorm scales of 0.1·N would shrink Cnn14's signal
    about tenfold at each of its 13 norms, and every candidate's CLAP
    embedding would collapse to the same value."""
    import torch
    from torch import nn

    norms = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d)
    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                noise = torch.randn(p.shape, generator=gen, device=p.device)
                if isinstance(mod, norms) and name == "weight":
                    p.copy_(1.0 + 0.1 * noise)
                elif p.ndim >= 2:
                    p.copy_(noise / math.sqrt(p[0].numel()))
                else:
                    p.copy_(0.1 * noise)


def t2a_latent(cfg, frames: int) -> tuple:
    """The T2A UNet's latent (h, w) for a mel canvas of ``frames``."""
    return cfg.mel_bins // cfg.vae_factor, frames // cfg.vae_factor


def flash_shapes(cfg, batch: int, latent: tuple, steps: int,
                 context: int) -> Counter:
    """Flash launches of one sampler run, by shape (B, Tq, Tk, H, D), from
    the configs of any diffusion engine (``cfg.unet``, ``cfg.timesteps``):
    the sampler's UNet evals (``ddim_steps(n)`` spaces ``range(0, T, T //
    n)``: 13 timesteps for n = 12, 50 for n = 50) times, at each UNet
    level, the transformer blocks there (the down path's res blocks and the
    up path's where the level has attention, the middle block at the
    deepest) whose self- or cross-attention reaches the dispatch rule's
    pair count (``ops/attention.py``). ``batch`` is the UNet's batch (the
    CFG pair doubles it); ``latent`` the UNet input's (h, w); ``context``
    the cross-attention's keys (the CLAP tokens of T2A, I2A's one image
    embedding, T2I's 77 CLIP tokens)."""
    from audiogpt_tpu_torch.models.diffusion import DiffusionSchedule

    evals = len(DiffusionSchedule.linear(cfg.timesteps).ddim_steps(steps)[0])
    return Counter({shape: evals * n for shape, n in
                    unet_flash_shapes(cfg.unet, batch, latent,
                                      context).items()})


def unet_flash_shapes(u, batch: int, latent: tuple,
                      context: int) -> Counter:
    """Flash launches of one forward of the UNet of config ``u`` (see
    :func:`flash_shapes`), by shape."""
    from audiogpt_tpu_torch.ops.attention import FLASH_MIN_PAIRS

    h, w = latent
    shapes, ds = Counter(), 1
    for level, mult in enumerate(u.channel_mult):
        blocks = (2 * u.num_res_blocks + 1) * (ds in u.attention_resolutions) \
            + (level == len(u.channel_mult) - 1)
        tokens, dim = h * w, mult * u.model_channels // u.num_heads
        keys = [tokens] + ([context] if u.context_dim else [])
        for tk in keys:
            if tokens * tk >= FLASH_MIN_PAIRS:
                shapes[(batch, tokens, tk, u.num_heads, dim)] += \
                    blocks * u.transformer_depth
        h, w, ds = -(-h // 2), -(-w // 2), 2 * ds     # stride-2 pad-1 convs
    return shapes


def snake_shapes(vcfg, batch: int, frames: int) -> Counter:
    """Snake-AA launches of one vocoder call, by shape (B, C, T), from the
    config: every AMP activation (two per dilation in ``resblock="1"``, one
    in ``"2"``) at each upsampling stage, plus ``act_post``."""
    per = (2 if vcfg.resblock == "1" else 1) \
        * sum(len(d) for d in vcfg.resblock_dilation_sizes)
    shapes, t = Counter(), frames
    for i, rate in enumerate(vcfg.upsample_rates):
        t *= rate
        c = vcfg.upsample_initial_channel // 2 ** (i + 1)
        shapes[(batch, c, t)] += per
    shapes[(batch, c, t)] += 1
    return shapes


def expected_counts(flash: Counter, snake: Counter, flash_bf16: bool = False,
                    snake_bf16: bool = False) -> dict:
    """The four launch counters of a path whose launches are ``flash`` and
    ``snake`` (by shape), in the entries of the given dtypes."""
    nf, ns = sum(flash.values()), sum(snake.values())
    return {"flash_attention": nf, "flash_attention_bf16": nf * flash_bf16,
            "snake_aa": ns, "snake_aa_bf16": ns * snake_bf16}


def counted(fn):
    """``fn()`` with every launch count set to 0 just before it and read just
    after; → (output, seconds, counts)."""
    import torch

    from audiogpt_tpu_torch.ops import _build
    from audiogpt_tpu_torch.ops.flash_attention import flash_attention
    from audiogpt_tpu_torch.ops.snake_aa import snake_aa

    _build.reset_counts(flash_attention)
    _build.reset_counts(snake_aa)
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, {
        "flash_attention": flash_attention.launches,
        "flash_attention_bf16": flash_attention.bf16_launches,
        "snake_aa": snake_aa.launches,
        "snake_aa_bf16": snake_aa.bf16_launches}


def t2a_path(eng) -> dict:
    """The launches of one ``txt2audio_best`` call by shape, and its counts."""
    cfg = eng.cfg
    flash = flash_shapes(cfg, 6, cfg.latent_hw, cfg.tool_steps,
                         cfg.clap.max_length)
    snake = snake_shapes(eng.vocoder.cfg, 3, cfg.mel_len)
    return {"flash": flash, "snake": snake,
            "counts": expected_counts(flash, snake, cfg.unet_bf16)}


def drive(eng) -> dict:
    """A cold and 10 warm counted ranked calls; the counts must match the
    configs, the output must be a finite, non-silent wav and a mel in
    [0, 1], the scores finite and not all equal, and the wav the argmax
    candidate of an unranked call at the same seed."""
    import numpy as np
    import torch

    def call():
        return eng.txt2audio_best(TEXT, n_samples=3, seed=0)

    cfg = eng.cfg
    _, cold_s, cold_counts = counted(call)
    torch.cuda.reset_peak_memory_stats()
    (mel, wav, scores), warm_s, counts = counted(call)
    expected = t2a_path(eng)["counts"]
    if counts != expected or cold_counts != expected:
        raise AssertionError(f"launch counts {cold_counts}, {counts}; "
                             f"expected {expected}")
    if wav.shape != (159744,) or not bool(torch.isfinite(
            torch.from_numpy(wav)).all()) or float(wav.std()) == 0.0:
        raise AssertionError(f"wav {wav.shape}, std {wav.std()}")
    if mel.shape != (624, 80) or not (0.0 <= mel.min() <= mel.max() <= 1.0):
        raise AssertionError(f"mel {mel.shape} in [{mel.min()}, {mel.max()}]")
    if scores.shape != (3,) or not np.isfinite(scores).all() \
            or np.ptp(scores) == 0.0:
        raise AssertionError(f"scores {scores}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    mels, wavs = eng.txt2audio(TEXT, n_samples=3, ddim_steps=cfg.tool_steps,
                               seed=0, sampler=cfg.tool_sampler)
    best = int(scores.argmax())
    winner_diff = float(np.abs(wavs[best] - wav).max())
    rescored = float(np.abs(eng.scorer.score(TEXT, wavs) - scores).max())
    # the same kernels on the same inputs: equal up to the order in which a
    # library kernel may sum, far below the gap between candidates
    if winner_diff > 1e-5 or rescored > 1e-5:
        raise AssertionError(f"winner {best} differs from the unranked "
                             f"candidate by {winner_diff}, scores by "
                             f"{rescored}")
    warm = sorted([warm_s] + [counted(call)[1]
                              for _ in range(WARM_CALLS - 1)])
    median = statistics.median(warm)
    return {"call": "txt2audio_best", "n_samples": 3, "sampler": "dpmpp",
            "steps": 12, "cold_s": cold_s, "warm_s": median,
            "warm_max_s": warm[-1], "warm_calls": len(warm),
            "rtf": median / CLIP_SECONDS, "clip_s": CLIP_SECONDS,
            "peak_mem_gb": peak, "launches": counts,
            "scores": scores.tolist(), "winner": best,
            "winner_max_abs_diff": winner_diff,
            "rescored_max_abs_diff": rescored,
            "wav_std": float(wav.std()), "mel_mean": float(mel.mean()),
            "mel": mel, "wav": wav, "mels": mels}


def phase_main_path(gen) -> dict:
    import torch

    from audiogpt_tpu_torch.engines import T2AConfig, T2AEngine, VocoderEngine
    from audiogpt_tpu_torch.models.textenc import CLAPScorer

    t0 = time.perf_counter()
    voc = VocoderEngine("bigvgan", buckets=(624, 848))
    scorer = CLAPScorer(sample_rate=16000)
    eng = T2AEngine(T2AConfig(), vocoder=voc, scorer=scorer)
    for m in (eng.unet, eng.vae, eng.clap, voc.model, scorer.text,
              scorer.audio):
        fill_random(m, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res = drive(eng)
    out = {k: res.pop(k) for k in ("mel", "wav", "mels")}
    emit({"phase": "main_path", "setup_s": setup_s, **res})
    return {"engine": eng, "launches": res["launches"],
            "warm_s": res["warm_s"], **out}


def phase_main_path_bf16(f32: dict) -> dict:
    """The f32 engine's weights under ``T2AConfig(unet_bf16=True)`` (the UNet
    cast to bf16 once), same vocoder and scorer, same call and seed."""
    import dataclasses

    import numpy as np

    from audiogpt_tpu_torch.engines import T2AEngine

    base = f32["engine"]
    eng = T2AEngine(dataclasses.replace(base.cfg, unet_bf16=True),
                    vocoder=base.vocoder, scorer=base.scorer)
    eng.load_state_dict({name: getattr(base, name).state_dict()
                         for name in ("unet", "vae", "clap")})
    res = drive(eng)
    mel = res.pop("mel")
    res.pop("wav"), res.pop("mels")
    res["mel_max_abs_diff_from_f32"] = float(np.abs(mel - f32["mel"]).max())
    res["warm_s_f32"] = f32["warm_s"]
    runs = [stage_ms(eng) for _ in range(STAGE_RUNS)]
    res["stages_ms"] = {k: statistics.median(r[k] for r in runs)
                        for k in runs[0]}
    emit({"phase": "main_path_bf16", "config": "unet_bf16", **res})
    inpaint_bf16_engine(base, eng, f32["wav"])
    return {"launches": res["launches"], "warm_s": res["warm_s"]}


def inpaint_bf16_engine(f32_eng, bf16_eng, wav) -> None:
    """The inpaint tool's call on an engine built with ``unet_bf16`` runs
    its f32 UNet: with the same draws its wav equals the f32 engine's."""
    import torch

    cfg = f32_eng.cfg
    wavs, launches = [], []
    for eng in (f32_eng, bf16_eng):
        mel01, mask_latent = eng.inpaint_inputs(wav, tool_mask(cfg))
        ctx = eng.encode_text([""])
        gen = torch.Generator("cuda").manual_seed(11)
        x_T = torch.randn(mask_latent.shape, generator=gen, device="cuda")
        out, _, counts = counted(lambda: eng.vocoder.vocode(eng.inpaint_core(
            mel01, mask_latent, ctx, ctx, x_T, gen, 1.0, 100, "ddim")[:, 0]))
        wavs.append(out)
        launches.append(counts)
    diff = (wavs[0] - wavs[1]).abs().max().item()
    emit({"phase": "inpaint_unet_bf16", "max_abs_diff_from_f32": diff,
          "launches": launches[1]})
    if diff > 1e-5 or launches[0] != launches[1] \
            or launches[1]["flash_attention_bf16"]:
        raise AssertionError(f"unet_bf16 engine's inpaint: {diff} from the "
                             f"f32 engine's, launches {launches}")


def inpaint_path(eng, steps: int = 100) -> dict:
    """The launches of one inpaint call at scale 1 (no CFG pair: batch 1) by
    shape, and its counts."""
    cfg = eng.cfg
    flash = flash_shapes(cfg, 1, t2a_latent(cfg, cfg.inpaint_mel_len),
                         steps, cfg.clap.max_length)
    snake = snake_shapes(eng.vocoder.cfg, 1, cfg.inpaint_mel_len)
    return {"flash": flash, "snake": snake,
            "counts": expected_counts(flash, snake)}


def tool_mask(cfg, t0: float = 1.0, t1: float = 3.0):
    """The agent tool's mask (``agent/toolset.py:inpaint_fn``): keep all but
    t0–t1 s of the canvas."""
    import numpy as np

    fps = cfg.sample_rate / cfg.hop
    mask = np.ones(cfg.inpaint_mel_len, np.float32)
    mask[int(t0 * fps): int(t1 * fps)] = 0.0
    return mask


def phase_inpaint(main: dict) -> dict:
    """The inpaint tool call on the main path's winning wav: regenerate
    1.0–3.0 s with DDIM-100 at scale 1, in f32."""
    import numpy as np
    import torch

    eng = main["engine"]
    cfg = eng.cfg
    mask = tool_mask(cfg)

    def call():
        return eng.inpaint(main["wav"], mask)

    expected = inpaint_path(eng)["counts"]
    _, cold_s, cold_counts = counted(call)
    torch.cuda.reset_peak_memory_stats()
    runs = [counted(call) for _ in range(INPAINT_WARM_CALLS)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    wav = runs[-1][0]
    for counts in [cold_counts] + [r[2] for r in runs]:
        if counts != expected:
            raise AssertionError(f"inpaint launches {counts}, expected "
                                 f"{expected}")
    n = cfg.inpaint_mel_len * eng.vocoder.hop_size
    if wav.shape != (n,) or not np.isfinite(wav).all() or wav.std() == 0.0:
        raise AssertionError(f"inpaint wav {wav.shape}, std {wav.std()}")
    median = statistics.median(r[1] for r in runs)
    regen = np.flatnonzero(mask == 0.0)
    emit({"phase": "inpaint", "call": "inpaint", "sampler": "ddim",
          "steps": 100, "scale": 1.0,
          "regenerated_frames": [int(regen[0]), int(regen[-1])],
          "cold_s": cold_s, "warm_s": median,
          "warm_max_s": max(r[1] for r in runs), "warm_calls": len(runs),
          "rtf": median / INPAINT_SECONDS, "clip_s": INPAINT_SECONDS,
          "peak_mem_gb": peak, "launches": runs[-1][2],
          "wav_len": int(wav.shape[0]), "wav_std": float(wav.std())})
    profile_call("inpaint_profile", call, median)
    stages = [inpaint_stage_ms(eng, main["wav"], mask)
              for _ in range(INPAINT_WARM_CALLS)]
    emit({"phase": "inpaint_stages", "runs": INPAINT_WARM_CALLS,
          **{k: statistics.median(r[k] for r in stages) for k in stages[0]}})
    return {"launches": runs[-1][2]}


def phase_vocoder_bf16(main: dict) -> dict:
    """``VocoderEngine(bf16=True)`` with the f32 vocoder's weights on the main
    path's three candidate mels."""
    import torch

    from audiogpt_tpu_torch.engines import VocoderEngine

    voc = main["engine"].vocoder
    vb = VocoderEngine("bigvgan", cfg=voc.cfg, buckets=voc.bucketer.buckets,
                       bf16=True)
    vb.load_state_dict(voc.model.state_dict())
    mel = torch.from_numpy(main["mels"]).cuda().transpose(1, 2).contiguous()
    frames = mel.shape[-1]
    expected = expected_counts(Counter(), snake_shapes(vb.cfg, 3, frames),
                               snake_bf16=True)
    _, _, cold_counts = counted(lambda: vb.vocode(mel))
    wav_b, _, counts = counted(lambda: vb.vocode(mel))
    if counts != expected or cold_counts != expected:
        raise AssertionError(f"bf16 vocoder launches {counts}, expected "
                             f"{expected}")
    wav_f = voc.vocode(mel)
    torch.cuda.synchronize()
    if wav_b.dtype != torch.float32 or wav_b.shape != wav_f.shape \
            or not bool(torch.isfinite(wav_b).all()):
        raise AssertionError(f"bf16 wav {wav_b.dtype} {tuple(wav_b.shape)}")
    snr = 10.0 * math.log10(float((wav_f ** 2).sum())
                            / float(((wav_f - wav_b) ** 2).sum()))
    # bf16 activations through ~100 layers of random weights: the wav must
    # stay the f32 wav's, well above noise (the JAX package measured ~39 dB
    # on trained weights)
    if snr < 10.0:
        raise AssertionError(f"bf16 vocoder SNR {snr} dB")
    emit({"phase": "vocoder_bf16", "shape": list(mel.shape),
          "launches": counts, "snr_db": snr,
          "max_abs_diff": float((wav_f - wav_b).abs().max()),
          "warm_ms_bf16": time_ms(lambda: vb.vocode(mel), 5),
          "warm_ms_f32": time_ms(lambda: voc.vocode(mel), 5)})
    return {"launches": counts}


def phase_small_reference() -> None:
    """A narrow engine and scorer on the card (kernels) against the same
    weights on the CPU (plain versions), with the same initial noise and
    inpaint draws: the sampler → VAE → vocoder core, the ranked core and the
    inpaint core. The level-0 latent has 16 × 32 = 512 tokens, so the flash
    path is taken on the card."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import T2AConfig, T2AEngine, VocoderEngine
    from audiogpt_tpu_torch.models.caption import Cnn14Config
    from audiogpt_tpu_torch.models.diffusion import UNetConfig, VAEConfig
    from audiogpt_tpu_torch.models.textenc import (
        BertConfig,
        CLAPScorer,
        CLAPTextConfig,
    )
    from audiogpt_tpu_torch.models.vocoder import BigVGANConfig

    def text_cfg():
        return CLAPTextConfig(bert=BertConfig(
            vocab_size=30522, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128), d_proj=64)

    cfg = T2AConfig(
        unet=UNetConfig(model_channels=64, num_res_blocks=1, num_heads=2,
                        context_dim=64),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(), resolution=64),
        clap=text_cfg(), mel_bins=32, mel_len=64, inpaint_mel_len=64,
        timesteps=1000)
    # hop 256: 16384-sample clips, long enough for the scorer's 32 kHz
    # Cnn14 frontend to keep a frame after its five pools
    vcfg = BigVGANConfig(num_mels=32, upsample_initial_channel=64,
                         upsample_rates=(8, 8, 4),
                         upsample_kernel_sizes=(16, 16, 8))
    steps, inpaint_steps = cfg.tool_steps, 100
    outs, launches = {}, {}
    for dev in ("cpu", "cuda"):
        voc = VocoderEngine("bigvgan", cfg=vcfg, buckets=(64,), device=dev)
        sc = CLAPScorer(text_cfg(), sample_rate=16000, device=dev,
                        audio_cfg=Cnn14Config(channels=(16, 16, 32, 32, 64,
                                                        64)))
        eng = T2AEngine(cfg, vocoder=voc, scorer=sc, device=dev)
        modules = (eng.unet, eng.vae, eng.clap, voc.model, sc.text, sc.audio)
        if dev == "cpu":
            g = torch.Generator().manual_seed(5)
            for m in modules:
                fill_random(m, g)
            state = [m.state_dict() for m in modules]
            x_T = torch.randn(3, 4, 16, 32, generator=g)
            x_inp = torch.randn(1, 4, 16, 32, generator=g)
            noise = [torch.randn(1, 4, 16, 32, generator=g)
                     for _ in range(inpaint_steps)]
            wav_in = (0.3 * torch.randn(20000, generator=g)).numpy()
        else:
            for m, sd in zip(modules, state):
                m.load_state_dict(sd)
        both = eng.encode_text([TEXT] * 3 + [""] * 3)
        ctx, uc, x = both[:3], both[3:], x_T.to(dev)

        def core():
            m = eng.sample_core(ctx, uc, x, 1.5, steps, cfg.tool_sampler)
            return m, voc.vocode(m[:, 0])

        (mel, wav), _, core_n = counted(core)
        (_, best_wav, scores), _, rank_n = counted(
            lambda: eng.sample_vocode_rank(TEXT, ctx, uc, x, 1.5, steps,
                                           cfg.tool_sampler))
        mel01, mask_latent = eng.inpaint_inputs(wav_in,
                                                tool_mask(cfg, 0.2, 0.6))
        c1 = eng.encode_text([TEXT])
        draws = [n.to(dev) for n in noise]
        out, _, inp_n = counted(lambda: voc.vocode(eng.inpaint_core(
            mel01, mask_latent, c1, c1, x_inp.to(dev), draws, 1.0,
            inpaint_steps, "ddim")[:, 0]))
        outs[dev] = [t.cpu() for t in (mel, wav, scores, best_wav, mel01,
                                       out)]
        launches[dev] = {"core": core_n, "ranked": rank_n, "inpaint": inp_n}
        expected = {
            "core": t2a_path(eng)["counts"],
            "ranked": t2a_path(eng)["counts"],
            "inpaint": expected_counts(
                flash_shapes(cfg, 1, t2a_latent(cfg, cfg.inpaint_mel_len),
                             inpaint_steps, cfg.clap.max_length),
                snake_shapes(vcfg, 1, cfg.inpaint_mel_len))}
    cpu, card = outs["cpu"], outs["cuda"]
    best = int(card[2].argmax())
    errs = {name: (a - b).abs().max().item() for name, a, b in zip(
        ("mel", "wav", "scores", "winner_wav", "inpaint_mel_in",
         "inpaint_wav"), [cpu[0], cpu[1], cpu[2], cpu[1][best]] + cpu[4:],
        card)}
    scores = cpu[2].numpy()
    top2 = np.sort(scores)[-2:]
    winner_checked = bool(top2[1] - top2[0] > 1e-3)
    res = {"phase": "small_reference",
           **{f"{k}_max_abs_err": v for k, v in errs.items()},
           "scores_cpu": scores.tolist(),
           "scores_cuda": card[2].tolist(),
           "winner_checked": winner_checked,
           "cuda_launches": launches["cuda"], "cpu_launches": launches["cpu"]}
    emit(res)
    # f32 on both sides, TF32 off; the sampler steps, the VAE, the vocoder
    # and the scorer sum in other orders on the card: 1e-3 absolute on
    # outputs in [-1, 1]
    bad = {k: v for k, v in errs.items() if not v <= 1e-3}
    if bad:
        raise AssertionError(f"card vs CPU: {bad}")
    # random weights can tie: the winner is compared only where the top two
    # scores are further apart than the tolerance
    if winner_checked and int(scores.argmax()) != best:
        raise AssertionError(f"winners differ: {res['scores_cpu']} vs "
                             f"{res['scores_cuda']}")
    if launches["cuda"] != expected:
        raise AssertionError(f"small-path launches {launches['cuda']}, "
                             f"expected {expected}")
    if any(any(n.values()) for n in launches["cpu"].values()):
        raise AssertionError("a CPU run counted kernel launches")


def profile_call(name: str, fn, warm_s: float) -> None:
    """One warm call of ``fn`` under torch.profiler, the device traced
    alone: device time by kernel and the device's busy share, of the traced
    call (tracing slows the host) and of the untraced warm median
    ``warm_s``. The host's operator events are left out: they triple what
    ``key_averages`` sorts, and sorting them took ≈ 100 s of the script for
    the T2A and inpaint calls (PR 7) that no number here reads."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    # device-side events only (kernels, copies): the operator rows above
    # them carry the same device time again
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    # the union of the device events' intervals: the time the device had
    # work, whatever the sum above counts twice
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    union_us, end = 0.0, -math.inf
    for start, stop in spans:
        union_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    emit({"phase": name, "wall_s": wall, "device_s": busy_us / 1e6,
          "device_union_s": union_us / 1e6,
          "device_busy_share": union_us / 1e6 / wall,
          "device_busy_share_untraced": union_us / 1e6 / warm_s,
          "launches": sum(e.count for e in kernels),
          "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                  for e in top]})


def phase_profile(eng, warm_s: float) -> None:
    """The main path's profile, then the time of each of its layers, median
    of 5 runs."""
    profile_call("profile", lambda: eng.txt2audio_best(TEXT, n_samples=3,
                                                       seed=0), warm_s)
    runs = [stage_ms(eng) for _ in range(STAGE_RUNS)]
    emit({"phase": "stages", "runs": STAGE_RUNS,
          **{k: statistics.median(r[k] for r in runs) for k in runs[0]}})


def stage_ms(eng) -> dict:
    """Time of each layer of one warm ``txt2audio_best`` call, the engine's
    steps run one by one between CUDA events (device time plus any gap in
    which the host had not yet queued the work), and the host's time to
    queue the sampler (when it nears the sampler's events, the host is what
    sets the pace)."""
    import torch

    from audiogpt_tpu_torch.engines.t2a import SAMPLERS

    cfg = eng.cfg
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    with torch.inference_mode():
        marks[0].record()
        ctx, uc, x_T = eng._prep_candidates(TEXT, 3, 0)
        marks[1].record()
        t0 = time.perf_counter()
        z = SAMPLERS[cfg.tool_sampler](
            eng.eps, eng.schedule, x_T, ctx, uc, n_steps=cfg.tool_steps,
            guidance_scale=1.5)
        host_s = time.perf_counter() - t0
        marks[2].record()
        mel = ((eng.vae.decode(z / cfg.scale_factor) + 1.0) / 2.0).clamp(0, 1)
        marks[3].record()
        wavs = eng.vocoder.vocode(mel[:, 0])
        marks[4].record()
        eng.scorer.similarity(TEXT, wavs).argmax()
        marks[5].record()
    marks[5].synchronize()
    names = ("clap_text_ms", "unet_sampler_ms", "vae_decode_ms",
             "bigvgan_ms", "clap_rank_ms")
    return {"unet_sampler_host_ms": host_s * 1e3,
            **{n: a.elapsed_time(b) for n, a, b in zip(names, marks,
                                                       marks[1:])}}


def inpaint_stage_ms(eng, wav, mask) -> dict:
    """Time of each layer of one warm inpaint call (as :func:`stage_ms`):
    the mel and mask on the canvas, the text tower, VAE encode, the DDIM
    sampler with the mask blend, VAE decode, vocoder."""
    import torch

    from audiogpt_tpu_torch.models.diffusion import ddim_sample

    cfg = eng.cfg
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    with torch.inference_mode():
        marks[0].record()
        mel01, mask_latent = eng.inpaint_inputs(wav, mask)
        marks[1].record()
        ctx = eng.encode_text([""])
        marks[2].record()
        z0 = eng.vae.encode(mel01 * 2.0 - 1.0).mode() * cfg.scale_factor
        marks[3].record()
        gen = torch.Generator("cuda").manual_seed(0)
        x_T = torch.randn(z0.shape, generator=gen, device="cuda")
        t0 = time.perf_counter()
        z = ddim_sample(eng.eps, eng.schedule, x_T, ctx, ctx, n_steps=100,
                        mask=mask_latent, x0=z0, noise=gen)
        host_s = time.perf_counter() - t0
        marks[4].record()
        mel = ((eng.vae.decode(z / cfg.scale_factor) + 1.0) / 2.0).clamp(0, 1)
        marks[5].record()
        eng.vocoder.vocode(mel[:, 0])
        marks[6].record()
    marks[6].synchronize()
    names = ("inputs_ms", "clap_text_ms", "vae_encode_ms", "unet_sampler_ms",
             "vae_decode_ms", "bigvgan_ms")
    return {"unet_sampler_host_ms": host_s * 1e3,
            **{n: a.elapsed_time(b) for n, a, b in zip(names, marks,
                                                       marks[1:])}}


# ---------------------------------------------------------------------------
# ASR: the agent's "Transcribe Speech" tool (whisper-base)
# ---------------------------------------------------------------------------


def speech_like(seconds: float, sr: int, seed: int):
    """A seeded speech-like test signal: a voiced source (a gliding f0 with
    12 harmonics) under a 4 Hz syllable envelope, over a noise floor."""
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 0.3 * t + 6.28 * rng.rand())
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 13))
    env = np.clip(np.sin(2 * np.pi * 4.0 * t + 6.28 * rng.rand()), 0, None)
    return (0.2 * env ** 2 * voiced + 0.01 * rng.randn(t.size)).astype(
        np.float32)


def asr_flash_shapes(cfg, batches) -> Counter:
    """Flash launches of the encoder passes whose batches are ``batches``:
    every encoder layer's self-attention over ``n_audio_ctx`` positions
    (``ops/attention.py``'s rule); the decoder's cached self-attention
    carries a mask and its cross-attention has at most 4 queries, so
    neither reaches the kernel."""
    from audiogpt_tpu_torch.ops.attention import FLASH_MIN_PAIRS

    ctx, h = cfg.n_audio_ctx, cfg.n_audio_head
    if ctx * ctx < FLASH_MIN_PAIRS:
        return Counter()
    shapes = Counter()
    for nb in batches:
        shapes[(nb, ctx, ctx, h, cfg.n_audio_state // h)] += cfg.n_audio_layer
    return shapes


def encoder_counted(eng, fn, tool_counts: dict | None = None):
    """:func:`counted` of ``fn``, the launches it should make and the batch
    of every whisper encoder pass of ``eng`` it made (a forward hook counts
    them): 6 flash launches per pass, plus ``tool_counts`` (the launches of
    another engine's call in ``fn``). → (output, seconds, counts, expected,
    batches)."""
    batches = []
    hook = eng._run.encoder.register_forward_hook(
        lambda m, args, out: batches.append(int(args[0].shape[0])))
    try:
        out, seconds, counts = counted(fn)
    finally:
        hook.remove()
    expected = expected_counts(asr_flash_shapes(eng.cfg, batches), Counter(),
                               flash_bf16=eng.bf16)
    for key, n in (tool_counts or {}).items():
        expected[key] += n
    return out, seconds, counts, expected, batches


def asr_counted(eng, fn):
    """:func:`counted` of ``fn``, and the batch of every encoder pass it
    made; the launch counts must be those of the passes."""
    out, seconds, counts, expected, batches = encoder_counted(eng, fn)
    if counts != expected:
        raise AssertionError(f"ASR launches {counts} for encoder batches "
                             f"{batches}, expected {expected}")
    return out, seconds, counts, batches


def device_launches(fn) -> int:
    """Device activities (kernels, copies, sets) of one ``fn()``, traced."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def asr_decode_parts(eng, wav):
    """The engine's first decode of ``wav`` [T] taken apart: (the decode
    function, mel, prompt, filter keywords) as ``_decode_stats`` passes
    them."""
    import torch

    from audiogpt_tpu_torch.engines.asr import LANG_BASE, N_LANGS
    from audiogpt_tpu_torch.models.asr import decode

    mel = eng._mel(wav[None])
    prompt = torch.from_numpy(eng._prompts(1, "translate", 0)).cuda()
    sup, gte, blanks, nsid = eng._filters
    kw = dict(eot_id=eng.eot, suppress=sup, suppress_gte=gte,
              blank_ids=blanks, no_speech_id=nsid,
              lang_range=(LANG_BASE, N_LANGS))
    return decode, mel, prompt, kw


def asr_stage_ms(eng, wav) -> dict:
    """Time of each layer of one 30 s window's decode between CUDA events:
    the log-mel, the encoder, the prime (a decode of 0 tokens: encoder,
    prompt forward, first pick, less the encoder) and the decode per token
    (a full decode less the 0-token one, over its decoder steps)."""
    import torch

    decode, _, prompt, kw = asr_decode_parts(eng, wav)
    steps = []
    hook = eng._run.decoder.register_forward_hook(
        lambda *a: steps.append(1))
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    try:
        with torch.inference_mode():
            marks[0].record()
            mel = eng._mel(wav[None])
            marks[1].record()
            eng._run.encode(mel.to(next(eng._run.parameters()).dtype))
            marks[2].record()
            decode(eng._run, mel, prompt, 0, **kw)
            marks[3].record()
            n0 = len(steps)
            decode(eng._run, mel, prompt, eng.max_tokens, **kw)
            marks[4].record()
        marks[4].synchronize()
    finally:
        hook.remove()
    n_steps = len(steps) - n0 - 1          # the prime's forward excluded
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return {"mel_ms": ms[0], "encoder_ms": ms[1],
            "prime_ms": ms[2] - ms[1], "decode_ms": ms[3],
            "decode_loop_ms": ms[3] - ms[2],
            "decode_per_token_ms": (ms[3] - ms[2]) / n_steps,
            "decode_steps": n_steps}


def phase_asr(gen) -> dict:
    """The ASR tool's call at whisper-base width: a 30 s seeded signal
    written as a 44.1 kHz wav, loaded with ``load_wav(path, 16000)`` and
    transcribed with ``temperatures=(0.0,)`` (auto language); cold and warm
    times, peak memory, one call of the six-rung ladder, one
    ``return_segments`` call, one ``detect_language``, the layer times, the
    launches per decode step and one traced call."""
    import tempfile

    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import ASREngine
    from audiogpt_tpu_torch.models.asr import WhisperConfig
    from audiogpt_tpu_torch.utils.audio_io import load_wav, save_wav

    held = torch.cuda.memory_allocated()     # the T2A engines, still alive
    t0 = time.perf_counter()
    eng = ASREngine(WhisperConfig(), temperatures=(0.0,))
    fill_random(eng.model, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "speech_44k.wav")
        save_wav(speech_like(ASR_SECONDS, 44100, 1), path, 44100)
        loads = []
        for _ in range(3):
            t = time.perf_counter()
            wav, sr = load_wav(path, 16000)
            loads.append(time.perf_counter() - t)
    if sr != 16000 or wav.shape != (480000,) or not np.isfinite(wav).all():
        raise AssertionError(f"load_wav: {wav.shape} at {sr} Hz")

    def call():
        return eng.transcribe(wav)

    cold = asr_counted(eng, call)
    torch.cuda.reset_peak_memory_stats()
    runs = [asr_counted(eng, call) for _ in range(ASR_WARM_CALLS)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    if any(r[0] != cold[0] for r in runs) or not isinstance(cold[0], str):
        raise AssertionError("transcripts differ between calls")
    toks = eng.transcribe_tokens(wav)
    if toks.shape != (1, 4 + eng.max_tokens) or toks.min() < 0 \
            or toks.max() >= eng.cfg.n_vocab:
        raise AssertionError(f"tokens {toks.shape} in [{toks.min()}, "
                             f"{toks.max()}]")
    median = statistics.median(r[1] for r in runs)
    redispatch = len(runs[0][3]) - 1      # the language re-dispatch
    eng.temperatures = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    try:
        ladder = asr_counted(eng, call)
    finally:
        eng.temperatures = (0.0,)
    segs = asr_counted(eng, lambda: eng.transcribe(wav,
                                                   return_segments=True))
    if not all(0.0 <= s <= e <= ASR_SECONDS for s, e, _ in segs[0]):
        raise AssertionError(f"segments {segs[0]}")
    forwards = []
    hook = eng._run.decoder.register_forward_hook(
        lambda *a: forwards.append(1))
    try:
        det = asr_counted(eng, lambda: eng.detect_language(wav))
    finally:
        hook.remove()
    probs = det[0][1]
    if det[3] != [1] or forwards != [1] or probs.shape != (1, 99) \
            or abs(float(probs.sum()) - 1.0) > 1e-4:
        raise AssertionError(f"detect_language: encoder passes {det[3]}, "
                             f"decoder forwards {len(forwards)}, probs "
                             f"{probs.shape} summing to {probs.sum()}")
    emit({"phase": "asr", "model": "whisper-base", "clip_s": ASR_SECONDS,
          "file_sr": 44100, "setup_s": setup_s, "load_wav_s": loads[0],
          "load_wav_warm_s": statistics.median(loads[1:]),
          "cold_s": cold[1], "warm_s": median,
          "warm_max_s": max(r[1] for r in runs), "warm_calls": len(runs),
          "rtf": median / ASR_SECONDS, "peak_mem_gb": peak,
          "asr_peak_mem_gb": peak - held / 1e9,
          "launches": runs[-1][2], "encoder_batches": runs[-1][3],
          "language_redispatch": bool(redispatch),
          "max_tokens": eng.max_tokens, "text_chars": len(cold[0]),
          "ladder": {"s": ladder[1], "rungs": len(ladder[3]) - redispatch,
                     "encoder_passes": len(ladder[3]),
                     "launches": ladder[2]},
          "segments": {"s": segs[1], "n": len(segs[0]),
                       "encoder_passes": len(segs[3])},
          "detect_language": {"s": det[1], "language": int(det[0][0][0]),
                              "p_max": float(probs.max()),
                              "decoder_forwards": len(forwards)}})
    runs_ms = [asr_stage_ms(eng, wav) for _ in range(3)]
    stages = {k: statistics.median(r[k] for r in runs_ms)
              for k in runs_ms[0]}
    decode, mel, prompt, kw = asr_decode_parts(eng, wav)
    steps = []
    hook = eng._run.decoder.register_forward_hook(lambda *a: steps.append(1))
    try:
        n0 = device_launches(lambda: decode(eng._run, mel, prompt, 0, **kw))
        s0 = len(steps)
        n1 = device_launches(lambda: decode(eng._run, mel, prompt, 32, **kw))
    finally:
        hook.remove()
    n_steps = len(steps) - 2 * s0
    emit({"phase": "asr_stages", "runs": 3, **stages,
          "decode_loop_share_of_call": stages["decode_loop_ms"] / 1e3
          * len(runs[-1][3]) / median,
          "launches_per_decode_step": (n1 - n0) / n_steps,
          "launches_prime": n0, "steps_traced": n_steps})
    profile_call("asr_profile", call, median)
    return {"engine": eng, "wav": wav, "launches": runs[-1][2],
            "batches": runs[-1][3], "warm_s": median, "held": held}


def phase_asr_long(asr: dict) -> dict:
    """A 60 s clip: three windows (1 s halo) in one padded batch of 4."""
    import torch

    eng = asr["engine"]
    wav = speech_like(60.0, eng.cfg.sample_rate, 2)
    n_windows = len(eng._windows(wav)[1])

    def call():
        return eng.transcribe(wav)

    cold = asr_counted(eng, call)
    torch.cuda.reset_peak_memory_stats()
    runs = [asr_counted(eng, call) for _ in range(ASR_LONG_WARM_CALLS)]
    if n_windows != 3 or any(b != [4] * len(b) for *_, b in runs):
        raise AssertionError(f"{n_windows} windows, encoder batches "
                             f"{[r[3] for r in runs]}")
    median = statistics.median(r[1] for r in runs)
    emit({"phase": "asr_long", "clip_s": 60.0, "windows": n_windows,
          "cold_s": cold[1], "warm_s": median, "warm_calls": len(runs),
          "rtf": median / 60.0,
          "asr_peak_mem_gb": (torch.cuda.max_memory_allocated()
                              - asr["held"]) / 1e9,
          "launches": runs[-1][2], "encoder_batches": runs[-1][3],
          "text_chars": len(runs[-1][0])})
    return {"launches": runs[-1][2], "batches": runs[-1][3]}


def phase_asr_bf16(asr: dict) -> dict:
    """``ASREngine(bf16=True)`` with the f32 engine's weights on the same
    clip: K1's bf16 entry in the encoder; the encoder output's distance
    from the f32 engine's."""
    import torch

    from audiogpt_tpu_torch.engines import ASREngine

    base, wav = asr["engine"], asr["wav"]
    eng = ASREngine(base.cfg, temperatures=(0.0,), bf16=True)
    eng.load_state_dict(base.model.state_dict())

    def call():
        return eng.transcribe(wav)

    cold = asr_counted(eng, call)
    torch.cuda.reset_peak_memory_stats()
    runs = [asr_counted(eng, call) for _ in range(ASR_BF16_WARM_CALLS)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.inference_mode():
        mel = base._mel(wav[None])
        xa32 = base._run.encode(mel)
        xa16 = eng._run.encode(mel.bfloat16()).float()
    diff = (xa16 - xa32).abs()
    rel = float(diff.max() / xa32.abs().max())
    t32, t16 = base.transcribe_tokens(wav), eng.transcribe_tokens(wav)
    median = statistics.median(r[1] for r in runs)
    emit({"phase": "asr_bf16", "cold_s": cold[1], "warm_s": median,
          "warm_s_f32": asr["warm_s"], "warm_calls": len(runs),
          "rtf": median / ASR_SECONDS,
          "asr_peak_mem_gb": peak - asr["held"] / 1e9,
          "launches": runs[-1][2], "encoder_batches": runs[-1][3],
          "encoder_max_abs_diff_from_f32": float(diff.max()),
          "encoder_rms_diff_from_f32": float(diff.square().mean().sqrt()),
          "encoder_max_rel_diff_from_f32": rel,
          "tokens_equal_to_f32": int((t32 == t16).sum()),
          "tokens": int(t32.size)})
    # bf16 rounds each of 6 layers' outputs (2^-9 relative): the encoder
    # stays within a few percent of the f32 engine's, far from a broken
    # kernel or a mis-cast stream (O(1))
    if not rel < 0.1:
        raise AssertionError(f"bf16 encoder {rel} (relative) from f32")
    return {"launches": runs[-1][2], "batches": runs[-1][3]}


def phase_asr_batched(asr: dict) -> None:
    """``BatchedASR`` with 4 concurrent ``transcribe`` calls (15–26 s
    clips): they must ride one batched decode (encoder batch 4)."""
    import threading

    from audiogpt_tpu_torch.serving import BatchedASR

    eng = asr["engine"]
    wavs = [speech_like(ASR_SECONDS * (0.5 + 0.125 * i), 16000, 10 + i)
            for i in range(4)]
    proxy = BatchedASR(eng, max_batch=8, window_ms=200.0)
    texts = [None] * len(wavs)

    def request(i):
        texts[i] = proxy.transcribe(wavs[i])

    def run():
        threads = [threading.Thread(target=request, args=(i,))
                   for i in range(len(wavs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)

    try:
        _, wall, counts, batches = asr_counted(eng, run)
    finally:
        proxy.batcher.close()
    emit({"phase": "asr_batched", "requests": len(wavs),
          "dispatches": proxy.batcher.batches, "encoder_batches": batches,
          "wall_s": wall, "single_warm_s": asr["warm_s"],
          "launches": counts,
          "batch_log": list(proxy.batcher.batch_log)})
    if proxy.batcher.batches != 1 or proxy.batcher.items != len(wavs) \
            or not batches or any(b != 4 for b in batches) \
            or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"{proxy.batcher.batches} batches for "
                             f"{proxy.batcher.items} requests, encoder "
                             f"batches {batches}")


# ---------------------------------------------------------------------------
# TTS: the agent's "Synthesize Speech" tool (FastSpeech2 + HiFi-GAN V1)
# ---------------------------------------------------------------------------


def set_durations(model) -> None:
    """Scale and bias the duration predictor's output layer (see
    ``TTS_DUR_SCALE``)."""
    import torch

    out = model.dur_predictor.out
    with torch.no_grad():
        out.weight.mul_(TTS_DUR_SCALE)
        out.bias.fill_(TTS_DUR_BIAS)


def tts_durations(eng, text: str) -> dict:
    """Phones, frames on the canvas, mean frames per phone and whether the
    canvas cut the durations (their sum against ``max_frames``)."""
    import torch

    ids = eng.frontend.encode(text)
    with torch.inference_mode():
        out = eng.model(eng._tokens([ids]))
    dur = (torch.exp(out["dur"][0, :len(ids)]) - 1.0).round().clamp_min(0)
    total = int(dur.sum())
    frames = int((out["mel2ph"] > 0).sum())
    return {"phones": len(ids), "frames": frames,
            "frames_per_phone": total / len(ids), "durations_sum": total,
            "canvas": eng.cfg.max_frames,
            "canvas_cut": total > eng.cfg.max_frames,
            "audio_s": frames * eng.vocoder.hop_size / eng.sample_rate}


def check_no_kernels(counts: dict, what: str) -> None:
    """The TTS path launches neither kernel: FS2's attention passes a dense
    mask (the plain path) and HiFi-GAN has no snake."""
    if any(counts.values()):
        raise AssertionError(f"{what}: kernel launches {counts}")


def tts_stage_ms(eng, text: str) -> dict:
    """Time of each layer of one warm fused TTS call, through the engine's
    own steps (``_fs2``, ``_vocode16``, ``_valid_rows``): the frontend on
    the host clock, then between CUDA events FS2 on the token bucket,
    HiFi-GAN on the whole canvas with the int16 cast, and the copy of the
    valid samples; and the host's time to queue FS2."""
    import torch

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t0 = time.perf_counter()
    ids = eng.frontend.encode(text)
    frontend_ms = (time.perf_counter() - t0) * 1e3
    toks = eng._tokens([ids])
    marks[0].record()
    t0 = time.perf_counter()
    mel, n = eng._fs2(toks)
    fs2_host_ms = (time.perf_counter() - t0) * 1e3
    marks[1].record()
    wav16 = eng._vocode16(mel)
    marks[2].record()
    eng._valid_rows(wav16, n, 1)
    marks[3].record()
    marks[3].synchronize()
    names = ("fs2_ms", "hifigan_int16_ms", "copy_ms")
    return {"frontend_host_ms": frontend_ms, "fs2_host_ms": fs2_host_ms,
            **{n: a.elapsed_time(b) for n, a, b in zip(names, marks,
                                                       marks[1:])}}


def phase_tts(gen) -> dict:
    """The TTS tool's call at the app's width: ``TTSEngine()`` (FS2 hidden
    256, 4 + 4 layers, 2 heads, FFN kernel 9, ``max_frames`` 1024;
    HiFi-GAN V1) with seeded random weights and durations set to ≈ 6
    frames a phone, on one 113-phone sentence: cold and warm times, RTF,
    set-up, peak memory, launches (neither kernel), layer times, one traced
    call."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import TTSEngine

    held = torch.cuda.memory_allocated()     # the earlier engines, alive
    t0 = time.perf_counter()
    eng = TTSEngine()
    fill_random(eng.model, gen)
    fill_random(eng.vocoder.model, gen)
    set_durations(eng.model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    info = tts_durations(eng, TTS_TEXT)
    if not (80 <= info["phones"] <= 128 and not info["canvas_cut"]
            and 4.0 <= info["frames_per_phone"] <= 10.0):
        raise AssertionError(f"TTS sentence {info}")

    def call():
        return eng(TTS_TEXT)

    cold = counted(call)
    torch.cuda.reset_peak_memory_stats()
    runs = [counted(call) for _ in range(TTS_WARM_CALLS)]
    peak = torch.cuda.max_memory_allocated()
    for wav, _, counts in [cold] + runs:
        check_no_kernels(counts, "tts")
    wav = cold[0]
    n_samples = info["frames"] * eng.vocoder.hop_size
    if wav.dtype != np.float32 or wav.shape != (n_samples,) \
            or not np.isfinite(wav).all() or float(wav.std()) == 0.0:
        raise AssertionError(f"TTS wav {wav.dtype} {wav.shape} (expected "
                             f"{n_samples}), std {wav.std()}")
    # the same kernels on the same inputs: equal within one int16 step
    drift = max(float(np.abs(r[0] - wav).max()) for r in runs)
    if drift > 1.5 / 32767:
        raise AssertionError(f"TTS calls differ by {drift}")
    warm = sorted(r[1] for r in runs)
    median = statistics.median(warm)
    launches = device_launches(call)
    emit({"phase": "tts", "model": "fastspeech2+hifigan_v1",
          "text_phones": info["phones"], "token_bucket":
          eng.bucketer.bucket(info["phones"]),
          "frames": info["frames"],
          "frames_per_phone": info["frames_per_phone"],
          "canvas": info["canvas"], "canvas_cut": info["canvas_cut"],
          "audio_s": info["audio_s"], "samples": n_samples,
          "canvas_samples": eng.cfg.max_frames * eng.vocoder.hop_size,
          "setup_s": setup_s, "cold_s": cold[1], "warm_s": median,
          "warm_max_s": warm[-1], "warm_calls": len(warm),
          "rtf": median / info["audio_s"],
          "tts_peak_mem_gb": (peak - held) / 1e9,
          "params_m": sum(p.numel() for m in (eng.model, eng.vocoder.model)
                          for p in m.parameters()) / 1e6,
          "kernel_launches": runs[-1][2], "device_launches": launches,
          "max_drift_between_calls": drift,
          "wav_std": float(wav.std())})
    runs_ms = [tts_stage_ms(eng, TTS_TEXT) for _ in range(STAGE_RUNS)]
    stages = {k: statistics.median(r[k] for r in runs_ms)
              for k in runs_ms[0]}
    device = stages["fs2_ms"] + stages["hifigan_int16_ms"]
    emit({"phase": "tts_stages", "runs": STAGE_RUNS, **stages,
          "hifigan_share_of_fs2_plus_hifigan": stages["hifigan_int16_ms"]
          / device})
    profile_call("tts_profile", call, median)
    return {"engine": eng, "wav": wav, "warm_s": median, "held": held,
            "audio_s": info["audio_s"]}


def phase_tts_long(tts: dict) -> None:
    """``synthesize_long`` on a 446-phone text: clause chunks in the
    256-phone bucket, joined with 0.1 s gaps. At ≈ 6 frames a phone a
    chunk overruns the 1024-frame canvas and loses its tail, as in the JAX
    package (only phones are checked)."""
    import numpy as np

    from audiogpt_tpu_torch.engines.tts import (split_for_buckets,
                                                synthesize_long)

    eng = tts["engine"]
    chunks = split_for_buckets(
        eng.frontend, TTS_LONG_TEXT,
        lambda pt: len(pt.phones) <= max(eng.bucketer.buckets))
    per_chunk = [tts_durations(eng, c) for c in chunks]

    def call():
        return synthesize_long(eng, TTS_LONG_TEXT)

    cold = counted(call)
    runs = [counted(call) for _ in range(3)]
    for r in [cold] + runs:
        check_no_kernels(r[2], "tts_long")
    gap = int(0.1 * eng.sample_rate)
    want = sum(c["frames"] for c in per_chunk) * eng.vocoder.hop_size \
        + gap * (len(chunks) - 1)
    if len(chunks) != 2 or cold[0].shape != (want,) \
            or not np.isfinite(cold[0]).all():
        raise AssertionError(f"{len(chunks)} chunks, wav {cold[0].shape}, "
                             f"expected {want}")
    median = statistics.median(r[1] for r in runs)
    audio_s = len(cold[0]) / eng.sample_rate
    emit({"phase": "tts_long", "phones": sum(c["phones"] for c in per_chunk),
          "chunks": len(chunks), "chunk_phones":
          [c["phones"] for c in per_chunk],
          "chunk_durations_sum": [c["durations_sum"] for c in per_chunk],
          "chunk_frames": [c["frames"] for c in per_chunk],
          "canvas_cut": [c["canvas_cut"] for c in per_chunk],
          "cold_s": cold[1], "warm_s": median, "audio_s": audio_s,
          "rtf": median / audio_s})


def phase_tts_batched(tts: dict) -> None:
    """``BatchedTTS`` with 4 concurrent requests (one batch of 4 at the
    128 bucket) against the same 4 texts as single calls."""
    import threading

    import numpy as np

    from audiogpt_tpu_torch.serving import BatchedTTS

    eng = tts["engine"]
    proxy = BatchedTTS(eng, max_batch=8, window_ms=200.0)
    proxy.warmup(token_buckets=(128,))
    out = [None] * len(TTS_BATCH_TEXTS)

    def request(i):
        out[i] = proxy(TTS_BATCH_TEXTS[i])

    def run():
        threads = [threading.Thread(target=request, args=(i,))
                   for i in range(len(TTS_BATCH_TEXTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)

    try:
        _, wall, counts = counted(run)
    finally:
        proxy.batcher.close()
    singles, single_s, single_counts = counted(
        lambda: [eng(t) for t in TTS_BATCH_TEXTS])
    check_no_kernels(counts, "tts_batched")
    check_no_kernels(single_counts, "tts_batched singles")
    diff = max(float(np.abs(a - b).max()) if a.shape == b.shape else np.inf
               for a, b in zip(out, singles))
    emit({"phase": "tts_batched", "requests": len(out),
          "dispatches": proxy.batcher.batches, "wall_s": wall,
          "four_single_calls_s": single_s, "single_warm_s": tts["warm_s"],
          "max_abs_diff_from_single_calls": diff,
          "batch_log": list(proxy.batcher.batch_log)})
    # a batch of 4 may take other cuDNN algorithms than batch 1: the int16
    # wav may move by a step
    if proxy.batcher.batches != 1 or proxy.batcher.items != len(out) \
            or diff > 2.5 / 32767:
        raise AssertionError(f"{proxy.batcher.batches} batches for "
                             f"{proxy.batcher.items} requests, {diff} from "
                             f"the single calls")


def phase_tts_vocoders(tts: dict, gen) -> None:
    """``VocoderEngine`` kinds ``hifigan`` with NSF, ``pwg`` and ``melgan``
    at their default widths on a 1024-frame mel (the TTS canvas's, with its
    f0 for NSF): warm ms and launches; the NSF source on the card against
    the CPU for the same draws; ``denoise`` of the TTS wav."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines.vocoder import VocoderEngine, denoise
    from audiogpt_tpu_torch.models.vocoder import HifiGANConfig
    from audiogpt_tpu_torch.models.vocoder.hifigan import harmonic_source

    eng = tts["engine"]
    with torch.inference_mode():
        out = eng.model(eng._tokens([eng.frontend.encode(TTS_TEXT)]))
    mel = out["mel_out"].transpose(1, 2).contiguous()       # [1, 80, 1024]
    f0 = out["f0_denorm"]
    res = {}
    for kind, cfg in (("hifigan", HifiGANConfig(use_nsf=True)),
                      ("pwg", None), ("melgan", None)):
        voc = VocoderEngine(kind, cfg, buckets=(eng.cfg.max_frames,))
        fill_random(voc.model, gen)

        def call(voc=voc):
            return voc.vocode(mel, f0 if voc.use_nsf else None)

        wav, _, counts = counted(call)
        check_no_kernels(counts, f"vocoder {kind}")
        if wav.shape != (1, eng.cfg.max_frames * voc.hop_size) \
                or not bool(torch.isfinite(wav).all()):
            raise AssertionError(f"{kind} wav {tuple(wav.shape)}")
        res[kind] = {"ms": time_ms(call, 5, warmup=2),
                     "device_launches": device_launches(call),
                     "params_m": sum(p.numel() for p in voc.model.parameters())
                     / 1e6, "hop": voc.hop_size}
        del voc
    cfg = HifiGANConfig(use_nsf=True)
    cpu = torch.Generator().manual_seed(3)
    h = cfg.harmonic_num + 1
    s = f0.shape[1] * cfg.hop_size
    draws = (torch.rand(1, 1, h, generator=cpu),
             torch.randn(1, s, h, generator=cpu))
    args = (cfg.hop_size, cfg.sample_rate, cfg.harmonic_num, cfg.sine_amp,
            cfg.noise_std, cfg.voiced_threshold)
    src_cpu = harmonic_source(f0.cpu(), *args, draws)
    src_card = harmonic_source(f0, *args,
                               tuple(d.to(f0.device) for d in draws))
    nsf_diff = float((src_card.cpu() - src_cpu).abs().max())
    wav = tts["wav"]
    clean = denoise(wav)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        denoise(wav)
        times.append(time.perf_counter() - t0)
    den_diff = float(np.abs(clean - denoise(wav, device="cpu")).max())
    emit({"phase": "tts_vocoders", "frames": eng.cfg.max_frames, **res,
          "nsf_source_samples": s,
          "nsf_source_card_vs_cpu_max_abs_diff": nsf_diff,
          "denoise_ms": statistics.median(times) * 1e3,
          "denoise_card_vs_cpu_max_abs_diff": den_diff})
    if clean.shape != wav.shape or not np.isfinite(clean).all() \
            or den_diff > 1e-4:
        raise AssertionError(f"denoise {clean.shape} vs {wav.shape}, "
                             f"{den_diff} from the CPU")


def phase_tts_small_reference() -> None:
    """A narrow FS2 + HiFi-GAN on the card against the same weights on the
    CPU (TF32 off): ``mel2ph`` equal, mel and f32 wav within 1e-4, the int16
    wav of the fused chunk within one step. The pitch output is held inside
    one coarse bin (weights · 1e-3, bias mid-bin), so no pitch bin sits on
    a rounding edge; each duration's margin is printed."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import TTSEngine, VocoderEngine
    from audiogpt_tpu_torch.models.tts import FastSpeech2Config
    from audiogpt_tpu_torch.models.tts import fastspeech2 as fs
    from audiogpt_tpu_torch.models.vocoder import HifiGANConfig

    cfg = FastSpeech2Config(hidden_size=64, enc_layers=2, dec_layers=2,
                            predictor_layers=2, max_frames=1024)
    vcfg = HifiGANConfig(upsample_initial_channel=64,
                         upsample_rates=(8, 8, 4),
                         upsample_kernel_sizes=(16, 16, 8),
                         resblock_kernel_sizes=(3, 7),
                         resblock_dilation_sizes=((1, 3), (1, 3)))
    engines = {}
    for dev in ("cpu", "cuda"):
        engines[dev] = TTSEngine(cfg, vocoder=VocoderEngine(
            "hifigan", vcfg, buckets=(1024,), device=dev),
            token_buckets=(128,), device=dev)
    cpu, card = engines["cpu"], engines["cuda"]
    # seed 9: the smallest distance of a duration from its rounding edge
    # is 5.6e-3 (the card's durations differ from the CPU's by ~1e-6)
    fill_random(cpu.model, torch.Generator().manual_seed(9))
    fill_random(cpu.vocoder.model, torch.Generator().manual_seed(8))
    set_durations(cpu.model)
    mel_mid = 59 * (fs.F0_MEL_MAX - fs.F0_MEL_MIN) / (fs.F0_BIN - 2) \
        + fs.F0_MEL_MIN
    with torch.no_grad():
        out_layer = cpu.model.pitch_predictor.out
        out_layer.weight[0].mul_(1e-3)
        out_layer.bias[0] = (700.0 * math.expm1(mel_mid / 1127.0)
                             - cfg.f0_mean) / cfg.f0_std
    card.model.load_state_dict(cpu.model.state_dict())
    card.vocoder.load_state_dict(cpu.vocoder.model.state_dict())
    toks = cpu._tokens([cpu.frontend.encode(TTS_TEXT)])
    res, launches = {}, {}
    for dev, eng in engines.items():
        def run(eng=eng):
            with torch.inference_mode():
                out = eng.model(toks.to(eng.device))
                wav = eng.vocoder.model(out["mel_out"].transpose(1, 2))
            return {k: v.float().cpu() for k, v in out.items()}, wav.cpu()
        (out, wav), _, counts = counted(run)
        chunk, _, chunk_counts = counted(
            lambda eng=eng: eng.synthesize_chunk(TTS_TEXT))
        res[dev] = (out, wav, chunk)
        launches[dev] = {k: counts[k] + chunk_counts[k] for k in counts}
    (o_cpu, w_cpu, c_cpu), (o_card, w_card, c_card) = res["cpu"], res["cuda"]
    d_cpu = torch.exp(o_cpu["dur"]) - 1
    d_err = float((torch.exp(o_card["dur"]) - 1 - d_cpu).abs().max())
    live = d_cpu > 0
    margin = float(((d_cpu - d_cpu.floor()) - 0.5).abs()[live].min())
    mel_err = float((o_card["mel_out"] - o_cpu["mel_out"]).abs().max())
    wav_err = float((w_card - w_cpu).abs().max())
    same = bool((o_card["mel2ph"] == o_cpu["mel2ph"]).all())
    chunk_err = float(np.abs(c_card - c_cpu).max()) \
        if c_card.shape == c_cpu.shape else float("inf")
    emit({"phase": "tts_small_reference", "mel2ph_equal": same,
          "frames": int((o_cpu["mel2ph"] > 0).sum()),
          "duration_max_abs_err": d_err, "duration_min_margin": margin,
          "mel_max_abs_err": mel_err, "wav_max_abs_err": wav_err,
          "int16_chunk_max_abs_err_lsb": chunk_err * 32767,
          "cuda_launches": launches["cuda"], "cpu_launches": launches["cpu"]})
    check_no_kernels(launches["cuda"], "tts_small_reference")
    check_no_kernels(launches["cpu"], "tts_small_reference CPU")
    # f32 on both sides, TF32 off; mel2ph is compared only where no
    # duration is within 10× the error of its rounding edge
    if not (margin > 10 * d_err and same and mel_err <= 1e-4
            and wav_err <= 1e-4 and chunk_err <= 1.0 / 32767 + 1e-6):
        raise AssertionError(f"card vs CPU TTS: mel2ph equal {same}, mel "
                             f"{mel_err}, wav {wav_err}, int16 "
                             f"{chunk_err * 32767} steps (duration margin "
                             f"{margin}, error {d_err})")


def phase_asr_small_reference() -> None:
    """A narrow whisper on the card (the encoder's 300 positions take the
    flash kernel) against the same weights on the CPU: the encoder output,
    the prime's logits, and the t = 0 tokens at each step whose top-2
    margin on the CPU exceeds 100× the logit error seen."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import ASREngine
    from audiogpt_tpu_torch.models.asr import WhisperConfig, whisper

    cfg = WhisperConfig(n_audio_ctx=300, n_audio_state=128, n_audio_head=2,
                        n_audio_layer=2, n_text_ctx=64, n_text_state=128,
                        n_text_head=2, n_text_layer=2, chunk_length=6)
    cpu = ASREngine(cfg, max_tokens=24, temperatures=(0.0,), device="cpu")
    fill_random(cpu.model, torch.Generator().manual_seed(6))
    card = ASREngine(cfg, max_tokens=24, temperatures=(0.0,))
    card.load_state_dict(cpu.model.state_dict())
    wav = speech_like(cfg.chunk_length, cfg.sample_rate, 3)
    prompt = torch.tensor([card.sot_sequence()])
    out, real = {}, whisper._pick
    for name, eng in (("cpu", cpu), ("cuda", card)):
        picks = []
        whisper._pick = lambda lg, t, g, picks=picks: (
            picks.append(lg.cpu()) or real(lg, t, g))
        try:
            mel = eng._mel(wav[None])
            with torch.inference_mode():
                xa, _, counts = counted(lambda: eng.model.encode(mel))
            logits = whisper.prime(eng.model, mel, prompt.to(mel.device),
                                   4)[2]
            toks = eng.transcribe_tokens(wav)[0, 4:]
        finally:
            whisper._pick = real
        out[name] = (xa.cpu(), logits.cpu(), toks, picks, counts)
    enc_err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    prime_err, compared, equal = err, 0, True
    n = len(out["cpu"][2])       # the last step's pick is not emitted
    for step, (lg_cpu, lg_card) in enumerate(zip(out["cpu"][3][:n],
                                                 out["cuda"][3][:n])):
        kept = torch.isfinite(lg_cpu)          # suppressed ids are -inf
        err = max(err, (lg_card - lg_cpu)[kept].abs().max().item())
        top2 = torch.topk(lg_cpu, 2, dim=-1).values
        if (top2[:, 0] - top2[:, 1]).min().item() <= 100 * err:
            break
        equal &= bool(out["cuda"][2][step] == out["cpu"][2][step])
        compared += 1
    emit({"phase": "asr_small_reference", "encoder_max_abs_err": enc_err,
          "prime_logits_max_abs_err": prime_err, "logit_err_seen": err,
          "steps_compared": compared, "steps": len(out["cpu"][2]),
          "tokens_equal": equal, "cuda_launches": out["cuda"][4],
          "cpu_launches": out["cpu"][4]})
    expected = expected_counts(asr_flash_shapes(cfg, [1]), Counter())
    if out["cuda"][4] != expected or any(out["cpu"][4].values()):
        raise AssertionError(f"small whisper launches {out['cuda'][4]}, "
                             f"expected {expected}; CPU {out['cpu'][4]}")
    # f32 on both sides, TF32 off
    if not (enc_err <= 1e-3 and prime_err <= 1e-3 and equal
            and compared >= 1):
        raise AssertionError(f"card vs CPU whisper: encoder {enc_err}, "
                             f"logits {prime_err}, {compared} steps "
                             f"compared, equal {equal}")


# ---------------------------------------------------------------------------
# I2A: the agent's "Generate Audio From The Image" tool (CLIP ViT-H/14)
# ---------------------------------------------------------------------------


def vit_flash_shapes(vcfg, batch: int, tokens: int) -> Counter:
    """Flash launches of one ViT pass (CLIP's, BLIP's), by shape: every
    block's self-attention over the ``tokens`` (the patches and the class
    token), when their pairs reach the dispatch rule's count
    (``ops/attention.py``)."""
    from audiogpt_tpu_torch.ops.attention import FLASH_MIN_PAIRS

    t = tokens
    if t * t < FLASH_MIN_PAIRS:
        return Counter()
    return Counter({(batch, t, t, vcfg.heads, vcfg.width // vcfg.heads):
                    vcfg.layers})


def i2a_path(eng, steps: int = I2A_STEPS) -> dict:
    """The launches of one ``img2audio`` call by shape, and its counts: the
    vision tower on one image, DDIM with the CFG pair (UNet batch 2, one
    context token: cross-attention stays plain), the vocoder on one mel.
    The ``""`` embedding is computed once per weight load."""
    cfg = eng.t2a.cfg
    flash = vit_flash_shapes(eng.vision_cfg, 1, eng.vision_cfg.tokens) \
        + flash_shapes(cfg, 2, cfg.latent_hw, steps, context=1)
    snake = snake_shapes(eng.t2a.vocoder.cfg, 1, cfg.mel_len)
    return {"flash": flash, "snake": snake,
            "counts": expected_counts(flash, snake)}


def seeded_image(path: str, size: int, seed: int) -> None:
    """A seeded [size, size, 3] uint8 image written as a PNG."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(seed)
    Image.fromarray(rs.randint(0, 256, (size, size, 3)).astype(
        np.uint8)).save(path)


def i2a_stage_ms(eng, image: str) -> dict:
    """Time of each layer of one warm ``img2audio`` call (as
    :func:`stage_ms`): the host's image preprocessing, the vision tower,
    the DDIM sampler with its UNet (and the host's time to queue it), VAE
    decode, vocoder."""
    import torch

    from audiogpt_tpu_torch.models.diffusion import ddim_sample
    from audiogpt_tpu_torch.models.textenc.clip import preprocess_image

    t2a = eng.t2a
    cfg = t2a.cfg
    h, w = cfg.latent_hw
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.inference_mode():
        t0 = time.perf_counter()
        img = torch.from_numpy(preprocess_image(
            image, eng.vision_cfg.image_size)).cuda()
        prep_s = time.perf_counter() - t0
        marks[0].record()
        ctx = eng.vision(img)[:, None, :]
        marks[1].record()
        gen = torch.Generator("cuda").manual_seed(55)
        x_T = torch.randn((1, cfg.unet.in_channels, h, w), generator=gen,
                          device="cuda")
        t0 = time.perf_counter()
        z = ddim_sample(t2a.eps, t2a.schedule, x_T, ctx, eng.uncond,
                        n_steps=I2A_STEPS, guidance_scale=3.0)
        host_s = time.perf_counter() - t0
        marks[2].record()
        mel = ((t2a.vae.decode(z / cfg.scale_factor) + 1.0) / 2.0).clamp(
            0, 1)
        marks[3].record()
        t2a.vocoder.vocode(mel[:, 0])
        marks[4].record()
    marks[4].synchronize()
    names = ("clip_vision_ms", "unet_sampler_ms", "vae_decode_ms",
             "bigvgan_ms")
    return {"preprocess_host_ms": prep_s * 1e3,
            "unet_sampler_host_ms": host_s * 1e3,
            **{n: a.elapsed_time(b) for n, a, b in zip(names, marks,
                                                       marks[1:])}}


def phase_i2a(main: dict, gen, tmp: str) -> dict:
    """The I2A tool's call at full width: ``I2AEngine`` (CLIP ViT-H/14 and
    the text tower of ``""``, seeded random weights) on the main path's
    T2A engine, one seeded 224 × 224 PNG by path, DDIM-100 at scale 3,
    seed 55: cold and warm (median of 3) times, RTF, set-up, peak memory,
    launches derived from the configs, and the layer times."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import I2AEngine

    held = torch.cuda.memory_allocated()     # the earlier engines, alive
    t0 = time.perf_counter()
    eng = I2AEngine(main["engine"])
    fill_random(eng.vision, gen)
    fill_random(eng.text, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    image = str(Path(tmp) / "photo.png")
    seeded_image(image, eng.vision_cfg.image_size, 7)
    with torch.inference_mode():
        norm = float(eng.embed_image(image).norm(dim=-1).max())
    if abs(norm - 1.0) > 1e-5:
        raise AssertionError(f"image embedding norm {norm}")

    def call():
        return eng.img2audio(image)

    expected = i2a_path(eng)["counts"]
    (cold_wav, sr), cold_s, cold_counts = counted(call)
    torch.cuda.reset_peak_memory_stats()
    runs = [counted(call) for _ in range(I2A_WARM_CALLS)]
    peak = torch.cuda.max_memory_allocated()
    for counts in [cold_counts] + [r[2] for r in runs]:
        if counts != expected:
            raise AssertionError(f"i2a launches {counts}, expected "
                                 f"{expected}")
    wav = runs[-1][0][0]
    n = main["engine"].cfg.mel_len * main["engine"].vocoder.hop_size
    if sr != 16000 or wav.shape != (n,) or not np.isfinite(wav).all() \
            or float(wav.std()) == 0.0:
        raise AssertionError(f"i2a wav {wav.shape} at {sr}, std {wav.std()}")
    # one seed, the same kernels on the same inputs: equal up to the order
    # in which a library kernel may sum
    drift = max(float(np.abs(r[0][0] - cold_wav).max()) for r in runs)
    if drift > 1e-5:
        raise AssertionError(f"i2a calls differ by {drift}")
    warm = sorted(r[1] for r in runs)
    median = statistics.median(warm)
    emit({"phase": "i2a", "call": "img2audio", "image": "224x224 png",
          "sampler": "ddim", "steps": I2A_STEPS, "scale": 3.0, "seed": 55,
          "embedding_norm": norm, "setup_s": setup_s, "cold_s": cold_s,
          "warm_s": median, "warm_max_s": warm[-1], "warm_calls": len(warm),
          "rtf": median / CLIP_SECONDS, "clip_s": CLIP_SECONDS,
          "peak_mem_gb": peak / 1e9, "i2a_peak_mem_gb": (peak - held) / 1e9,
          "params_m": sum(p.numel() for m in (eng.vision, eng.text)
                          for p in m.parameters()) / 1e6,
          "launches": runs[-1][2], "max_drift_between_calls": drift,
          "wav_std": float(wav.std())})
    stages = [i2a_stage_ms(eng, image) for _ in range(I2A_WARM_CALLS)]
    emit({"phase": "i2a_stages", "runs": I2A_WARM_CALLS,
          **{k: statistics.median(r[k] for r in stages) for k in stages[0]}})
    return {"engine": eng, "image": image, "wav": wav,
            "launches": runs[-1][2]}


def phase_i2a_small_reference() -> None:
    """A narrow CLIP (224 px, 257 tokens: its self-attention takes the
    kernel) and a narrow T2A engine on the card against the same weights on
    the CPU, with the same image and initial noise: the image context, the
    DDIM-100 core with the CFG pair, and the vocoder's wav."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import (I2AEngine, T2AConfig, T2AEngine,
                                            VocoderEngine)
    from audiogpt_tpu_torch.models.diffusion import UNetConfig, VAEConfig
    from audiogpt_tpu_torch.models.textenc import BertConfig, CLAPTextConfig
    from audiogpt_tpu_torch.models.textenc.clip import (CLIPTextConfig,
                                                        CLIPVisionConfig)
    from audiogpt_tpu_torch.models.vocoder import BigVGANConfig

    cfg = T2AConfig(
        unet=UNetConfig(model_channels=64, num_res_blocks=1, num_heads=2,
                        context_dim=64),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(), resolution=64),
        clap=CLAPTextConfig(bert=BertConfig(
            vocab_size=30522, hidden_size=64, num_layers=1, num_heads=2,
            intermediate_size=128), d_proj=64),
        mel_bins=32, mel_len=64, timesteps=1000)
    vcfg = BigVGANConfig(num_mels=32, upsample_initial_channel=64,
                         upsample_rates=(8, 8, 4),
                         upsample_kernel_sizes=(16, 16, 8))
    vision = CLIPVisionConfig(width=128, layers=2, heads=2, embed_dim=64)
    text = CLIPTextConfig(width=64, layers=1, heads=2, embed_dim=64)
    rs = np.random.RandomState(8)
    image = rs.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    outs, launches = {}, {}
    for dev in ("cpu", "cuda"):
        voc = VocoderEngine("bigvgan", cfg=vcfg, buckets=(64,), device=dev)
        t2a = T2AEngine(cfg, vocoder=voc, device=dev)
        eng = I2AEngine(t2a, vision, text, device=dev)
        modules = (t2a.unet, t2a.vae, voc.model, eng.vision, eng.text)
        if dev == "cpu":
            g = torch.Generator().manual_seed(9)
            for m in modules:
                fill_random(m, g)
            state = [m.state_dict() for m in modules]
            x_T = torch.randn(1, 4, 16, 32, generator=g)
        else:
            for m, sd in zip(modules, state):
                m.load_state_dict(sd)

        def core(eng=eng, voc=voc, x=x_T.to(dev)):
            ctx = eng.embed_image(image)
            mel = eng.sample(ctx, x, 3.0, I2A_STEPS)
            return ctx, mel, voc.vocode(mel[:, 0])

        out, _, launches[dev] = counted(core)
        outs[dev] = [t.cpu() for t in out]
        expected = expected_counts(
            vit_flash_shapes(vision, 1, vision.tokens)
            + flash_shapes(cfg, 2, cfg.latent_hw, I2A_STEPS, context=1),
            snake_shapes(vcfg, 1, cfg.mel_len))
    errs = {name: (a - b).abs().max().item() for name, a, b in zip(
        ("context", "mel", "wav"), outs["cpu"], outs["cuda"])}
    emit({"phase": "i2a_small_reference",
          **{f"{k}_max_abs_err": v for k, v in errs.items()},
          "cuda_launches": launches["cuda"], "cpu_launches": launches["cpu"]})
    # f32 on both sides, TF32 off: 1e-3 absolute on outputs in [-1, 1]
    bad = {k: v for k, v in errs.items() if not v <= 1e-3}
    if bad:
        raise AssertionError(f"card vs CPU I2A: {bad}")
    if launches["cuda"] != expected or any(launches["cpu"].values()):
        raise AssertionError(f"small I2A launches {launches['cuda']}, "
                             f"expected {expected}; CPU {launches['cpu']}")


# ---------------------------------------------------------------------------
# T2I: the agent's "Generate Image From User Input Text" tool (SD-1.x)
# I2T: the agent's "Get Photo Description" tool (BLIP-base)
# ---------------------------------------------------------------------------


def recorded_flash_streams(fn):
    """``fn()`` with every call that ``ops/attention.py`` hands the flash
    kernel's wrapper recorded by the stream it was queued on (its handle)
    and its shape (B, Tq, Tk, H, D) → (output, Counter of (stream, shape)).
    The wrapper and its launch count are untouched: this says at which
    shapes, and on which replica's stream, the counted launches were made.
    Replicas call from threads of their own, so the record is locked."""
    import importlib
    import threading

    import torch

    # the module (``ops/__init__.py`` exports a function of its name)
    attn = importlib.import_module("audiogpt_tpu_torch.ops.attention")
    real, seen, lock = attn.flash_attention, Counter(), threading.Lock()

    def recorder(q, k, v, **kw):
        key = (torch.cuda.current_stream(q.device).cuda_stream,
               (q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3]))
        with lock:
            seen[key] += 1
        return real(q, k, v, **kw)

    attn.flash_attention = recorder
    try:
        return fn(), seen
    finally:
        attn.flash_attention = real


def recorded_flash(fn):
    """:func:`recorded_flash_streams` summed over the streams → (output,
    Counter of shapes)."""
    out, seen = recorded_flash_streams(fn)
    shapes = Counter()
    for (_, shape), n in seen.items():
        shapes[shape] += n
    return out, shapes


def t2i_path(eng, steps: int = T2I_STEPS) -> dict:
    """The launches of one T2I tool call by shape, and its counts: DDIM with
    the CFG pair (UNet batch 2) on the 77 CLIP tokens; the text tower's
    77² pairs and the VAE stay plain."""
    cfg = eng.cfg
    flash = flash_shapes(cfg, 2, cfg.latent_hw, steps,
                         cfg.text.context_length)
    return {"flash": flash,
            "counts": expected_counts(flash, Counter(), cfg.unet_bf16)}


def i2t_path(eng) -> dict:
    """The launches of one I2T tool call by shape, and its counts: the
    vision tower on one image; the decoder's attentions stay plain."""
    vcfg = eng.cfg.vision
    flash = vit_flash_shapes(vcfg, 1, vcfg.seq_len)
    return {"flash": flash, "counts": expected_counts(flash, Counter())}


def check_recorded(what: str, counts: dict, shapes: Counter,
                   path: dict) -> None:
    """The counted launches and the recorded shapes of one call against the
    path's derived ones."""
    if counts != path["counts"] or shapes != path["flash"]:
        raise AssertionError(f"{what}: launches {counts}, shapes "
                             f"{dict(shapes)}; expected {path['counts']}, "
                             f"{dict(path['flash'])}")


def t2i_stage_ms(eng) -> dict:
    """Time of each layer of one warm T2I tool call (as :func:`stage_ms`):
    the CLIP text tower (tokenising included), the DDIM-50 sampler with its
    UNet (and the host's time to queue it), VAE decode, and on the host
    the image's copy (which waits for the device to finish the queued
    work) and the PNG write."""
    import numpy as np
    import torch
    from PIL import Image

    from audiogpt_tpu_torch.models.diffusion import ddim_sample

    cfg = eng.cfg
    h, w = cfg.latent_hw
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        marks[0].record()
        both = eng.encode_ids(eng._tokenize([T2I_TEXT, ""]))
        marks[1].record()
        x_T = torch.randn((1, cfg.unet.in_channels, h, w), device="cuda")
        t0 = time.perf_counter()
        z = ddim_sample(eng.eps, eng.schedule, x_T, both[:1], both[1:],
                        n_steps=T2I_STEPS, guidance_scale=7.5)
        host_s = time.perf_counter() - t0
        marks[2].record()
        img = ((eng.vae.decode(z / cfg.scale_factor) + 1.0) / 2.0).clamp(
            0.0, 1.0)
        marks[3].record()
        t0 = time.perf_counter()
        arr = img.permute(0, 2, 3, 1).cpu().numpy()
        copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Image.fromarray((arr[0] * 255).astype(np.uint8)).save(
        Path(eng.media_root) / "stage.png")
    png_s = time.perf_counter() - t0
    names = ("clip_text_ms", "unet_sampler_ms", "vae_decode_ms")
    return {"unet_sampler_host_ms": host_s * 1e3,
            "image_to_host_ms": copy_s * 1e3, "png_write_ms": png_s * 1e3,
            **{n: a.elapsed_time(b) for n, a, b in zip(names, marks,
                                                       marks[1:])}}


def phase_t2i(gen, tmp: str) -> dict:
    """The T2I tool's call at full width: ``T2IEngine(T2IConfig())`` (the
    SD-1.x UNet, the f8 RGB VAE at 512 × 512, CLIP ViT-L/14's text tower;
    seeded random weights) called as the toolset calls it, text → PNG path
    (DDIM-50, scale 7.5, the CFG pair): set-up, cold and warm (median of
    3) times, peak memory above the earlier engines, K1 launches by shape
    (1 250, 250 of them at D = 160) and none of K2; the PNG; the time of
    each layer; one traced call (the device's busy share)."""
    import numpy as np
    import torch
    from PIL import Image

    from audiogpt_tpu_torch.engines import T2IConfig, T2IEngine

    held = torch.cuda.memory_allocated()     # the earlier engines, alive
    root = Path(tmp) / "t2i"
    t0 = time.perf_counter()
    eng = T2IEngine(T2IConfig(), media_root=str(root))
    for m in (eng.unet, eng.vae, eng.text):
        fill_random(m, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    path = t2i_path(eng)
    d160 = sum(n for s, n in path["flash"].items() if s[-1] == 160)

    def call():
        return eng(T2I_TEXT)

    (rel, shapes), cold_s, cold_counts = counted(
        lambda: recorded_flash(call))
    check_recorded("t2i", cold_counts, shapes, path)
    torch.cuda.reset_peak_memory_stats()
    runs = [counted(call) for _ in range(T2I_WARM_CALLS)]
    peak = torch.cuda.max_memory_allocated()
    for _, _, counts in runs:
        if counts != path["counts"]:
            raise AssertionError(f"t2i launches {counts}, expected "
                                 f"{path['counts']}")
    with Image.open(root / runs[-1][0]) as im:
        png = np.asarray(im)
    img = eng.txt2img(T2I_TEXT, seed=0)
    if png.shape != (512, 512, 3) or float(png.std()) == 0.0 \
            or img.shape != (1, 512, 512, 3) or not np.isfinite(img).all() \
            or not 0.0 <= img.min() <= img.max() <= 1.0:
        raise AssertionError(f"t2i png {png.shape} std {png.std()}, image "
                             f"{img.shape} in [{img.min()}, {img.max()}]")
    warm = sorted(r[1] for r in runs)
    median = statistics.median(warm)
    emit({"phase": "t2i", "call": "T2IEngine.__call__", "size": "512x512",
          "sampler": "ddim", "steps": T2I_STEPS, "scale": 7.5,
          "setup_s": setup_s, "cold_s": cold_s, "warm_s": median,
          "warm_max_s": warm[-1], "warm_calls": len(warm),
          "peak_mem_gb": peak / 1e9, "t2i_peak_mem_gb": (peak - held) / 1e9,
          "params_m": sum(p.numel() for m in (eng.unet, eng.vae, eng.text)
                          for p in m.parameters()) / 1e6,
          "launches": runs[-1][2],
          "launches_by_shape": {str(list(s)): n for s, n in shapes.items()},
          "launches_d160": d160, "png": list(png.shape),
          "png_std": float(png.std()), "image_mean": float(img.mean())})
    if d160 != 250:
        raise AssertionError(f"t2i: {d160} launches at D = 160")
    stages = [t2i_stage_ms(eng) for _ in range(T2I_WARM_CALLS)]
    emit({"phase": "t2i_stages", "runs": T2I_WARM_CALLS,
          **{k: statistics.median(r[k] for r in stages) for k in stages[0]}})
    profile_call("t2i_profile", call, median)
    return {"engine": eng, "launches": runs[-1][2], "image": img}


def phase_t2i_bf16(t2i: dict) -> dict:
    """The T2I engine's weights under ``T2IConfig(unet_bf16=True)`` (a bf16
    copy of the UNet, cast once): the same call on K1's bf16 entry alone,
    its counts and shapes, warm median of 3, and the seed-0 image's
    distance from the f32 engine's."""
    import dataclasses

    import numpy as np

    from audiogpt_tpu_torch.engines import T2IEngine

    base = t2i["engine"]
    eng = T2IEngine(dataclasses.replace(base.cfg, unet_bf16=True),
                    tokenizer=base.tokenizer, media_root=base.media_root)
    eng.load_state_dict({name: getattr(base, name).state_dict()
                         for name in ("unet", "vae", "text")})
    path = t2i_path(eng)

    def call():
        return eng(T2I_TEXT)

    (_, shapes), cold_s, cold_counts = counted(lambda: recorded_flash(call))
    check_recorded("t2i_bf16", cold_counts, shapes, path)
    runs = [counted(call) for _ in range(T2I_WARM_CALLS)]
    if any(r[2] != path["counts"] for r in runs):
        raise AssertionError(f"t2i_bf16 launches {[r[2] for r in runs]}")
    img = eng.txt2img(T2I_TEXT, seed=0)
    if not np.isfinite(img).all():
        raise AssertionError("t2i_bf16: non-finite image")
    warm = sorted(r[1] for r in runs)
    emit({"phase": "t2i_bf16", "cold_s": cold_s,
          "warm_s": statistics.median(warm), "warm_max_s": warm[-1],
          "warm_calls": len(warm), "launches": runs[-1][2],
          "image_max_abs_diff_from_f32": float(
              np.abs(img - t2i["image"]).max()),
          "image_mean_abs_diff_from_f32": float(
              np.abs(img - t2i["image"]).mean())})
    return {"launches": runs[-1][2]}


def phase_t2i_small_reference() -> None:
    """A narrow T2I engine on the card against the same weights on the CPU:
    a 3-level UNet (160 channels, 4 heads: D = 40, 80, 160, so every K1
    width of the tool's call) on 64 × 64 latents, an f2 RGB VAE, a 1-layer
    CLIP text tower; the text states and the DDIM core with the CFG pair
    from the same initial noise, and the card's launches against the
    configs."""
    import torch

    from audiogpt_tpu_torch.engines import T2IConfig, T2IEngine
    from audiogpt_tpu_torch.models.diffusion import UNetConfig, VAEConfig
    from audiogpt_tpu_torch.models.textenc.clip import CLIPTextConfig

    cfg = T2IConfig(
        unet=UNetConfig(model_channels=160, num_res_blocks=1,
                        attention_resolutions=(1, 2, 4),
                        channel_mult=(1, 2, 4), num_heads=4, context_dim=64),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(), in_channels=3, out_ch=3,
                      resolution=128),
        text=CLIPTextConfig(width=64, layers=1, heads=2, embed_dim=64),
        height=128, width=128)
    steps = 2
    outs, launches = {}, {}
    for dev in ("cpu", "cuda"):
        eng = T2IEngine(cfg, device=dev)
        modules = (eng.unet, eng.vae, eng.text)
        if dev == "cpu":
            g = torch.Generator().manual_seed(12)
            for m in modules:
                fill_random(m, g)
            state = [m.state_dict() for m in modules]
            x_T = torch.randn(1, 4, 64, 64, generator=g)
        else:
            for m, sd in zip(modules, state):
                m.load_state_dict(sd)

        def core(eng=eng, x=x_T.to(dev)):
            both = eng.encode_ids(eng._tokenize([T2I_TEXT, ""]))
            return both, eng.sample(both[:1], both[1:], x, 7.5, steps)

        out, _, launches[dev] = counted(core)
        outs[dev] = [t.cpu() for t in out]
    path = flash_shapes(cfg, 2, cfg.latent_hw, steps,
                        cfg.text.context_length)
    expected = expected_counts(path, Counter())
    errs = {name: (a - b).abs().max().item() for name, a, b in zip(
        ("context", "image"), outs["cpu"], outs["cuda"])}
    emit({"phase": "t2i_small_reference",
          **{f"{k}_max_abs_err": v for k, v in errs.items()},
          "cuda_launches": launches["cuda"], "cpu_launches": launches["cpu"],
          "shapes": {str(list(s)): n for s, n in path.items()}})
    # f32 on both sides, TF32 off: 1e-3 absolute on images in [0, 1]
    bad = {k: v for k, v in errs.items() if not v <= 1e-3}
    if bad:
        raise AssertionError(f"card vs CPU T2I: {bad}")
    if launches["cuda"] != expected or any(launches["cpu"].values()) \
            or not any(s[-1] == 160 for s in path):
        raise AssertionError(f"small T2I launches {launches['cuda']}, "
                             f"expected {expected}; CPU {launches['cpu']}")


def i2t_decode_parts(eng, image: str) -> dict:
    """One warm caption taken apart between CUDA events: the image's
    preprocessing on the host, the vision tower, the cross K/V projection,
    and the greedy decode (the BOS step and ``max_tokens - 1`` cached
    steps) per token; and the device launches of one cached step."""
    import torch

    from audiogpt_tpu_torch.models.caption.blip import preprocess_image
    from audiogpt_tpu_torch.ops.attention import KVCache

    model, cfg = eng.model, eng.cfg.text
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.inference_mode():
        t0 = time.perf_counter()
        px = torch.from_numpy(preprocess_image(
            image, eng.cfg.vision.image_size)).cuda()
        prep_s = time.perf_counter() - t0
        marks[0].record()
        img = model.encode_image(px)
        marks[1].record()
        cross = model.cross_kvs(img)
        marks[2].record()
        caches = [KVCache.create(1, 1 + eng.max_tokens, cfg.heads,
                                 cfg.width // cfg.heads, img.dtype, "cuda")
                  for _ in range(cfg.layers)]
        tok = torch.full((1, 1), cfg.bos_id, dtype=torch.long, device="cuda")
        for i in range(eng.max_tokens):
            tok = model.decode_step(tok, cross, i, caches)[:, -1].argmax(
                -1, keepdim=True)
        marks[3].record()
        marks[3].synchronize()
        caches = [KVCache.create(1, 1, cfg.heads, cfg.width // cfg.heads,
                                 img.dtype, "cuda")
                  for _ in range(cfg.layers)]
        step = device_launches(
            lambda: model.decode_step(tok, cross, 1, caches))
    vision, cross_ms, decode = (a.elapsed_time(b) for a, b in
                                zip(marks, marks[1:]))
    return {"preprocess_host_ms": prep_s * 1e3, "vision_ms": vision,
            "cross_kv_ms": cross_ms, "decode_ms": decode,
            "decode_ms_per_token": decode / eng.max_tokens,
            "device_launches_per_step": step}


def phase_i2t(gen, tmp: str) -> dict:
    """The I2T tool's call at full width: ``ImageCaptionEngine()``
    (BLIP-base: ViT-B/16 at 384 px, 12 + 12 layers; seeded random
    weights) on one seeded 512 × 512 PNG by path: set-up, cold and warm
    (median of 5) times, peak memory above the earlier engines, K1 at
    [1, 577, 12, 64] (12 a call), the decode per token and the launches
    of one decode step."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import ImageCaptionEngine
    from audiogpt_tpu_torch.models.caption.blip import preprocess_image

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = ImageCaptionEngine(media_root=tmp)
    fill_random(eng.model, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    image = str(Path(tmp) / "i2t_photo.png")
    seeded_image(image, 512, 11)
    path = i2t_path(eng)

    def call():
        return eng(image)

    (caption, shapes), cold_s, cold_counts = counted(
        lambda: recorded_flash(call))
    check_recorded("i2t", cold_counts, shapes, path)
    torch.cuda.reset_peak_memory_stats()
    runs = [counted(call) for _ in range(I2T_WARM_CALLS)]
    peak = torch.cuda.max_memory_allocated()
    if any(r[2] != path["counts"] or r[0] != caption for r in runs):
        raise AssertionError(f"i2t calls: {[(r[0], r[2]) for r in runs]}")
    toks = eng.caption_tokens(preprocess_image(image, 384))
    t = eng.cfg.text
    if toks.shape != (1, 1 + eng.max_tokens) or toks[0, 0] != t.bos_id \
            or not (0 <= toks).all() or not (toks < t.vocab_size).all() \
            or not isinstance(caption, str):
        raise AssertionError(f"i2t tokens {toks}, caption {caption!r}")
    warm = sorted(r[1] for r in runs)
    emit({"phase": "i2t", "call": "ImageCaptionEngine.__call__",
          "image": "512x512 png", "max_tokens": eng.max_tokens,
          "setup_s": setup_s, "cold_s": cold_s,
          "warm_s": statistics.median(warm), "warm_max_s": warm[-1],
          "warm_calls": len(warm), "peak_mem_gb": peak / 1e9,
          "i2t_peak_mem_gb": (peak - held) / 1e9,
          "params_m": sum(p.numel() for p in eng.model.parameters()) / 1e6,
          "launches": runs[-1][2], "caption_chars": len(caption),
          "tokens": toks[0].tolist(),
          "eos_at": int(np.argmax(toks[0, 1:] == t.eos_id))
          if (toks[0, 1:] == t.eos_id).any() else None})
    parts = [i2t_decode_parts(eng, image) for _ in range(I2T_WARM_CALLS)]
    emit({"phase": "i2t_stages", "runs": I2T_WARM_CALLS,
          **{k: statistics.median(r[k] for r in parts) for k in parts[0]}})
    return {"engine": eng, "image": image, "caption": caption,
            "launches": runs[-1][2]}


def phase_i2t_small_reference() -> None:
    """A narrow BLIP (384 px: 577 tokens, whose self-attention takes K1 at
    D = 64; 2 + 2 layers) on the card against the same weights on the CPU:
    the vision states, the greedy tokens (equal) and the card's launches."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.models.caption.blip import (BlipCaptioner,
                                                        BlipConfig,
                                                        BlipTextConfig,
                                                        BlipVisionConfig,
                                                        greedy_caption)

    cfg = BlipConfig(
        vision=BlipVisionConfig(width=128, layers=2, heads=2, mlp_dim=256),
        text=BlipTextConfig(vocab_size=1000, width=64, layers=2, heads=2,
                            mlp_dim=128, encoder_width=128, bos_id=998,
                            eos_id=102))
    images = np.random.RandomState(13).randn(1, 384, 384, 3).astype(
        np.float32)
    outs, launches = {}, {}
    for dev in ("cpu", "cuda"):
        model = BlipCaptioner(cfg).to(dev).eval()
        if dev == "cpu":
            fill_random(model, torch.Generator().manual_seed(14))
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        x = torch.from_numpy(images).to(dev)

        def core(model=model, x=x):
            with torch.inference_mode():
                return (model.encode_image(x),
                        greedy_caption(model, x, max_tokens=8))

        out, _, launches[dev] = counted(core)
        outs[dev] = [t.cpu() for t in out]
    # two vision passes: ``encode_image`` and the caption's own
    vit = vit_flash_shapes(cfg.vision, 1, cfg.vision.seq_len)
    expected = expected_counts(vit + vit, Counter())
    err = (outs["cpu"][0] - outs["cuda"][0]).abs().max().item()
    equal = bool(torch.equal(outs["cpu"][1], outs["cuda"][1]))
    emit({"phase": "i2t_small_reference", "vision_max_abs_err": err,
          "tokens_equal": equal, "tokens": outs["cuda"][1][0].tolist(),
          "cuda_launches": launches["cuda"], "cpu_launches": launches["cpu"]})
    if not (err <= 1e-3 and equal):
        raise AssertionError(f"card vs CPU BLIP: vision {err}, tokens "
                             f"{outs['cpu'][1]} vs {outs['cuda'][1]}")
    if launches["cuda"] != expected or any(launches["cpu"].values()):
        raise AssertionError(f"small BLIP launches {launches['cuda']}, "
                             f"expected {expected}; CPU {launches['cpu']}")


# ---------------------------------------------------------------------------
# the audio analysis and transform tools
# ---------------------------------------------------------------------------


def events_like(seconds: float, sr: int, seed: int):
    """A seeded sound-event test signal: a noise floor, three tone bursts
    (each its own pitch and start) and a train of clicks."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    x = 0.02 * rng.randn(n)
    for hz in (440.0, 1250.0, 3100.0):
        start = rng.rand() * seconds * 0.7
        env = ((t >= start) & (t < start + 0.3 * seconds)).astype(np.float64)
        x += 0.2 * env * np.sin(2 * np.pi * hz * t + 6.28 * rng.rand())
    x[::int(sr * 0.37)] += 0.5
    return x.astype(np.float32)


def tool_runs(fn, warm: int) -> dict:
    """A cold and ``warm`` counted calls of ``fn``, neither kernel launched
    in any: the output, cold time, warm median and slowest, and the peak
    memory of the warm calls."""
    import torch

    cold = counted(fn)
    torch.cuda.reset_peak_memory_stats()
    runs = [counted(fn) for _ in range(warm)]
    peak = torch.cuda.max_memory_allocated()
    for _, _, counts in [cold] + runs:
        check_no_kernels(counts, "tool call")
    warm_s = sorted(r[1] for r in runs)
    return {"out": cold[0], "outs": [r[0] for r in runs], "cold_s": cold[1],
            "warm_s": statistics.median(warm_s), "warm_max_s": warm_s[-1],
            "warm_calls": warm, "peak": peak, "launches": runs[-1][2]}


def event_ms(steps) -> dict:
    """Run each ``(name, fn)`` of ``steps`` in turn between CUDA events
    → {name_ms: device-clock time}, and the last output."""
    import torch

    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(len(steps) + 1)]
    out = None
    with torch.inference_mode():
        marks[0].record()
        for mark, (_, fn) in zip(marks[1:], steps):
            out = fn(out)
            mark.record()
        marks[-1].synchronize()
    return {f"{name}_ms": a.elapsed_time(b)
            for (name, _), a, b in zip(steps, marks, marks[1:])}, out


def median_parts(runs: list) -> dict:
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def caption_stage_ms(eng, wav) -> dict:
    """One warm greedy caption taken apart between CUDA events: Cnn14, the
    GRU, and the re-run decode per position; and the device launches of
    one position."""
    import torch

    from audiogpt_tpu_torch.models.caption.captioner import greedy_tokens

    model = eng.model
    padded, n = eng._padded(wav)
    enc = {}

    def cnn(_):
        enc.update(model.cnn(padded, n))

    def gru(_):
        return model.rnn(enc["attn_emb"], enc["attn_emb_len"])

    def decode(memory):
        enc["memory"] = memory
        return greedy_tokens(model, memory, enc["attn_emb_len"])

    parts, toks = event_ms([("cnn14", cnn), ("gru", gru),
                            ("decode", decode)])
    positions = eng.cfg.max_caption_len - 1
    parts["decode_ms_per_position"] = parts["decode_ms"] / positions
    with torch.inference_mode():
        parts["device_launches_per_position"] = device_launches(
            lambda: model.decode_logits(toks, enc["memory"],
                                        enc["attn_emb_len"]))
    return parts


def phase_caption(gen) -> dict:
    """The "Generate Text From The Audio" tool at the app's width:
    ``CaptionEngine()`` (Cnn14 2048 wide, a bidirectional GRU of 512, a
    2-layer decoder of 256 over 4 981 words; seeded random weights) on a
    10 s events clip at 32 kHz (the 512 000-sample bucket): greedy and
    beam-3, each cold and warm (median of 5), set-up, peak memory above
    the earlier engines, RTF, neither kernel launched; the layer times."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import CaptionEngine

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = CaptionEngine()
    fill_random(eng.model, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wav = events_like(TOOL_SECONDS, eng.sr, 21)
    greedy = tool_runs(lambda: eng.caption(wav), TOOL_WARM_CALLS)
    beam = tool_runs(lambda: eng.caption_beam(wav, 3), TOOL_WARM_CALLS)
    toks = eng.caption_tokens(wav)
    cfg = eng.cfg
    if toks.shape != (cfg.max_caption_len,) or toks[0] != cfg.sos_id \
            or not ((0 <= toks) & (toks < cfg.vocab_size)).all() \
            or any(o != greedy["out"] for o in greedy["outs"]) \
            or any(o != beam["out"] for o in beam["outs"]):
        raise AssertionError(f"caption tokens {toks}, captions "
                             f"{greedy['outs']}, {beam['outs']}")
    emit({"phase": "caption", "call": "CaptionEngine.caption",
          "clip_s": TOOL_SECONDS, "bucket": eng.bucketer.bucket(len(wav)),
          "setup_s": setup_s, "cold_s": greedy["cold_s"],
          "warm_s": greedy["warm_s"], "warm_max_s": greedy["warm_max_s"],
          "warm_calls": TOOL_WARM_CALLS,
          "rtf": greedy["warm_s"] / TOOL_SECONDS,
          "beam3_cold_s": beam["cold_s"], "beam3_warm_s": beam["warm_s"],
          "beam3_rtf": beam["warm_s"] / TOOL_SECONDS,
          "caption_peak_mem_gb": (max(greedy["peak"], beam["peak"]) - held)
          / 1e9,
          "params_m": sum(p.numel() for p in eng.model.parameters()) / 1e6,
          "launches": greedy["launches"], "beam3_launches": beam["launches"],
          "tokens": toks.tolist(),
          "eos_at": int(np.argmax(toks[1:] == cfg.eos_id))
          if (toks[1:] == cfg.eos_id).any() else None})
    runs = [caption_stage_ms(eng, wav) for _ in range(STAGE_RUNS)]
    emit({"phase": "caption_stages", "runs": STAGE_RUNS, **median_parts(runs)})
    return {"engine": eng, "wav": wav, "caption": greedy["out"]}


def sed_stage_ms(eng, wav) -> dict:
    """One warm SED call taken apart between CUDA events: the net (the
    frontend and backbone included), the copy of the framewise matrix to
    the host; then on the host the figure's data, its drawing and the PNG
    write."""
    from audiogpt_tpu_torch.engines.analysis import render_sed_figure

    import torch

    x = torch.from_numpy(wav).to(eng.device)
    padded, n = eng.bucketer.pad_to_bucket(x[None])
    frames = math.ceil(n / eng.cfg.hop)
    parts, _ = event_ms([
        ("net", lambda _: eng.model(padded)["framewise_output"]),
        ("to_host", lambda fw: fw[0, :frames].cpu())])
    t0 = time.perf_counter()
    panels = eng.plot_panels(wav)
    parts["panels_host_ms"] = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        render_sed_figure(panels, str(Path(tmp) / "sed.png"))
        parts["draw_and_png_write_host_ms"] = (time.perf_counter() - t0) * 1e3
    return parts


def phase_sed(gen, tmp: str) -> dict:
    """The "Detect The Sound Event From The Audio" tool at the app's width:
    ``SEDEngine()`` (PANN-SED: Cnn14 2048 wide, 527 classes; seeded random
    weights) on a 10 s events clip: ``framewise``, ``detect`` and ``plot``
    (the tool's call: a PNG), each cold and warm (median of 5), the PNG
    drawing and write timed apart; set-up, peak memory, RTF, neither
    kernel launched; the layer times."""
    import numpy as np
    import torch
    from PIL import Image

    from audiogpt_tpu_torch.engines import SEDEngine

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = SEDEngine()
    fill_random(eng.model, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wav = events_like(TOOL_SECONDS, eng.cfg.sample_rate, 22)
    png = str(Path(tmp) / "sed_direct.png")
    fw = tool_runs(lambda: eng.framewise(wav), TOOL_WARM_CALLS)
    det = tool_runs(lambda: eng.detect(wav), TOOL_WARM_CALLS)
    plot = tool_runs(lambda: eng.plot(wav, png), TOOL_WARM_CALLS)
    out = fw["out"]
    frames = math.ceil(len(wav) / eng.cfg.hop)
    with Image.open(png) as im:
        size = im.size
    if out.shape != (frames, 527) or not np.isfinite(out).all() \
            or not 0.0 <= out.min() <= out.max() <= 1.0 \
            or len(det["out"]) != 10 or size != (1000, 400):
        raise AssertionError(f"sed framewise {out.shape} in [{out.min()}, "
                             f"{out.max()}], {len(det['out'])} events, png "
                             f"{size}")
    emit({"phase": "sed", "model": "panns_cnn14", "clip_s": TOOL_SECONDS,
          "bucket": eng.bucketer.bucket(len(wav)), "setup_s": setup_s,
          "cold_s": plot["cold_s"], "warm_s": plot["warm_s"],
          "warm_max_s": plot["warm_max_s"], "warm_calls": TOOL_WARM_CALLS,
          "rtf": plot["warm_s"] / TOOL_SECONDS,
          "framewise_warm_s": fw["warm_s"], "detect_warm_s": det["warm_s"],
          "sed_peak_mem_gb": (max(fw["peak"], plot["peak"]) - held) / 1e9,
          "params_m": sum(p.numel() for p in eng.model.parameters()) / 1e6,
          "launches": plot["launches"], "frames": frames,
          "top3": [e["label"] for e in det["out"][:3]], "png": list(size)})
    runs = [sed_stage_ms(eng, wav) for _ in range(STAGE_RUNS)]
    emit({"phase": "sed_stages", "runs": STAGE_RUNS, **median_parts(runs)})
    return {"engine": eng, "wav": wav}


def pvt_flash_shapes(cfg, n_samples: int) -> Counter:
    """K1 launches of one PVT SED call on ``n_samples`` (a bucket), by shape
    (B, Tq, Tk, H, D), from the config: the mel grid (frames × mel bins)
    through each stage's patch embed (k7 s4, then k3 s2; padding k // 3),
    and the stage's blocks where its spatial-reduction attention (keys from
    the ``sr × sr`` unpadded conv) reaches ``ops/attention.py``'s pair
    count at a head dim the kernel takes."""
    from audiogpt_tpu_torch.ops.attention import FLASH_MIN_PAIRS
    from audiogpt_tpu_torch.ops.flash_attention import MAX_HEAD_DIM

    h, w = n_samples // cfg.hop + 1, cfg.mel.n_mels
    shapes = Counter()
    for i, (dim, depth, heads, sr) in enumerate(zip(
            cfg.embed_dims, cfg.depths, cfg.num_heads, cfg.sr_ratios)):
        k, s = (7, 4) if i == 0 else (3, 2)
        h, w = (h + 2 * (k // 3) - k) // s + 1, (w + 2 * (k // 3) - k) // s + 1
        tokens = h * w
        keys = (h // sr) * (w // sr) if sr > 1 else tokens
        d = dim // heads
        if tokens * keys >= FLASH_MIN_PAIRS and d <= MAX_HEAD_DIM \
                and d % 4 == 0:
            shapes[(1, tokens, keys, heads, d)] += depth
    return shapes


def sed_pvt_path(eng, n_samples: int) -> dict:
    flash = pvt_flash_shapes(eng.cfg, eng.bucketer.bucket(n_samples))
    return {"flash": flash, "counts": expected_counts(flash, Counter())}


def phase_sed_pvt(flash: dict, gen) -> dict:
    """The SED tool on the reference's own net: ``SEDEngine(model=
    PVTSED(PVTConfig()))`` (PVTv2-b2: dims 64/128/320/512, depths 3/4/6/3;
    seeded random weights) on a 10 s and a 32 s events clip: K1 launches
    by recorded shape against the config's (7 and 13), K2 none; cold and
    warm times (median of 5, 3 at 32 s), peak memory, RTF, and K1's time
    in the call (its per-launch time at each shape, from the flash cells,
    times the launches)."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import SEDEngine
    from audiogpt_tpu_torch.models.sed import PVTSED, PVTConfig

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = SEDEngine(model=PVTSED(PVTConfig()))
    fill_random(eng.model, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    out = {"engine": eng}
    for seconds, warm, want in ((TOOL_SECONDS, TOOL_WARM_CALLS, 7),
                                (PVT_LONG_SECONDS, 3, 13)):
        wav = events_like(seconds, eng.cfg.sample_rate, 23)
        path = sed_pvt_path(eng, len(wav))
        if sum(path["flash"].values()) != want:
            raise AssertionError(f"sed_pvt {seconds} s: derived "
                                 f"{dict(path['flash'])}, not {want}")

        def call():
            return eng.framewise(wav)

        (fw, shapes), cold_s, cold_counts = counted(
            lambda: recorded_flash(call))
        check_recorded(f"sed_pvt {seconds} s", cold_counts, shapes, path)
        torch.cuda.reset_peak_memory_stats()
        runs = [counted(call) for _ in range(warm)]
        peak = torch.cuda.max_memory_allocated()
        if any(r[2] != path["counts"] for r in runs):
            raise AssertionError(f"sed_pvt launches {[r[2] for r in runs]}")
        frames = math.ceil(len(wav) / eng.cfg.hop)
        if fw.shape != (frames, 527) or not np.isfinite(fw).all() \
                or not 0.0 <= fw.min() <= fw.max() <= 1.0:
            raise AssertionError(f"sed_pvt framewise {fw.shape}")
        key = "sed_pvt" if seconds == TOOL_SECONDS else "sed_pvt_32s"
        k1 = path_record(flash["float32"], key, path["flash"],
                         runs[-1][2]["flash_attention"])
        warm_s = statistics.median(r[1] for r in runs)
        emit({"phase": key, "model": "pvtv2_b2", "clip_s": seconds,
              "bucket": eng.bucketer.bucket(len(wav)), "setup_s": setup_s,
              "cold_s": cold_s, "warm_s": warm_s, "warm_calls": warm,
              "rtf": warm_s / seconds,
              "sed_pvt_peak_mem_gb": (peak - held) / 1e9,
              "launches": runs[-1][2],
              "launches_by_shape": {str(list(s)): n
                                    for s, n in shapes.items()},
              "k1_ms_of_call": k1["ms"], "k1_plain_ms_of_call":
              k1["plain_ms"], "k1_sdpa_ms_of_call": k1["library_ms"],
              "k1_bound_ms_of_call": k1["bound_ms"]})
        out[key] = {"path": path, "launches": runs[-1][2]}
    return out


def tsd_threshold(probs):
    """A threshold in the widest gap among the middle half of the sorted
    ``probs``: about half the frames active, and no frame near it."""
    import numpy as np

    p = np.sort(probs)
    lo, hi = len(p) // 4, 3 * len(p) // 4
    i = lo + int(np.argmax(np.diff(p[lo:hi + 1])))
    return float((p[i] + p[i + 1]) / 2)


def phase_tsd(gen) -> dict:
    """The "Target Sound Detection" tool at the app's width: ``TSDEngine()``
    (the CDur-style net: 4 conv blocks 64–512, a bidirectional GRU of 512;
    the CLAP text tower, BERT-base, for the query; seeded random weights)
    on a 10 s events clip at 22.05 kHz with a text query: cold and warm
    (median of 5), set-up, peak memory, RTF, neither kernel launched; the
    split between the CLAP text tower and the TSD net."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.dsp.mel import log_mel
    from audiogpt_tpu_torch.engines import TSDEngine

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = TSDEngine()
    fill_random(eng.model, gen)
    fill_random(eng.clap, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wav = events_like(TOOL_SECONDS, eng.mel.sr, 24)
    probs = eng.decision(wav, TSD_TEXT)
    thr = tsd_threshold(probs)
    runs = tool_runs(lambda: eng.detect(wav, TSD_TEXT, threshold=thr),
                     TOOL_WARM_CALLS)
    frames = len(wav) // eng.mel.hop + 1
    if probs.shape != (frames,) or not np.isfinite(probs).all() \
            or not runs["out"] or any(o != runs["out"] for o in runs["outs"]):
        raise AssertionError(f"tsd probabilities {probs.shape}, spans "
                             f"{runs['out']}")
    x = torch.from_numpy(wav).to(eng.device)

    def net(emb):
        m = log_mel(x, eng.mel)
        padded, _ = eng.bucketer.pad_to_bucket(m[None], axis=1)
        return eng.model(padded, emb)[1]

    parts = [event_ms([("clap_text", lambda _: eng.embed_text(TSD_TEXT)),
                       ("tsd_net", net)])[0] for _ in range(STAGE_RUNS)]
    emit({"phase": "tsd", "clip_s": TOOL_SECONDS, "sr": eng.mel.sr,
          "bucket_frames": eng.bucketer.bucket(frames), "setup_s": setup_s,
          "cold_s": runs["cold_s"], "warm_s": runs["warm_s"],
          "warm_max_s": runs["warm_max_s"], "warm_calls": TOOL_WARM_CALLS,
          "rtf": runs["warm_s"] / TOOL_SECONDS,
          "tsd_peak_mem_gb": (runs["peak"] - held) / 1e9,
          "params_m": sum(p.numel() for m in (eng.model, eng.clap)
                          for p in m.parameters()) / 1e6,
          "launches": runs["launches"], "threshold": thr,
          "spans": len(runs["out"]), **median_parts(parts)})
    return {"engine": eng, "wav": wav}


def phase_extraction(gen) -> dict:
    """The "Extract Sound Event From Mixture Audio Based On Language
    Description" tool at the app's width: ``ExtractionEngine()`` (LASSNet:
    BERT-mini, a 6-level ResUNet 32–384 with FiLM; seeded random weights)
    on a 10 s events clip at 32 kHz (1 251 STFT frames, the 2 048 bucket):
    cold and warm (median of 5), set-up, peak memory, RTF, neither kernel
    launched; the split between STFT, BERT-mini, U-Net and iSTFT."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.dsp.stft import istft, stft
    from audiogpt_tpu_torch.engines import ExtractionEngine

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = ExtractionEngine()
    fill_random(eng.model, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wav = events_like(TOOL_SECONDS, eng.sr, 25)
    runs = tool_runs(lambda: eng.extract(wav, EXTRACT_TEXT), TOOL_WARM_CALLS)
    out = runs["out"]
    if out.shape != wav.shape or not np.isfinite(out).all() \
            or float(out.std()) == 0.0:
        raise AssertionError(f"extraction {out.shape}, std {out.std()}")
    x = torch.from_numpy(wav).to(eng.device)
    ids, mask = eng.tokenizer.encode(EXTRACT_TEXT, 64)
    ids = torch.from_numpy(ids)[None].long().to(eng.device)
    mask = torch.from_numpy(mask)[None].to(eng.device)
    spec = {}

    def do_stft(_):
        spec["s"] = stft(x, eng.n_fft, eng.hop)
        padded, spec["frames"] = eng.bucketer.pad_to_bucket(
            spec["s"].abs()[None], axis=1)
        return padded

    def bert(padded):
        spec["padded"] = padded
        return eng.model.text_cond(ids, mask)

    def unet(cond):
        return eng.model.masks(spec["padded"], cond)

    def do_istft(m):
        return istft(m[0, :spec["frames"]] * spec["s"], eng.n_fft, eng.hop,
                     length=len(wav))

    parts = [event_ms([("stft", do_stft), ("bert_mini", bert),
                       ("unet", unet), ("istft", do_istft)])[0]
             for _ in range(STAGE_RUNS)]
    emit({"phase": "extraction", "clip_s": TOOL_SECONDS, "sr": eng.sr,
          "bucket_frames": eng.bucketer.bucket(len(wav) // eng.hop + 1),
          "setup_s": setup_s, "cold_s": runs["cold_s"],
          "warm_s": runs["warm_s"], "warm_max_s": runs["warm_max_s"],
          "warm_calls": TOOL_WARM_CALLS,
          "rtf": runs["warm_s"] / TOOL_SECONDS,
          "extraction_peak_mem_gb": (runs["peak"] - held) / 1e9,
          "params_m": sum(p.numel() for p in eng.model.parameters()) / 1e6,
          "launches": runs["launches"], "out_std": float(out.std()),
          **median_parts(parts)})
    return {"engine": eng, "wav": wav}


def phase_separation(gen) -> dict:
    """The "Speech Enhancement" and "Speech Separation" tools at the app's
    width: ``SeparationEngine`` with ``ConvTasNetConfig(n_src=1)``
    (``enhance``) and ``n_src=2`` (``separate``: N 512, B 128, H 512, 3 × 8
    TCN blocks), and with the ``SkiM()`` override (``separate_skim``), on
    a 10 s speech-like clip at 16 kHz: 11 chunks of 2.4 s at a 0.8 s hop
    in one batch of 16; cold and warm (median of 5), set-up, peak memory,
    RTF, neither kernel launched. → {name: {"engine", "launches"}}."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import SeparationEngine
    from audiogpt_tpu_torch.models.separation import (ConvTasNetConfig,
                                                      SkiM, SkiMConfig)

    wav = speech_like(TOOL_SECONDS, 16000, 26)
    out = {"wav": wav}
    for name, build in (
            ("enhance", lambda: SeparationEngine(ConvTasNetConfig(n_src=1))),
            ("separate", lambda: SeparationEngine(ConvTasNetConfig(n_src=2))),
            ("separate_skim",
             lambda: SeparationEngine(model=SkiM(SkiMConfig())))):
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = build()
        fill_random(eng.model, gen)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        runs = tool_runs(lambda: eng.separate(wav), TOOL_WARM_CALLS)
        stems = runs["out"]
        n_src = eng.cfg.n_src
        if stems.shape != (n_src, len(wav)) or not np.isfinite(stems).all() \
                or float(stems.std()) == 0.0:
            raise AssertionError(f"{name}: stems {stems.shape}")
        seg, hop = int(2.4 * 16000), int(0.8 * 16000)
        chunks = len(range(0, len(wav) - seg + hop, hop))
        emit({"phase": name, "model": type(eng.model).__name__,
              "n_src": n_src, "clip_s": TOOL_SECONDS, "chunks": chunks,
              "chunk_batch": 1 << (chunks - 1).bit_length(),
              "setup_s": setup_s, "cold_s": runs["cold_s"],
              "warm_s": runs["warm_s"], "warm_max_s": runs["warm_max_s"],
              "warm_calls": TOOL_WARM_CALLS,
              "rtf": runs["warm_s"] / TOOL_SECONDS,
              f"{name}_peak_mem_gb": (runs["peak"] - held) / 1e9,
              "params_m": sum(p.numel() for p in eng.model.parameters())
              / 1e6, "launches": runs["launches"],
              "stem_std": float(stems.std())})
        out[name] = {"engine": eng}
    return out


def phase_binaural(gen) -> dict:
    """The "Sythesize Binaural Audio From A Mono Audio Input" tool at the
    app's width: ``BinauralEngine()`` (the geometric warp and a 4-layer
    warpnet of 64; seeded random weights) on a 10 s speech-like clip at
    48 kHz along the default 1 m orbit: 10 chunks of 1 s with an
    800-sample halo; cold and warm (median of 5), the time a chunk,
    set-up, peak memory, RTF, neither kernel launched."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import BinauralEngine

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = BinauralEngine()
    fill_random(eng.model, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mono = speech_like(TOOL_SECONDS, eng.cfg.sample_rate, 27)
    runs = tool_runs(lambda: eng.binauralize(mono), TOOL_WARM_CALLS)
    out = runs["out"]
    if out.shape != (2, len(mono)) or not np.isfinite(out).all() \
            or np.abs(out).max() > 1.0 or float(out.std()) == 0.0 \
            or np.array_equal(out[0], out[1]):
        raise AssertionError(f"binaural {out.shape}")
    chunks = -(-len(mono) // 48000)
    emit({"phase": "binaural", "clip_s": TOOL_SECONDS,
          "sr": eng.cfg.sample_rate, "chunks": chunks, "setup_s": setup_s,
          "cold_s": runs["cold_s"], "warm_s": runs["warm_s"],
          "warm_max_s": runs["warm_max_s"], "warm_calls": TOOL_WARM_CALLS,
          "chunk_ms": runs["warm_s"] / chunks * 1e3,
          "rtf": runs["warm_s"] / TOOL_SECONDS,
          "binaural_peak_mem_gb": (runs["peak"] - held) / 1e9,
          "launches": runs["launches"],
          "left_right_max_abs_diff": float(np.abs(out[0] - out[1]).max())})
    return {"engine": eng, "wav": mono}


def card_and_cpu(build, gen_seed: int):
    """The module ``build()`` makes, with seeded random weights, on the CPU
    and a copy of it on the card: → (cpu, cuda)."""
    import torch

    cpu = build().eval()
    fill_random(cpu, torch.Generator().manual_seed(gen_seed))
    cuda = build().cuda().eval()
    cuda.load_state_dict(cpu.state_dict())
    return cpu, cuda


def phase_analysis_small_reference() -> None:
    """Narrow analysis nets on the card against the same weights on the
    CPU: the captioner's greedy and beam-3 ids (equal), PANN-SED's
    framewise output (≤ 1e-4), a narrow PVT whose stage-0 and stage-1
    attentions take K1 on the card ([1, 6400 → 100, 1, 64], [1, 1600 →
    100, 2, 64] on a 10 s clip; ≤ 1e-4), and the TSD net's spans (equal)
    with its decision (≤ 1e-4)."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.models.caption import Cnn14Config
    from audiogpt_tpu_torch.models.caption.captioner import (
        CaptionConfig, CaptionModel, caption_beam_decode,
        caption_greedy_decode)
    from audiogpt_tpu_torch.models.sed import (PVTSED, PVTConfig, SEDConfig,
                                               SEDModel, TSDConfig, TSDModel,
                                               decode_timestamps)

    cnn = Cnn14Config(channels=(16, 16, 32, 32, 64, 64))
    res = {"phase": "analysis_small_reference"}
    wav = events_like(4.0, 32000, 31)[None]
    cap, cap_gpu = card_and_cpu(lambda: CaptionModel(CaptionConfig(
        cnn14=cnn, rnn_hidden=32, vocab_size=200, emb_dim=32, nhead=2,
        nlayers=2, dim_feedforward=64)), 32)
    ids = {}
    for dev, model in (("cpu", cap), ("cuda", cap_gpu)):
        x = torch.from_numpy(wav).to(dev)
        ids[dev] = [f(model, x).cpu() for f in (
            caption_greedy_decode,
            lambda m, x: caption_beam_decode(m, x, beam_size=3))]
    res["caption_ids_equal"] = all(torch.equal(a, b) for a, b in
                                   zip(ids["cpu"], ids["cuda"]))
    res["caption_greedy"] = ids["cuda"][0][0].tolist()

    def compare(name, cpu, cuda, x, key="framewise_output", tol=1e-4):
        outs, launches = {}, {}
        for dev, model in (("cpu", cpu), ("cuda", cuda)):
            def call(model=model, dev=dev):
                with torch.inference_mode():
                    return model(torch.from_numpy(x).to(dev))[key].cpu()
            outs[dev], _, launches[dev] = counted(call)
        err = (outs["cpu"] - outs["cuda"]).abs().max().item()
        res[f"{name}_max_abs_err"] = err
        res[f"{name}_cuda_launches"] = launches["cuda"]
        if err > tol or any(launches["cpu"].values()):
            raise AssertionError(f"{name}: card vs CPU {err}, launches "
                                 f"{launches}")
        return launches["cuda"]

    sed, sed_gpu = card_and_cpu(lambda: SEDModel(SEDConfig(cnn14=cnn)), 33)
    check_no_kernels(compare("sed", sed, sed_gpu, wav), "small SED")
    pcfg = PVTConfig(embed_dims=(64, 128, 128, 128), depths=(1, 1, 1, 1),
                     num_heads=(1, 2, 2, 2), mlp_ratios=(2, 2, 2, 2))
    pvt, pvt_gpu = card_and_cpu(lambda: PVTSED(pcfg), 34)
    pwav = np.pad(events_like(TOOL_SECONDS, 32000, 35),
                  (0, 512000 - 320000))[None]
    got = compare("pvt", pvt, pvt_gpu, pwav)
    want = expected_counts(pvt_flash_shapes(pcfg, 512000), Counter())
    if got != want or got["flash_attention"] != 2:
        raise AssertionError(f"small PVT launches {got}, expected {want}")
    tcfg = TSDConfig(gru_hidden=32, channels=(16, 16, 32, 32))
    tsd, tsd_gpu = card_and_cpu(lambda: TSDModel(tcfg), 36)
    mel = np.random.RandomState(37).randn(1, 512, 64).astype(np.float32)
    emb = np.random.RandomState(38).randn(1, 128).astype(np.float32)
    probs = {}
    for dev, model in (("cpu", tsd), ("cuda", tsd_gpu)):
        with torch.inference_mode():
            up = model(torch.from_numpy(mel).to(dev),
                       torch.from_numpy(emb).to(dev))[1]
        probs[dev] = up[0, :, 0].cpu().numpy()
    thr = tsd_threshold(probs["cpu"])
    spans = {dev: decode_timestamps(p, 86.1328125, 7, thr)
             for dev, p in probs.items()}
    res["tsd_max_abs_err"] = float(np.abs(probs["cpu"]
                                          - probs["cuda"]).max())
    res["tsd_spans_equal"] = spans["cpu"] == spans["cuda"]
    res["tsd_spans"] = len(spans["cpu"])
    emit(res)
    if not (res["caption_ids_equal"] and res["tsd_spans_equal"]
            and spans["cpu"] and res["tsd_max_abs_err"] <= 1e-4):
        raise AssertionError(f"small analysis nets: {res}")


def phase_transform_small_reference() -> None:
    """Narrow transform nets on the card against the same weights on the
    CPU, on the same inputs: LASSNet's mask, Conv-TasNet with a valid
    length, SkiM, each ≤ 1e-4 of the CPU output's largest value (f32, TF32
    off: the libraries sum in other orders), and the binaural network, ≤
    two f32 ulps of its read position times the signal's largest step
    (the warp reads the signal at f32 positions up to 48 000)."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.models.binaural import (BinauralConfig,
                                                    BinauralNetwork)
    from audiogpt_tpu_torch.models.extraction import (LASSNet,
                                                      LASSNetConfig)
    from audiogpt_tpu_torch.models.extraction.lassnet import BERT_MINI
    from audiogpt_tpu_torch.models.separation import (ConvTasNet,
                                                      ConvTasNetConfig,
                                                      SkiM, SkiMConfig)

    rng = np.random.RandomState(41)
    sp = np.abs(rng.randn(1, 512, 513)).astype(np.float32)
    ids = rng.randint(1000, 30000, (1, 64))
    ids[0, 10:] = 0
    mask = (np.arange(64) < 10).astype(np.int32)[None]
    speech = speech_like(2.4, 16000, 42)
    mono = speech_like(1.0, 48000, 43)
    view = np.zeros((1, 7, 120), np.float32)
    view[0, 0], view[0, 1], view[0, 6] = 1.0, np.linspace(-1, 1, 120), 1.0
    cases = {
        "lassnet": (lambda: LASSNet(LASSNetConfig(
            bert=BERT_MINI, enc_channels=(16, 16, 32, 32, 64, 64))),
            (sp, ids, mask)),
        "convtasnet": (lambda: ConvTasNet(ConvTasNetConfig(
            enc_dim=128, bottleneck=64, hidden=128, skip=64, n_blocks=4,
            n_repeats=2)), (np.stack([speech, speech * 0.5]),
                            np.asarray([len(speech), 20000]))),
        "skim": (lambda: SkiM(SkiMConfig(enc_dim=64, hidden=32,
                                         n_blocks=2)), (speech[None],)),
        "binaural": (lambda: BinauralNetwork(BinauralConfig(
            warpnet_channels=32)), (mono[None, :48000], view[:, :, :120])),
    }
    res = {"phase": "transform_small_reference"}
    for seed, (name, (build, args)) in enumerate(cases.items()):
        cpu, cuda = card_and_cpu(build, 50 + seed)
        outs, launches = {}, {}
        for dev, model in (("cpu", cpu), ("cuda", cuda)):
            def call(model=model, dev=dev):
                with torch.inference_mode():
                    return model(*(torch.from_numpy(np.asarray(a)).to(dev)
                                   for a in args)).cpu().numpy()
            outs[dev], _, launches[dev] = counted(call)
            check_no_kernels(launches[dev], f"small {name}")
        err = float(np.abs(outs["cpu"] - outs["cuda"]).max())
        if name == "binaural":
            tol = 2 * float(np.spacing(np.float32(48000))) \
                * float(np.abs(np.diff(mono)).max())
        else:
            tol = 1e-4 * float(np.abs(outs["cpu"]).max())
        res[f"{name}_max_abs_err"] = err
        res[f"{name}_bound"] = tol
        if not err <= tol or not np.isfinite(outs["cuda"]).all():
            raise AssertionError(f"small {name}: card vs CPU {err} > {tol}")
    emit(res)


# ---------------------------------------------------------------------------
# SVS: "Generate Singing Voice From User Input Text, Note and Duration
# Sequence" (DiffSinger + HiFi-GAN V1; VISinger); Style Transfer
# (GenerSpeech + HiFi-GAN V1)
# ---------------------------------------------------------------------------


def set_svs_durations(model) -> None:
    """The DiffSinger duration head's output layer (see ``SVS_DUR_SCALE``)."""
    import torch

    out = model.fs2.dur_predictor.out
    with torch.no_grad():
        out.weight.mul_(SVS_DUR_SCALE)
        out.bias.fill_(SVS_DUR_BIAS)


def svs_frames(eng) -> dict:
    """The default song's phones and its frames on the canvas."""
    import torch

    from audiogpt_tpu_torch.agent.toolset import DEFAULT_SONG
    from audiogpt_tpu_torch.engines.svs import score_tensors

    toks, midi, dur, slur = score_tensors(eng, *DEFAULT_SONG)
    with torch.inference_mode():
        ret = eng.model.conditioner(toks, midi, dur, slur)
    frames = int((ret["mel2ph"] > 0).sum())
    notes_s = sum(float(d) for d in DEFAULT_SONG[2].split("|"))
    return {"phones": int((toks > 0).sum()), "frames": frames,
            "notes_s": notes_s, "notes_frames": notes_s
            * eng.sample_rate / eng.vocoder.hop_size,
            "audio_s": frames * eng.vocoder.hop_size / eng.sample_rate}


def timed_calls(hooks: dict, fn):
    """``fn()`` with each ``(object, method name)`` of ``hooks[group]``
    wrapped to record CUDA events around its calls → (output, {group_ms:
    the summed device-clock time of its calls}, {group_host_ms: the host's
    time to queue them})."""
    import torch

    spans = {g: [] for g in hooks}
    host = {g: 0.0 for g in hooks}

    def wrap(group, orig):
        def run(*args, **kw):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            host[group] += (time.perf_counter() - t0) * 1e3
            b.record()
            spans[group].append((a, b))
            return out
        return run

    patched = []
    for group, targets in hooks.items():
        for obj, name in targets:
            setattr(obj, name, wrap(group, getattr(obj, name)))
            patched.append((obj, name))
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        for obj, name in patched:
            delattr(obj, name)
    return out, {f"{g}_ms": sum(a.elapsed_time(b) for a, b in s)
                 for g, s in spans.items()}, \
        {f"{g}_host_ms": h for g, h in host.items()}


def phase_svs(gen) -> dict:
    """The SVS tool's call at the app's width: ``SVSEngine(vocoder=
    VocoderEngine("hifigan"))`` (DiffSinger: FS2-MIDI hidden 256 with
    ``rel_pos``, ``max_frames`` 2048; DiffNet 20 layers of 256; PLMS at
    step 10 over K_step 1000: 100 steps, 101 DiffNet evals on [1, 2048,
    80]; HiFi-GAN V1) with seeded random weights, on the toolset's default
    song (26 phones, 4.04 s of notes), the duration head set so the
    phones get about as many frames as the notes' seconds. Cold and warm
    (median of 3) times, RTF against the valid seconds, set-up, peak
    memory, launches (neither kernel); the stages (FS2, one DiffNet eval,
    the PLMS loop with the host's queueing time, the vocoder) and one
    device-only trace."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.agent.toolset import DEFAULT_SONG
    from audiogpt_tpu_torch.engines import SVSEngine, VocoderEngine
    from audiogpt_tpu_torch.engines.svs import score_tensors

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = SVSEngine(vocoder=VocoderEngine("hifigan"))
    fill_random(eng.model, gen)
    fill_random(eng.vocoder.model, gen)
    set_svs_durations(eng.model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    info = svs_frames(eng)
    if not (info["phones"] == 26
            and 0.6 <= info["frames"] / info["notes_frames"] <= 1.6):
        raise AssertionError(f"SVS song {info}")

    def call():
        return eng.synthesize(*DEFAULT_SONG)

    runs = tool_runs(call, SVS_WARM_CALLS)
    wav = runs["out"]
    n = info["frames"] * eng.vocoder.hop_size
    if wav.dtype != np.float32 or wav.shape != (n,) \
            or not np.isfinite(wav).all() or float(wav.std()) == 0.0:
        raise AssertionError(f"SVS wav {wav.dtype} {wav.shape} (expected "
                             f"{n}), std {wav.std()}")
    cfg = eng.cfg
    steps = len(range(0, cfg.K_step, eng.pndm_speedup))
    evals = []
    real_eval = eng.model.denoiser.forward

    def counting_eval(*a, **kw):
        evals.append(1)
        return real_eval(*a, **kw)

    eng.model.denoiser.forward = counting_eval
    try:
        counted(call)
    finally:
        del eng.model.denoiser.forward
    if len(evals) != steps + 1:
        raise AssertionError(f"{len(evals)} DiffNet evals, {steps} steps")
    emit({"phase": "svs", "model": "diffsinger+hifigan_v1",
          "sampler": f"plms-{eng.pndm_speedup}", "plms_steps": steps,
          "diffnet_evals": len(evals), "canvas": cfg.fs2.max_frames,
          **info, "samples": n, "setup_s": setup_s,
          "cold_s": runs["cold_s"], "warm_s": runs["warm_s"],
          "warm_max_s": runs["warm_max_s"], "warm_calls": SVS_WARM_CALLS,
          "rtf": runs["warm_s"] / info["audio_s"],
          "svs_peak_mem_gb": (runs["peak"] - held) / 1e9,
          "params_m": sum(p.numel() for m in (eng.model, eng.vocoder.model)
                          for p in m.parameters()) / 1e6,
          "kernel_launches": runs["launches"],
          "wav_std": float(wav.std())})
    # the stages of one warm call, median of 5
    model = eng.model
    hooks = {"fs2": [(model, "conditioner")], "plms": [(model, "sample")],
             "vocoder": [(eng.vocoder, "vocode")]}
    parts = [timed_calls(hooks, call) for _ in range(STAGE_RUNS)]
    stages = median_parts([{**p[1], **p[2]} for p in parts])
    toks = score_tensors(eng, *DEFAULT_SONG)
    with torch.inference_mode():
        cond = model.conditioner(*toks)["decoder_inp"]
        x = torch.randn(1, cond.shape[1], cfg.net.mel_bins, device="cuda")
        t = torch.full((1,), 990, dtype=torch.int32, device="cuda")
        eval_ms = time_ms(lambda: model.denoiser(x, t, cond), 10)
        eval_graph_ms = time_ms(lambda: model.denoiser(x, t, cond), 10,
                                graph=True)
    emit({"phase": "svs_stages", "runs": STAGE_RUNS, **stages,
          "diffnet_eval_ms": eval_ms, "diffnet_eval_graph_ms": eval_graph_ms,
          "plms_per_eval_ms": stages["plms_ms"] / len(evals),
          "diffnet_eval_flop": diffnet_flop(cfg, cond.shape[1]),
          "diffnet_eval_f32_bound_ms": diffnet_flop(cfg, cond.shape[1])
          / F32_FLOPS * 1e3})
    profile_call("svs_profile", call, runs["warm_s"])
    return {"engine": eng, "launches": runs["launches"], "wav": wav}


def diffnet_flop(cfg, frames: int) -> float:
    """Multiply-adds × 2 of one DiffNet eval on ``frames``: per layer the
    k3 dilated conv and two 1×1 convs (C → 2C, H → 2C, C → 2C), plus the
    input, skip and output projections."""
    c, h, m = (cfg.net.residual_channels, cfg.net.encoder_hidden,
               cfg.net.mel_bins)
    per_layer = 2 * c * (3 * c + h + c)
    return 2.0 * frames * (cfg.net.residual_layers * per_layer
                           + m * c + c * c + c * m)


def phase_visinger(gen) -> dict:
    """``VISingerEngine()`` (score encoder 192 wide, 4 FFT layers, the
    4-layer coupling flow, HiFi-GAN at 256 channels from 192; 24 kHz,
    ``max_frames`` 1024) on the default song: frames from the note
    durations (each phone of a word carries the word's duration, as in
    JAX). Cold and warm (median of 3), RTF, set-up, peak memory, neither
    kernel."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.agent.toolset import DEFAULT_SONG
    from audiogpt_tpu_torch.engines import VISingerEngine

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = VISingerEngine()
    fill_random(eng.model, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    runs = tool_runs(lambda: eng.synthesize(*DEFAULT_SONG), SVS_WARM_CALLS)
    wav = runs["out"]
    hop = eng.cfg.decoder.hop_size
    if wav.ndim != 1 or wav.size % hop or not np.isfinite(wav).all() \
            or float(wav.std()) == 0.0:
        raise AssertionError(f"VISinger wav {wav.shape}")
    audio_s = wav.size / eng.sample_rate
    emit({"phase": "visinger", "frames": wav.size // hop,
          "canvas": eng.cfg.max_frames, "audio_s": audio_s,
          "setup_s": setup_s, "cold_s": runs["cold_s"],
          "warm_s": runs["warm_s"], "warm_max_s": runs["warm_max_s"],
          "warm_calls": SVS_WARM_CALLS, "rtf": runs["warm_s"] / audio_s,
          "visinger_peak_mem_gb": (runs["peak"] - held) / 1e9,
          "params_m": sum(p.numel() for p in eng.model.parameters()) / 1e6,
          "kernel_launches": runs["launches"], "wav_std": float(wav.std())})
    return {"engine": eng, "launches": runs["launches"]}


def orthogonal_1x1(model, seed: int) -> None:
    """Random orthogonal matrices in the Glow post-flow's invertible 1×1
    convolutions, as the JAX init makes them (``fill_random``'s N(0, 1/C)
    matrices can be ill-conditioned, and ``reverse`` applies their
    inverses)."""
    import torch

    flow = model.post_flow
    for i in range(flow.n_steps):
        w = getattr(flow, f"step{i}").inv1x1_w
        q = torch.linalg.qr(torch.randn(w.shape, generator=torch.Generator()
                                        .manual_seed(seed + i)))[0]
        with torch.no_grad():
            w.copy_(q)


def phase_tts_ood(gen) -> dict:
    """The Style Transfer tool at the app's width: ``StyleTransferEngine(
    vocoder=VocoderEngine("hifigan"))`` (GenerSpeech: FS2 hidden 256,
    ``max_frames`` 2048, three VQ style branches and aligners, the GST
    encoder, the 4-step Glow post-flow; HiFi-GAN V1), seeded random
    weights (the zero-initialised coupling outputs and actnorms too, so the
    flow reads its conditioning) and ≈ 6 frames a phone, on the TTS
    sentence (113 phones) with a seeded 5 s speech-like reference at
    22.05 kHz (431 frames, the 512 bucket), then a 10 s one (cut to 512
    frames). Cold and warm (median of 3), RTF against the valid seconds,
    set-up, peak memory, neither kernel; the stages (style encoders,
    FS2 body with the aligners, the Glow reverse, the vocoder)."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import StyleTransferEngine, VocoderEngine

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = StyleTransferEngine(vocoder=VocoderEngine("hifigan"))
    fill_random(eng.model, gen)
    orthogonal_1x1(eng.model, 30)
    fill_random(eng.vocoder.model, gen)
    set_durations(eng.model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ref5 = speech_like(5.0, 22050, 31)
    ref10 = speech_like(10.0, 22050, 32)
    res = {}
    for name, ref in (("tts_ood", ref5), ("tts_ood_10s_ref", ref10)):
        runs = tool_runs(lambda ref=ref: eng.synthesize(TTS_TEXT, ref),
                         SVS_WARM_CALLS)
        wav = runs["out"]
        with torch.inference_mode():
            mel = eng.synthesize_mel(TTS_TEXT, ref)
        hop = eng.vocoder.hop_size
        if wav.shape != (mel.shape[0] * hop,) or not np.isfinite(wav).all() \
                or float(wav.std()) == 0.0:
            raise AssertionError(f"{name} wav {wav.shape}, mel {mel.shape}")
        audio_s = wav.size / eng.sample_rate
        res[name] = runs
        emit({"phase": name, "text_phones": len(eng.frontend.encode(
              TTS_TEXT)), "ref_s": ref.size / 22050,
              "ref_frames": int(eng.ref_mel(ref).abs().sum(-1).gt(0).sum()),
              "frames": mel.shape[0], "audio_s": audio_s,
              "setup_s": setup_s, "cold_s": runs["cold_s"],
              "warm_s": runs["warm_s"], "warm_max_s": runs["warm_max_s"],
              "warm_calls": SVS_WARM_CALLS,
              "rtf": runs["warm_s"] / audio_s,
              "tts_ood_peak_mem_gb": (runs["peak"] - held) / 1e9,
              "params_m": sum(p.numel() for m in (eng.model,
                                                  eng.vocoder.model)
                              for p in m.parameters()) / 1e6,
              "kernel_launches": runs["launches"],
              "wav_std": float(wav.std())})
    model = eng.model
    hooks = {"style": [(model, "style")],
             "glow": [(model.post_flow, "reverse")],
             "model": [(model, "forward")],
             "vocoder": [(eng.vocoder, "vocode")]}
    parts = [timed_calls(hooks, lambda: eng.synthesize(TTS_TEXT, ref5))
             for _ in range(STAGE_RUNS)]
    st = median_parts([{**p[1], **p[2]} for p in parts])
    emit({"phase": "tts_ood_stages", "runs": STAGE_RUNS,
          "style_ms": st["style_ms"], "glow_ms": st["glow_ms"],
          "fs2_ms": st["model_ms"] - st["style_ms"] - st["glow_ms"],
          "vocoder_ms": st["vocoder_ms"], "model_ms": st["model_ms"],
          "model_host_ms": st["model_host_ms"]})
    return {"engine": eng, "launches": res["tts_ood"]["launches"],
            "ref": ref10}


def phase_speech_small_reference() -> None:
    """Narrow nets of the three new tools on the card against the same
    weights and draws on the CPU (TF32 off): DiffSinger's conditioner and
    its DDPM sampler over 8 steps of the cosine schedule with replayed
    draws, the pitch extractor on the mel padded onto the vocoder's
    bucket, the FS2 ``cwt`` branch, VISinger's wav, GenerSpeech's mel
    through the post-flow and its vocoder's wav. Durations held mid-way
    between rounding edges (weights · 1e-3)."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import (StyleTransferEngine, SVSEngine,
                                            VISingerEngine, VocoderEngine)
    from audiogpt_tpu_torch.models.svs import (DiffNetConfig,
                                               DiffSingerConfig,
                                               VISingerConfig)
    from audiogpt_tpu_torch.models.tts import (FastSpeech2,
                                               FastSpeech2Config)
    from audiogpt_tpu_torch.models.tts.generspeech import GenerSpeechConfig
    from audiogpt_tpu_torch.models.tts.pitch_extractor import (
        PitchExtractor, PitchExtractorConfig)
    from audiogpt_tpu_torch.models.vocoder import HifiGANConfig

    song = ("ni hao SP shi jie AP", "C4 | D4 E4 | rest | F#4/Gb4 | G4 | rest",
            "0.1 | 0.3 0.2 | 0.25 | 0.2 | 0.15 | 0.3")
    hifi = dict(upsample_initial_channel=64, upsample_rates=(8, 8, 4),
                upsample_kernel_sizes=(16, 16, 8), resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1, 3),))
    fs2 = dict(hidden_size=64, enc_layers=2, dec_layers=2,
               predictor_layers=2, max_frames=256)

    def pair(build, dur=None, seed=0):
        cpu, card = build("cpu"), build("cuda")
        fill_random(cpu.model, torch.Generator().manual_seed(seed))
        if dur is not None:
            with torch.no_grad():
                dur(cpu.model).weight.mul_(1e-3)
                dur(cpu.model).bias.fill_(math.log(5.0))
        card.model.load_state_dict(cpu.model.state_dict())
        if hasattr(cpu, "vocoder"):
            fill_random(cpu.vocoder.model, torch.Generator().manual_seed(
                seed + 1))
            card.vocoder.load_state_dict(cpu.vocoder.model.state_dict())
        return cpu, card

    res = {}
    pes = {}

    def build_svs(device):
        pes[device] = PitchExtractor(PitchExtractorConfig(
            hidden=64, predictor_layers=2))
        return SVSEngine(DiffSingerConfig(
            fs2=FastSpeech2Config(use_midi=True, rel_pos=True,
                                  use_pitch_embed=False, **fs2),
            net=DiffNetConfig(encoder_hidden=64, residual_layers=4,
                              residual_channels=64),
            timesteps=8, K_step=8, schedule_type="cosine"),
            vocoder=VocoderEngine("hifigan", HifiGANConfig(**hifi),
                                  buckets=(256,), device=device),
            pitch_extractor=pes[device], token_buckets=(16,),
            pndm_speedup=1, device=device)

    g = torch.Generator().manual_seed(5)
    x_t = torch.randn(1, 256, 80, generator=g)
    noise = [torch.randn(1, 256, 80, generator=g) for _ in range(8)]
    out = {}
    svs_pair = pair(build_svs, lambda m: m.fs2.dur_predictor.out, seed=11)
    fill_random(pes["cpu"], torch.Generator().manual_seed(13))
    pes["cuda"].load_state_dict(pes["cpu"].state_dict())
    for eng in svs_pair:
        dev = eng.device
        def run(eng=eng, dev=dev):
            mel, f0 = eng.synthesize_mel(*song, draws=(
                x_t.to(dev), [n.to(dev) for n in noise]))
            return mel.cpu(), f0.cpu()
        (mel, f0), _, counts = counted(run)
        out[dev.type] = (mel, f0, counts)
    res["svs_ddpm_mel"] = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    res["svs_pitch_extractor_f0_hz"] = float(
        (out["cuda"][1] - out["cpu"][1]).abs().max())
    res["svs_frames"] = out["cpu"][0].shape[0]
    launches = [out["cuda"][2]]

    cwt_cfg = FastSpeech2Config(pitch_type="cwt", **fs2)
    cpu_fs2 = FastSpeech2(cwt_cfg).eval()
    fill_random(cpu_fs2, torch.Generator().manual_seed(17))
    with torch.no_grad():
        cpu_fs2.dur_predictor.out.weight.mul_(1e-3)
        cpu_fs2.dur_predictor.out.bias.fill_(math.log(5.0))
        cpu_fs2.cwt_stats.weight.mul_(1e-2)
        cpu_fs2.cwt_stats.bias.copy_(torch.tensor([math.log(200.0), 0.3]))
    card_fs2 = FastSpeech2(cwt_cfg).cuda().eval()
    card_fs2.load_state_dict(cpu_fs2.state_dict())
    toks = torch.randint(3, 80, (1, 24), generator=torch.Generator()
                         .manual_seed(18))
    with torch.inference_mode():
        a = cpu_fs2(toks)
        b, _, counts = counted(lambda: card_fs2(toks.cuda()))
    launches.append(counts)
    res["fs2_cwt_mel"] = float((b["mel_out"].cpu() - a["mel_out"]).abs()
                               .max())
    res["fs2_cwt_f0_rel"] = float(((b["f0_denorm"].cpu() - a["f0_denorm"])
                                   .abs() / a["f0_denorm"].clamp_min(1.0))
                                  .max())
    res["fs2_cwt_mel2ph_equal"] = bool((b["mel2ph"].cpu() == a["mel2ph"])
                                       .all())

    vis = pair(lambda device: VISingerEngine(VISingerConfig(
        hidden=64, latent_dim=32, enc_layers=2, posterior_layers=1,
        flow_layers=2, flow_wn_layers=2, max_frames=256,
        decoder=HifiGANConfig(in_channels=32, **hifi)), token_buckets=(16,),
        device=device), seed=19)
    z = torch.randn(1, 256, 32, generator=torch.Generator().manual_seed(20))
    wa = vis[0].synthesize(*song, draws=z)
    wb, _, counts = counted(lambda: vis[1].synthesize(*song,
                                                      draws=z.cuda()))
    launches.append(counts)
    res["visinger_wav"] = float(np.abs(wb - wa).max()) \
        if wa.shape == wb.shape else math.inf

    gs = pair(lambda device: StyleTransferEngine(GenerSpeechConfig(
        fs2=FastSpeech2Config(**fs2), n_vq=16, emb_dim=32, glow_hidden=32,
        glow_steps=2, glow_wn_layers=2),
        vocoder=VocoderEngine("hifigan", HifiGANConfig(**hifi),
                              buckets=(256,), device=device),
        device=device), lambda m: m.dur_predictor.out, seed=21)
    for eng in gs:
        orthogonal_1x1(eng.model, 24)
    ref = speech_like(1.5, 22050, 22)
    zg = torch.randn(1, 128, 160, generator=torch.Generator().manual_seed(23))
    ma = gs[0].synthesize_mel(TTS_TEXT[:40], ref, draws=zg)
    mb, _, counts = counted(lambda: gs[1].synthesize_mel(
        TTS_TEXT[:40], ref, draws=zg.cuda()))
    launches.append(counts)
    res["generspeech_mel"] = float((mb.cpu() - ma).abs().max()) \
        if ma.shape == mb.shape else math.inf
    res["generspeech_frames"] = ma.shape[0]
    wa = gs[0].vocoder.vocode(ma.T[None].contiguous())
    wb = gs[1].vocoder.vocode(mb.T[None].contiguous())
    res["generspeech_wav"] = float((wb.cpu() - wa).abs().max())
    emit({"phase": "speech_small_reference", **res,
          "cuda_launches": launches})
    for c in launches:
        check_no_kernels(c, "speech_small_reference")
    bad = {k: v for k, v in res.items()
           if (k.endswith(("_mel", "_wav")) and not v <= 5e-4)
           or (k == "svs_pitch_extractor_f0_hz" and not v <= 1e-2)
           or (k == "fs2_cwt_f0_rel" and not v <= 1e-4)}
    if bad or not res["fs2_cwt_mel2ph_equal"]:
        raise AssertionError(f"card vs CPU: {res}")


# ---------------------------------------------------------------------------
# GeneFace, the HTSAT CLAP tower, PortaSpeech and SyntaSpeech
# ---------------------------------------------------------------------------


def face_stage_ms(eng, path: str, out: str) -> dict:
    """One warm GeneFace call taken apart: the mel, Audio2Motion on the
    bucket and the warp between CUDA events; the uint8 frames' copy to the
    host; the AVI write (250 JPEG encodes and the RIFF) and the encodes
    alone, on the host clock."""
    import torch

    from audiogpt_tpu_torch.utils.audio_io import load_wav
    from audiogpt_tpu_torch.utils.video_io import _jpeg, write_mjpeg_avi

    wav, _ = load_wav(path, sr=16000)
    portrait = torch.from_numpy(eng.portrait).cuda()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.inference_mode():
        marks[0].record()
        mel = eng.mel(wav)
        marks[1].record()
        lm = eng.motion(mel)
        marks[2].record()
        frames = eng.warper.frames(portrait, lm)
        marks[3].record()
        host = frames.cpu().numpy()
        marks[4].record()
    marks[4].synchronize()
    t0 = time.perf_counter()
    write_mjpeg_avi(out, host, fps=eng.cfg.fps, audio=wav,
                    sample_rate=eng.cfg.sample_rate)
    t1 = time.perf_counter()
    for f in host:
        _jpeg(f, 90)
    t2 = time.perf_counter()
    names = ("mel_ms", "motion_ms", "render_ms", "frames_to_host_ms")
    return {**{n: a.elapsed_time(b) for n, a, b in zip(names, marks,
                                                       marks[1:])},
            "avi_write_ms": (t1 - t0) * 1e3, "jpeg_encode_ms": (t2 - t1) * 1e3}


def phase_geneface(gen, tmp: str) -> dict:
    """The agent's last tool, "Generate a talking human portrait video
    given a input Audio", at the app's width: ``GeneFaceEngine()``
    (Audio2Motion hidden 256, latent 16, 3 conv layers; the 256 × 256
    warp at 25 fps; mel buckets 256–2048) with seeded random weights, on a
    10 s seeded speech-like clip at 16 kHz, named relative to the media
    root: 626 mel frames on the 1024 bucket, 250 video frames, the audio
    muxed in. Cold and warm (median of 3), RTF, set-up, peak memory,
    neither kernel; the AVI read back; the stages (mel, motion, warp,
    the frames' copy, the AVI write and its JPEG encodes)."""
    import torch

    from audiogpt_tpu_torch.engines import GeneFaceEngine
    from audiogpt_tpu_torch.utils.audio_io import save_wav
    from audiogpt_tpu_torch.utils.video_io import read_avi_info

    root = Path(tmp) / "face"
    (root / "audio").mkdir(parents=True)
    wav = speech_like(FACE_SECONDS, 16000, 41)
    path = str(root / "audio" / "face.wav")
    save_wav(wav, path, 16000)
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = GeneFaceEngine(media_root=str(root))
    fill_random(eng.model, gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    runs = tool_runs(lambda: eng("audio/face.wav"), FACE_WARM_CALLS)
    info = read_avi_info(str(root / runs["out"]))
    mel_frames = int(eng.mel(wav).shape[0])
    if (info["n_frames"], info["n_video_chunks"], info["fps"],
            info["n_streams"], info["width"]) != (250, 250, 25, 2, 256) \
            or eng.bucketer.bucket(mel_frames) != 1024:
        raise AssertionError(f"GeneFace video {info}, {mel_frames} frames")
    emit({"phase": "geneface", "clip_s": FACE_SECONDS,
          "mel_frames": mel_frames, "bucket": 1024,
          "video_frames": info["n_frames"], "fps": info["fps"],
          "size": info["width"],
          "avi_bytes": (root / runs["out"]).stat().st_size,
          "setup_s": setup_s, "cold_s": runs["cold_s"],
          "warm_s": runs["warm_s"], "warm_max_s": runs["warm_max_s"],
          "warm_calls": FACE_WARM_CALLS,
          "rtf": runs["warm_s"] / FACE_SECONDS,
          "geneface_peak_mem_gb": (runs["peak"] - held) / 1e9,
          "params_m": sum(p.numel() for p in eng.model.parameters()) / 1e6,
          "kernel_launches": runs["launches"]})
    parts = [face_stage_ms(eng, path, str(root / "stage.avi"))
             for _ in range(STAGE_RUNS)]
    emit({"phase": "geneface_stages", "runs": STAGE_RUNS,
          **median_parts(parts),
          "device_launches_motion_and_warp": device_launches(
              lambda: eng.warper.frames(torch.from_numpy(eng.portrait)
                                        .cuda(), eng.motion(eng.mel(wav))))})
    return {"engine": eng, "launches": runs["launches"], "wav": wav}


def htsat_scorer(gen, **kw):
    """``CLAPScorer(audio_tower="htsat", sample_rate=16000)`` with seeded
    random weights; ``bn0``'s variances positive."""
    import torch

    from audiogpt_tpu_torch.models.textenc import CLAPScorer

    scorer = CLAPScorer(audio_tower="htsat", sample_rate=16000, **kw)
    fill_random(scorer.text, gen)
    fill_random(scorer.audio, gen)
    var = scorer.audio.bn0_var
    with torch.no_grad():
        var.copy_(1.0 + 0.1 * torch.randn(var.shape, generator=gen,
                                          device=var.device).abs())
    return scorer


def phase_htsat(gen) -> dict:
    """The HTSAT CLAP tower at HTSAT-tiny's width (``spec_size`` 256,
    embed 96, depths (2, 2, 6, 2), heads (4, 8, 16, 32), ``d_proj`` 1024;
    the 48 kHz filterbank on the 16 kHz candidates, as in JAX) scoring
    three seeded 10 s clips: the tower's time a batch of 3 and the whole
    similarity's between CUDA events (median of 5), its FLOPs
    (``FlopCounterMode``) against the f32 bound, its device launches,
    set-up, peak memory; neither kernel."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    scorer = htsat_scorer(gen)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = int(CLIP_SECONDS * 16000)
    wavs = np.stack([events_like(CLIP_SECONDS + 0.1, 16000, 50 + i)[:n]
                     for i in range(3)])
    x = torch.from_numpy(wavs).cuda()
    torch.cuda.reset_peak_memory_stats()
    scores, _, counts = counted(lambda: scorer.similarity(TEXT, x))
    check_no_kernels(counts, "htsat")
    scores = scores.cpu().numpy()
    if not np.isfinite(scores).all() or np.ptp(scores) == 0.0:
        raise AssertionError(f"HTSAT scores {scores}")
    runs = [event_ms([("tower", lambda _: scorer.audio(x)),
                      ("similarity", lambda _: scorer.similarity(TEXT, x))]
                     )[0] for _ in range(STAGE_RUNS)]
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        scorer.audio(x)
    flop = float(fc.get_total_flops())
    st = median_parts(runs)
    emit({"phase": "htsat", "config": "HTSAT-tiny", "batch": 3,
          "samples": n, "setup_s": setup_s,
          "tower_ms_per_batch3": st["tower_ms"],
          "similarity_ms": st["similarity_ms"], "tower_gflop": flop / 1e9,
          "tower_f32_bound_ms": flop / F32_FLOPS * 1e3,
          "device_launches_per_tower_call": device_launches(
              lambda: scorer.audio(x)),
          "htsat_peak_mem_gb": (torch.cuda.max_memory_allocated() - held)
          / 1e9,
          "params_m": sum(p.numel() for p in scorer.audio.parameters())
          / 1e6, "scores": scores.tolist(), "kernel_launches": counts})
    return {"scorer": scorer}


def phase_t2a_htsat(main: dict, htsat: dict) -> dict:
    """``txt2audio_best`` on the main path's engine with the HTSAT scorer
    in place of the PANN one (restored after): the launches must be the
    configs' (K1 65, K2 73, as on the main path), the scores finite and
    not all equal, the wav the argmax of the HTSAT scores of an unranked
    call at the same seed; cold, warm (median of 3), RTF."""
    import numpy as np
    import torch

    eng = main["engine"]
    cfg = eng.cfg
    pann = eng.scorer
    eng.scorer = htsat["scorer"]
    try:
        def call():
            return eng.txt2audio_best(TEXT, n_samples=3, seed=0)

        expected = t2a_path(eng)["counts"]
        (_, wav, scores), cold_s, cold_counts = counted(call)
        runs = [counted(call) for _ in range(FACE_WARM_CALLS)]
        if any(c != expected for c in [cold_counts] + [r[2] for r in runs]):
            raise AssertionError(f"t2a_htsat launches {cold_counts}, "
                                 f"{[r[2] for r in runs]}; expected "
                                 f"{expected}")
        if wav.shape != (159744,) or not np.isfinite(scores).all() \
                or np.ptp(scores) == 0.0:
            raise AssertionError(f"t2a_htsat wav {wav.shape}, scores "
                                 f"{scores}")
        _, wavs = eng.txt2audio(TEXT, n_samples=3, ddim_steps=cfg.tool_steps,
                                seed=0, sampler=cfg.tool_sampler)
        best = int(scores.argmax())
        winner = float(np.abs(wavs[best] - wav).max())
        rescored = float(np.abs(eng.scorer.score(TEXT, wavs)
                                - scores).max())
        if winner > 1e-5 or rescored > 1e-5:
            raise AssertionError(f"t2a_htsat winner {best} differs by "
                                 f"{winner}, scores by {rescored}")
        torch.cuda.synchronize()
    finally:
        eng.scorer = pann
    warm = sorted(r[1] for r in runs)
    median = statistics.median(warm)
    emit({"phase": "t2a_htsat", "call": "txt2audio_best",
          "scorer": "htsat-tiny", "cold_s": cold_s, "warm_s": median,
          "warm_max_s": warm[-1], "warm_calls": len(warm),
          "rtf": median / CLIP_SECONDS, "warm_s_pann": main["warm_s"],
          "scores": scores.tolist(), "winner": best,
          "winner_max_abs_diff": winner, "rescored_max_abs_diff": rescored,
          "launches": runs[-1][2]})
    return {"launches": runs[-1][2]}


def set_ps_durations(model) -> None:
    """PortaSpeech's duration head (see ``PS_PHONE_FRAMES``)."""
    import torch

    out = model.dur_predictor.out
    with torch.no_grad():
        out.weight.mul_(PS_DUR_SCALE)
        out.bias.fill_(math.log(math.expm1(PS_PHONE_FRAMES)))


def phase_portaspeech(gen, name: str, use_graph: bool) -> dict:
    """The app's ``tts_portaspeech`` / ``syntaspeech`` engine at its width
    (``PortaSpeechTTSEngine()``, with ``PortaSpeechConfig(use_graph=True)``
    for SyntaSpeech: hidden 192, 4 + 4 + 4 relative-window encoder layers,
    the FVAE decoder and the 4-block prior flow on the 1024-frame canvas;
    HiFi-GAN V1), seeded random weights (the zero-initialised couplings
    and the prior's graph projection too) and ≈ 6 frames a phone, on the
    TTS sentence (113 phones; its words and ``<BOS>`` / ``<EOS>`` on the 32
    word bucket). Cold and warm (median of 3), RTF against the valid
    seconds, set-up, peak memory, neither kernel; the stages (the
    encoders with the durations and the word-to-mel attention, the prior
    flow, the FVAE decoder, the vocoder)."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import (PortaSpeechTTSEngine,
                                            VocoderEngine)
    from audiogpt_tpu_torch.models.tts import PortaSpeechConfig

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = PortaSpeechTTSEngine(
        cfg=PortaSpeechConfig(use_graph=True) if use_graph else None,
        vocoder=VocoderEngine("hifigan"))
    fill_random(eng.model, gen)
    fill_random(eng.vocoder.model, gen)
    set_ps_durations(eng.model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    inputs = eng.inputs(TTS_TEXT)
    with torch.inference_mode():
        enc = eng.model.encode(**inputs)
    frames = int((enc["mel2word"] > 0).sum())
    runs = tool_runs(lambda: eng(TTS_TEXT), FACE_WARM_CALLS)
    wav = runs["out"]
    hop = eng.vocoder.hop_size
    if wav.size % hop or not 0.9 * frames <= wav.size / hop <= frames \
            or not np.isfinite(wav).all() or float(wav.std()) == 0.0:
        raise AssertionError(f"{name} wav {wav.shape}, {frames} frames")
    audio_s = wav.size / eng.sample_rate
    emit({"phase": name, "graph": use_graph,
          "phones": int((inputs["txt_tokens"] > 0).sum()),
          "words": int((inputs["word_tokens"] > 0).sum()),
          "word_bucket": int(inputs["word_tokens"].shape[1]),
          "frames": frames, "canvas": eng.cfg.max_frames,
          "audio_s": audio_s, "setup_s": setup_s, "cold_s": runs["cold_s"],
          "warm_s": runs["warm_s"], "warm_max_s": runs["warm_max_s"],
          "warm_calls": FACE_WARM_CALLS, "rtf": runs["warm_s"] / audio_s,
          f"{name}_peak_mem_gb": (runs["peak"] - held) / 1e9,
          "params_m": sum(p.numel() for p in eng.model.parameters()) / 1e6,
          "vocoder_params_m": sum(p.numel() for p in
                                  eng.vocoder.model.parameters()) / 1e6,
          "kernel_launches": runs["launches"], "wav_std": float(wav.std())})
    model = eng.model
    hooks = {"encoders": [(model, "encode")], "prior_flow": [(model, "prior")],
             "fvae_dec": [(model, "decode")],
             "vocoder": [(eng.vocoder, "vocode")]}
    parts = [timed_calls(hooks, lambda: eng(TTS_TEXT))
             for _ in range(STAGE_RUNS)]
    emit({"phase": f"{name}_stages", "runs": STAGE_RUNS,
          **median_parts([{**p[1], **p[2]} for p in parts])})
    return {"engine": eng, "launches": runs["launches"]}


def phase_face_small_reference() -> None:
    """Narrow nets of the new engines on the card against the same weights
    and draws on the CPU (TF32 off): Audio2Motion's landmarks and the warp's
    frames, HTSAT at the full 256² image (the clamp rule at stage 4) and
    SyntaSpeech's mel (the graph on)."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import (GeneFaceEngine,
                                            PortaSpeechTTSEngine,
                                            VocoderEngine)
    from audiogpt_tpu_torch.models.face import Audio2MotionConfig
    from audiogpt_tpu_torch.models.textenc import (HTSATAudioEncoder,
                                                   HTSATConfig)
    from audiogpt_tpu_torch.models.tts import PortaSpeechConfig
    from audiogpt_tpu_torch.models.vocoder import HifiGANConfig

    res, launches = {}, []
    face = [GeneFaceEngine(Audio2MotionConfig(hidden=64, latent=8,
                                              conv_layers=2),
                           video_size=64, buckets=(256,), device=d)
            for d in ("cpu", "cuda")]
    fill_random(face[0].model, torch.Generator().manual_seed(60))
    face[1].model.load_state_dict(face[0].model.state_dict())
    mel = torch.rand(200, 80, generator=torch.Generator().manual_seed(61))
    z = torch.randn(1, 102, 8, generator=torch.Generator().manual_seed(62))
    lm_cpu = face[0].motion(mel, z)
    lm_card, _, counts = counted(lambda: face[1].motion(mel.cuda(),
                                                        z.cuda()))
    launches.append(counts)
    res["geneface_landmarks"] = float((lm_card.cpu() - lm_cpu).abs().max())
    frames = [e.warper.render(e.portrait, lm_cpu) for e in face]
    diff = np.abs(frames[0].astype(np.int16) - frames[1])
    res["geneface_frames_max_levels"] = int(diff.max())
    res["geneface_frames_off_share"] = float((diff > 0).mean())

    cfg = HTSATConfig(embed_dim=16, num_heads=(2, 2, 4, 4), d_proj=32)
    cpu = HTSATAudioEncoder(cfg).eval()
    fill_random(cpu, torch.Generator().manual_seed(63))
    with torch.no_grad():
        cpu.bn0_var.uniform_(0.5, 1.5,
                             generator=torch.Generator().manual_seed(64))
    card = HTSATAudioEncoder(cfg).cuda().eval()
    card.load_state_dict(cpu.state_dict())
    wav = 0.1 * torch.randn(2, 96000, generator=torch.Generator()
                            .manual_seed(65))
    with torch.inference_mode():
        a = cpu(wav, return_dict=True)
        b, _, counts = counted(lambda: card(wav.cuda(), return_dict=True))
    launches.append(counts)
    for key in ("projected", "clipwise"):
        res[f"htsat_{key}"] = float((b[key].cpu() - a[key]).abs().max())

    hifi = dict(upsample_initial_channel=32, upsample_rates=(8, 8, 4),
                upsample_kernel_sizes=(16, 16, 8), resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1,),))
    pcfg = PortaSpeechConfig(hidden_size=64, enc_layers=2, word_enc_layers=2,
                             fvae_hidden=64, prior_flow_hidden=32,
                             max_frames=256, use_graph=True)
    ps = [PortaSpeechTTSEngine(pcfg, vocoder=VocoderEngine(
        "hifigan", HifiGANConfig(**hifi), buckets=(256,), device=d),
        device=d) for d in ("cpu", "cuda")]
    fill_random(ps[0].model, torch.Generator().manual_seed(66))
    with torch.no_grad():
        ps[0].model.dur_predictor.out.weight.mul_(1e-3)
        ps[0].model.dur_predictor.out.bias.fill_(math.log(math.expm1(2.7)))
    ps[1].model.load_state_dict(ps[0].model.state_dict())
    zp = torch.randn(1, 64, 16, generator=torch.Generator().manual_seed(67))
    text = TTS_TEXT[:60]
    ma = ps[0].text_to_mel(text, draws=zp)
    mb, _, counts = counted(lambda: ps[1].text_to_mel(text,
                                                      draws=zp.cuda()))
    launches.append(counts)
    res["syntaspeech_mel"] = float(np.abs(mb - ma).max()) \
        if ma.shape == mb.shape else math.inf
    res["syntaspeech_frames"] = int(ma.shape[0])
    emit({"phase": "face_small_reference", **res, "cuda_launches": launches})
    for c in launches:
        check_no_kernels(c, "face_small_reference")
    if not (res["geneface_landmarks"] <= 1e-5
            and res["geneface_frames_max_levels"] <= 1
            and res["geneface_frames_off_share"] <= 1e-3
            and res["htsat_projected"] <= 1e-4
            and res["htsat_clipwise"] <= 1e-4
            and res["syntaspeech_mel"] <= 5e-4
            and res["syntaspeech_frames"] > 20):
        raise AssertionError(f"card vs CPU: {res}")


# ---------------------------------------------------------------------------
# served: the agent behind the HTTP server, one turn per tool
# ---------------------------------------------------------------------------


def http_json(port: int, path: str, body=None) -> dict:
    """One request to the server on 127.0.0.1: a JSON object, raw bytes or
    nothing (GET) → the JSON reply; a status other than 200 raises."""
    data = body if isinstance(body, (bytes, type(None))) \
        else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise AssertionError(f"{path}: HTTP {r.status}")
        return json.loads(r.read())


def served_tts_stream(port: int, sr: int) -> None:
    """``GET /tts/stream`` of the TTS sentence in clause chunks of at most
    64 phones: the time to the first PCM sample (the header goes out first,
    then each chunk as it is synthesised) and to the end of the stream."""
    import http.client
    import urllib.parse

    import numpy as np

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("GET", "/tts/stream?text="
                     + urllib.parse.quote(TTS_TEXT))
        r = conn.getresponse()
        head = r.read(46)                      # the header, one sample
        first_s = time.perf_counter() - t0
        raw = head + r.read()
        wall = time.perf_counter() - t0
    finally:
        conn.close()
    pcm = np.frombuffer(raw[44:], "<i2")
    if r.status != 200 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE" \
            or int.from_bytes(raw[24:28], "little") != sr or pcm.size == 0:
        raise AssertionError(f"/tts/stream: HTTP {r.status}, {len(raw)} "
                             f"bytes")
    emit({"phase": "served_tts_stream", "first_audio_s": first_s,
          "wall_s": wall, "audio_s": pcm.size / sr,
          "rtf": wall / (pcm.size / sr)})


def thread_cost(eng) -> None:
    """One warm ``txt2audio_best`` as the first call of a new thread, and
    on a thread that has run it before (median of 3 each). PyTorch builds
    its per-thread state (cuDNN's execution plans among it) again on each
    new thread, which is why ``AppServer`` runs every engine call on one
    thread of its own and not on the HTTP server's thread per request."""
    import threading

    import torch

    def timed():
        t = time.perf_counter()
        eng.txt2audio_best(TEXT, n_samples=3, seed=0)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    fresh = []
    for _ in range(3):
        thread = threading.Thread(target=lambda: fresh.append(timed()))
        thread.start()
        thread.join(timeout=120)
    same = [timed() for _ in range(3)]
    if len(fresh) != 3:
        raise AssertionError(f"{len(fresh)} of 3 threaded calls finished")
    emit({"phase": "served_thread_cost", "call": "txt2audio_best",
          "new_thread_first_call_s": statistics.median(fresh),
          "same_thread_call_s": statistics.median(same),
          "new_thread": fresh, "same_thread": same})


def asr_split(app, port: int, asr_eng, speech: str, turns: int) -> None:
    """The ASR tool's served turn taken apart, each part timed ``turns``
    times in turn with the others (the median and every time): the HTTP
    ``/chat`` turn, the tool called in this process, the tool's file load
    and ``transcribe`` on the server's engine thread, and ``transcribe``
    on this thread. All transcribe the server's file (int16, as the
    served turn does), and the transcript's length says how far the
    decode ran."""
    import torch

    from audiogpt_tpu_torch.utils.audio_io import load_wav

    wav16, _ = load_wav(speech, 16000)
    tool = app.tools.get("Transcribe Speech")
    on_engine = app.run_on_engine_thread
    parts = {
        "http_turn": lambda: http_json(port, "/chat", {"text": "use asr"}),
        "tool_call": lambda: tool(speech),
        "load_on_engine_thread": lambda: on_engine(
            lambda: load_wav(speech, sr=16000, device=asr_eng.device)),
        "transcribe_on_engine_thread": lambda: on_engine(
            asr_eng.transcribe, wav16),
        "transcribe_here": lambda: asr_eng.transcribe(wav16),
    }
    times = {name: [] for name in parts}
    for _ in range(turns):
        for name, fn in parts.items():
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
    emit({"phase": "served_asr_split",
          "transcript_chars": len(asr_eng.transcribe(wav16)),
          **{f"{name}_s": statistics.median(ts) for name, ts in
             times.items()}, "times": times})


def phase_served(main: dict, inpaint: dict, asr: dict, tts: dict,
                 i2a: dict, t2i: dict, i2t: dict, tools: dict,
                 singing: dict, face: dict, tmp: str) -> None:
    """``AppServer(ScriptedLLM(script), build_engines({...}))`` behind
    ``make_server`` on 127.0.0.1 (an OS-chosen port), the built engines of
    the earlier phases passed as a mapping: one ``/chat`` turn per tool
    (t2a; inpaint of the t2a turn's wav; asr of the ASR phase's clip; tts;
    i2a of the I2A phase's PNG by path; t2i; i2t of the PNG the t2i turn
    wrote, by the name the turn's answer gives; the seven audio analysis
    and transform tools of ``tools`` on the SED phase's events clip or the
    separation phase's speech clip; svs on the default song and tts_ood
    on the Style Transfer phase's 10 s reference, whose file must be mono
    at 22 050 Hz: ``singing``; geneface on the GeneFace phase's clip, named
    relative to the media root, whose ``video/<file>.avi`` must hold 250
    frames at 25 fps with audio and come back from ``GET /media/`` as
    ``video/x-msvideo``), each twice (its first call
    on the server's engine thread, then warm), then ``/mode`` speech and one
    ``/speech`` turn (ASR → agent → the t2a tool → TTS → merge), then
    ``/stats`` and one ``/tts/stream``; first the cost of a new thread
    (:func:`thread_cost`), and before the mode switch the ASR turn taken
    apart (:func:`asr_split`). Each turn's wall time (the HTTP round trip) and
    launches, which must be the tool's derived ones and equal to the
    direct call's; the t2a, tts and i2a files hold the direct calls'
    wavs; ``GET /media/image/...`` returns the t2i turn's 512 × 512 PNG and
    the sed turn's figure; the i2t, caption and tsd turns answer the direct
    call's text on their file, and separate's merged file lies under the
    media root."""
    import shutil
    import threading
    import wave

    import numpy as np
    from PIL import Image

    from audiogpt_tpu_torch.agent import ScriptedLLM
    from audiogpt_tpu_torch.app import (ALL_ENGINES, build_engines,
                                        speech_callables)
    from audiogpt_tpu_torch.serving import AppServer, make_server
    from audiogpt_tpu_torch.utils.audio_io import load_wav, save_wav
    from audiogpt_tpu_torch.utils.video_io import read_avi_info

    # every serving factory of the JAX app (audiogpt_tpu/app.py)
    if len(ALL_ENGINES) != 19 or not {"geneface", "tts_portaspeech",
                                      "syntaspeech"} <= set(ALL_ENGINES):
        raise AssertionError(f"app factories {ALL_ENGINES}")

    t2a, asr_eng, tts_eng = main["engine"], asr["engine"], tts["engine"]
    thread_cost(t2a)
    root = Path(tmp) / "media"
    (root / "audio").mkdir(parents=True)
    speech = str(root / "audio" / "speech.wav")
    save_wav(asr["wav"], speech, 16000)
    t2a_wav = str(root / "audio" / "t2a_turn.wav")
    events = str(root / "audio" / "events.wav")
    save_wav(tools["sed"]["wav"], events, 32000)
    speech10 = str(root / "audio" / "speech10.wav")
    save_wav(tools["wav16k"], speech10, 16000)
    voice = str(root / "audio" / "voice10.wav")
    save_wav(singing["tts_ood"]["ref"], voice, 22050)
    save_wav(face["wav"], str(root / "audio" / "face10.wav"), 16000)
    # the tools read only files under the media root (utils/media.py)
    (root / "image").mkdir(exist_ok=True)
    i2a_image = str(root / "image" / "i2a_photo.png")
    shutil.copyfile(i2a["image"], i2a_image)
    turns = [
        ("t2a", "Generate Audio From User Input Text", TEXT),
        ("inpaint", "Audio Inpainting", f"{t2a_wav}, 1.0, 3.0"),
        ("asr", "Transcribe Speech", speech),
        ("tts", "Synthesize Speech Given the User Input Text", TTS_TEXT),
        ("i2a", "Generate Audio From The Image", i2a_image),
        ("t2i", "Generate Image From User Input Text", T2I_TEXT),
        ("i2t", "Get Photo Description", "{image}"),
        ("caption", "Generate Text From The Audio", events),
        ("sed", "Detect The Sound Event From The Audio", events),
        ("tsd", "Target Sound Detection", f"{events}, {TSD_TEXT}"),
        ("extraction", "Extract Sound Event From Mixture Audio Based On "
                       "Language Description", f"{events}, {EXTRACT_TEXT}"),
        ("enhance", "Speech Enhancement In Single-Channel", speech10),
        ("separate", "Speech Separation In Single-Channel", speech10),
        ("binaural", "Sythesize Binaural Audio From A Mono Audio Input",
         speech10),
        ("svs", "Generate Singing Voice From User Input Text, Note and "
                "Duration Sequence", '""'),
        ("tts_ood", "Style Transfer", f"{voice}, {TTS_TEXT}"),
        ("geneface", "Generate a talking human portrait video given a "
                     "input Audio", "audio/face10.wav"),
    ]
    new_tools = ("caption", "sed", "tsd", "extraction", "enhance",
                 "separate", "binaural", "svs", "tts_ood", "geneface")

    class ImagePathLLM(ScriptedLLM):
        """The script with ``{image}`` replaced by the last
        ``image/<file>.png`` the prompt names: the t2i turn's answer copies
        its observation, and the i2t turn's input copies that answer."""

        def complete(self, prompt, stop=None):
            out = super().complete(prompt, stop)
            names = re.findall(r"image/[\w.-]+\.png", prompt)
            return out.replace("{image}", names[-1]) if names else out

    script = []
    split_turns = 3
    # each tool twice (the engine thread's first call of it, then warm),
    # the ASR turns of ``asr_split``, then the speech turn's tool
    for key, tool, arg in 2 * turns + split_turns * [turns[2]] + [turns[0]]:
        script += [f"Thought: Do I need to use a tool? Yes\nAction: {tool}\n"
                   f"Action Input: {arg}",
                   "Thought: Do I need to use a tool? No\nAI: Done."
                   + (" {image}" if key == "t2i" else "")]
    engines = build_engines({"t2a": t2a, "asr": asr_eng, "tts": tts_eng,
                             "i2a": i2a["engine"], "t2i": t2i["engine"],
                             "i2t": i2t["engine"],
                             **{k: {**tools, **singing,
                                    "geneface": face}[k]["engine"]
                                for k in new_tools}})
    asr_fn, tts_fn = speech_callables(engines, str(root))
    app = AppServer(ImagePathLLM(script), engines, media_root=str(root),
                    asr=asr_fn, tts=tts_fn)
    httpd = make_server(app, "127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        wav16, _ = load_wav(speech, 16000)
        direct = {
            "t2a": main["launches"], "inpaint": inpaint["launches"],
            "asr": asr_counted(asr_eng,
                               lambda: asr_eng.transcribe(wav16))[2],
            "tts": expected_counts(Counter(), Counter()),
            "i2a": i2a["launches"], "t2i": t2i["launches"],
            "i2t": i2t["launches"],
            **{k: expected_counts(Counter(), Counter()) for k in new_tools}}
        tool_counts = {"t2a": t2a_path(t2a)["counts"],
                       "inpaint": inpaint_path(t2a)["counts"],
                       "asr": None, "tts": None,
                       "i2a": i2a_path(i2a["engine"])["counts"],
                       "t2i": t2i_path(t2i["engine"])["counts"],
                       "i2t": i2t_path(i2t["engine"])["counts"],
                       **{k: None for k in new_tools}}
        refs = {"t2a": main["wav"], "tts": tts["wav"], "i2a": i2a["wav"]}
        first_wall = {}
        for n, (key, tool, _) in enumerate(2 * turns):
            if key == "t2a":
                t2a._generator.manual_seed(0)  # the main path's draws
            # a served turn's launches: its tool's, and the ASR engine's
            # 6 per encoder pass
            reply, wall, counts, expected, _ = encoder_counted(
                asr_eng, lambda: http_json(port, "/chat",
                                           {"text": f"use {key}"}),
                tool_counts[key])
            step = reply["steps"][0]
            if step["tool"] != tool or counts != expected \
                    or counts != direct[key]:
                raise AssertionError(f"served {key}: {step}, launches "
                                     f"{counts}, expected {expected}, "
                                     f"direct {direct[key]}")
            res = {"tool": key, "wall_s": wall,
                   "first_call_wall_s": first_wall.setdefault(key, wall),
                   "launches": counts}
            if key == "asr":
                res["transcript_chars"] = len(step["observation"])
            elif key == "t2i":
                rel = step["observation"]
                png = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/media/{rel}", timeout=60).read()
                with Image.open(io.BytesIO(png)) as im:
                    size = im.size
                if reply["media"] != [{"kind": "image", "url": f"/media/{rel}",
                                       "tool": tool}] \
                        or png != (root / rel).read_bytes() \
                        or size != (512, 512):
                    raise AssertionError(f"served t2i: {reply}, {size}")
                res.update(image=rel, png_bytes=len(png))
            elif key == "i2t":
                image = str(root / step["input"])
                direct_caption = i2t["engine"](image)
                if not step["input"].startswith("image/") \
                        or step["observation"] != direct_caption:
                    raise AssertionError(f"served i2t: {step}, direct "
                                         f"{direct_caption!r}")
                res.update(image=step["input"],
                           caption_chars=len(step["observation"]))
            elif key in ("caption", "tsd"):
                eng = engines[key]
                sr = eng.sr if key == "caption" else eng.mel.sr
                wav, _ = load_wav(events, sr, device=eng.device)
                direct_text = eng.caption(wav) if key == "caption" \
                    else tool_text_tsd(eng, wav)
                if step["observation"] != direct_text or reply["media"]:
                    raise AssertionError(f"served {key}: {step}, direct "
                                         f"{direct_text!r}")
                res["answer_chars"] = len(direct_text)
            elif key == "sed":
                rel = os.path.relpath(step["observation"], root)
                png = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/media/{rel}", timeout=60).read()
                with Image.open(io.BytesIO(png)) as im:
                    size = im.size
                if not rel.startswith("image/") \
                        or reply["media"] != [{"kind": "image",
                                               "url": f"/media/{rel}",
                                               "tool": tool}] \
                        or png != (root / rel).read_bytes() \
                        or size != (1000, 400):
                    raise AssertionError(f"served sed: {reply}, {size}")
                res.update(image=rel, png_bytes=len(png))
            elif key == "geneface":
                rel = step["observation"]
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/media/{rel}",
                        timeout=60) as r:
                    avi, ctype = r.read(), r.headers["Content-Type"]
                info = read_avi_info(str(root / rel))
                if not rel.startswith("video/") \
                        or reply["media"] != [{"kind": "video",
                                               "url": f"/media/{rel}",
                                               "tool": tool}] \
                        or ctype != "video/x-msvideo" \
                        or avi != (root / rel).read_bytes() \
                        or (info["n_frames"], info["fps"],
                            info["n_streams"]) != (250, 25, 2):
                    raise AssertionError(f"served geneface: {reply}, "
                                         f"{ctype}, {info}")
                res.update(video=rel, avi_bytes=len(avi))
            else:
                out, sr = load_wav(step["observation"])
                if not (reply["media"] and np.isfinite(out).all()
                        and out.std() > 0):
                    raise AssertionError(f"served {key}: {reply}")
                res.update(sr=sr, samples=int(out.size))
                if key in refs:
                    ref = np.clip(refs[key], -1.0, 1.0)
                    # the int16 file against the f32 wav: one step, each
                    # way of rounding
                    diff = float(np.abs(out - ref).max()) \
                        if out.shape == ref.shape else math.inf
                    res["max_abs_diff_from_direct"] = diff
                    if diff > 2.0 / 32767:
                        raise AssertionError(f"served {key} wav differs "
                                             f"from the direct call by "
                                             f"{diff}")
                if key == "t2a":
                    shutil.copy(step["observation"], t2a_wav)
                if key in new_tools and not Path(step["observation"]) \
                        .resolve().is_relative_to(root.resolve()):
                    raise AssertionError(f"served {key}: {step} is not "
                                         f"under the media root")
                if key == "binaural":
                    with wave.open(step["observation"], "rb") as w:
                        stereo = (w.getnchannels(), w.getnframes())
                    if stereo != (2, 480000) or sr != 48000:
                        raise AssertionError(f"served binaural: {stereo}")
                if key in ("svs", "tts_ood"):
                    # mono audio at the vocoder's rate, whole frames
                    with wave.open(step["observation"], "rb") as w:
                        mono = (w.getnchannels(), w.getframerate(),
                                w.getnframes() % 256)
                    if mono != (1, 22050, 0):
                        raise AssertionError(f"served {key}: (channels, "
                                             f"rate, frames % hop) {mono}")
                    res["audio_s"] = out.size / sr
            if n >= len(turns):                     # the warm turn
                emit({"phase": "served_turn", **res})
        asr_split(app, port, asr_eng, speech, split_turns)
        http_json(port, "/mode", {"mode": "speech"})
        with open(speech, "rb") as f:
            body = f.read()
        reply, wall, counts, expected, _ = encoder_counted(
            asr_eng, lambda: http_json(port, "/speech", body),
            tool_counts["t2a"])
        if counts != expected or not reply["audio"].startswith("/media/"):
            raise AssertionError(f"speech turn: {reply}, launches {counts}, "
                                 f"expected {expected}")
        out, sr = load_wav(str(root / reply["audio"][len("/media/"):]))
        emit({"phase": "served_speech", "wall_s": wall, "launches": counts,
              "transcript_chars": len(reply["transcript"]),
              "reply_sr": sr, "reply_s": out.size / sr})
        stats = http_json(port, "/stats")
        emit({"phase": "served_stats", "stats": stats})
        if sorted(stats) != sorted(tool for _, tool, _ in turns):
            raise AssertionError(f"/stats tools {sorted(stats)}")
        served_tts_stream(port, tts_eng.sample_rate)
    finally:
        httpd.shutdown()
        httpd.server_close()
        app.close()
        thread.join(timeout=60)


def tool_text_tsd(eng, wav) -> str:
    """The TSD tool's answer for ``wav`` (``agent/toolset.py``'s
    ``tsd_fn``)."""
    spans = eng.detect(wav, TSD_TEXT)
    if not spans:
        return f"no occurrence of '{TSD_TEXT}' detected"
    return "; ".join(f"({s:.2f}s, {t:.2f}s)" for s, t in spans)


#: the training phases: steps of each full-width run (20, cut from 60 to
#: 40 and then to 20 to keep the whole script inside its time limit), its
#: fixture's size,
#: the loss windows compared (the first and the last steps), the steps left
#: out of the step-time median (the FLOP-counted step, the allocator's
#: first blocks), and the bound on the UNet gradients with K1 against the
#: plain attention path (f32, TF32 off): max|Δg| / max|g|
TRAIN_STEPS, TRAIN_RECORDS, TRAIN_WINDOW, TRAIN_WARM_SKIP = 20, 64, 10, 3
TRAIN_GRAD_TOL = 1e-4
#: the mel canvas of ldm.yaml (``data.width``) and its mel bins
LDM_FRAMES, LDM_MELS = 624, 80
#: the tiny LDM of the resume phase (tests/test_train.py:514-525's)
TINY_LDM = ("model.unet.model_channels=32,model.unet.num_res_blocks=1,"
            "model.unet.num_heads=4,model.unet.context_dim=24,"
            "model.vae.ch=32,model.vae.ch_mult=[1, 2],"
            "model.vae.num_res_blocks=1,model.clap.bert.hidden_size=16,"
            "model.clap.bert.num_layers=1,model.clap.bert.num_heads=2,"
            "model.clap.bert.intermediate_size=32,model.clap.d_proj=24,"
            "model.timesteps=50,data.width=32,batch_size=8")


def train_fixture(root: Path, n: int, frames: int, mels: int, seed: int,
                  valid: int = 0) -> str:
    """``n`` seeded LDM records (``mel`` [frames, mels] in [0, 1],
    ``text_ids``: [CLS], 6–75 BERT word ids, [SEP]) written by the port's
    ``RecordWriter`` as the train split, ``valid`` more as the valid split;
    → the binary dir."""
    import numpy as np

    from audiogpt_tpu_torch.data import RecordWriter

    rng = np.random.default_rng(seed)
    for split, count in (("train", n), ("valid", valid)):
        if not count:
            continue
        with RecordWriter(str(root / "bin" / split)) as w:
            for _ in range(count):
                words = rng.integers(1000, 30522, int(rng.integers(6, 76)))
                w.add({"mel": rng.random((frames, mels), dtype=np.float32),
                       "text_ids": np.concatenate(
                           [[101], words, [102]]).astype(np.int32)})
    return str(root / "bin")


def ldm_config(bin_dir: str, bf16: bool, extra: str = ""):
    """``configs/t2a/ldm.yaml`` through the port's ``load_config``, on
    ``bin_dir``, with ``model.bf16_compute`` and ``extra`` overrides."""
    from audiogpt_tpu_torch.config import load_config

    hp = f"model.bf16_compute={str(bf16).lower()},data.binary_dir={bin_dir}"
    return load_config(str(ROOT / "configs" / "t2a" / "ldm.yaml"),
                       overrides=hp + ("," + extra if extra else ""))


def ldm_trainer(cfg, work_dir: str, **over):
    """``train_cli.build_task`` and a ``Trainer`` with the CLI's config,
    ``over`` replacing fields of it; → (task, trainer)."""
    import dataclasses

    from audiogpt_tpu_torch import train_cli
    from audiogpt_tpu_torch.train import Trainer

    task = train_cli.build_task(cfg)
    tcfg = dataclasses.replace(train_cli.trainer_config(cfg, work_dir),
                               **over)
    return task, Trainer(task, tcfg)


def ldm_step_shapes(task, batch: int, frames: int, mels: int) -> Counter:
    """K1 launches of one training step by shape: the UNet's forward (its
    backward recomputes the plain version; ``use_checkpoint`` runs the
    forward again), from the configs."""
    cfg = task.cfg
    f = 2 ** (len(cfg.vae.ch_mult) - 1)
    once = unet_flash_shapes(cfg.unet, batch, (mels // f, frames // f),
                             cfg.clap.max_length)
    return Counter({s: n * (1 + cfg.unet.use_checkpoint)
                    for s, n in once.items()})


def phase_train_ldm(tmp: str, bf16: bool, checkpoint: bool = False) -> dict:
    """``ldm.yaml`` at full width trained for ``TRAIN_STEPS`` steps through
    the CLI's builders and ``Trainer.fit`` (no valid split: every launch is
    a training step's); with ``checkpoint`` the UNet's blocks are
    recomputed in the backward (``model.unet.use_checkpoint``), which runs
    each attention block's forward, K1 included, a second time."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch import train_cli

    name = "train_ldm_bf16" if bf16 else "train_ldm"
    name += "_ckpt" if checkpoint else ""
    root = Path(tmp) / name
    bin_dir = train_fixture(root, TRAIN_RECORDS, LDM_FRAMES, LDM_MELS, 21)
    cfg = ldm_config(bin_dir, bf16, "model.unet.use_checkpoint=true"
                     if checkpoint else "")
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    task, trainer = ldm_trainer(cfg, str(root / "exp"), log_interval=1,
                                num_sanity_val_steps=0,
                                val_check_interval=10 ** 9,
                                use_tensorboard=False)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    train_it, val_fn = train_cli.build_loaders(cfg, "ldm")
    batch = cfg["batch_size"]
    if val_fn is not None or batch != 16 or task.cfg.unet.model_channels \
            != 320 or task.cfg.bf16_compute != bf16 \
            or task.cfg.unet.use_checkpoint != checkpoint:
        raise AssertionError(f"{name}: config {cfg.to_dict()}")
    per_step = ldm_step_shapes(task, batch, LDM_FRAMES, LDM_MELS)
    torch.cuda.reset_peak_memory_stats()
    (_, shapes), fit_s, counts = counted(lambda: recorded_flash(
        lambda: trainer.fit(train_it, max_updates=TRAIN_STEPS)))
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    expected = expected_counts(
        Counter({s: n * TRAIN_STEPS for s, n in per_step.items()}),
        Counter(), flash_bf16=bf16)
    if counts != expected or shapes != Counter(
            {s: n * TRAIN_STEPS for s, n in per_step.items()}) \
            or trainer.step != TRAIN_STEPS:
        raise AssertionError(f"{name}: launches {counts}, shapes "
                             f"{dict(shapes)}, step {trainer.step}; "
                             f"expected {expected}, {dict(per_step)} a step")
    lines = [json.loads(line) for line in
             open(root / "exp" / "metrics.jsonl")]
    tr = [line for line in lines if line["prefix"] == "tr"]
    loss = [line["diff"] for line in tr]
    first = statistics.fmean(loss[:TRAIN_WINDOW])
    last = statistics.fmean(loss[-TRAIN_WINDOW:])
    if len(tr) != TRAIN_STEPS or not np.isfinite(loss).all() \
            or any(line["nonfinite"] for line in tr) or not last < first:
        raise AssertionError(f"{name}: losses {loss}")
    if trainer.store.latest_step() != TRAIN_STEPS:
        raise AssertionError(f"{name}: checkpoints "
                             f"{trainer.store.all_steps()}")
    steady = tr[TRAIN_WARM_SKIP:]
    step_s = statistics.median(1.0 / line["steps_per_sec"]
                               for line in steady)
    flops = next(iter(trainer._flops.values()))
    peak_rate = BF16_FLOPS if bf16 else F32_FLOPS
    res = {"phase": name, "steps": TRAIN_STEPS, "batch": batch,
           "mel": [LDM_MELS, LDM_FRAMES], "bf16_compute": bf16,
           "use_checkpoint": checkpoint,
           "trainable_params": sum(p.numel() for p in trainer.params["unet"]),
           "frozen_params": sum(p.numel() for p in
                                task.modules["frozen"].parameters()),
           "setup_s": setup_s, "fit_s": fit_s,
           "step_ms": step_s * 1e3,
           "step_ms_min": 1e3 * min(1.0 / line["steps_per_sec"]
                                    for line in steady),
           "samples_per_s": batch / step_s, "peak_mem_gb": peak,
           "k1_launches_per_step": sum(per_step.values()),
           "k1_shapes_per_step": {str(list(s)): n
                                  for s, n in per_step.items()},
           "k2_launches": counts["snake_aa"],
           "loss_first_window": first, "loss_last_window": last,
           "loss_first": loss[0], "loss_last": loss[-1],
           "grad_norm_last": tr[-1]["grad_norm"],
           "step_gflop": flops / 1e9,
           "mfu": statistics.median(line["mfu"] for line in steady),
           "mfu_peak_tflops": peak_rate / 1e12,
           "step_bound_ms": flops / peak_rate * 1e3,
           "bound_by": "operations"}
    emit(res)
    shutil.rmtree(root / "exp")        # the checkpoint: ≈ 2.6 GB
    return {"task": task, "trainer": trainer, "shapes": per_step,
            "launches": {k: v // TRAIN_STEPS for k, v in counts.items()},
            "step_ms": res["step_ms"], "peak_mem_gb": peak, "losses": loss,
            "batch": next(iter(train_cli.build_loaders(cfg, "ldm")[0]))}


def unet_grads(task, batch, seed: int) -> list:
    """The UNet's gradients of the f32 loss on ``batch`` (on the card) with
    the draws of a generator seeded with ``seed``."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    loss, _ = task.loss(batch, gen)
    params = [p for p in task.unet.parameters()]
    return [g.detach() for g in torch.autograd.grad(loss, params)]


def phase_train_grad_check(train: dict, gen) -> None:
    """The f32 task's UNet (seeded noise in every weight, so every layer
    gets a gradient) on one full-width batch: its gradients with K1 against
    those with the plain attention path forced; then ``FlashAttention``'s
    dq, dk, dv at the training shape against the plain version's autograd
    and SDPA's, f32 and bf16, with the backward's times."""
    import importlib

    import torch
    import torch.nn.functional as F

    from audiogpt_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    task, trainer = train["task"], train["trainer"]
    fill_random(task.unet, gen)
    batch = trainer._to_device(train["batch"])
    (kernel, _), _, counts = counted(lambda: recorded_flash(
        lambda: unet_grads(task, batch, 5)))
    attn = importlib.import_module("audiogpt_tpu_torch.ops.attention")
    takes = attn.flash_takes
    attn.flash_takes = lambda *a, **kw: False
    try:
        plain, _, plain_counts = counted(lambda: unet_grads(task, batch, 5))
    finally:
        attn.flash_takes = takes
    if counts["flash_attention"] != sum(train["shapes"].values()) \
            or plain_counts["flash_attention"] != 0:
        raise AssertionError(f"grad check launches {counts}, "
                             f"{plain_counts}")
    diff = max(float((a - b).abs().max()) for a, b in zip(kernel, plain))
    scale = max(float(b.abs().max()) for b in plain)
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(kernel, plain))
    zero = sum(int(float(b.abs().max()) == 0.0) for b in plain)
    if not diff <= TRAIN_GRAD_TOL * scale or zero:
        raise AssertionError(f"UNet grads with K1: max abs diff {diff} of "
                             f"{scale}; {zero} zero gradients")
    (b, t, _, h, d), = train["shapes"]
    attention = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                   .to(dtype).requires_grad_() for _ in range(3))
        g = torch.randn(b, t, h, d, generator=gen, device="cuda").to(dtype)
        out = flash_attention(q, k, v)
        got = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
        ref_out = flash_attention_reference(q, k, v)
        ref = torch.autograd.grad(ref_out, (q, k, v), g, retain_graph=True)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
        sdpa = torch.autograd.grad(sdpa_out, (q, k, v), g.transpose(1, 2),
                                   retain_graph=True)
        err = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(got, ref))
        sdpa_err = max(float((x.float() - y.float()).abs().max())
                       for x, y in zip(got, sdpa))
        # the backward is the plain version's autograd on the same inputs:
        # equal up to the order in which a library kernel may sum
        if err > (1e-5 if dtype == torch.float32 else 1e-2):
            raise AssertionError(f"FlashAttention {dname} grads differ "
                                 f"from the plain version's by {err}")
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            out, (q, k, v), g, retain_graph=True), 10)
        sdpa_ms = time_ms(lambda: torch.autograd.grad(
            sdpa_out, (q, k, v), g.transpose(1, 2), retain_graph=True), 10)
        attention[dname] = {"dqkv_max_abs_err": err,
                            "sdpa_dqkv_max_abs_diff": sdpa_err,
                            "recompute_backward_ms": bwd_ms,
                            "sdpa_backward_ms": sdpa_ms}
    per_step = sum(train["shapes"].values())
    emit({"phase": "train_grad_check", "unet_grad_max_abs_diff": diff,
          "unet_grad_max_abs": scale, "relative": diff / scale,
          "worst_tensor_relative": worst, "bound": TRAIN_GRAD_TOL,
          "k1_launches": counts["flash_attention"],
          "plain_launches": plain_counts["flash_attention"],
          "attention_shape": [b, t, t, h, d], "attention": attention,
          "recompute_ms_per_step": per_step
          * attention["float32"]["recompute_backward_ms"],
          "recompute_share_of_step": per_step
          * attention["float32"]["recompute_backward_ms"] / train["step_ms"]})


#: data parallelism (PR 17): ``train_ddp_ldm``'s steps against
#: ``train_ldm``'s first; ``train_ddp_gloo_small``'s steps. Losses within
#: 1e-6 relative; the first step's gradients within 5e-5 of each tensor's
#: largest, floored at 1e-7 of the group's largest gradient; the updated
#: parameters within 5e-5 of each tensor's largest, but an element whose
#: first gradient is under that floor (rounding noise: a true gradient of
#: 0 or next to it) within Adam's move of up to the rate a step either
#: way, which normalises that noise
DDP_STEPS, DDP_SMALL_STEPS = 8, 3
DDP_LOSS_RTOL, DDP_PARAM_RTOL, DDP_ZERO_GRAD_TOL = 1e-6, 5e-5, 1e-7
#: the tiny LDM of ``train_ddp_gloo_small``: a 32 × 32 mel's latent holds
#: 16 · 16 = 256 tokens at level 0, so its self-attention reaches K1
#: (256² pairs), at D = 40 as the full UNet's; no block recomputed in the
#: backward, as ``ldm.yaml``'s
TINY_DDP_UNET = dict(model_channels=160, num_res_blocks=1,
                     channel_mult=(1, 2), num_heads=4, context_dim=24,
                     use_checkpoint=False)
TINY_DDP_MEL = 32


def phase_train_ddp_ldm(tmp: str, train: dict) -> dict:
    """``ldm.yaml`` at full width trained by ``python -m
    torch.distributed.run --standalone --nproc-per-node 1 -m
    audiogpt_tpu_torch.train_cli`` (NCCL, one rank) on ``train_ldm``'s
    records for ``DDP_STEPS`` steps: each step's loss against
    ``train_ldm``'s first steps (the same config, seed and records, in
    process and without a group), the step times, the flat gradient
    all-reduce's time a step, the peaks and K1's launches, from the CLI's
    ``--report``. The subprocess turns TF32 off through
    ``NVIDIA_TF32_OVERRIDE=0``, as this process has it off, and grows its
    allocator's segments (``expandable_segments``): its ≈ 50 GB then fit
    beside what this process holds."""
    import gc

    import numpy as np
    import torch

    gc.collect()
    # cuBLAS's workspaces (≈ 65 MB) pin the earlier steps' segments
    # (≈ 14 GB after train_ldm) in this process's cache
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_allocated() / 1e9,
            torch.cuda.memory_reserved() / 1e9)
    root = Path(tmp) / "train_ddp_ldm"
    report = root / "report.json"
    hp = ",".join(["model.bf16_compute=false",
                   f"data.binary_dir={Path(tmp) / 'train_ldm' / 'bin'}",
                   "log_interval=1", "num_sanity_val_steps=0",
                   "val_check_interval=1000000000", "use_tensorboard=false"])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "audiogpt_tpu_torch.train_cli",
           "--config", str(ROOT / "configs" / "t2a" / "ldm.yaml"),
           "--exp_name", str(root / "exp"), "--hparams", hp,
           "--max_updates", str(DDP_STEPS), "--report", str(report)]
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"train_ddp_ldm: torchrun exit "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    rep = json.loads(report.read_text())
    tr = [line for line in map(json.loads, open(root / "exp" /
                                               "metrics.jsonl"))
          if line["prefix"] == "tr"]
    loss = [line["diff"] for line in tr]
    ref = train["losses"][:DDP_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(loss, ref)]
    per_step = train["shapes"]
    expected = expected_counts(
        Counter({s: n * DDP_STEPS for s, n in per_step.items()}), Counter())
    if rep["launches"] != expected or rep["steps"] != DDP_STEPS \
            or rep["world"] != 1 or rep["backend"] != "nccl" \
            or len(loss) != DDP_STEPS or not np.isfinite(loss).all() \
            or max(rel) > DDP_LOSS_RTOL \
            or len(rep["comm_ms"]) != DDP_STEPS:
        raise AssertionError(f"train_ddp_ldm: report {rep['launches']}, "
                             f"steps {rep['steps']}, world {rep['world']}, "
                             f"backend {rep['backend']}; losses {loss} "
                             f"against {ref}")
    steady = tr[TRAIN_WARM_SKIP:]
    step_ms = statistics.median(1e3 / line["steps_per_sec"]
                                for line in steady)
    comm = statistics.median(rep["comm_ms"][TRAIN_WARM_SKIP:])
    grad_bytes = 4 * rep["grad_numel"]["unet"]
    emit({"phase": "train_ddp_ldm", "steps": DDP_STEPS,
          "launcher": "torch.distributed.run --standalone "
                      "--nproc-per-node 1", "backend": rep["backend"],
          "world": rep["world"], "wall_s": wall,
          "parent_allocated_gb": held[0], "parent_reserved_gb": held[1],
          "losses": loss,
          "reference_losses": ref, "loss_max_rel_diff": max(rel),
          "loss_rtol": DDP_LOSS_RTOL, "step_ms": step_ms,
          "reference_step_ms": train["step_ms"],
          "step_ms_ratio": step_ms / train["step_ms"],
          "allreduce_ms": comm, "allreduce_ms_min": min(rep["comm_ms"]),
          "allreduce_bytes": grad_bytes,
          "allreduce_share_of_step": comm / step_ms,
          "peak_mem_gb": rep["peak_mem_gb"],
          "reference_peak_mem_gb": train["peak_mem_gb"],
          "k1_launches_per_step": rep["launches"]["flash_attention"]
          // DDP_STEPS,
          "k1_shapes_per_step": {str(list(s)): n
                                 for s, n in per_step.items()},
          "k2_launches": rep["launches"]["snake_aa"]})
    shutil.rmtree(root)                 # the checkpoint: ≈ 2.6 GB
    return {"shapes": per_step,
            "launches": {k: v // DDP_STEPS
                         for k, v in rep["launches"].items()}}


def tiny_ldm_batch(seed: int) -> dict:
    """A batch of 4 mel images [4, 32, 32, 1] in [−1, 1] with 6-token
    texts, the last row of weight 0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m = TINY_DDP_MEL
    return {"mels": np.tanh(rng.normal(size=(4, m, m, 1))).astype(np.float32),
            "text_ids": rng.integers(1, 100, (4, 6)).astype(np.int32),
            "text_mask": np.ones((4, 6), np.int32),
            "weight": np.asarray([1, 1, 1, 0], np.float32)}


def ddp_small_run(name: str, work: Path, mesh) -> dict:
    """The tiny ``ldm`` or ``fs2`` task on the card (seeded noise in every
    weight), ``DDP_SMALL_STEPS`` steps through ``Trainer.fit`` on ``mesh``
    (None: no group) with the launch counts set to 0 just before and read
    just after; → the logged losses (rank 0), the parameters, the first
    step's gradients and rates, the launches."""
    import torch

    from audiogpt_tpu_torch.models.diffusion import UNetConfig, VAEConfig
    from audiogpt_tpu_torch.models.textenc import CLAPTextConfig
    from audiogpt_tpu_torch.models.textenc.bert import BertConfig
    from audiogpt_tpu_torch.models.tts import FastSpeech2Config
    from audiogpt_tpu_torch.train import Trainer, TrainerConfig
    from audiogpt_tpu_torch.train.tasks import (FS2Task, FS2TaskConfig,
                                                LDMTask, LDMTaskConfig)

    if name == "ldm":
        task = LDMTask(LDMTaskConfig(
            unet=UNetConfig(**TINY_DDP_UNET),
            vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                          attn_resolutions=()),
            clap=CLAPTextConfig(bert=BertConfig(**TINY_BERT), d_proj=24),
            timesteps=50))
        batches = [tiny_ldm_batch(s) for s in range(DDP_SMALL_STEPS)]
        key = "diff"
    else:
        task = FS2Task(FS2TaskConfig(model=FastSpeech2Config(**TINY_FS2)))
        batches = [tiny_fs2_batch(s) for s in range(DDP_SMALL_STEPS)]
        key = "total_loss"
    gen = torch.Generator("cuda").manual_seed(17)
    for group in sorted(task.modules):
        fill_random(task.modules[group], gen)
    trainer = Trainer(task, TrainerConfig(
        work_dir=str(work), log_interval=1, val_check_interval=10 ** 9,
        num_sanity_val_steps=0, use_tensorboard=False), mesh=mesh)
    grads, lrs = {}, {}
    for g, opt in trainer.opt.items():
        def step(gs, g=g, opt=opt, real=opt.step):
            if g not in grads:
                grads[g] = [x.detach().cpu().clone() for x in gs]
            lrs.setdefault(g, []).append(float(opt.schedule(opt.count)))
            real(gs)
        opt.step = step
    _, fit_s, counts = counted(lambda: trainer.fit(
        batches, max_updates=DDP_SMALL_STEPS))
    losses = None
    if trainer.logger.is_main:
        trainer.logger.close()
        losses = [line[key] for line in map(json.loads, open(
            work / "metrics.jsonl")) if line["prefix"] == "tr"]
    return {"losses": losses, "grads": grads, "lr": lrs,
            "launches": counts, "fit_s": fit_s,
            "params": {g: {n: p.detach().cpu().clone()
                           for n, p in trainer.named[g]}
                       for g in trainer.groups}}


def ddp_small_child(argv: list) -> int:
    """``chip_smoke.py --gloo-rank R --port P --out DIR``: one of the two
    gloo ranks of ``train_ddp_gloo_small`` on the one card; writes
    ``DIR/rank{R}.pt``."""
    import argparse

    import torch
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--gloo-rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from audiogpt_tpu_torch.parallel import distributed_init, make_mesh

    r = args.gloo_rank
    distributed_init(f"127.0.0.1:{args.port}", 2, r, backend="gloo")
    mesh = make_mesh()
    out = Path(args.out)
    res = {name: ddp_small_run(name, out / f"{name}_rank{r}", mesh)
           for name in ("ldm", "fs2")}
    torch.save(res, out / f"rank{r}.pt")
    dist.destroy_process_group()
    return 0


def ddp_compare(name: str, single: dict, ranks: list) -> dict:
    """``train_ddp_gloo_small``'s checks of one task (module comment
    above ``DDP_STEPS``); → the largest differences."""
    import torch

    res = {"loss_max_rel_diff": max(
        abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                            single["losses"]))}
    if len(ranks[0]["losses"]) != DDP_SMALL_STEPS \
            or res["loss_max_rel_diff"] > DDP_LOSS_RTOL:
        raise AssertionError(f"{name}: losses {ranks[0]['losses']} against "
                             f"{single['losses']}")
    worst_grad = worst_param = 0.0
    noise_elements = 0
    for g, params in single["params"].items():
        names = list(params)
        top = max(float(x.abs().max()) for x in single["grads"][g])
        for n, s, d in zip(names, single["grads"][g], ranks[0]["grads"][g]):
            bound = max(DDP_PARAM_RTOL * float(s.abs().max()),
                        DDP_ZERO_GRAD_TOL * top)
            err = float((d - s).abs().max())
            worst_grad = max(worst_grad, err / bound)
            if err > bound:
                raise AssertionError(f"{name}: first gradient of {g}.{n} "
                                     f"{err} past {bound}")
        adam = 2.0 * sum(single["lr"][g])
        for n, grad in zip(names, single["grads"][g]):
            s = params[n]
            for rank in ranks:
                if not torch.equal(rank["params"][g][n],
                                   ranks[0]["params"][g][n]):
                    raise AssertionError(f"{name}: the ranks' {g}.{n} "
                                         f"differ")
            noise = grad.abs() <= DDP_ZERO_GRAD_TOL * top
            noise_elements += int(noise.sum())
            bound = torch.where(noise, adam, DDP_PARAM_RTOL * float(
                s.abs().max()))
            err = (ranks[0]["params"][g][n] - s).abs()
            worst_param = max(worst_param, float(
                (err / bound.clamp_min(1e-30)).max()))
            if bool((err > bound).any()):
                raise AssertionError(f"{name}: parameter {g}.{n} "
                                     f"{float(err.max())} past its bound")
    res.update(grad_worst_share_of_bound=worst_grad,
               param_worst_share_of_bound=worst_param,
               noise_elements=noise_elements)
    return res


def phase_train_ddp_gloo_small(tmp: str) -> dict:
    """Two processes on the one card joined over gloo, each training its
    half of every batch of the tiny ``ldm`` and ``fs2`` tasks, against
    this process training them on the whole batches without a group
    (``ddp_compare``); each rank's K1 launches against the configs'."""
    import socket

    import torch

    root = Path(tmp) / "train_ddp_gloo_small"
    root.mkdir(parents=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--gloo-rank", str(r),
         "--port", str(port), "--out", str(root)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        single = {name: ddp_small_run(name, root / f"{name}_single", None)
                  for name in ("ldm", "fs2")}
        logs = [p.communicate(timeout=300)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode:
            raise AssertionError(f"train_ddp_gloo_small rank {r} exit "
                                 f"{p.returncode}:\n{logs[r][-3000:]}")
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    from audiogpt_tpu_torch.models.diffusion import UNetConfig

    # the VAE's factor 2: a 16 × 16 latent; 6 text tokens
    per_rank = Counter({s: n * DDP_SMALL_STEPS for s, n in unet_flash_shapes(
        UNetConfig(**TINY_DDP_UNET), 2, (TINY_DDP_MEL // 2,) * 2,
        6).items()})
    res = {"phase": "train_ddp_gloo_small", "steps": DDP_SMALL_STEPS,
           "backend": "gloo", "world": 2, "wall_s": wall,
           "batch": 4, "rows_per_rank": 2}
    for name in ("ldm", "fs2"):
        res[name] = ddp_compare(name, single[name],
                                [rank[name] for rank in ranks])
        want = expected_counts(per_rank if name == "ldm" else Counter(),
                               Counter())
        got = [rank[name]["launches"] for rank in ranks]
        if any(c != want for c in got):
            raise AssertionError(f"train_ddp_gloo_small {name}: launches "
                                 f"{got}, expected {want} a rank")
        res[name].update(
            k1_launches_per_rank=[c["flash_attention"] for c in got],
            single_k1_launches=single[name]["launches"]["flash_attention"],
            fit_s_per_rank=[rank[name]["fit_s"] for rank in ranks],
            single_fit_s=single[name]["fit_s"], losses=ranks[0][name][
                "losses"], single_losses=single[name]["losses"])
    res["k1_shapes_per_rank_step"] = {
        str(list(s)): n // DDP_SMALL_STEPS for s, n in per_rank.items()}
    emit(res)
    return {"shapes": Counter({s: n // DDP_SMALL_STEPS
                               for s, n in per_rank.items()}),
            "launches": {k: v // DDP_SMALL_STEPS
                         for k, v in ranks[0]["ldm"]["launches"].items()}}


def phase_train_resume(tmp: str) -> None:
    """A tiny LDM (``TINY_LDM``) with a valid split trained to step 4 with a
    checkpoint every 2 steps (sanity and periodic validation on the card);
    a second task and trainer on the same work dir (its UNet refilled, so
    only the restore can give the saved params) resume at step 4 and train
    on to step 6."""
    import torch

    from audiogpt_tpu_torch import train_cli

    root = Path(tmp) / "train_resume"
    bin_dir = train_fixture(root, 20, 32, 16, 22, valid=6)
    cfg = ldm_config(bin_dir, False, TINY_LDM + ",val_check_interval=2,"
                     "num_sanity_val_steps=1")
    work = str(root / "exp")
    task, first = ldm_trainer(cfg, work, log_interval=1,
                              use_tensorboard=False)
    train_it, val_fn = train_cli.build_loaders(cfg, "ldm")
    first.fit(train_it, val_fn, max_updates=4)
    saved = {n: p.detach().clone() for n, p in first.named["unet"]}
    task2, second = ldm_trainer(cfg, work, log_interval=1,
                                use_tensorboard=False)
    fill_random(task2.unet, torch.Generator("cuda").manual_seed(3))
    second.restore_or_init()
    resumed_at = second.step
    same = all(torch.equal(p, saved[n]) for n, p in second.named["unet"])
    train_it, val_fn = train_cli.build_loaders(cfg, "ldm")
    second.fit(train_it, val_fn, max_updates=6)
    lines = [json.loads(line) for line in open(Path(work) / "metrics.jsonl")]
    steps = [line["step"] for line in lines if line["prefix"] == "tr"]
    val = [line["step"] for line in lines if line["prefix"] == "val"]
    if resumed_at != 4 or not same or second.step != 6 \
            or steps != [1, 2, 3, 4, 5, 6] or val != [2, 4, 6] \
            or second.store.all_steps() != [2, 4, 6] \
            or second.opt["unet"].count != 6:
        raise AssertionError(f"resume: at {resumed_at}, params restored "
                             f"{same}, steps {steps}, val {val}, ckpts "
                             f"{second.store.all_steps()}")
    emit({"phase": "train_resume", "saved_step": 4, "resumed_at": resumed_at,
          "params_restored": same, "final_step": second.step,
          "logged_steps": steps, "val_steps": val,
          "checkpoints": second.store.all_steps(),
          "sanity": [line for line in lines if line["prefix"] == "sanity"]})


#: the TTS training phases. The LJSpeech-like fixture: items, their length
#: range in seconds (LJSpeech's clips run 1–10 s), frames a phone (≈ 11
#: phones a second at hop 256), the share of unvoiced phones, and the items
#: of the CWT split. Steps of each run (cut from 60 and 40 to keep the
#: whole script inside its time limit); the rsqrt warmup of the fs2 runs:
#: fs2.yaml's 8000-step warmup stays under 1.1e-5 over such a run, so the
#: run uses 400 (6.3e-4 at step 40; the yaml's peak is 1.4e-3); the loss
#: windows compared; the card-vs-CPU bounds of the small reference (f32,
#: TF32 off): the losses relative, the gradients against each tensor's
#: largest
TTS_ITEMS, TTS_SECONDS, TTS_FRAMES_PER_PHONE = 256, (1.5, 10.0), 8
TTS_UNVOICED, TTS_CWT_ITEMS = 0.2, 64
FS2_STEPS, FS2_CWT_STEPS, GAN_STEPS, FS2_WARMUP = 40, 10, 30, 400
TTS_LOSS_RTOL, TTS_GRAD_TOL = 1e-5, 1e-4
#: a vanishing gradient (an attention's key bias) of the PR 13 recipes,
#: against the group's largest gradient (the CPU tests' bound)
TTS_ZERO_GRAD_TOL = 1e-7
#: the tiny tasks of the CPU tests (tests/test_torch_fs2_train.py MODEL,
#: tests/test_torch_vocoder_gan.py GEN and DISC)
TINY_FS2 = dict(vocab_size=30, hidden_size=16, enc_layers=1, dec_layers=1,
                num_heads=2, enc_ffn_kernel_size=3, dec_ffn_kernel_size=3,
                dur_predictor_layers=1, predictor_layers=2,
                predictor_hidden=8, max_frames=64)
TINY_GEN = dict(in_channels=20, upsample_rates=(4, 4),
                upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
TINY_DISC = dict(periods=(2, 3), scales=2, period_channels=(4, 8),
                 scale_channels=(8, 16, 16), scale_groups=(1, 1, 1))


#: the word-level fixture: a small English lexicon (its word set stays
#: under the configs' ``word_vocab_size`` of 100) and ESD's five emotions
TTS_WORDS = (
    "the a an and of to in is it that was he she they we you i his her "
    "with for on at by from as but not all one two old new big small "
    "long little good great day night time year man woman child dog cat "
    "house water river road tree light sound voice word story morning "
    "came went said made saw found took gave told asked ran sat stood "
    "walked looked turned back down over under near again").split()
TTS_EMOTIONS = ("Neutral", "Happy", "Sad", "Angry", "Surprise")
TTS_WORD_ITEMS, TTS_EMO_ITEMS = 128, 64
PS_STEPS, SYNTA_STEPS, PS_ADV_STEPS, GS_STEPS, PE_STEPS = 30, 10, 20, 20, 20
PE_WARMUP = 100
#: the tiny PortaSpeech, GenerSpeech and pitch extractor of the CPU tests
#: (tests/test_torch_portaspeech_train.py PS, tests/test_torch_generspeech.py
#: FS2 and GS, tests/test_torch_generspeech_train.py's PE), the critic at
#: their windows
TINY_PS = dict(word_vocab_size=20, hidden_size=16, enc_layers=1,
               word_enc_layers=1, num_heads=2, enc_ffn_kernel_size=3,
               dur_predictor_layers=1, n_mels=16, max_frames=64,
               latent_size=4, fvae_hidden=8, fvae_enc_layers=2,
               fvae_dec_layers=1, prior_flow_hidden=8, prior_flow_blocks=2,
               graph_steps=2)
TINY_GS_FS2 = dict(vocab_size=90, hidden_size=16, enc_layers=1,
                   dec_layers=1, num_heads=2, enc_ffn_kernel_size=3,
                   dec_ffn_kernel_size=3, n_mels=20, dur_predictor_layers=1,
                   predictor_layers=1, predictor_hidden=8, max_frames=64)
TINY_GS = dict(n_vq=8, emb_dim=16, glow_hidden=16, glow_steps=2,
               glow_wn_layers=2)
TINY_PE = dict(n_mels=20, hidden=16, prenet_layers=2, conv_layers=1,
               predictor_layers=2)
TINY_WINDOWS = (8, 16)


def voiced_wav(rng, samples: int, dur, sr: int, hop: int):
    """A seeded voice-like wav of ``samples`` samples over phones of
    ``dur`` frames: each phone voiced (two harmonics of a moving f0,
    90–260 Hz base, plus noise) or, one in ``1 / TTS_UNVOICED``, unvoiced
    noise. → (wav, the per-frame f0 it was made with, 0 where
    unvoiced)."""
    import numpy as np

    frames = 1 + samples // hop
    voiced = np.repeat(rng.random(len(dur)) >= TTS_UNVOICED, dur)
    t = np.arange(frames) * hop / sr
    f0 = rng.uniform(90, 260) * (1 + 0.1 * np.sin(
        2 * np.pi * rng.uniform(0.3, 1.2) * t + rng.uniform(0, 6.3)))
    f0_s = np.repeat(f0, hop)[:samples]
    v_s = np.repeat(voiced, hop)[:samples]
    ph = 2 * np.pi * np.cumsum(f0_s) / sr
    wav = np.where(v_s, 0.3 * np.sin(ph) + 0.1 * np.sin(2 * ph), 0.0) \
        + rng.normal(0, 0.01, samples) \
        + np.where(v_s, 0.0, rng.normal(0, 0.05, samples))
    return wav.astype(np.float32), np.where(voiced, f0, 0.0)


def tts_corpus(n: int, seed: int, sr: int = 22050, hop: int = 256):
    """``n`` seeded LJSpeech-like items (``data/binarizer.py`` ``Item``):
    1.5–10 s at 22 050 Hz, phones drawn from the ARPAbet set with durations
    (≥ 1 frame, ≈ 8 a phone) that sum to the item's frames, the wav from
    ``voiced_wav``. → (items, the per-frame f0 each item was made with, 0
    where unvoiced)."""
    import numpy as np

    from audiogpt_tpu_torch.data import Item
    from audiogpt_tpu_torch.text import default_arpabet_vocab

    vocab = default_arpabet_vocab()
    rng = np.random.default_rng(seed)
    items, tracks = [], []
    for i in range(n):
        samples = int(rng.uniform(*TTS_SECONDS) * sr)
        frames = 1 + samples // hop
        n_ph = max(2, frames // TTS_FRAMES_PER_PHONE)
        cuts = np.sort(rng.choice(np.arange(1, frames), n_ph - 1,
                                  replace=False))
        dur = np.diff(np.concatenate([[0], cuts, [frames]]))
        wav, track = voiced_wav(rng, samples, dur, sr, hop)
        phones = [vocab[j] for j in rng.integers(0, len(vocab), n_ph)]
        items.append(Item(name=f"LJ{i:04d}", wav=wav, phones=phones,
                          durations=dur.tolist()))
        tracks.append(track)
    return items, tracks


def phase_binarize_tts(tmp: str) -> dict:
    """The port's ``TTSBinarizer`` (mel and f0 on the card) on the fixture
    corpus with ``with_wav`` and ``with_f0`` (the fs2 and vocoder split),
    and on its first ``TTS_CWT_ITEMS`` items with ``with_f0cwt`` too (the
    split ``fs2_cwt.yaml`` reads): items/s, the device time of the mel and
    the f0 over the corpus, the f0 against the pitch each item was made
    with and against a 220 Hz sine, the phone set against ``vocab_size``."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.data import (BinarizeConfig, TTSBinarizer,
                                         load_phone_encoder, load_split)
    from audiogpt_tpu_torch.dsp.f0 import estimate_f0
    from audiogpt_tpu_torch.dsp.mel import log_mel
    from audiogpt_tpu_torch.models.tts import FastSpeech2Config

    t0 = time.perf_counter()
    items, tracks = tts_corpus(TTS_ITEMS, 31)
    corpus_s = time.perf_counter() - t0
    root = Path(tmp) / "tts_bin"
    binz = TTSBinarizer(BinarizeConfig(with_wav=True, with_f0=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = binz.binarize(items, str(root / "lj"))
    bin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cwt_counts = TTSBinarizer(BinarizeConfig(
        with_f0=True, with_f0cwt=True)).binarize(items[:TTS_CWT_ITEMS],
                                                 str(root / "lj_cwt"))
    cwt_s = time.perf_counter() - t0
    # the device time of the two DSP steps over the corpus, item by item
    # as the binarizer runs them
    spec = binz.cfg.mel
    wavs = [torch.from_numpy(it.wav).cuda() for it in items]
    for fn in (lambda x: log_mel(x, spec),
               lambda x: estimate_f0(x, spec.sr, spec.hop)):
        fn(wavs[0])
    dsp_ms = {}
    for name, fn in (("mel", lambda x: log_mel(x, spec)),
                     ("f0", lambda x: estimate_f0(x, spec.sr, spec.hop))):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for x in wavs:
            fn(x)
        end.record()
        end.synchronize()
        dsp_ms[name] = start.elapsed_time(end)
    del wavs
    # f0 against the pitch each frame was made with: voiced frames whose
    # phone is voiced on both neighbours (no onset), in cents
    train = load_split(str(root / "lj"), "train")
    n_valid = counts["valid"]
    cents, uv_agree, frames = [], 0, 0
    for j in range(len(train)):
        rec, track = train[j], tracks[n_valid + j]
        est = rec["f0"]
        inner = (track > 0) & np.roll(track > 0, 1) & np.roll(track > 0, -1)
        both = inner & (est > 0)
        cents.append(1200 * np.abs(np.log2(est[both] / track[both])))
        uv_agree += int(((est > 0) == (track > 0)).sum())
        frames += len(track)
    cents = np.concatenate(cents)
    sr = spec.sr
    sine = torch.sin(2 * math.pi * 220.0 * torch.arange(2 * sr) / sr
                     ).cuda() * 0.5
    hz, voiced = estimate_f0(sine, sr, spec.hop)
    sine_err = float((hz[4:-4][voiced[4:-4] > 0] - 220.0).abs().max())
    phones = len(load_phone_encoder(str(root / "lj")))
    vocab = FastSpeech2Config().vocab_size
    res = {"phase": "binarize_tts", "items": len(items),
           "audio_s": sum(len(it.wav) for it in items) / sr,
           "fixture_s": corpus_s, "splits": counts,
           "binarize_s": bin_s, "items_per_s": len(items) / bin_s,
           "cwt_split": cwt_counts, "cwt_binarize_s": cwt_s,
           "device_ms_mel": dsp_ms["mel"], "device_ms_f0": dsp_ms["f0"],
           "f0_cents_median": float(np.median(cents)),
           "f0_cents_p95": float(np.percentile(cents, 95)),
           "uv_agreement": uv_agree / frames,
           "sine_220_max_abs_err_hz": sine_err,
           "phone_ids": phones, "vocab_size": vocab,
           "mel_frames": int(np.load(root / "lj" / "train_lengths.npy").sum())}
    emit(res)
    rec = train[0]
    if phones > vocab or sine_err > 2.0 or res["f0_cents_median"] > 20 \
            or res["uv_agreement"] < 0.9 or counts["train"] + \
            counts["valid"] != TTS_ITEMS or rec["mel"].shape != (
                rec["len"], 80) or "wav" not in rec \
            or rec["mel2ph"].max() != len(rec["tokens"]):
        raise AssertionError(f"binarize_tts: {res}")
    return {"lj": str(root / "lj"), "lj_cwt": str(root / "lj_cwt")}


def tts_trainer(config: str, bin_dir: str, work: str, extra: str = "",
                **over):
    """``configs/<config>`` through the port's ``load_config`` on
    ``bin_dir``, ``train_cli.build_task`` and a ``Trainer`` with the CLI's
    config, ``over`` replacing fields of it; → (cfg, task, trainer)."""
    import dataclasses

    from audiogpt_tpu_torch import train_cli
    from audiogpt_tpu_torch.config import load_config
    from audiogpt_tpu_torch.train import Trainer

    cfg = load_config(str(ROOT / "configs" / config),
                      overrides=f"data.binary_dir={bin_dir}"
                      + ("," + extra if extra else ""))
    task = train_cli.build_task(cfg)
    tcfg = dataclasses.replace(train_cli.trainer_config(cfg, work),
                               use_tensorboard=False, **over)
    return cfg, task, Trainer(task, tcfg)


def tapped(it, seen: list):
    """``it``'s batches, each one's shapes and real units appended to
    ``seen`` as it is drawn: a token-budget batch's real mel frames; a
    fixed-shape batch's real rows times its frames (a mel image's width)
    or samples."""
    for b in it:
        real = b["weight"] > 0
        if "txt_tokens" in b:
            seen.append(((tuple(b["mels"].shape),
                          tuple(b["txt_tokens"].shape)),
                         int(b["mel_lengths"][real].sum())))
        else:
            x = b["mels"] if "mels" in b else b.get("wav", b.get("mix"))
            seen.append(((tuple(x.shape),), int(real.sum())
                         * x.shape[2 if x.ndim == 4 else 1]))
        yield b


def train_lines(work: Path) -> list:
    return [line for line in (json.loads(x) for x in
                              open(work / "metrics.jsonl"))
            if line["prefix"] == "tr"]


def peak_sites(events: list, base: int, top: int = 8) -> dict:
    """Replay an allocator trace (``torch.cuda.memory._snapshot()``'s
    ``device_traces``) from ``base`` allocated bytes: the peak, and the
    blocks live at it grouped by the innermost frame of the package (or of
    this script) that allocated them, in GB, with the largest blocks."""
    def walk(stop=None):
        live, total, best, at = {}, base, base, 0
        for i, ev in enumerate(events):
            if i == stop:
                break
            if ev["action"] == "alloc":
                live[ev["addr"]] = ev
                total += ev["size"]
            elif ev["action"].startswith("free") and ev["addr"] in live:
                total -= live.pop(ev["addr"])["size"]
            if total > best:
                best, at = total, i + 1
        return live, best, at

    def site(ev):
        for f in ev.get("frames", []):
            name = f["filename"].replace("\\", "/")
            for root in ("audiogpt_tpu_torch/", "chip_smoke.py"):
                if root in name:
                    return (name[name.index(root):]
                            + f":{f['line']} {f['name']}")
        return "(no frame of the port)"

    _, best, at = walk()
    live, _, _ = walk(at)
    by: Counter = Counter()
    for ev in live.values():
        by[site(ev)] += ev["size"]
    blocks = sorted(live.values(), key=lambda ev: -ev["size"])[:5]
    return {"peak_gb": (best - base) / 1e9,
            "sites_gb": {k: v / 1e9 for k, v in by.most_common(top)},
            "largest_blocks": [[ev["size"] / 1e9, site(ev)]
                               for ev in blocks]}


def fs2_memory_split(trainer, batch) -> dict:
    """What one FS2 training step allocates at its peak, on ``batch`` (the
    run's largest shape), after the fit: the trainer's held state (model,
    Adam moments), then a warm ``train_step`` and one under
    ``FlopCounterMode`` (as the first step of a shape runs), each under the
    allocator's history with the sites live at its peak; and one forward
    that keeps its graph, with what the backward would keep: the saved
    tensors (each storage once, parameters left out) and the part of them
    that is [.., T, T] attention maps."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    batch = trainer._to_device(batch)
    T = batch["mels"].shape[1]
    params = {p.untyped_storage().data_ptr()
              for p in trainer.task.model.parameters()}
    torch.cuda.synchronize()
    out = {"shape": list(batch["mels"].shape),
           "held_gb": torch.cuda.memory_allocated() / 1e9}
    for name, mode in (("warm", None), ("flop_counter", FlopCounterMode)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(
            enabled="all", stacks="python", max_entries=1_000_000)
        if mode is None:
            trainer.train_step("model", batch, 0)
        else:
            with mode(display=False):
                trainer.train_step("model", batch, 0)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        out[name] = {"step_peak_gb": (torch.cuda.max_memory_allocated()
                                      - base) / 1e9,
                     **peak_sites(snap["device_traces"][
                         torch.cuda.current_device()], base)}
    saved: dict = {}

    def pack(t):
        key = t.untyped_storage().data_ptr()
        if t.is_cuda and key not in params and key not in saved:
            saved[key] = (t.untyped_storage().nbytes(),
                          t.dim() >= 2 and t.shape[-1] == t.shape[-2] == T)
        return t

    base = torch.cuda.memory_allocated()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = trainer.task.loss_fns["model"](batch, trainer.generator)
    torch.cuda.synchronize()
    out["forward_kept_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
    out["saved_gb"] = sum(n for n, _ in saved.values()) / 1e9
    out["saved_TxT_gb"] = sum(n for n, tt in saved.values() if tt) / 1e9
    del loss, _
    out["conv_alone"] = conv_peaks(trainer, batch)
    return out


def conv_peaks(trainer, batch) -> list:
    """Each distinct ``Conv1d`` of the FS2 model at the input it gets from
    ``batch``, alone: the peak of its forward and its backward (input and
    weight gradients) above what was allocated, against the bytes of its
    input, output and their gradients; the rest is what the convolution
    itself asks for (cuDNN's workspace). GB, largest first."""
    import torch

    seen: dict = {}

    def hook(mod, args, _out):
        x = args[0]
        key = (mod.in_channels, mod.out_channels, mod.kernel_size[0],
               tuple(x.shape))
        seen.setdefault(key, mod)

    convs = [m for m in trainer.task.model.modules()
             if isinstance(m, torch.nn.Conv1d)]
    hooks = [m.register_forward_hook(hook) for m in convs]
    with torch.no_grad():
        trainer.task.loss_fns["model"](batch, trainer.generator)
    for h in hooks:
        h.remove()
    rows = []
    for (cin, cout, k, shape), mod in seen.items():
        # [B, C, T] as a transpose of [B, T, C], as conv_time feeds it
        x = torch.randn(shape[0], shape[2], shape[1], device="cuda"
                        ).transpose(1, 2).requires_grad_()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = mod(x)
        gx, gw = torch.autograd.grad(y, (x, mod.weight), torch.ones_like(y))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        io = 2 * (x.numel() + y.numel()) * 4 + gw.numel() * 4
        rows.append({"conv": f"{cin}->{cout} k{k}", "input": list(shape),
                     "peak_gb": peak / 1e9, "io_gb": io / 1e9,
                     "rest_gb": (peak - io) / 1e9})
        del x, y, gx, gw
    return sorted(rows, key=lambda r: -r["peak_gb"])


def phase_train_fs2(bins: dict, tmp: str) -> dict:
    """``configs/tts/fs2.yaml`` at full width (hidden 256, 4 + 4 FFT
    layers, 2 heads, FFN kernel 9, frame pitch with uv, 2048 frames) on the
    binarized corpus, through the CLI's builders at the yaml's budget
    (30 000 tokens, 100 sentences, the 128–2048 × 8–64 ladder) and
    ``Trainer.fit`` for ``FS2_STEPS`` steps with the valid split checked at
    the last step (its mel figure written)."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch import train_cli

    work = Path(tmp) / "train_fs2"
    cfg, task, trainer = tts_trainer(
        "tts/fs2.yaml", bins["lj"], str(work),
        f"optim.warmup_steps={FS2_WARMUP}", log_interval=1,
        num_sanity_val_steps=0, val_check_interval=FS2_STEPS)
    m = task.cfg.model
    if (m.hidden_size, m.enc_layers, m.dec_layers, m.num_heads,
            m.enc_ffn_kernel_size, m.pitch_type, m.use_uv, m.max_frames) != \
            (256, 4, 4, 2, 9, "frame", True, 2048):
        raise AssertionError(f"train_fs2: model {m}")
    train_it, val_fn = train_cli.build_loaders(cfg, "fs2")
    seen: list = []
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, fit_s, counts = counted(lambda: trainer.fit(
        tapped(train_it, seen), val_fn, max_updates=FS2_STEPS))
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    tr = train_lines(work)
    loss = [line["total_loss"] for line in tr]
    first = statistics.fmean(loss[:TRAIN_WINDOW])
    last = statistics.fmean(loss[-TRAIN_WINDOW:])
    shapes = [key for key, _ in seen[:FS2_STEPS]]
    repeat = [i for i in range(FS2_STEPS) if shapes[i] in shapes[:i]]
    step_s = [1.0 / tr[i]["steps_per_sec"] for i in repeat]
    png = work / "figures" / f"mel_0_{FS2_STEPS}.png"
    val = [line for line in (json.loads(x) for x in
                             open(work / "metrics.jsonl"))
           if line["prefix"] == "val"]
    res = {"phase": "train_fs2", "steps": FS2_STEPS,
           "params": sum(p.numel() for p in task.model.parameters()),
           "fit_s": fit_s, "warmup_steps": FS2_WARMUP,
           "batch_shapes": len(set(shapes)),
           "shapes": sorted({str(list(s)) for s in shapes}),
           "repeat_steps": len(repeat),
           "step_ms": 1e3 * statistics.median(step_s),
           "step_ms_min": 1e3 * min(step_s),
           "valid_frames_per_s": statistics.median(
               seen[i][1] / s for i, s in zip(repeat, step_s)),
           "peak_mem_gb": peak,
           "k1_launches_per_step": counts["flash_attention"] / FS2_STEPS,
           "k2_launches_per_step": counts["snake_aa"] / FS2_STEPS,
           "loss_first_window": first, "loss_last_window": last,
           "loss_first": loss[0], "loss_last": loss[-1],
           "nonfinite": sum(line["nonfinite"] for line in tr),
           "mfu": statistics.median(tr[i].get("mfu", math.nan)
                                    for i in repeat),
           "mfu_peak_tflops": F32_FLOPS / 1e12,
           "step_gflop_median": statistics.median(
               trainer._flops[k] for k in trainer._flops) / 1e9,
           "val_total_loss": val[-1]["total_loss"] if val else None,
           "figure_bytes": png.stat().st_size if png.exists() else 0}
    big = max(shapes, key=lambda key: math.prod(key[0]))
    batch = next(b for b in train_cli.build_loaders(cfg, "fs2")[0]
                 if (tuple(b["mels"].shape), tuple(b["txt_tokens"].shape))
                 == big)
    res["memory"] = fs2_memory_split(trainer, batch)
    emit(res)
    check_no_kernels(counts, "train_fs2")
    if len(tr) != FS2_STEPS or not np.isfinite(loss).all() \
            or res["nonfinite"] or not last < first or not repeat \
            or not res["figure_bytes"] or not val \
            or trainer.step != FS2_STEPS:
        raise AssertionError(f"train_fs2: {res}")
    return {"launches": counts}


def phase_train_fs2_cwt(bins: dict, tmp: str) -> dict:
    """``configs/tts/fs2_cwt.yaml`` (FS2 with ``pitch_type: cwt``) on the
    CWT split for ``FS2_CWT_STEPS`` steps: the ``cwt``, ``uv``,
    ``f0_mean`` and ``f0_std`` terms present and finite at every step."""
    import numpy as np

    from audiogpt_tpu_torch import train_cli

    work = Path(tmp) / "train_fs2_cwt"
    cfg, task, trainer = tts_trainer(
        "tts/fs2_cwt.yaml", bins["lj_cwt"], str(work),
        f"optim.warmup_steps={FS2_WARMUP}", log_interval=1,
        num_sanity_val_steps=0, val_check_interval=10 ** 9)
    if task.cfg.model.pitch_type != "cwt":
        raise AssertionError(f"train_fs2_cwt: model {task.cfg.model}")
    train_it, _ = train_cli.build_loaders(cfg, "fs2")
    _, fit_s, counts = counted(lambda: trainer.fit(
        train_it, max_updates=FS2_CWT_STEPS))
    tr = train_lines(work)
    terms = ("cwt", "uv", "f0_mean", "f0_std")
    res = {"phase": "train_fs2_cwt", "steps": len(tr), "fit_s": fit_s,
           **{f"{k}_first": tr[0].get(k) for k in terms},
           **{f"{k}_last": tr[-1].get(k) for k in terms},
           "total_loss_first": tr[0]["total_loss"],
           "total_loss_last": tr[-1]["total_loss"],
           "nonfinite": sum(line["nonfinite"] for line in tr),
           "k1_launches": counts["flash_attention"],
           "k2_launches": counts["snake_aa"]}
    emit(res)
    check_no_kernels(counts, "train_fs2_cwt")
    if len(tr) != FS2_CWT_STEPS or res["nonfinite"] or not all(
            k in line and np.isfinite(line[k]) for line in tr
            for k in terms):
        raise AssertionError(f"train_fs2_cwt: {res}")
    return {"launches": counts}


def phase_train_vocoder_gan(bins: dict, tmp: str) -> dict:
    """``configs/vocoder/hifigan.yaml`` at full width (HiFi-GAN V1: 512
    channels, rates 8, 8, 2, 2; MPD periods 2, 3, 5, 7, 11 at 32–1024
    channels; MSD 3 scales with groups 1, 4, 16, 16, 16, 16, 1; batch 16 ×
    32 frames) on the binarized corpus through the CLI's builders and
    ``Trainer.fit`` for ``GAN_STEPS`` steps (each ``disc`` then ``gen``);
    then each group's step alone, timed on one batch."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch import train_cli

    work = Path(tmp) / "train_vocoder_gan"
    cfg, task, trainer = tts_trainer(
        "vocoder/hifigan.yaml", bins["lj"], str(work), log_interval=1,
        num_sanity_val_steps=0, val_check_interval=10 ** 9)
    g, d = task.cfg.gen, task.cfg.disc
    if (g.upsample_initial_channel, tuple(g.upsample_rates),
            tuple(d.periods), d.scales, tuple(d.scale_groups),
            cfg["batch_size"], task.cfg.segment_frames) != \
            (512, (8, 8, 2, 2), (2, 3, 5, 7, 11), 3,
             (1, 4, 16, 16, 16, 16, 1), 16, 32):
        raise AssertionError(f"train_vocoder_gan: config {task.cfg}")
    before = {grp: [p.detach().clone() for p in trainer.params[grp]]
              for grp in trainer.groups}
    train_it, val_fn = train_cli.build_loaders(cfg, "vocoder_gan")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, fit_s, counts = counted(lambda: trainer.fit(train_it,
                                                   max_updates=GAN_STEPS))
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    moved = {grp: max(float((p.detach() - q).abs().max()) for p, q in
                      zip(trainer.params[grp], before[grp]))
             for grp in trainer.groups}
    tr = train_lines(work)
    g_mel = [line["g_mel"] for line in tr]
    step_s = [1.0 / line["steps_per_sec"] for line in tr[1:]]
    batch = trainer._to_device(next(train_it))
    group_ms = {}
    for grp in trainer.groups:
        times = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(grp, batch, i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        group_ms[grp] = 1e3 * statistics.median(times[1:])
    flops = {key[0]: v for key, v in trainer._flops.items()}
    res = {"phase": "train_vocoder_gan", "steps": GAN_STEPS,
           "gen_params": sum(p.numel() for p in trainer.params["gen"]),
           "disc_params": sum(p.numel() for p in trainer.params["disc"]),
           "fit_s": fit_s, "step_ms": 1e3 * statistics.median(step_s),
           "disc_step_ms": group_ms["disc"], "gen_step_ms": group_ms["gen"],
           "samples_per_s": cfg["batch_size"] * task.cfg.segment_frames
           * g.hop_size / statistics.median(step_s),
           "peak_mem_gb": peak,
           "d_loss_first": tr[0]["d_loss"], "d_loss_last": tr[-1]["d_loss"],
           "g_mel_first_window": statistics.fmean(g_mel[:TRAIN_WINDOW]),
           "g_mel_last_window": statistics.fmean(g_mel[-TRAIN_WINDOW:]),
           "g_adv_last": tr[-1]["g_adv"], "g_fm_last": tr[-1]["g_fm"],
           "params_moved": moved,
           "nonfinite": sum(line["nonfinite"] for line in tr),
           "disc_step_gflop": flops["disc"] / 1e9,
           "gen_step_gflop": flops["gen"] / 1e9,
           "mfu": statistics.median(line.get("mfu", math.nan)
                                    for line in tr[1:]),
           "k1_launches": counts["flash_attention"],
           "k2_launches": counts["snake_aa"]}
    emit(res)
    check_no_kernels(counts, "train_vocoder_gan")
    if len(tr) != GAN_STEPS or val_fn is not None or res["nonfinite"] \
            or not np.isfinite(g_mel).all() or not all(moved.values()) \
            or not res["g_mel_last_window"] < res["g_mel_first_window"]:
        raise AssertionError(f"train_vocoder_gan: {res}")
    return {"launches": counts}


def tts_word_corpus(n: int, seed: int, sr: int = 22050, hop: int = 256):
    """``n`` seeded LJSpeech-like items with text: 1.5–10 s at 22 050 Hz,
    sentences of ``TTS_WORDS`` long enough for ≈ 8 frames a phone of the
    port's frontend, each phone (``<BOS>``, word boundaries and
    punctuation included) ≥ 1 frame, the durations summing to the item's
    frames, so the binarizer writes ``mel2ph`` and ``mel2word``; emotions
    cycle through ``TTS_EMOTIONS``."""
    import numpy as np

    from audiogpt_tpu_torch.data import Item
    from audiogpt_tpu_torch.text.frontend import EnglishFrontend

    frontend = EnglishFrontend()
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        samples = int(rng.uniform(*TTS_SECONDS) * sr)
        frames = 1 + samples // hop
        words: list = []
        while True:
            words.append(TTS_WORDS[int(rng.integers(len(TTS_WORDS)))])
            if rng.random() < 0.08:
                words[-1] += ","
            text = " ".join(words) + "."
            n_ph = len(frontend(text).phones)
            if n_ph * TTS_FRAMES_PER_PHONE >= frames:
                break
        cuts = np.sort(rng.choice(np.arange(1, frames), n_ph - 1,
                                  replace=False))
        dur = np.diff(np.concatenate([[0], cuts, [frames]]))
        wav, _ = voiced_wav(rng, samples, dur, sr, hop)
        items.append(Item(name=f"LJW{i:04d}", wav=wav, text=text,
                          durations=dur.tolist(),
                          emotion=TTS_EMOTIONS[i % len(TTS_EMOTIONS)]))
    return items


def phase_binarize_tts_words(tmp: str) -> dict:
    """The word-level fixture through the port's ``TTSBinarizer`` with
    ``with_f0``, ``with_words`` and ``with_graph`` (the PortaSpeech family
    and the pitch extractor read it), and its first ``TTS_EMO_ITEMS`` items
    through ``EmotionBinarizer`` with ``with_style_embed`` (GenerSpeech
    reads it): items/s, the phone and word sets and the emotion map against
    the configs' vocab sizes."""
    from audiogpt_tpu_torch.data import (BinarizeConfig, EmotionBinarizer,
                                         TTSBinarizer, load_emo_map,
                                         load_phone_encoder, load_split,
                                         load_word_encoder)
    from audiogpt_tpu_torch.models.tts import PortaSpeechConfig

    t0 = time.perf_counter()
    items = tts_word_corpus(TTS_WORD_ITEMS, 37)
    corpus_s = time.perf_counter() - t0
    root = Path(tmp) / "tts_bin"
    t0 = time.perf_counter()
    counts = TTSBinarizer(BinarizeConfig(
        with_f0=True, with_words=True, with_graph=True)).binarize(
        items, str(root / "lj_words"))
    words_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    emo_counts = EmotionBinarizer(BinarizeConfig(
        with_f0=True, with_style_embed=True)).binarize(
        items[:TTS_EMO_ITEMS], str(root / "esd"))
    emo_s = time.perf_counter() - t0
    ps = PortaSpeechConfig()
    phones = len(load_phone_encoder(str(root / "lj_words")))
    words = len(load_word_encoder(str(root / "lj_words")))
    emo_map = load_emo_map(str(root / "esd"))
    gs_phones = len(load_phone_encoder(str(root / "esd")))
    rec = load_split(str(root / "lj_words"), "train")[0]
    emo = load_split(str(root / "esd"), "train")[0]
    res = {"phase": "binarize_tts_words", "items": len(items),
           "audio_s": sum(len(it.wav) for it in items) / 22050,
           "fixture_s": corpus_s, "splits": counts,
           "binarize_s": words_s, "items_per_s": len(items) / words_s,
           "emotion_splits": emo_counts, "emotion_binarize_s": emo_s,
           "emotion_items_per_s": TTS_EMO_ITEMS / emo_s,
           "phone_ids": phones, "ph_vocab_size": ps.ph_vocab_size,
           "word_ids": words, "word_vocab_size": ps.word_vocab_size,
           "generspeech_phone_ids": gs_phones,
           "generspeech_vocab_size": 100, "emo_map": emo_map,
           "graph_shape": list(rec["graph_adj"].shape)}
    emit(res)
    if phones > ps.ph_vocab_size or words > ps.word_vocab_size \
            or gs_phones > 100 or sorted(emo_map) != sorted(TTS_EMOTIONS) \
            or counts["train"] + counts["valid"] != TTS_WORD_ITEMS \
            or rec["mel2word"].max() != len(rec["word_tokens"]) \
            or rec["mel2ph"].max() != len(rec["tokens"]) \
            or "emo_id" not in emo or emo["spk_embed"].shape != (256,):
        raise AssertionError(f"binarize_tts_words: {res}")
    return {"lj_words": str(root / "lj_words"), "esd": str(root / "esd")}


def fit_run(name: str, config: str, bin_dir: str, tmp: str, steps: int,
            extra: str = "", validate: bool = False) -> dict:
    """``configs/<config>`` through ``train_cli.build_task`` /
    ``build_loaders`` and ``Trainer.fit`` for ``steps`` steps (with
    ``validate``, the valid split checked at the last step): → the
    trainer, the task, the metrics lines, the launches, the batch shapes
    seen and the step times at shapes seen before."""
    import torch

    from audiogpt_tpu_torch import train_cli

    work = Path(tmp) / name
    cfg, task, trainer = tts_trainer(
        config, bin_dir, str(work), extra, log_interval=1,
        num_sanity_val_steps=0,
        val_check_interval=steps if validate else 10 ** 9)
    train_it, val_fn = train_cli.build_loaders(cfg, cfg["task"])
    seen: list = []
    before = {g: [p.detach().clone() for p in trainer.params[g]]
              for g in trainer.groups}
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, fit_s, counts = counted(lambda: trainer.fit(
        tapped(train_it, seen), val_fn if validate else None,
        max_updates=steps))
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    tr = train_lines(work)
    shapes = [key for key, _ in seen[:steps]]
    repeat = [i for i in range(len(tr)) if shapes[i] in shapes[:i]]
    step_s = [1.0 / tr[i]["steps_per_sec"] for i in repeat]
    check_no_kernels(counts, name)
    if len(tr) != steps or trainer.step != steps:
        raise AssertionError(f"{name}: {len(tr)} steps logged")
    return {"cfg": cfg, "task": task, "trainer": trainer, "tr": tr,
            "work": work, "counts": counts, "fit_s": fit_s, "peak": peak,
            "seen": seen, "shapes": shapes, "repeat": repeat,
            "step_s": step_s, "moved": {
                g: max(float((p.detach() - q).abs().max()) for p, q in
                       zip(trainer.params[g], before[g]))
                for g in trainer.groups}}


def fit_report(run: dict, terms: tuple) -> dict:
    """The common numbers of a run: parameters, shapes, the median step
    time over steps at shapes seen before, valid mel frames/s, MFU at the
    f32 FMA peak, peak memory, launches, and each term over the first and
    the last ``TRAIN_WINDOW`` steps."""
    tr, repeat, step_s = run["tr"], run["repeat"], run["step_s"]
    trainer = run["trainer"]
    win = min(TRAIN_WINDOW, len(tr) // 2)
    res = {"steps": len(tr), "fit_s": run["fit_s"],
           "params": {g: sum(p.numel() for p in trainer.params[g])
                      for g in trainer.groups},
           "batch_shapes": len(set(run["shapes"])),
           "shapes": sorted({str(list(s)) for s in run["shapes"]}),
           "repeat_steps": len(repeat),
           "step_ms": 1e3 * statistics.median(step_s) if step_s else None,
           "valid_frames_per_s": statistics.median(
               run["seen"][i][1] / s for i, s in zip(repeat, step_s))
           if step_s else None,
           "peak_mem_gb": run["peak"],
           "mfu": statistics.median(tr[i].get("mfu", math.nan)
                                    for i in repeat) if repeat else None,
           "mfu_peak_tflops": F32_FLOPS / 1e12,
           "step_gflop_median": statistics.median(
               trainer._flops.values()) / 1e9,
           "nonfinite": sum(line["nonfinite"] for line in tr),
           "k1_launches": run["counts"]["flash_attention"],
           "k2_launches": run["counts"]["snake_aa"],
           "params_moved": run["moved"]}
    for k in terms:
        vals = [line.get(k, math.nan) for line in tr]
        res[f"{k}_first_window"] = statistics.fmean(vals[:win])
        res[f"{k}_last_window"] = statistics.fmean(vals[-win:])
    return res


def largest_batch(run: dict) -> dict:
    """A batch of the run's largest shape, from a fresh loader."""
    from audiogpt_tpu_torch import train_cli

    big = max(run["shapes"], key=lambda key: math.prod(key[0]))
    return next(b for b in train_cli.build_loaders(
        run["cfg"], run["cfg"]["task"])[0]
        if (tuple(b["mels"].shape), tuple(b["txt_tokens"].shape)) == big)


def finite_terms(tr: list, terms: tuple) -> bool:
    import numpy as np

    return all(k in line and np.isfinite(line[k]) for line in tr
               for k in terms)


def phase_train_portaspeech(bins: dict, tmp: str) -> dict:
    """``configs/tts/portaspeech.yaml`` at full width (hidden 192, 4 + 4
    relative-window encoder layers, FVAE 8 + 4 layers at stride 4, latent
    16, the prior flow's 4 blocks) on the word split for ``PS_STEPS``
    steps, the valid split checked at the last (its figure written): the
    loss terms, the KL following its ramp (``kl`` = ``kl_v`` · step /
    ``kl_start_steps``, the step logged before the update), the peak and,
    on the run's largest batch, each ``Conv1d`` alone (``conv_peaks``)."""
    import numpy as np

    run = fit_run("train_portaspeech", "tts/portaspeech.yaml",
                  bins["lj_words"], tmp, PS_STEPS, validate=True)
    task, tr = run["task"], run["tr"]
    m = task.cfg.model
    if (m.hidden_size, m.enc_layers, m.word_enc_layers, m.encoder_type,
            m.fvae_enc_layers, m.fvae_dec_layers, m.fvae_strides,
            m.latent_size, m.prior_flow_blocks, m.use_graph) != \
            (192, 4, 4, "rel_fft", 8, 4, 4, 16, 4, False):
        raise AssertionError(f"train_portaspeech: model {m}")
    terms = ("mel", "ssim", "kl_v", "kl", "wdur", "total_loss")
    res = {"phase": "train_portaspeech", **fit_report(run, terms)}
    ks = task.cfg.kl_start_steps
    ramp_err = max(abs(line["kl"] - max(line["kl_v"], task.cfg.kl_min)
                       * min((line["step"] - 1) / ks, 1.0)
                       * task.cfg.lambda_kl) for line in tr)
    png = run["work"] / "figures" / f"mel_0_{PS_STEPS}.png"
    val = [line for line in (json.loads(x) for x in
                             open(run["work"] / "metrics.jsonl"))
           if line["prefix"] == "val"]
    res.update(kl_start_steps=ks, kl_ramp_max_abs_err=ramp_err,
               kl_last=tr[-1]["kl"], kl_v_last=tr[-1]["kl_v"],
               val_total_loss=val[-1]["total_loss"] if val else None,
               figure_bytes=png.stat().st_size if png.exists() else 0)
    res["conv_alone"] = conv_peaks(run["trainer"], run["trainer"]._to_device(
        largest_batch(run)))[:4]
    emit(res)
    if res["nonfinite"] or not np.isfinite([line["total_loss"]
                                            for line in tr]).all() \
            or not res["total_loss_last_window"] \
            < res["total_loss_first_window"] or ramp_err > 1e-6 \
            or not res["figure_bytes"] or not val or not run["repeat"]:
        raise AssertionError(f"train_portaspeech: {res}")
    return {"launches": run["counts"]}


def phase_train_syntaspeech(bins: dict, tmp: str) -> dict:
    """``configs/tts/syntaspeech.yaml`` (PortaSpeech with the word graphs
    in the duration predictor and the prior) on the same records, with
    their ``graph_adj``, for ``SYNTA_STEPS`` steps: every term finite."""
    run = fit_run("train_syntaspeech", "tts/syntaspeech.yaml",
                  bins["lj_words"], tmp, SYNTA_STEPS)
    if not run["task"].cfg.model.use_graph:
        raise AssertionError("train_syntaspeech: use_graph is off")
    terms = ("mel", "ssim", "kl_v", "kl", "wdur", "total_loss")
    res = {"phase": "train_syntaspeech", **fit_report(run, terms)}
    emit(res)
    if res["nonfinite"] or not finite_terms(run["tr"], terms):
        raise AssertionError(f"train_syntaspeech: {res}")
    return {"launches": run["counts"]}


def group_step_ms(trainer, batch, iters: int = 6) -> dict:
    """Each group's ``train_step`` alone on one device batch, the median of
    ``iters`` − 1 after one warm step."""
    import torch

    out = {}
    for grp in trainer.groups:
        times = []
        for i in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(grp, batch, i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[grp] = 1e3 * statistics.median(times[1:])
    return out


def phase_train_ps_adv(bins: dict, tmp: str) -> dict:
    """``configs/tts/ps_adv.yaml`` (PortaSpeech and the 32/64/128-frame
    multi-window critic, ``disc`` then ``model``) for ``PS_ADV_STEPS``
    steps: each group's step alone on the run's largest batch, ``d_loss``
    and ``adv``, both groups' parameters moved."""
    run = fit_run("train_ps_adv", "tts/ps_adv.yaml", bins["lj_words"], tmp,
                  PS_ADV_STEPS)
    task, tr = run["task"], run["tr"]
    if task.disc.time_lengths != (32, 64, 128) or task.cfg.lambda_adv != 0.05:
        raise AssertionError(f"train_ps_adv: config {task.cfg}")
    terms = ("d_loss", "adv", "mel", "kl", "wdur", "total_loss")
    res = {"phase": "train_ps_adv", **fit_report(run, terms)}
    groups = group_step_ms(run["trainer"], run["trainer"]._to_device(
        largest_batch(run)))
    res.update(disc_step_ms=groups["disc"], model_step_ms=groups["model"],
               d_loss_first=tr[0]["d_loss"], d_loss_last=tr[-1]["d_loss"],
               adv_first=tr[0]["adv"], adv_last=tr[-1]["adv"])
    emit(res)
    if res["nonfinite"] or not finite_terms(tr, terms) \
            or not all(run["moved"].values()):
        raise AssertionError(f"train_ps_adv: {res}")
    return {"launches": run["counts"]}


def phase_train_generspeech(bins: dict, tmp: str) -> dict:
    """``configs/tts/generspeech.yaml`` at full width (hidden 256, 4 + 4
    FFT layers, 128 codes, Glow 12 steps at hidden 192) on the emotion
    split for ``GS_STEPS`` steps, its warm-up cut from 8000 to
    ``FS2_WARMUP`` steps as ``train_fs2``'s: step time, peak, MFU, the mel
    term first and last; ``commit``, ``guided`` and ``postflow`` finite;
    on the run's largest batch each ``Conv1d`` alone."""
    run = fit_run("train_generspeech", "tts/generspeech.yaml", bins["esd"],
                  tmp, GS_STEPS, f"optim.warmup_steps={FS2_WARMUP}")
    cfg = run["task"].cfg.model
    if (cfg.fs2.hidden_size, cfg.fs2.enc_layers, cfg.fs2.dec_layers,
            cfg.n_vq, cfg.glow_steps, cfg.glow_hidden, cfg.vq_ema) != \
            (256, 4, 4, 128, 12, 192, False):
        raise AssertionError(f"train_generspeech: model {cfg}")
    terms = ("mel", "commit", "guided", "postflow", "ssim", "f0", "uv",
             "total_loss")
    res = {"phase": "train_generspeech", **fit_report(run, terms),
           "warmup_steps": [8000, FS2_WARMUP],
           "mel_first": run["tr"][0]["mel"], "mel_last": run["tr"][-1]["mel"]}
    res["conv_alone"] = conv_peaks(run["trainer"], run["trainer"]._to_device(
        largest_batch(run)))[:4]
    emit(res)
    if res["nonfinite"] or not finite_terms(run["tr"], terms):
        raise AssertionError(f"train_generspeech: {res}")
    return {"launches": run["counts"]}


def phase_train_pe(bins: dict, tmp: str) -> dict:
    """``configs/tts/pe.yaml`` (the pitch extractor, 256 wide) on the word
    split's mels and f0 for ``PE_STEPS`` steps, its warm-up cut from 8000
    to ``PE_WARMUP`` steps: the ``f0`` and ``uv`` terms must fall."""
    emit({"phase": "train_pe_cut", "warmup_steps": [8000, PE_WARMUP],
          "steps": PE_STEPS})
    run = fit_run("train_pe", "tts/pe.yaml", bins["lj_words"], tmp, PE_STEPS,
                  f"optim.warmup_steps={PE_WARMUP}")
    res = {"phase": "train_pe", **fit_report(run, ("f0", "uv",
                                                   "total_loss"))}
    emit(res)
    if res["nonfinite"] or not all(
            res[f"{k}_last_window"] < res[f"{k}_first_window"]
            for k in ("f0", "uv")):
        raise AssertionError(f"train_pe: {res}")
    return {"launches": run["counts"]}


#: the SVS, face and LDM-family training phases. The sung fixture: items
#: and their length range in seconds before the last note (Opencpop's
#: segments run 2–10 s; ≤ 5.1 s keeps VISinger's hop-256 items under 512
#: frames, so its batches stay on the 512 rung or below), the
#: syllables and note names of its scores; the Mandarin fixture's
#: sentences and items. Steps of each run; the CLAP fixture's records (a
#: multiple of the batch: a padded row of zero length has no Cnn14 frame
#: and makes the loss NaN, ROADMAP §C)
SVS_ITEMS, SVS_SECONDS = 128, (2.0, 4.5)
SVS_SYLLABLES = ("xiao jiu wo ni hao ai shi tian di ren yue liang xing "
                 "kong feng hua xue yu chun qiu meng xiang guang ming "
                 "zhi dao you yi").split()
SVS_NOTES = ("C4 C#4/Db4 D4 D#4/Eb4 E4 F4 F#4/Gb4 G4 G#4/Ab4 A4 A#4/Bb4 "
             "B4 C5 D5 E5").split()
ZH_TEXTS = ("你好，世界。", "今天天气很好，我们去公园散步。", "音乐让我快乐！",
            "我有2个苹果和3个梨。", "春风吹过山谷，花开满地。")
ZH_ITEMS = 32
DS_STEPS, VIS_STEPS, A2M_STEPS, VAE_STEPS, CLAP_STEPS = 12, 4, 12, 8, 8
#: VISinger's ``data.max_tokens`` on the card (the yaml's: 30 000)
VIS_MAX_TOKENS = 1500
CLAP_RECORDS = 64
CLAP_CAPTIONS = ("a dog barks in the rain", "birds sing at dawn",
                 "a car passes on a wet road", "people talk in a cafe",
                 "a piano plays a slow tune", "thunder rolls far away")
#: the 24 kHz, hop-256 mel of the VISinger records (the decoder's hop)
VIS_MEL = dict(sr=24000, n_fft=1024, hop=256, win_length=1024, n_mels=80,
               fmin=30.0, fmax=12000.0, power=1.0, pad_mode="constant",
               log="log10", amin=1e-5)


def svs_corpus(n: int, seed: int, sr: int = 24000):
    """``n`` seeded Opencpop-style items: pinyin words (one in 12 a rest,
    ``SP`` or ``AP``), one note each or, one in five, a slur of two, each
    note 0.15–0.6 s; the wav a tone at each note's pitch (two harmonics
    and noise, continuous phase), noise on the rests."""
    import numpy as np

    from audiogpt_tpu_torch.data import SVSItem
    from audiogpt_tpu_torch.engines.svs import note_to_midi

    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        target = rng.uniform(*SVS_SECONDS)
        words, notes, durs, total = [], [], [], 0.0
        while total < target:
            if rng.random() < 1 / 12:
                words.append(("SP", "AP")[int(rng.integers(2))])
                ns = ["rest"]
            else:
                words.append(SVS_SYLLABLES[int(rng.integers(
                    len(SVS_SYLLABLES)))])
                ns = [SVS_NOTES[int(rng.integers(len(SVS_NOTES)))]
                      for _ in range(2 if rng.random() < 0.2 else 1)]
            ds = [float(f"{rng.uniform(0.15, 0.6):.3f}") for _ in ns]
            notes.append(" ".join(ns))
            durs.append(" ".join(f"{d:.3f}" for d in ds))
            total += sum(ds)
        parts, phase = [], 0.0
        for ns, ds in zip(notes, durs):
            for note, d in zip(ns.split(), map(float, ds.split())):
                m = int(round(d * sr))
                midi = note_to_midi(note)
                if midi == 0:
                    parts.append(rng.normal(0, 0.02, m))
                    continue
                hz = 440.0 * 2 ** ((midi - 69) / 12)
                ph = phase + 2 * np.pi * hz * np.arange(1, m + 1) / sr
                phase = float(ph[-1])
                parts.append(0.3 * np.sin(ph) + 0.1 * np.sin(2 * ph)
                             + rng.normal(0, 0.01, m))
        items.append(SVSItem(
            name=f"OPC{i:04d}", wav=np.concatenate(parts).astype(np.float32),
            text=" ".join(words), notes=" | ".join(notes),
            notes_duration=" | ".join(durs)))
    return items


def zh_corpus(n: int, seed: int, sr: int = 22050, hop: int = 256):
    """``n`` seeded Mandarin items of 1.5–4 s: ``ZH_TEXTS`` sentences, the
    frames cut at random over the Mandarin frontend's phones (``|`` and
    punctuation included), each ≥ 1 frame, as ``tts_corpus``'s."""
    import numpy as np

    from audiogpt_tpu_torch.data import Item
    from audiogpt_tpu_torch.text.zh import ZhTTSFrontend

    frontend = ZhTTSFrontend()
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        text = ZH_TEXTS[i % len(ZH_TEXTS)]
        samples = int(rng.uniform(1.5, 4.0) * sr)
        frames = 1 + samples // hop
        n_ph = len(frontend(text).phones)
        cuts = np.sort(rng.choice(np.arange(1, frames), n_ph - 1,
                                  replace=False))
        dur = np.diff(np.concatenate([[0], cuts, [frames]]))
        wav, _ = voiced_wav(rng, samples, dur, sr, hop)
        items.append(Item(name=f"ZH{i:04d}", wav=wav, text=text,
                          durations=dur.tolist()))
    return items


def phase_binarize_svs(tmp: str) -> dict:
    """The sung fixture through ``SVSBinarizer`` at ``opencpop.yaml``'s mel
    (24 kHz, hop 128; DiffSinger reads it) and again at hop 256 with the
    wav, its records rewritten with the fixture's linear spec (the port's
    STFT, n_fft 1024, 513 bins on the mel's frames; VISinger reads it: no
    binarizer writes a spec, as in the JAX package); the Mandarin fixture
    through ``ZhBinarizer``: items/s, the phone set, the notes, slurs and
    rests, and the Mandarin durations after the two rules."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.data import (BinarizeConfig, RecordWriter,
                                         SVSBinarizer, ZhBinarizer,
                                         load_phone_encoder, load_split)
    from audiogpt_tpu_torch.dsp.mel import NEURALSEQ_MEL_24K, MelSpec
    from audiogpt_tpu_torch.dsp.stft import spectrogram

    t0 = time.perf_counter()
    items = svs_corpus(SVS_ITEMS, 41)
    corpus_s = time.perf_counter() - t0
    root = Path(tmp) / "svs_bin"
    t0 = time.perf_counter()
    counts = SVSBinarizer(BinarizeConfig(
        mel=NEURALSEQ_MEL_24K, with_f0=True)).binarize(
        items, str(root / "opencpop"))
    svs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = root / "opencpop_wav"
    SVSBinarizer(BinarizeConfig(mel=MelSpec(**VIS_MEL), with_f0=False,
                                with_wav=True)).binarize(items, str(raw))
    vis = root / "visinger"
    vis.mkdir()
    for f in raw.iterdir():
        if f.suffix in (".json", ".npy"):
            shutil.copy(f, vis / f.name)
    for split in ("train", "valid", "test"):
        ds = load_split(str(raw), split)
        with RecordWriter(str(vis / split)) as w:
            for i in range(len(ds)):
                rec = ds[i]
                spec = spectrogram(torch.from_numpy(rec["wav"]).cuda(),
                                   1024, 256, 1024, center=True,
                                   pad_mode="constant", power=1.0)
                rec["spec"] = spec[:rec["len"]].cpu().numpy()
                w.add(rec)
    vis_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    zh_items = zh_corpus(ZH_ITEMS, 43)
    zh_counts = ZhBinarizer(BinarizeConfig(with_f0=True)).binarize(
        zh_items, str(root / "zh"))
    zh_s = time.perf_counter() - t0
    train = load_split(str(root / "opencpop"), "train")
    recs = [train[i] for i in range(len(train))]
    vrec = load_split(str(vis), "train")[0]
    zh = [load_split(str(root / "zh"), "train")[i] for i in range(8)]
    phones = len(load_phone_encoder(str(root / "opencpop")))
    res = {"phase": "binarize_svs", "items": len(items),
           "audio_s": sum(len(it.wav) for it in items) / 24000,
           "fixture_s": corpus_s, "splits": counts, "binarize_s": svs_s,
           "items_per_s": len(items) / svs_s,
           "visinger_binarize_and_spec_s": vis_s,
           "visinger_items_per_s": len(items) / vis_s,
           "phone_ids": phones, "vocab_size": 100,
           "phones": int(sum(len(r["tokens"]) for r in recs)),
           "notes": int(sum((r["pitch_midi"] > 0).sum() for r in recs)),
           "rests": int(sum((r["pitch_midi"] == 0).sum() for r in recs)),
           "slurs": int(sum(r["is_slur"].sum() for r in recs)),
           "midi_range": [int(min(r["pitch_midi"][r["pitch_midi"] > 0].min()
                                  for r in recs)),
                          int(max(r["pitch_midi"].max() for r in recs))],
           "aligned_share": float(np.mean([(r["mel2ph"] > 0).mean()
                                           for r in recs])),
           "mel_frames": int(sum(r["len"] for r in recs)),
           "visinger_spec_shape": list(vrec["spec"].shape),
           "visinger_wav_per_frame": len(vrec["wav"]) / vrec["len"],
           "zh_splits": zh_counts, "zh_binarize_s": zh_s,
           "zh_items_per_s": ZH_ITEMS / zh_s,
           "zh_phone_ids": len(load_phone_encoder(str(root / "zh"))),
           "zh_separators_collapsed": int(sum(
               (r["dur"] == 0).sum() for r in zh)),
           "zh_durations_exact": all(int(r["dur"].sum()) == r["len"]
                                     for r in zh)}
    emit(res)
    if phones > 100 or counts["train"] + counts["valid"] != SVS_ITEMS \
            or not res["slurs"] or not res["rests"] \
            or res["aligned_share"] < 0.95 \
            or any(r["mel2ph"].max() > len(r["tokens"]) for r in recs) \
            or vrec["spec"].shape != (vrec["len"], 513) \
            or zh_counts["train"] + zh_counts["valid"] != ZH_ITEMS \
            or not res["zh_separators_collapsed"] \
            or not res["zh_durations_exact"]:
        raise AssertionError(f"binarize_svs: {res}")
    return {"svs": str(root / "opencpop"), "visinger": str(vis)}


def phase_train_diffsinger(bins: dict, tmp: str) -> dict:
    """``configs/svs/diffsinger.yaml`` at full width (FS2-MIDI 256 wide
    with ``rel_pos``, no pitch embedding; DiffNet 20 × 256; t over K_step
    1000) on the hop-128 records for ``DS_STEPS`` steps, the warm-up cut
    from 8000 to ``FS2_WARMUP`` steps as ``train_fs2``'s: step time, MFU,
    peak, the batch shapes, ``diff`` and ``pdur`` first and last."""
    run = fit_run("train_diffsinger", "svs/diffsinger.yaml", bins["svs"],
                  tmp, DS_STEPS, f"optim.warmup_steps={FS2_WARMUP}")
    m, tr = run["task"].cfg.model, run["tr"]
    if (m.timesteps, m.K_step, m.fs2.hidden_size, m.fs2.use_midi,
            m.fs2.rel_pos, m.fs2.use_pitch_embed, m.net.residual_layers,
            m.net.residual_channels) != (1000, 1000, 256, True, True,
                                         False, 20, 256):
        raise AssertionError(f"train_diffsinger: model {m}")
    terms = ("diff", "pdur", "sdur", "total_loss")
    res = {"phase": "train_diffsinger", **fit_report(run, terms),
           "warmup_steps": [8000, FS2_WARMUP],
           "diff_first": tr[0]["diff"], "diff_last": tr[-1]["diff"],
           "pdur_first": tr[0]["pdur"], "pdur_last": tr[-1]["pdur"]}
    emit(res)
    if res["nonfinite"] or not finite_terms(tr, terms) \
            or not all(run["moved"].values()):
        raise AssertionError(f"train_diffsinger: {res}")
    return {"launches": run["counts"]}


def phase_train_visinger(bins: dict, tmp: str) -> dict:
    """``configs/svs/visinger.yaml`` at full width (score encoder 192 wide,
    posterior 8 WaveNet layers, flow 4 × 4, HiFi-GAN at 256 channels,
    MPD + MSD) for ``VIS_STEPS`` steps at ``data.max_tokens`` cut to
    ``VIS_MAX_TOKENS``: the decoder and both critics run on the whole
    F · 256 wav, and the yaml's 30 000 tokens do not fit the card (a
    padded frame of a step takes 6.48 MB). A budget that no longer fits
    fails the phase with the allocator's error. Each group's step alone on
    the run's largest batch, the peak, both groups moved."""
    run = fit_run("train_visinger", "svs/visinger.yaml", bins["visinger"],
                  tmp, VIS_STEPS, f"data.max_tokens={VIS_MAX_TOKENS}")
    task, tr = run["task"], run["tr"]
    m = task.cfg.model
    if (m.hidden, m.latent_dim, m.spec_bins, m.posterior_layers,
            m.flow_layers, m.decoder.upsample_initial_channel,
            m.decoder.hop_size, task.cfg.disc.periods) != (
                192, 192, 513, 8, 4, 256, 256, (2, 3, 5, 7, 11)):
        raise AssertionError(f"train_visinger: config {task.cfg}")
    terms = ("d_loss", "kl", "mel", "adv", "fm", "pdur", "total_loss")
    res = {"phase": "train_visinger", **fit_report(run, terms),
           "max_tokens": [30000, VIS_MAX_TOKENS]}
    groups = group_step_ms(run["trainer"], run["trainer"]._to_device(
        largest_batch(run)), iters=3)
    res.update(disc_step_ms=groups["disc"], model_step_ms=groups["model"],
               d_loss_first=tr[0]["d_loss"], d_loss_last=tr[-1]["d_loss"],
               mel_first=tr[0]["mel"], mel_last=tr[-1]["mel"],
               kl_first=tr[0]["kl"], kl_last=tr[-1]["kl"])
    emit(res)
    if res["nonfinite"] or not finite_terms(tr, terms) \
            or not all(run["moved"].values()):
        raise AssertionError(f"train_visinger: {res}")
    return {"launches": run["counts"]}


def phase_train_audio2motion(bins: dict, tmp: str) -> dict:
    """``configs/face/audio2motion.yaml`` at full width (hidden 256, latent
    16, 3 conv layers; 512 mel frames → 204 video frames, batch 16) on the
    TTS fixture's mels and their energy pseudo-targets for ``A2M_STEPS``
    steps (the yaml's 2000-step warm-up kept: the steps move the weights
    little): step time, MFU, the three terms first and last."""
    run = fit_run("train_audio2motion", "face/audio2motion.yaml",
                  bins["lj"], tmp, A2M_STEPS)
    m, tr = run["task"].cfg.model, run["tr"]
    if (m.hidden, m.latent, m.conv_layers, m.mel_bins, m.video_len(512)) \
            != (256, 16, 3, 80, 204) or run["shapes"][0] != ((16, 512, 80),):
        raise AssertionError(f"train_audio2motion: {m}, {run['shapes']}")
    terms = ("recon_loss", "kl_loss", "vel_loss", "total_loss")
    res = {"phase": "train_audio2motion", **fit_report(run, terms)}
    emit(res)
    if res["nonfinite"] or not finite_terms(tr, terms) \
            or not all(run["moved"].values()):
        raise AssertionError(f"train_audio2motion: {res}")
    return {"launches": run["counts"]}


def phase_train_vae(tmp: str) -> dict:
    """``configs/t2a/vae.yaml`` at full width (ch 128, ch_mult 1-2-2-4, 2
    res blocks, the mid block's single-head attention at 512 channels)
    with the PatchGAN critic, batch 8 of [80, 624] mel images, on the
    records ``train_ldm`` wrote, ``VAE_STEPS`` steps of ``disc`` then
    ``model``: each group's step alone, the peak, both groups moved."""
    from audiogpt_tpu_torch import train_cli

    run = fit_run("train_vae", "t2a/vae.yaml",
                  str(Path(tmp) / "train_ldm" / "bin"), tmp, VAE_STEPS)
    task, tr = run["task"], run["tr"]
    v = task.cfg.vae
    if (v.ch, tuple(v.ch_mult), v.num_res_blocks, tuple(v.attn_resolutions),
            run["shapes"][0]) != (128, (1, 2, 2, 4), 2, (),
                                  ((8, 80, 624, 1),)):
        raise AssertionError(f"train_vae: {v}, {run['shapes']}")
    terms = ("d_loss", "rec", "kl", "g_adv", "total_loss")
    res = {"phase": "train_vae", **fit_report(run, terms)}
    groups = group_step_ms(run["trainer"], run["trainer"]._to_device(
        next(iter(train_cli.build_loaders(run["cfg"], "vae")[0]))), iters=3)
    res.update(disc_step_ms=groups["disc"], model_step_ms=groups["model"],
               rec_first=tr[0]["rec"], rec_last=tr[-1]["rec"],
               d_loss_first=tr[0]["d_loss"], d_loss_last=tr[-1]["d_loss"])
    emit(res)
    if res["nonfinite"] or not finite_terms(tr, terms) \
            or not all(run["moved"].values()):
        raise AssertionError(f"train_vae: {res}")
    return {"launches": run["counts"]}


def clap_fixture(root: Path, n: int, seed: int) -> str:
    """``n`` seeded CLAP records (``wav``: 10 s at 16 kHz of sound events;
    ``text_ids``: a caption through the bundled WordPiece vocab) as the
    train split; → the binary dir."""
    import numpy as np

    from audiogpt_tpu_torch.data import RecordWriter
    from audiogpt_tpu_torch.models.textenc.clap import WordPieceTokenizer

    tok = WordPieceTokenizer()
    with RecordWriter(str(root / "bin" / "train")) as w:
        for i in range(n):
            ids, mask = tok.encode(CLAP_CAPTIONS[i % len(CLAP_CAPTIONS)], 77)
            w.add({"wav": events_like(10.0, 16000, seed + i),
                   "text_ids": ids[:int(mask.sum())]})
    return str(root / "bin")


def phase_train_clap(tmp: str) -> dict:
    """``configs/t2a/clap.yaml`` at full width (BERT-base text tower, the
    PANN Cnn14 audio tower, ``d_proj`` 1024, the learned temperature),
    batch 32 of 10 s clips at 16 kHz and 77-token captions, for
    ``CLAP_STEPS`` steps: step time, MFU, ``acc`` and ``scale``, and every
    BatchNorm buffer of Cnn14 where its init left it (the tower runs on
    its running statistics, as JAX's ``train=False``)."""
    import torch

    bin_dir = clap_fixture(Path(tmp) / "clap", CLAP_RECORDS, 51)
    run = fit_run("train_clap", "t2a/clap.yaml", bin_dir, tmp, CLAP_STEPS)
    task, tr = run["task"], run["tr"]
    t, a = task.cfg.text.bert, task.model.audio.backbone.cfg
    if (t.hidden_size, t.num_layers, task.cfg.d_proj, a.channels[-1],
            run["shapes"][0]) != (768, 12, 1024, 2048, ((32, 160000),)):
        raise AssertionError(f"train_clap: {task.cfg}, {run['shapes']}")
    bufs = dict(task.model.audio.named_buffers())
    moved = [n for n, b in bufs.items()
             if (n.endswith("running_mean") and bool(b.any()))
             or (n.endswith("running_var") and not bool((b == 1).all()))
             or (n.endswith("num_batches_tracked") and int(b) != 0)]
    terms = ("total_loss", "nce_a", "nce_t", "scale", "acc")
    res = {"phase": "train_clap", **fit_report(run, terms),
           "acc_first": tr[0]["acc"], "acc_last": tr[-1]["acc"],
           "scale_first": tr[0]["scale"], "scale_last": tr[-1]["scale"],
           "bn_buffers": len(bufs), "bn_buffers_moved": moved,
           "audio_tower_training": task.model.audio.training}
    emit(res)
    if res["nonfinite"] or not finite_terms(tr, terms) or moved \
            or task.model.audio.training or not all(run["moved"].values()) \
            or not torch.isfinite(task.model.logit_scale):
        raise AssertionError(f"train_clap: {res}")
    return {"launches": run["counts"]}


def tiny_ps_batch(seed: int) -> dict:
    """The CPU tests' PortaSpeech batch (``ps_batch``): three items of 12,
    9 and 7 phones over 6, 4 and 3 words and 64, 48 and 36 frames, and a
    padded row of zeros (weight 0, mel length 0), with a word graph."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b, t, w, f, m = 4, 12, 6, 64, TINY_PS["n_mels"]
    batch = {k: np.zeros(s, np.int32) for k, s in (
        ("txt_tokens", (b, t)), ("ph2word", (b, t)),
        ("word_tokens", (b, w)), ("mel2word", (b, f)))}
    n_ph, n_w, n_fr = (12, 9, 7, 0), (6, 4, 3, 0), (64, 48, 36, 0)
    for i in range(3):
        batch["txt_tokens"][i, :n_ph[i]] = rng.integers(3, 30, n_ph[i])
        batch["ph2word"][i, :n_ph[i]] = np.sort(np.concatenate([
            np.arange(1, n_w[i] + 1),
            rng.integers(1, n_w[i] + 1, n_ph[i] - n_w[i])]))
        batch["word_tokens"][i, :n_w[i]] = rng.integers(3, 20, n_w[i])
        cuts = np.sort(rng.choice(np.arange(1, n_fr[i]), n_w[i] - 1,
                                  replace=False))
        parts = np.diff(np.concatenate([[0], cuts, [n_fr[i]]]))
        batch["mel2word"][i, :n_fr[i]] = np.repeat(np.arange(1, n_w[i] + 1),
                                                   parts)
    valid = batch["mel2word"] > 0
    batch["mels"] = (rng.normal(size=(b, f, m)) * valid[..., None]
                     ).astype(np.float32)
    batch["mel_lengths"] = np.asarray(n_fr, np.int32)
    batch["word_lengths"] = np.asarray(n_w, np.int32)
    batch["weight"] = np.asarray([1, 1, 1, 0], np.float32)
    words = np.arange(w)[None] < batch["word_lengths"][:, None]
    batch["graph_adj"] = ((rng.random((b, 6, w, w)) < 0.3)
                          * words[:, None, :, None]
                          * words[:, None, None, :]).astype(np.float32)
    return batch


def tiny_fs2_batch(seed: int) -> dict:
    """A padded FS2 batch of 4 (a dummy row of weight 0, unvoiced frames,
    the CWT fields), the CPU tests' shapes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b, t, f = 4, 12, 64
    tok = rng.integers(3, 30, (b, t)).astype(np.int32)
    tok[1, 9:] = 0
    lens = (tok > 0).sum(1)
    mlen = np.array([60, 40, 64, 20])
    mel2ph = np.zeros((b, f), np.int32)
    for i in range(b):
        mel2ph[i, :mlen[i]] = np.minimum(
            np.arange(mlen[i]) * lens[i] // mlen[i] + 1, lens[i])
    valid = mel2ph > 0
    return {"txt_tokens": tok, "txt_lengths": lens.astype(np.int32),
            "mels": (rng.normal(size=(b, f, 80)) * valid[..., None])
            .astype(np.float32), "mel_lengths": mlen.astype(np.int32),
            "mel2ph": mel2ph, "weight": np.array([1, 1, 1, 0], np.float32),
            "f0": (rng.uniform(100, 300, (b, f)) * valid
                   * (rng.random((b, f)) > 0.2)).astype(np.float32)}


def card_vs_cpu_steps(builds: dict, what: str, exact: tuple = (),
                      grad_tol: float = TTS_GRAD_TOL,
                      prime: dict | None = None) -> tuple[dict, dict]:
    """Each task of ``builds`` (name → (build(device), batch, draws as
    numpy or None)) on the CPU and on the card with the same seeded
    weights (for a name in ``prime``, its ``prime[name](cpu_task)`` sets
    more of the CPU task's state after the fill, before the card's copy,
    and its report is the fixture's), each group's loss terms and
    gradients on the same batch and draws, the card's launches none. →
    (report, worst): each group's
    largest relative loss error and gradient error against the tensor's
    largest CPU gradient, floored, for the tasks not in ``exact``, at
    ``TTS_ZERO_GRAD_TOL / grad_tol`` of the group's largest (an
    attention's key bias, or a conv bias before a one-channel group norm,
    has a vanishing gradient: rounding noise on both devices)."""
    import torch

    def on(dev, x):
        if isinstance(x, dict):
            return {k: on(dev, v) for k, v in x.items()}
        return None if x is None else torch.as_tensor(x).to(dev)

    report, worst = {}, {}
    for name, (build, batch, draws) in builds.items():
        cpu, card = build("cpu"), build("cuda")
        ortho = torch.Generator().manual_seed(8)
        for grp, mod in cpu.modules.items():
            fill_random(mod, torch.Generator().manual_seed(7))
            for key, p in mod.state_dict().items():
                if key.endswith("inv1x1_w"):
                    # a Glow 1×1 orthogonal, as initialised: its
                    # log-determinant's gradient is its inverse
                    p.copy_(torch.linalg.qr(torch.randn(
                        p.shape, generator=ortho))[0])
        if name in (prime or {}):
            report[f"{name}_fixture"] = prime[name](cpu)
        for grp, mod in cpu.modules.items():
            card.modules[grp].load_state_dict(mod.state_dict())
        for grp in cpu.loss_fns:
            out = {}
            for dev, task in (("cpu", cpu), ("cuda", card)):
                b = on(task.device, batch)
                kw = {} if draws is None else {"draws": on(task.device,
                                                           draws)}
                (loss, metrics), _, counts = counted(
                    lambda: task.loss_fns[grp](b, None, **kw))
                params = list(task.modules[grp].parameters())
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                out[dev] = ({k: float(v) for k, v in metrics.items()},
                            [torch.zeros_like(p) if g is None else g.cpu()
                             for g, p in zip(grads, params)], counts)
            (m_cpu, g_cpu, _), (m_card, g_card, c_card) = out["cpu"], \
                out["cuda"]
            check_no_kernels(c_card, f"{what} {name}")
            loss_err = max(abs(m_card[k] - v) / max(abs(v), 1e-30)
                           for k, v in m_cpu.items())
            # each tensor's error over its largest gradient, floored
            floor = 0.0 if name in exact else \
                TTS_ZERO_GRAD_TOL / grad_tol \
                * max(float(b.abs().max()) for b in g_cpu)
            names = [n for n, _ in task.modules[grp].named_parameters()]
            errs = {n: float((a.cpu() - b).abs().max())
                    / max(float(b.abs().max()), floor, 1e-30)
                    for n, a, b in zip(names, g_card, g_cpu)}
            grad_err = max(errs.values())
            key = f"{name}_{grp}"
            report[key] = {"loss_max_rel_err": loss_err,
                           "grad_max_rel_err": grad_err,
                           "worst_grad": max(errs, key=errs.get),
                           "terms": sorted(m_cpu)}
            worst[key] = (loss_err, grad_err)
    return report, worst


def phase_train_tts_small_reference() -> None:
    """The CPU tests' tiny FS2, vocoder-GAN, PortaSpeech, ``ps_adv``
    (both groups), GenerSpeech and pitch-extractor tasks on the card and on
    the CPU with the same weights, batch and draws (ε, the crops'
    starts, ``MixStyle``'s), in one process (TF32 off): one step's losses
    within ``TTS_LOSS_RTOL`` relative, every gradient within
    ``TTS_GRAD_TOL`` of its tensor's largest (for the tasks of the
    PortaSpeech family, GenerSpeech and the pitch extractor, a vanishing
    gradient within ``TTS_ZERO_GRAD_TOL`` of the group's largest)."""
    import dataclasses

    import numpy as np
    import torch

    from audiogpt_tpu_torch.models.tts import (FastSpeech2Config,
                                               PortaSpeechConfig)
    from audiogpt_tpu_torch.models.tts.generspeech import GenerSpeechConfig
    from audiogpt_tpu_torch.models.tts.pitch_extractor import \
        PitchExtractorConfig
    from audiogpt_tpu_torch.models.vocoder import (DiscriminatorConfig,
                                                   HifiGANConfig)
    from audiogpt_tpu_torch.train.tasks import (
        FS2Task, FS2TaskConfig, GenerSpeechTask, GenerSpeechTaskConfig,
        PETask, PETaskConfig, PortaSpeechAdvTask, PortaSpeechAdvTaskConfig,
        PortaSpeechTask, PortaSpeechTaskConfig, VocoderGANTask,
        VocoderGANTaskConfig)

    rng, rng_new = np.random.default_rng(2), np.random.default_rng(3)
    ps_cfg = PortaSpeechTaskConfig(model=PortaSpeechConfig(**TINY_PS),
                                   lambda_sent_dur=0.5)
    ps_batch = tiny_ps_batch(1)
    eps = rng_new.normal(size=(4, 16, TINY_PS["latent_size"])).astype(
        np.float32)
    gs_batch = tiny_fs2_batch(3)
    gs_batch["mels"] = np.ascontiguousarray(gs_batch["mels"][..., :20])
    mix = {"perm": np.array([2, 0, 3, 1]),
           "lam": rng_new.beta(0.1, 0.1, (4, 1, 1)).astype(np.float32),
           "apply": np.array(True)}
    # name → (the task on a device, the batch, the draws as numpy or None)
    builds = {
        "fs2": (lambda dev: FS2Task(FS2TaskConfig(
            model=FastSpeech2Config(**TINY_FS2)), device=dev),
            tiny_fs2_batch(1), None),
        "vocoder_gan": (lambda dev: VocoderGANTask(VocoderGANTaskConfig(
            gen=HifiGANConfig(**TINY_GEN),
            disc=DiscriminatorConfig(**TINY_DISC), segment_frames=16,
            lambda_stft=1.0), device=dev),
            {"mels": rng.normal(size=(4, 16, 20)).astype(np.float32),
             "wav": (rng.normal(size=(4, 256)) * 0.1).astype(np.float32),
             "weight": np.ones(4, np.float32)}, None),
        "portaspeech": (lambda dev: PortaSpeechTask(ps_cfg, device=dev),
                        dict(ps_batch, step=np.array(50)), eps),
        "syntaspeech": (lambda dev: PortaSpeechTask(dataclasses.replace(
            ps_cfg, model=PortaSpeechConfig(**TINY_PS, use_graph=True)),
            device=dev), ps_batch, eps),
        "ps_adv": (lambda dev: PortaSpeechAdvTask(PortaSpeechAdvTaskConfig(
            ps=ps_cfg, disc_windows=TINY_WINDOWS, disc_hidden=8),
            device=dev), ps_batch, {"eps": eps, "starts": np.array([0, 0])}),
        "generspeech": (lambda dev: GenerSpeechTask(GenerSpeechTaskConfig(
            model=GenerSpeechConfig(fs2=FastSpeech2Config(**TINY_GS_FS2),
                                    **TINY_GS)), device=dev), gs_batch, mix),
        "pe": (lambda dev: PETask(PETaskConfig(
            model=PitchExtractorConfig(**TINY_PE)), device=dev), gs_batch,
            None)}

    report, worst = card_vs_cpu_steps(builds, "train_tts_small_reference",
                                      exact=("fs2", "vocoder_gan"))
    emit({"phase": "train_tts_small_reference", "bounds": {
        "loss_rtol": TTS_LOSS_RTOL, "grad_tol": TTS_GRAD_TOL,
        "zero_grad_tol": TTS_ZERO_GRAD_TOL}, **report})
    bad = {k: v for k, v in worst.items()
           if not (v[0] <= TTS_LOSS_RTOL and v[1] <= TTS_GRAD_TOL)}
    if bad:
        raise AssertionError(f"card vs CPU TTS training: {bad}")


#: the tiny SVS, face and LDM-family tasks of the CPU tests
#: (tests/test_torch_svs_train.py, tests/test_torch_ldm_family_train.py)
#: and the card-vs-CPU bounds of their small reference (f32, TF32 off)
TINY_DS_FS2 = dict(use_midi=True, rel_pos=True, vocab_size=30,
                   hidden_size=16, enc_layers=1, dec_layers=1, num_heads=2,
                   enc_ffn_kernel_size=3, dec_ffn_kernel_size=3,
                   dur_predictor_layers=1, predictor_layers=1,
                   predictor_hidden=8, max_frames=64, n_mels=16)
TINY_DS = dict(timesteps=50, K_step=40, spec_min=(-6.0,) * 16,
               spec_max=(1.5,) * 16)
TINY_NET = dict(mel_bins=16, encoder_hidden=16, residual_layers=2,
                residual_channels=8)
TINY_VIS = dict(vocab_size=30, hidden=16, enc_layers=1, enc_heads=2,
                latent_dim=8, spec_bins=33, posterior_layers=2,
                flow_layers=2, flow_wn_layers=1, max_frames=64)
TINY_A2M = dict(mel_bins=16, hidden=16, latent=4, conv_layers=2)
TINY_VAE = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1,
                attn_resolutions=(8,), resolution=16)
TINY_BERT = dict(vocab_size=100, hidden_size=16, num_layers=1, num_heads=2,
                 intermediate_size=32, max_position=32)
SVS_LOSS_RTOL, SVS_GRAD_TOL = 1e-6, 5e-5


def tiny_score_batch(seed: int) -> dict:
    """The CPU tests' scored batch (``score_batch``): three items of 10, 7
    and 4 phones over 64, 40 and 24 frames and a padded row of zeros, the
    score fields, f0, a 33-bin spec and the wav at hop 16."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b, t, f, m = 4, 10, 64, 16
    n_ph, n_fr = (10, 7, 4, 0), (64, 40, 24, 0)
    tok = np.zeros((b, t), np.int32)
    mel2ph = np.zeros((b, f), np.int32)
    for i in range(3):
        tok[i, :n_ph[i]] = rng.integers(3, 30, n_ph[i])
        cuts = np.sort(rng.choice(np.arange(1, n_fr[i]), n_ph[i] - 1,
                                  replace=False))
        parts = np.diff(np.concatenate([[0], cuts, [n_fr[i]]]))
        mel2ph[i, :n_fr[i]] = np.repeat(np.arange(1, n_ph[i] + 1), parts)
    valid, nonpad = mel2ph > 0, tok > 0
    return {
        "txt_tokens": tok, "txt_lengths": np.asarray(n_ph, np.int32),
        "mels": (rng.uniform(-5.5, 1.0, (b, f, m)) * valid[..., None]
                 ).astype(np.float32),
        "mel_lengths": np.asarray(n_fr, np.int32), "mel2ph": mel2ph,
        "pitch_midi": (rng.integers(48, 80, (b, t)) * nonpad
                       ).astype(np.int32),
        "midi_dur": (rng.uniform(0.1, 0.6, (b, t)) * nonpad
                     ).astype(np.float32),
        "is_slur": ((rng.random((b, t)) < 0.3) * nonpad).astype(np.int32),
        "spec": (np.abs(rng.normal(size=(b, f, 33))) * valid[..., None]
                 ).astype(np.float32),
        "wav": (0.1 * rng.normal(size=(b, f * 16))
                * np.repeat(valid, 16, axis=1)).astype(np.float32),
        "weight": np.asarray([1, 1, 1, 0], np.float32),
        "f0": (rng.uniform(100, 300, (b, f)) * (rng.random((b, f)) > 0.2)
               * valid).astype(np.float32)}


def calibrate_bn(module, *inputs) -> None:
    """Every BatchNorm of ``module`` takes the statistics of one forward on
    ``inputs`` as its running ones (momentum 1 for that pass), then the
    module is back in eval mode."""
    import torch
    from torch import nn

    norms = [m for m in module.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    module.train()
    with torch.no_grad():
        module(*inputs)
    module.eval()
    for m, mom in zip(norms, momenta):
        m.momentum = mom


def phase_train_svs_small_reference() -> None:
    """The CPU tests' tiny DiffSinger (the pitch embedding off, as
    ``diffsinger.yaml``, and on), VISinger (both groups), Audio2Motion, VAE
    (both groups) and CLAP tasks on the card and on the CPU with the same
    weights, batch and draws (DiffSinger's t and ε, the posteriors' ε),
    TF32 off: one step's losses within ``SVS_LOSS_RTOL`` relative, every
    gradient within ``SVS_GRAD_TOL`` of its tensor's largest (a vanishing
    one within ``TTS_ZERO_GRAD_TOL`` of the group's largest). The tiny CLAP
    task's Cnn14 holds the running statistics of one forward on the batch
    (``calibrate_bn``), as a trained tower's fit its data: with the fill's
    statistics (mean 0, variance 1) its random convolutions map every clip
    to one direction (the embeddings' cosines are 1.0000), the InfoNCE
    gradient becomes a difference of nearly equal vectors, and the card's
    f32 gradients missed the CPU's by 1.49e-4. The audio and text
    embeddings' cosines are reported."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.models.caption import Cnn14Config
    from audiogpt_tpu_torch.models.diffusion.vae import VAEConfig
    from audiogpt_tpu_torch.models.face import (Audio2MotionConfig,
                                                pseudo_motion_targets)
    from audiogpt_tpu_torch.models.svs import (DiffNetConfig,
                                               DiffSingerConfig,
                                               VISingerConfig)
    from audiogpt_tpu_torch.models.textenc.bert import BertConfig
    from audiogpt_tpu_torch.models.textenc.clap import CLAPTextConfig
    from audiogpt_tpu_torch.models.tts import FastSpeech2Config
    from audiogpt_tpu_torch.models.vocoder import (DiscriminatorConfig,
                                                   HifiGANConfig)
    from audiogpt_tpu_torch.train.tasks import (
        Audio2MotionTask, Audio2MotionTaskConfig, CLAPTask, CLAPTaskConfig,
        DiffSingerTask, DiffSingerTaskConfig, VAETask, VAETaskConfig,
        VISingerTask, VISingerTaskConfig)

    rng = np.random.default_rng(5)
    score = tiny_score_batch(1)
    ds_draws = {"t": rng.integers(0, TINY_DS["K_step"], 4),
                "noise": rng.normal(size=(4, 64, 16)).astype(np.float32)}
    mels = rng.uniform(0, 1, (4, 64, 16)).astype(np.float32)
    motion = np.stack([pseudo_motion_targets(m, 25) for m in mels])
    t = np.arange(16000) / 16000.0
    wav = 0.2 * rng.normal(size=(4, 16000)) + 0.5 * np.sin(
        2 * np.pi * np.asarray([220.0, 880.0, 3000.0, 440.0])[:, None] * t)
    # zero past each clip's length, as collate_audio_text pads
    wav_len = np.asarray([16000, 12000, 14000, 11000], np.int32)
    wav = (wav * (np.arange(16000) < wav_len[:, None])).astype(np.float32)
    ids = np.zeros((4, 8), np.int32)
    for i, n in enumerate((8, 5, 6, 3)):
        ids[i, :n] = rng.integers(3, 100, n)
    clap_batch = {"wav": wav, "wav_len": wav_len, "text_ids": ids,
                  "text_mask": (ids != 0).astype(np.int32),
                  "weight": np.asarray([1, 1, 1, 0], np.float32)}

    def clap_prime(task) -> dict:
        """Cnn14's statistics from the batch; the embeddings' cosines."""
        b = {k: torch.as_tensor(v) for k, v in clap_batch.items()}
        calibrate_bn(task.model.audio, b["wav"], b["wav_len"].long())
        with torch.no_grad():
            a, t_emb, _ = task.model(b["wav"], b["text_ids"].long(),
                                     b["text_mask"].long(),
                                     b["wav_len"].long())
        return {f"{k}_cosines": [[round(float(c), 4) for c in row]
                                 for row in x @ x.T]
                for k, x in (("audio", a), ("text", t_emb))}

    def diffsinger(pitch):
        return lambda dev: DiffSingerTask(DiffSingerTaskConfig(
            model=DiffSingerConfig(fs2=FastSpeech2Config(
                use_pitch_embed=pitch, **TINY_DS_FS2),
                net=DiffNetConfig(**TINY_NET), **TINY_DS)), device=dev)

    builds = {
        "diffsinger": (diffsinger(False), score, ds_draws),
        "diffsinger_f0": (diffsinger(True), score, ds_draws),
        "visinger": (lambda dev: VISingerTask(VISingerTaskConfig(
            model=VISingerConfig(decoder=HifiGANConfig(
                in_channels=8, upsample_rates=(4, 4),
                upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
                resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1, 3),)), **TINY_VIS),
            disc=DiscriminatorConfig(**TINY_DISC)), device=dev), score,
            rng.normal(size=(4, 64, 8)).astype(np.float32)),
        "audio2motion": (lambda dev: Audio2MotionTask(Audio2MotionTaskConfig(
            model=Audio2MotionConfig(**TINY_A2M)), device=dev),
            {"mels": mels, "motion": motion.astype(np.float32),
             "weight": np.asarray([1, 1, 1, 0], np.float32)},
            rng.normal(size=(4, 25, 4)).astype(np.float32)),
        "vae": (lambda dev: VAETask(VAETaskConfig(vae=VAEConfig(**TINY_VAE)),
                                    device=dev),
                {"mels": rng.uniform(-1, 1, (2, 16, 20, 1)).astype(
                    np.float32), "weight": np.ones(2, np.float32)},
                rng.normal(size=(2, 4, 8, 10)).astype(np.float32)),
        "clap": (lambda dev: CLAPTask(CLAPTaskConfig(
            text=CLAPTextConfig(bert=BertConfig(**TINY_BERT), d_proj=16),
            d_proj=16, audio=Cnn14Config(channels=(4, 4, 8, 8, 16, 16))),
            device=dev), clap_batch, None)}
    report, worst = card_vs_cpu_steps(builds, "train_svs_small_reference",
                                      grad_tol=SVS_GRAD_TOL,
                                      prime={"clap": clap_prime})
    emit({"phase": "train_svs_small_reference", "bounds": {
        "loss_rtol": SVS_LOSS_RTOL, "grad_tol": SVS_GRAD_TOL,
        "zero_grad_tol": TTS_ZERO_GRAD_TOL}, **report})
    bad = {k: v for k, v in worst.items()
           if not (v[0] <= SVS_LOSS_RTOL and v[1] <= SVS_GRAD_TOL)}
    if bad:
        raise AssertionError(f"card vs CPU SVS, face and LDM training: {bad}")


#: the analysis recipes' phases: steps of each run (the yamls' widths and
#: batches; steps cut from ``max_updates`` to what the time limit allows),
#: the fixtures' records (two batches of each recipe) and their lengths
SED_STEPS, CAPTION_STEPS, SEP_STEPS = 6, 6, 8
SED_RECORDS, SEP_RECORDS = 64, 16
SED_CLASSES, CAPTION_TOKENS = 527, (5, 21)
#: the CPU tests' tiny analysis tasks (``tests/test_torch_analysis_train``)
TINY_CNN = (4, 4, 8, 8, 16, 16)
TINY_CAPTION = dict(rnn_hidden=8, vocab_size=40, emb_dim=16, nhead=2,
                    nlayers=1, dim_feedforward=32, max_caption_len=8)
TINY_TASNET = dict(enc_dim=32, bottleneck=8, hidden=16, skip=8, n_blocks=2,
                   n_repeats=1, sample_rate=8000)
#: ``infer_cli --engine t2a``: PLMS over 25 steps, one sample (the CFG pair
#: makes the UNet's batch 2)
INFER_T2A_STEPS = 25
#: the GPT-2 refiner at GPT-2 small's width: prompt and new tokens
GPT2_PROMPT, GPT2_NEW = 16, 40
GPT2_TINY = dict(vocab_size=300, n_positions=64, width=128, layers=2,
                 heads=2, eos_id=299)


def analysis_fixtures(root: Path) -> dict:
    """Seeded records of the three analysis recipes, written by the port's
    ``RecordWriter``: AudioSet-like clips (10 s of sound events at 32 kHz)
    with multi-hot targets over 527 classes (1–4 labels) and captions
    (``<sos>`` 0, 5–21 word ids below 4 981, ``<eos>`` 9), one split that
    ``sed`` and ``caption`` share; 4 s mixtures at 16 kHz of two
    speech-like sources at 0 dB. → the binary dirs."""
    import numpy as np

    from audiogpt_tpu_torch.data import RecordWriter

    rng = np.random.default_rng(61)
    with RecordWriter(str(root / "tagged" / "bin" / "train")) as w:
        for i in range(SED_RECORDS):
            target = np.zeros(SED_CLASSES, np.float32)
            target[rng.choice(SED_CLASSES, int(rng.integers(1, 5)),
                              replace=False)] = 1.0
            n = int(rng.integers(*CAPTION_TOKENS))
            tokens = np.concatenate([[0], rng.integers(10, 4981, n),
                                     [9]]).astype(np.int32)
            w.add({"wav": events_like(10.0, 32000, 700 + i),
                   "target": target, "tokens": tokens})
    with RecordWriter(str(root / "mixtures" / "bin" / "train")) as w:
        for i in range(SEP_RECORDS):
            src = np.stack([speech_like(4.0, 16000, 800 + 2 * i),
                            speech_like(4.0, 16000, 801 + 2 * i)])
            w.add({"mix": src.sum(0), "sources": src})
    tagged = str(root / "tagged" / "bin")
    return {"sed": tagged, "caption": tagged,
            "separation": str(root / "mixtures" / "bin")}


def bn_buffers_moved(module) -> list:
    """The BatchNorm buffers of ``module`` that left their init (mean 0,
    variance 1, no batches counted)."""
    return [n for n, b in module.named_buffers()
            if (n.endswith("running_mean") and bool(b.any()))
            or (n.endswith("running_var") and not bool((b == 1).all()))
            or (n.endswith("num_batches_tracked") and int(b) != 0)]


def analysis_report(run: dict, terms: tuple) -> dict:
    """``fit_report`` and each term at the first and the last step."""
    tr = run["tr"]
    res = fit_report(run, terms)
    for k in terms:
        res[f"{k}_first"], res[f"{k}_last"] = tr[0][k], tr[-1][k]
    return res


def phase_train_sed(dirs: dict, tmp: str) -> dict:
    """``configs/sed/panns.yaml`` at full width (PANN-SED: Cnn14 2048 wide,
    527 classes), batch 32 of 10 s at 32 kHz, mixup α 1 drawn on the card,
    ``SED_STEPS`` steps: step time, MFU, peak, ``clip_bce`` first and last,
    neither kernel, and every BatchNorm buffer where its init left it (the
    model runs on its running statistics, JAX's ``train=False``)."""
    run = fit_run("train_sed", "sed/panns.yaml", dirs["sed"], tmp, SED_STEPS)
    task, tr = run["task"], run["tr"]
    cnn = task.model.backbone.cfg
    if (cnn.channels[-1], task.cfg.model.classes_num, task.cfg.mixup_alpha,
            run["shapes"][0]) != (2048, 527, 1.0, ((32, 320000),)):
        raise AssertionError(f"train_sed: {task.cfg}, {run['shapes']}")
    terms = ("clip_bce", "total_loss")
    moved = bn_buffers_moved(task.model)
    res = {"phase": "train_sed", **analysis_report(run, terms),
           "bn_buffers_moved": moved, "model_training": task.model.training}
    emit(res)
    if res["nonfinite"] or not finite_terms(tr, terms) or moved \
            or task.model.training or not all(run["moved"].values()):
        raise AssertionError(f"train_sed: {res}")
    return {"launches": run["counts"]}


def phase_train_caption(dirs: dict, tmp: str) -> dict:
    """``configs/caption/cnn14rnn.yaml`` at full width (Cnn14, the
    bidirectional GRU of 512 under autograd, a 2-layer decoder over 4 981
    words), batch 32 of 10 s at 32 kHz and 22 tokens, ``CAPTION_STEPS``
    steps on the rsqrt warm-up: step time, MFU, peak, ``ce`` and
    ``token_acc`` first and last, neither kernel, Cnn14 in eval mode with
    its buffers unmoved (cuDNN's GRU trains in training mode)."""
    run = fit_run("train_caption", "caption/cnn14rnn.yaml", dirs["caption"],
                  tmp, CAPTION_STEPS)
    task, tr = run["task"], run["tr"]
    m = task.cfg.model
    if (m.cnn14.channels[-1], m.rnn_hidden, m.vocab_size, m.nlayers,
            run["shapes"][0]) != (2048, 512, 4981, 2, ((32, 320000),)):
        raise AssertionError(f"train_caption: {m}, {run['shapes']}")
    terms = ("ce", "token_acc", "total_loss")
    moved = bn_buffers_moved(task.model)
    res = {"phase": "train_caption", **analysis_report(run, terms),
           "bn_buffers_moved": moved,
           "cnn14_training": task.model.cnn.training}
    emit(res)
    if res["nonfinite"] or not finite_terms(tr, terms) or moved \
            or task.model.cnn.training or not all(run["moved"].values()):
        raise AssertionError(f"train_caption: {res}")
    return {"launches": run["counts"]}


def phase_train_separation(dirs: dict, tmp: str) -> dict:
    """``configs/separation/convtasnet.yaml`` at full width (Conv-TasNet
    512/128/512, 8 blocks × 3 repeats, two sources), batch 8 of 4 s
    mixtures at 16 kHz, PIT SI-SNR, ``SEP_STEPS`` steps: step time, MFU,
    peak, ``neg_si_snr`` first and last, neither kernel. The weights are
    then written as ``train_cli --export`` writes them (``export``)."""
    from audiogpt_tpu_torch.train_cli import export_weights

    run = fit_run("train_separation", "separation/convtasnet.yaml",
                  dirs["separation"], tmp, SEP_STEPS)
    task, tr = run["task"], run["tr"]
    m = task.cfg.model
    if (m.n_src, m.enc_dim, m.bottleneck, m.hidden, m.n_blocks, m.n_repeats,
            run["shapes"][0]) != (2, 512, 128, 512, 8, 3, ((8, 64000),)):
        raise AssertionError(f"train_separation: {m}, {run['shapes']}")
    terms = ("neg_si_snr", "total_loss")
    res = {"phase": "train_separation", **analysis_report(run, terms)}
    emit(res)
    if res["nonfinite"] or not finite_terms(tr, terms) \
            or not all(run["moved"].values()):
        raise AssertionError(f"train_separation: {res}")
    return {"launches": run["counts"],
            "export": export_weights(run["trainer"], str(run["work"]))}


def phase_train_analysis_small_reference() -> None:
    """The CPU tests' tiny SED (mixup on replayed draws, strong labels and
    a weight-0 row), caption and Conv-TasNet (one and two sources) tasks
    on the card and on the CPU with the same weights, batch and draws, TF32
    off: one step's losses within ``SVS_LOSS_RTOL`` relative, every
    gradient within ``SVS_GRAD_TOL`` of its tensor's largest. Each Cnn14
    holds the running statistics of one forward on the batch
    (``calibrate_bn``)."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.models.caption import Cnn14Config
    from audiogpt_tpu_torch.models.caption.captioner import CaptionConfig
    from audiogpt_tpu_torch.models.sed.panns_sed import SEDConfig
    from audiogpt_tpu_torch.models.separation import ConvTasNetConfig
    from audiogpt_tpu_torch.train.tasks import (CaptionTask,
                                                CaptionTaskConfig, SEDTask,
                                                SEDTaskConfig,
                                                SeparationTask,
                                                SeparationTaskConfig)

    rng = np.random.default_rng(9)
    n = 32000
    t = np.arange(n) / 32000.0
    lens = np.asarray([n, 24000, 28000], np.int32)
    wav = 0.2 * rng.normal(size=(3, n)) + 0.5 * np.sin(
        2 * np.pi * rng.uniform(200, 4000, (3, 1)) * t)
    wav = (wav * (np.arange(n) < lens[:, None])).astype(np.float32)
    sed_batch = {"wav": wav, "wav_len": lens,
                 "target": (rng.random((3, 10)) < 0.3).astype(np.float32),
                 "frame_target": (rng.random((3, 32, 10)) < 0.2).astype(
                     np.float32),
                 "weight": np.asarray([1, 1, 0], np.float32)}
    tokens = np.zeros((3, 7), np.int32)
    tok_len = np.asarray([6, 4, 5], np.int32)
    for i, k in enumerate(tok_len):
        tokens[i, 1:k] = rng.integers(1, 40, k - 1)
    cap_batch = {"wav": wav, "wav_len": lens, "tokens": tokens,
                 "token_len": tok_len,
                 "weight": np.asarray([1, 0, 1], np.float32)}

    def mixture(n_src):
        src = (0.3 * rng.normal(size=(3, n_src, 4000))).astype(np.float32)
        return {"mix": src.sum(1), "sources": src,
                "weight": np.asarray([1, 1, 0], np.float32)}

    cnn = Cnn14Config(channels=TINY_CNN)
    t_wav, t_len = torch.from_numpy(wav), torch.from_numpy(lens).long()
    builds = {
        "sed": (lambda dev: SEDTask(SEDTaskConfig(model=SEDConfig(
            cnn14=cnn, classes_num=10)), device=dev), sed_batch,
            {"lam": np.float32(rng.beta(1.0, 1.0)),
             "perm": np.asarray([2, 0, 1], np.int64)}),
        "caption": (lambda dev: CaptionTask(CaptionTaskConfig(
            model=CaptionConfig(cnn14=cnn, **TINY_CAPTION)), device=dev),
            cap_batch, None),
        **{f"separation_{k}": (lambda dev, k=k: SeparationTask(
            SeparationTaskConfig(model=ConvTasNetConfig(
                n_src=k, **TINY_TASNET)), device=dev), mixture(k), None)
           for k in (1, 2)}}
    prime = {"sed": lambda task: calibrate_bn(task.model.backbone, t_wav,
                                              t_len),
             "caption": lambda task: calibrate_bn(task.model.cnn, t_wav,
                                                  t_len)}
    report, worst = card_vs_cpu_steps(builds, "train_analysis_small_reference",
                                      grad_tol=SVS_GRAD_TOL, prime=prime)
    emit({"phase": "train_analysis_small_reference", "bounds": {
        "loss_rtol": SVS_LOSS_RTOL, "grad_tol": SVS_GRAD_TOL,
        "zero_grad_tol": TTS_ZERO_GRAD_TOL}, **report})
    bad = {k: v for k, v in worst.items()
           if not (v[0] <= SVS_LOSS_RTOL and v[1] <= SVS_GRAD_TOL)}
    if bad:
        raise AssertionError(f"card vs CPU analysis training: {bad}")


def reference_vocoder_names(kind: str, cfg, state: dict) -> dict:
    """A port HiFi-GAN or BigVGAN generator's state under the reference
    checkpoint's names (``NeuralSeq/modules/hifigan/hifigan.py:104`` and
    ``Make_An_Audio/vocoder/bigvgan/models.py:133``: ``ups``,
    ``resblocks.{i · kernels + j}.convs{1,2}``, BigVGAN's
    ``activations.{n}.act``), HiFi-GAN's convs as torch weight-norm pairs
    (g = ‖w‖ per output channel, v = 2w), under ``generator.``."""
    import torch

    nk = len(cfg.resblock_kernel_sizes)
    amp = kind == "bigvgan"

    def block(m):
        i, j, what, k = (int(m.group(1)), int(m.group(2)), m.group(3),
                         int(m.group(4)))
        r = f"resblocks.{i * nk + j}"
        return f"{r}.activations.{k}.act." if what == "SnakeAA" \
            else f"{r}.convs{1 + k % 2}.{k // 2}."

    out = {}
    for key, t in state.items():
        key = re.sub(r"^conv_(pre|post)\.Conv_0\.", r"conv_\1.", key)
        key = re.sub(r"^up_(\d+)\.", r"ups.\1.0." if amp else r"ups.\1.",
                     key)
        key = re.sub(r"^(?:amp|res)_(\d+)_(\d+)\.(Conv1d|SnakeAA)_(\d+)\."
                     r"(?:Conv_0\.)?", block, key)
        key = re.sub(r"^act_post\.", "activation_post.act.", key)
        if not amp and t.ndim == 3 and key.endswith("weight") \
                and key.startswith(("ups", "resblocks")):
            g = t.double().pow(2).sum((1, 2), keepdim=True).sqrt().float()
            out["generator." + key[:-6] + "weight_g"] = g
            out["generator." + key[:-6] + "weight_v"] = 2 * t
        else:
            out["generator." + key] = t
    return {k: torch.as_tensor(v).contiguous() for k, v in out.items()}


def phase_import_cli(main: dict, tts: dict, separation: dict,
                     exported: str, tmp: str) -> dict:
    """Checkpoint import and the CLIs on the card. A synthetic reference
    ``.ckpt`` at full width for ``hifigan`` (V1, weight-norm pairs) and
    ``bigvgan`` (the T2A vocoder), each from a seeded generator under the
    reference's names, goes through ``python -m
    audiogpt_tpu_torch.import_ckpt`` in a subprocess (the two at once); the
    trees load into engines built by ``app.build_engines`` through
    ``app.load_engine_ckpts`` (no kernel launched), and each vocodes a
    seeded mel to the wav of the same engine with the tree converted in
    this process and passed directly (equal, bitwise). ``infer_cli
    --engine separate --params`` on the weights that ``train_separation``
    exported builds its engine through the app's own factory, on the card,
    and writes the stems that a ``SeparationEngine`` given those weights
    directly writes (within one int16 step). Then ``infer_cli`` runs
    ``tts``, ``enhance`` and ``t2a`` on the card, in this process, on the
    app's engines as the earlier phases built them (the factories return
    them): the files' lengths and finiteness, and ``t2a``'s K1 and
    K2 launches against the counts derived from the configs (PLMS-25, the
    CFG pair, one vocoded clip). The import seconds and the files'
    sizes."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch import app, import_ckpt, infer_cli
    from audiogpt_tpu_torch.engines import SeparationEngine, VocoderEngine
    from audiogpt_tpu_torch.models.separation import ConvTasNetConfig
    from audiogpt_tpu_torch.utils.audio_io import load_wav, save_wav

    root = Path(tmp) / "import_cli"
    root.mkdir(parents=True)
    sizes, ckpts = {}, {}
    for kind in ("hifigan", "bigvgan"):
        cfg = import_ckpt.default_config(kind)
        gen = VocoderEngine(kind, cfg=cfg, device="cpu").model
        fill_random(gen, torch.Generator().manual_seed(71))
        sd = reference_vocoder_names(kind, cfg, gen.state_dict())
        ckpts[kind] = str(root / f"{kind}.ckpt")
        torch.save({"state_dict": sd, "global_step": 1000}, ckpts[kind])
        sizes[f"{kind}_ckpt_mb"] = os.path.getsize(ckpts[kind]) / 1e6
    t0 = time.perf_counter()
    procs = {kind: subprocess.Popen(
        [sys.executable, "-m", "audiogpt_tpu_torch.import_ckpt", "--family",
         kind, "--ckpt", ckpts[kind], "--out", str(root / kind)],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for kind in ckpts}
    import_s, logs = {}, {}
    for kind, p in procs.items():
        out, err = p.communicate(timeout=300)
        import_s[kind] = time.perf_counter() - t0
        if p.returncode:
            raise AssertionError(f"import_ckpt {kind}: {err[-2000:]}")
        logs[kind] = out.strip().splitlines()[-1]
        sizes[f"{kind}_params_mb"] = os.path.getsize(
            root / kind / import_ckpt.PARAMS_FILE) / 1e6
    engines = app.build_engines({
        "hifigan": VocoderEngine("hifigan", buckets=(256,)),
        "bigvgan": VocoderEngine("bigvgan", buckets=(256,))})
    _, load_s, load_counts = counted(lambda: app.load_engine_ckpts(
        engines, [f"{kind}={root / kind}" for kind in ckpts]))
    check_no_kernels(load_counts, "import_cli load")
    mel = torch.from_numpy(np.random.default_rng(72).normal(
        -4.0, 1.5, (1, 80, 200)).astype(np.float32)).cuda()
    equal = {}
    for kind in ckpts:
        direct = VocoderEngine(kind, params=import_ckpt.convert(
            kind, import_ckpt.load_torch_state_dict(ckpts[kind]),
            import_ckpt.default_config(kind)), buckets=(256,))
        a, b = engines[kind].vocode(mel), direct.vocode(mel)
        equal[kind] = float((a - b).abs().max())
        if equal[kind] != 0.0 or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"import_cli {kind}: |Δwav| {equal[kind]}")
    noisy = str(root / "noisy.wav")
    save_wav(speech_like(10.0, 16000, 73), noisy, 16000)
    # infer_cli --params on the trained weights, through the app's factory
    stems = str(root / "separate.wav")
    rc, sep_s, sep_counts = counted(lambda: infer_cli.main(
        ["--engine", "separate", "--in", noisy, "--out", stems,
         "--params", exported]))
    check_no_kernels(sep_counts, "infer_cli separate")
    weights = torch.load(exported, map_location="cpu", weights_only=True)
    if rc != 0 or weights["ema"]:
        raise AssertionError(f"infer_cli separate: rc {rc}, ema "
                             f"{list(weights['ema'])}")
    direct = SeparationEngine(ConvTasNetConfig(n_src=2))
    direct.model.load_state_dict(weights["params"]["model"])
    direct_stems = np.atleast_2d(direct.separate(load_wav(noisy)[0]))
    sep_diff = []
    for i, stem in enumerate(direct_stems):
        save_wav(stem, str(root / f"direct_{i}.wav"), 16000)
        a = load_wav(stems.replace(".wav", f"_{i}.wav"))[0]
        b = load_wav(str(root / f"direct_{i}.wav"))[0]
        sep_diff.append(float(np.abs(a - b).max()))
    if len(direct_stems) != 2 or max(sep_diff) > 1.0 / 32768 \
            or not np.isfinite(direct_stems).all() \
            or not np.abs(direct_stems).max() > 0:
        raise AssertionError(f"infer_cli separate vs direct: {sep_diff}")
    # infer_cli on the app's engines of the earlier phases
    saved = dict(app._FACTORIES)
    app._FACTORIES.update(
        t2a=lambda device=None: main["engine"],
        tts=lambda device=None: tts["engine"],
        enhance=lambda device=None: separation["enhance"]["engine"])
    runs = {}
    try:
        for name, args in (
                ("tts", ["--text", TTS_TEXT]),
                ("enhance", ["--in", noisy]),
                ("t2a", ["--text", TEXT])):
            out = str(root / f"{name}.wav")
            rc, secs, counts = counted(lambda: infer_cli.main(
                ["--engine", name, "--out", out, *args]))
            wav, sr = load_wav(out)
            runs[name] = {"rc": rc, "s": secs, "counts": counts,
                          "samples": int(wav.size), "sr": sr,
                          "finite": bool(np.isfinite(wav).all()),
                          "rms": float(np.sqrt(np.mean(wav ** 2)))}
    finally:
        app._FACTORIES.clear()
        app._FACTORIES.update(saved)
    eng = main["engine"]
    cfg = eng.cfg
    flash = flash_shapes(cfg, 2, cfg.latent_hw, INFER_T2A_STEPS,
                         cfg.clap.max_length)
    snake = snake_shapes(eng.vocoder.cfg, 1, cfg.mel_len)
    want = expected_counts(flash, snake)
    res = {"phase": "import_cli", "import_s": import_s, "load_s": load_s,
           "sizes_mb": sizes, "import_logs": logs,
           "vocoded_max_abs_diff": equal,
           "infer_cli_separate_params": {
               "s": sep_s, "stems_max_abs_diff": sep_diff,
               "int16_step": 1.0 / 32768, "counts": sep_counts},
           "infer_cli": {k: {**v, "counts": v["counts"]}
                         for k, v in runs.items()},
           "t2a_expected_counts": want}
    emit(res)
    for name, r in runs.items():
        if r["rc"] != 0 or not r["finite"] or r["samples"] == 0 \
                or r["rms"] == 0.0:
            raise AssertionError(f"infer_cli {name}: {r}")
        if name != "t2a":
            check_no_kernels(r["counts"], f"infer_cli {name}")
    if runs["t2a"]["counts"] != want \
            or runs["t2a"]["samples"] != cfg.mel_len * eng.vocoder.hop_size:
        raise AssertionError(f"infer_cli t2a: {runs['t2a']}, want {want}")
    return {"import": {"launches": load_counts},
            "infer_cli_separate": {"launches": sep_counts},
            "infer_cli_tts": {"launches": runs["tts"]["counts"]},
            "infer_cli_enhance": {"launches": runs["enhance"]["counts"]},
            "t2a": {"launches": runs["t2a"]["counts"], "flash": flash,
                    "snake": snake}}


def phase_gpt2_refiner() -> dict:
    """The T2I prompt refiner's LM at GPT-2 small's width (12 × 768, 12
    heads, 50 257 ids, tied head; seeded random weights, no GPT-2 vocab in
    the repository): ``generate_tokens`` on a ``GPT2_PROMPT``-token prompt
    (its bucket) with ``GPT2_NEW`` new tokens: cold and warm (median of 3)
    wall times, the prefill alone, ms per decode token, the device
    launches of one decode step (traced), K1 launches against the count
    the dispatch rule gives (a prefill of Tq·Tk ≥ 256², per layer). At a
    tiny config the card's greedy ids equal the CPU's."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines.base import seeded
    from audiogpt_tpu_torch.models.textenc.gpt2 import (GPT2Config, GPT2LM,
                                                        bucket_prompt,
                                                        generate_tokens,
                                                        greedy_generate)
    from audiogpt_tpu_torch.ops.attention import FLASH_MIN_PAIRS, KVCache

    cfg = GPT2Config()
    t0 = time.perf_counter()
    model = seeded(0, lambda: GPT2LM(cfg)).cuda().eval()
    fill_random(model, torch.Generator("cuda").manual_seed(81))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(82)
    prompt = [int(x) for x in rng.integers(0, cfg.eos_id, GPT2_PROMPT)]
    toks, val = (torch.from_numpy(a).cuda()
                 for a in bucket_prompt(prompt, cfg.eos_id))
    L = toks.shape[1]

    def generate():
        return generate_tokens(model, toks, val, GPT2_NEW)

    out, cold_s, counts = counted(generate)
    warm = [counted(generate)[1] for _ in range(3)]
    want_k1 = cfg.layers * int(L * L >= FLASH_MIN_PAIRS)
    heads, d = cfg.heads, cfg.width // cfg.heads

    def caches():
        return [KVCache.create(1, L + GPT2_NEW, heads, d, device="cuda")
                for _ in range(cfg.layers)]

    kv = torch.cat([val, torch.ones(1, GPT2_NEW, dtype=val.dtype,
                                    device="cuda")], 1)
    pos = (val.cumsum(1) - 1).clamp_min(0)

    def prefill():
        with torch.inference_mode():
            return model(toks, pos, caches(), kv)

    prefill_s = statistics.median(counted(prefill)[1] for _ in range(3))
    cs = caches()
    with torch.inference_mode():
        model(toks, pos, cs, kv)
        step_tok = out[:, :1]
        step_launches = device_launches(
            lambda: model(step_tok, pos[:, -1:] + 1, cs, kv))
    warm_s = statistics.median(warm)
    # the tiny config on the card and on the CPU, the same weights
    tiny = GPT2Config(**GPT2_TINY)
    cpu_model = seeded(1, lambda: GPT2LM(tiny)).eval()
    fill_random(cpu_model, torch.Generator().manual_seed(83))
    card_model = GPT2LM(tiny).cuda().eval()
    card_model.load_state_dict(cpu_model.state_dict())
    tiny_prompt = [int(x) for x in rng.integers(0, tiny.eos_id, 11)]
    ids_cpu = greedy_generate(cpu_model, tiny_prompt, 24)
    ids_card = greedy_generate(card_model, tiny_prompt, 24)
    res = {"phase": "gpt2_refiner", "layers": cfg.layers,
           "width": cfg.width, "vocab": cfg.vocab_size, "bucket": L,
           "prompt": GPT2_PROMPT, "new_tokens": GPT2_NEW,
           "setup_s": setup_s, "cold_s": cold_s, "warm_s": warm_s,
           "prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_token": 1e3 * (warm_s - prefill_s) / GPT2_NEW,
           "device_launches_per_decode_step": step_launches,
           "k1_launches": counts["flash_attention"], "k1_expected": want_k1,
           "k2_launches": counts["snake_aa"],
           "tiny_ids_equal": ids_cpu == ids_card, "tiny_ids": ids_card}
    emit(res)
    if counts["flash_attention"] != want_k1 or counts["snake_aa"] \
            or ids_cpu != ids_card or out.shape != (1, GPT2_NEW):
        raise AssertionError(f"gpt2_refiner: {res}")
    return {"launches": counts}


# -- the T5 text tower, PortaSpeech's speakers, the bf16 LDM step with
# -- checkpointing ------------------------------------------------------------

T5_BATCH, T5_MAX_LEN, T5_WARM = 8, 77, 10
T5_PROMPTS = (
    "a dog barks in the rain while cars pass by",
    "birds sing at dawn in a quiet forest",
    "a crowd cheers as the final whistle blows",
    "soft piano music with a gentle female voice",
    "thunder rumbles over the sea and waves crash on rocks",
    "an old train rattles along the tracks at night",
    "children laugh and play in a busy school yard",
    "a cat purrs next to a crackling fireplace")
T5_TINY = dict(d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4)
#: FLAN-T5-large's parameters (24 × 12 847 104, the embedding, the bias
#: table and the final norm)
T5_PARAMS = 341_231_104
PS_SPK_ITEMS, PS_SPK_SPEAKERS, PS_SPK_STEPS = 48, 16, 10


def t5_state_dict(cfg, gen) -> dict:
    """A ``T5EncoderModel`` state dict under HF's names (v1.1, gated GELU;
    the relative bias in block 0; ``encoder.embed_tokens`` the same tensor
    as ``shared``), seeded: weights normal · fan_in^-½, the embedding
    normal, the RMS norms' weights 1 + 0.1·N, the bias table 0.1·N."""
    import torch

    def w(out, inp):
        return torch.randn(out, inp, generator=gen) / math.sqrt(inp)

    def norm():
        return 1.0 + 0.1 * torch.randn(cfg.d_model, generator=gen)

    inner = cfg.num_heads * cfg.d_kv
    shared = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen)
    sd = {"shared.weight": shared, "encoder.embed_tokens.weight": shared,
          "encoder.final_layer_norm.weight": norm()}
    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}.layer"
        for n in "qkv":
            sd[f"{b}.0.SelfAttention.{n}.weight"] = w(inner, cfg.d_model)
        sd[f"{b}.0.SelfAttention.o.weight"] = w(cfg.d_model, inner)
        if i == 0:
            sd[f"{b}.0.SelfAttention.relative_attention_bias.weight"] = \
                0.1 * torch.randn(cfg.rel_buckets, cfg.num_heads,
                                  generator=gen)
        sd[f"{b}.0.layer_norm.weight"] = norm()
        sd[f"{b}.1.layer_norm.weight"] = norm()
        sd[f"{b}.1.DenseReluDense.wi_0.weight"] = w(cfg.d_ff, cfg.d_model)
        sd[f"{b}.1.DenseReluDense.wi_1.weight"] = w(cfg.d_ff, cfg.d_model)
        sd[f"{b}.1.DenseReluDense.wo.weight"] = w(cfg.d_model, cfg.d_ff)
    return sd


def wordpiece_sp_model() -> bytes:
    """A unigram ``spiece.model`` written by ``write_sp_model`` from the
    port's bundled WordPiece vocabulary: ``<pad>``, ``</s>``, ``<unk>``,
    then each word-initial token as ``▁token`` and each ``##`` tail as a
    bare piece ([bracketed] specials left out), scored −(1 + rank / n), so
    the fewest pieces win and the vocabulary's order breaks ties."""
    import gzip

    from audiogpt_tpu_torch.text.sentencepiece import (CONTROL, NORMAL,
                                                       UNKNOWN,
                                                       write_sp_model)

    path = ROOT / "audiogpt_tpu_torch" / "text" / "data" / "wordpiece_en.txt.gz"
    with gzip.open(path, "rt", encoding="utf-8") as f:
        tokens = [t.rstrip("\n") for t in f]
    tokens = [t for t in tokens if t and not t.startswith("[")]
    pieces = [("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
              ("<unk>", 0.0, UNKNOWN)]
    for rank, tok in enumerate(tokens):
        piece = tok[2:] if tok.startswith("##") else "▁" + tok
        pieces.append((piece, -(1.0 + rank / len(tokens)), NORMAL))
    return write_sp_model(pieces)


def t5_bound(cfg, batch: int, length: int) -> dict:
    """The encode's work from the config: 2 FLOPs a weight a token in the
    projections and feed-forwards, Q·Kᵀ and P·V per layer; the bytes: the
    layers' weights, the gathered embedding rows and the output, each once
    → the bound on the f32 FMA units (TF32 off, as this script runs) and
    on TF32's tensor cores."""
    inner = cfg.num_heads * cfg.d_kv
    per_layer = 4 * cfg.d_model * inner + 3 * cfg.d_model * cfg.d_ff
    weights = cfg.num_layers * per_layer
    tokens = batch * length
    flop = 2 * weights * tokens + cfg.num_layers * 4 * batch \
        * cfg.num_heads * length * length * cfg.d_kv
    n_bytes = 4 * (weights + cfg.num_layers * 2 * cfg.d_model
                   + cfg.num_heads * cfg.rel_buckets
                   + 2 * tokens * cfg.d_model)
    f32_ms, by = bound_ms(n_bytes, flop, F32_FLOPS)
    tf32_ms, tf32_by = bound_ms(n_bytes, flop, TF32_FLOPS)
    return {"layer_weights": weights, "tflop": flop / 1e12,
            "bytes_gb": n_bytes / 1e9, "bound_ms": f32_ms, "bound_by": by,
            "tf32_bound_ms": tf32_ms, "tf32_bound_by": tf32_by}


def phase_t5(tmp: str) -> dict:
    """The FLAN-T5-large text tower at full width (24 layers, d 1024, d_ff
    2816, 16 heads, 32 128 ids; seeded weights: no checkpoint in the
    repository): an HF-named ``T5EncoderModel`` state dict goes through
    ``python -m audiogpt_tpu_torch.import_ckpt --family t5`` in a
    subprocess; the port's ``T5Conditioner`` on the card loads that tree
    strictly, with a ``spiece.model`` written from the bundled WordPiece
    vocabulary, and encodes ``T5_BATCH`` prompts at ``max_length``
    ``T5_MAX_LEN``: cold, warm (median of ``T5_WARM``, CUDA events), K1
    launches (0: the position bias is a dense term, the plain path), the
    peak memory, the FLOPs ``FlopCounterMode`` counts and the bound. The
    card's first row is as close to a float64 CPU encode of it as the
    CPU's own f32 encode is (within 4× that error)."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch import import_ckpt
    from audiogpt_tpu_torch.models.textenc.t5 import (T5Conditioner,
                                                      T5Config, T5Encoder)
    from audiogpt_tpu_torch.text.sentencepiece import SentencePieceUnigram
    from audiogpt_tpu_torch.utils.flops import count_flops
    from audiogpt_tpu_torch.utils.jax_params import load_jax_params

    root = Path(tmp) / "t5"
    root.mkdir(parents=True)
    cfg = T5Config.flan_t5_large()
    t0 = time.perf_counter()
    sd = t5_state_dict(cfg, torch.Generator().manual_seed(91))
    ckpt = root / "flan_t5_large.bin"
    torch.save(sd, ckpt)
    n_params = sum(v.numel() for k, v in sd.items()
                   if k != "encoder.embed_tokens.weight")
    del sd
    fixture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "audiogpt_tpu_torch.import_ckpt", "--family",
         "t5", "--ckpt", str(ckpt), "--out", str(root / "tree")],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    import_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"t5 import: {proc.stderr[-2000:]}")
    tree = import_ckpt.restore_params(str(root / "tree"))
    spm = root / "spiece.model"
    spm.write_bytes(wordpiece_sp_model())
    codec = SentencePieceUnigram(str(spm))
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cond = T5Conditioner(cfg, params=tree, tokenizer=codec,
                         max_length=T5_MAX_LEN)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    texts = list(T5_PROMPTS[:T5_BATCH])
    ids, mask = cond.tokenize(texts)
    torch.cuda.reset_peak_memory_stats()
    out, cold_s, counts = counted(lambda: cond.encode(texts))
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    warm = []
    for _ in range(T5_WARM):
        start.record()
        cond.encode(texts)
        end.record()
        end.synchronize()
        warm.append(start.elapsed_time(end))
    warm_counts = counted(lambda: cond.encode(texts))[2]
    _, counted_flop = count_flops(lambda: cond.encode(texts))
    # the first prompt on the CPU from the same tree, in f32 and in float64
    # (the norms' statistics and the softmax stay f32, as the module
    # computes them): the card's f32 error against the CPU's own
    cpu = T5Encoder(cfg).eval()
    load_jax_params(cpu, tree)
    args = (torch.from_numpy(ids[:1]).long(), torch.from_numpy(mask[:1]))
    with torch.no_grad():
        ref32 = cpu(*args)[0]
        ref = cpu.double()(*args)[0]
    err = float((out[0].cpu().double() - ref).abs().max())
    cpu_err = float((ref32.double() - ref).abs().max())
    scale = float(ref.abs().max())
    bound = t5_bound(cfg, T5_BATCH, T5_MAX_LEN)
    warm_ms = statistics.median(warm)
    res = {"phase": "t5", "config": "flan_t5_large", "params": n_params,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "batch": T5_BATCH,
           "max_length": T5_MAX_LEN, "tokens": int(mask.sum()),
           "fixture_s": fixture_s, "ckpt_gb": ckpt.stat().st_size / 1e9,
           "import_s": import_s, "import_log": proc.stdout.strip()
           .splitlines()[-1], "setup_s": setup_s, "cold_s": cold_s,
           "warm_ms": warm_ms, "warm_ms_min": min(warm),
           "peak_mem_gb": peak, "k1_launches": counts["flash_attention"],
           "k1_launches_warm": warm_counts["flash_attention"],
           "k2_launches": counts["snake_aa"],
           "counted_tflop": counted_flop / 1e12, **bound,
           "bound_share": bound["bound_ms"] / warm_ms,
           "shape": list(out.shape), "row0_f64_max_abs_err": err,
           "cpu_f32_row0_f64_max_abs_err": cpu_err, "row0_max_abs": scale,
           "spiece_pieces": codec.vocab_size,
           "unk_tokens": int((ids == codec.unk_id).sum()),
           "ids_row0": ids[0, :int(mask[0].sum())].tolist()}
    emit(res)
    if any(counts.values()) or any(warm_counts.values()) \
            or tuple(out.shape) != (T5_BATCH, T5_MAX_LEN, cfg.d_model) \
            or not bool(torch.isfinite(out).all()) \
            or err > 4 * cpu_err + 1e-6 * scale \
            or n_params != T5_PARAMS or res["unk_tokens"]:
        raise AssertionError(f"t5: {res}")
    return {"launches": counts}


def phase_t5_vq_small_reference() -> dict:
    """A tiny T5 conditioner and GenerSpeech's EMA quantizer on the card
    and on the CPU with the same weights (TF32 off): the hidden states
    within 1e-5 of their largest, and after two training calls of the
    quantizer its codebook and statistics within 1e-6; the card's two
    training calls (the VQ EMA path) launch neither kernel."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.models.textenc.t5 import T5Conditioner, T5Config
    from audiogpt_tpu_torch.models.tts.generspeech import VQEmbeddingEMA
    from audiogpt_tpu_torch.text.sentencepiece import SentencePieceUnigram

    codec = SentencePieceUnigram(wordpiece_sp_model())
    cfg = T5Config(vocab_size=codec.vocab_size, **T5_TINY)
    conds = {dev: T5Conditioner(cfg, tokenizer=codec, max_length=T5_MAX_LEN,
                                device=dev)
             for dev in ("cpu", "cuda")}
    fill_random(conds["cpu"].model, torch.Generator().manual_seed(93))
    conds["cuda"].model.load_state_dict(conds["cpu"].model.state_dict())
    out = {dev: c.encode(list(T5_PROMPTS[:3])).cpu()
           for dev, c in conds.items()}
    t5_err = float((out["cuda"] - out["cpu"]).abs().max())
    t5_scale = float(out["cpu"].abs().max())
    rng = np.random.default_rng(94)
    xs = [torch.from_numpy(rng.normal(size=(4, 40, 256)).astype(np.float32))
          for _ in range(2)]
    vqs = {dev: VQEmbeddingEMA(64, 256).to(dev) for dev in ("cpu", "cuda")}
    vqs["cuda"].load_state_dict(vqs["cpu"].state_dict())
    before = vqs["cpu"].embedding.clone()
    for x in xs:
        vqs["cpu"](x, train=True)
    _, _, counts = counted(lambda: [vqs["cuda"](x.cuda(), train=True)
                                    for x in xs])
    vq_err = {name: float((getattr(vqs["cuda"], name).cpu()
                           - getattr(vqs["cpu"], name)).abs().max()
                          / getattr(vqs["cpu"], name).abs().max())
              for name in ("embedding", "ema_weight", "ema_count")}
    moved = float((vqs["cpu"].embedding - before).abs().max())
    res = {"phase": "t5_vq_small_reference", "t5_max_abs_err": t5_err,
           "t5_max_abs": t5_scale, "vq_rel_err": vq_err,
           "vq_codebook_moved": moved, "vq_launches": counts}
    emit(res)
    if t5_err > 1e-5 * t5_scale or max(vq_err.values()) > 1e-6 \
            or moved < 1e-4 or any(counts.values()):
        raise AssertionError(f"t5_vq_small_reference: {res}")
    return {"launches": counts}


def phase_train_portaspeech_spk(tmp: str) -> dict:
    """``configs/tts/portaspeech.yaml`` at full width with ``model.num_spk
    400`` (the VCTK preset's speakers) on ``PS_SPK_ITEMS`` word-level items
    of ``PS_SPK_SPEAKERS`` speakers, binarized with their speaker ids, for
    ``PS_SPK_STEPS`` steps: step time, peak, neither kernel; then on one
    batch the speaker table's gradient is non-zero exactly on the rows of
    the batch's real items' ids."""
    import torch

    from audiogpt_tpu_torch.data import BinarizeConfig, TTSBinarizer

    items = tts_word_corpus(PS_SPK_ITEMS, 95)
    for i, it in enumerate(items):
        it.spk = f"p{225 + i % PS_SPK_SPEAKERS}"
    bin_dir = str(Path(tmp) / "tts_bin" / "vctk_words")
    t0 = time.perf_counter()
    TTSBinarizer(BinarizeConfig(with_f0=True, with_words=True)).binarize(
        items, bin_dir)
    binarize_s = time.perf_counter() - t0
    run = fit_run("train_portaspeech_spk", "tts/portaspeech.yaml", bin_dir,
                  tmp, PS_SPK_STEPS, extra="model.num_spk=400")
    task = run["task"]
    batch = run["trainer"]._to_device(largest_batch(run))
    loss, _ = task.loss(batch, torch.Generator(batch["mels"].device)
                        .manual_seed(96))
    table, = torch.autograd.grad(loss, [task.model.spk_embed.weight])
    rows = sorted(torch.nonzero(table.abs().sum(1)).flatten().tolist())
    real = batch["weight"] > 0
    want = sorted(set(batch["spk_ids"][real].tolist()))
    res = {"phase": "train_portaspeech_spk", "num_spk": task.cfg.model.num_spk,
           "speakers": PS_SPK_SPEAKERS, "binarize_s": binarize_s,
           **fit_report(run, ("mel", "kl_v", "wdur", "total_loss")),
           "spk_table_rows": list(table.shape), "grad_rows": rows,
           "batch_speakers": want}
    emit(res)
    if task.cfg.model.num_spk != 400 \
            or tuple(table.shape) != (401, task.cfg.model.hidden_size) \
            or rows != want or len(want) < 2 or res["nonfinite"]:
        raise AssertionError(f"train_portaspeech_spk: {res}")
    return {"launches": run["counts"]}


# ---------------------------------------------------------------------------
# The engines' candidate sharding: two replicas on the one card
# ---------------------------------------------------------------------------


def replica_launches(eng) -> list:
    """Each replica's launches of both kernels, read from the counts by
    stream (a replica queues on its runner's stream)."""
    from audiogpt_tpu_torch.ops.flash_attention import flash_attention
    from audiogpt_tpu_torch.ops.snake_aa import snake_aa

    keys = [(s.device.index, s.cuda_stream) for s in eng.runner.streams]
    return [{"flash_attention": flash_attention.launches_by_stream[k],
             "snake_aa": snake_aa.launches_by_stream[k]} for k in keys]


def check_replicas(what: str, eng, seen: Counter, flash: Counter,
                   per_replica: dict, counts: dict) -> dict:
    """Each replica's launches (by stream) and recorded K1 shapes against
    one replica's derived ones, and the call's totals against their sum;
    → the shapes each replica recorded."""
    streams = [s.cuda_stream for s in eng.runner.streams]
    shapes = {i: Counter({shape: n for (st, shape), n in seen.items()
                          if st == stream})
              for i, stream in enumerate(streams)}
    per = replica_launches(eng)
    r = len(streams)
    total = {k: r * v for k, v in per_replica.items()}
    if per != [per_replica] * r or any(shapes[i] != flash for i in shapes) \
            or sum(seen.values()) != total["flash_attention"] \
            or {k: counts[k] for k in total} != total \
            or counts["flash_attention_bf16"] or counts["snake_aa_bf16"]:
        raise AssertionError(f"{what}: replica launches {per}, shapes "
                             f"{shapes}, totals {counts}; expected "
                             f"{per_replica} and {dict(flash)} a replica")
    return shapes


def warm_replica_runs(what: str, eng, fn, counts: dict,
                      per_replica: dict) -> list:
    """``MESH_WARM_CALLS`` counted calls of ``fn``, each with the cold
    call's totals and ``per_replica`` on every replica's stream."""
    runs = []
    for _ in range(MESH_WARM_CALLS):
        runs.append(counted(fn))
        per = replica_launches(eng)
        if runs[-1][2] != counts or per != [per_replica] * len(per):
            raise AssertionError(f"{what} warm launches {runs[-1][2]}, "
                                 f"{per}; cold {counts}")
    return runs


def phase_t2a_mesh(main: dict) -> dict:
    """``txt2audio_best`` at full width on a mesh that names the card twice
    (``device_mesh(["cuda:0", "cuda:0"])``: two replicas, each with its own
    UNet, VAE, BigVGAN and Cnn14 copy, thread and stream) with the main
    path's weights, loaded, not filled anew; the tool's sampler
    (DPM-Solver++(2M)-12), n = 3 rounded up to 4, two rows a replica. Each
    replica's stream must launch K1 at [4, 780, 780, 8, 40] and K2 at batch
    2 as ``flash_shapes`` / ``snake_shapes`` give them for its rows (65 and
    73); the call is held against the main path's one-replica engine at
    n = 4 and the same seed (scores, argmax, the winner's mel and wav,
    within ``MESH_TOL``); cold and warm (median of 3) walls of both."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import T2AEngine
    from audiogpt_tpu_torch.parallel import device_mesh

    eng = main["engine"]
    cfg = eng.cfg
    t0 = time.perf_counter()
    meng = T2AEngine(cfg, vocoder=eng.vocoder, scorer=eng.scorer,
                     mesh=device_mesh(["cuda:0"] * MESH_REPLICAS))
    meng.load_state_dict({name: getattr(eng, name).state_dict()
                          for name in ("unet", "vae", "clap")})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = MESH_ROWS * MESH_REPLICAS
    flash = flash_shapes(cfg, 2 * MESH_ROWS, cfg.latent_hw, cfg.tool_steps,
                         cfg.clap.max_length)
    snake = snake_shapes(eng.vocoder.cfg, MESH_ROWS, cfg.mel_len)
    per_replica = {"flash_attention": sum(flash.values()),
                   "snake_aa": sum(snake.values())}

    def one():
        return eng.txt2audio_best(TEXT, n_samples=n, seed=0)

    def two():
        return meng.txt2audio_best(TEXT, n_samples=MESH_N, seed=0)

    ref, one_cold_s, _ = counted(one)
    (out, seen), cold_s, counts = counted(lambda: recorded_flash_streams(two))
    shapes = check_replicas("t2a_mesh", meng, seen, flash, per_replica,
                            counts)
    runs = warm_replica_runs("t2a_mesh", meng, two, counts, per_replica)
    per = replica_launches(meng)
    one_warm = sorted(counted(one)[1] for _ in range(MESH_WARM_CALLS))
    (mel, wav, scores), (mel1, wav1, scores1) = out, ref
    if scores.shape != (n,) or not np.isfinite(scores).all() \
            or np.ptp(scores) == 0.0 or wav.shape != (159744,) \
            or not np.isfinite(wav).all():
        raise AssertionError(f"t2a_mesh scores {scores}, wav {wav.shape}")
    diff = {"mel": float(np.abs(mel - mel1).max()),
            "wav": float(np.abs(wav - wav1).max()),
            "scores": float(np.abs(scores - scores1).max())}
    top = np.sort(scores1)[-2:]
    same_winner = int(scores.argmax()) == int(scores1.argmax())
    warm = sorted(r[1] for r in runs)
    emit({"phase": "t2a_mesh", "card": card_line(),
          "call": "txt2audio_best", "mesh": "cuda:0 x 2",
          "replicas": MESH_REPLICAS, "n_samples": MESH_N, "rounded_n": n,
          "sampler": cfg.tool_sampler, "steps": cfg.tool_steps,
          "setup_s": setup_s, "cold_s": cold_s,
          "warm_s": statistics.median(warm), "warm_max_s": warm[-1],
          "warm_calls": len(warm), "one_replica_n": n,
          "one_replica_cold_s": one_cold_s,
          "one_replica_warm_s": statistics.median(one_warm),
          "launches": counts, "launches_per_replica": per,
          "flash_shapes_per_replica": {
              i: {str(list(k)): v for k, v in sh.items()}
              for i, sh in shapes.items()},
          "snake_shapes_per_replica": {str(list(k)): v
                                       for k, v in snake.items()},
          "max_abs_diff_from_one_replica": diff, "tolerance": MESH_TOL,
          "winner": int(scores.argmax()),
          "one_replica_winner": int(scores1.argmax()),
          "one_replica_top2_gap": float(top[1] - top[0]),
          "scores": scores.tolist()})
    if any(diff[k] > MESH_TOL[k] for k in diff) or not (
            same_winner or top[1] - top[0] <= MESH_TOL["scores"]):
        raise AssertionError(f"t2a_mesh against one replica: {diff}, "
                             f"winners {int(scores.argmax())}, "
                             f"{int(scores1.argmax())}")
    return {"launches": counts,
            "flash": Counter({k: MESH_REPLICAS * v for k, v in flash.items()}),
            "snake": Counter({k: MESH_REPLICAS * v for k, v in snake.items()})}


def phase_t2i_mesh(t2i: dict) -> dict:
    """``txt2img`` at full width (512², f32) on a mesh that names the card
    twice, with the T2I phase's weights loaded: n = 2, one image a replica,
    the sampler cut from the tool's DDIM-50 to DDIM-10 (the script's time
    limit; the cut is printed). Each replica's stream must launch K1 250
    times, 50 at each of the five shapes of batch 2 (the CFG pair), and K2
    never; the images are held against the T2I engine's at n = 2 and the
    same seed; cold and warm (median of 3) walls of both."""
    import numpy as np
    import torch

    from audiogpt_tpu_torch.engines import T2IEngine
    from audiogpt_tpu_torch.parallel import device_mesh

    base = t2i["engine"]
    cfg = base.cfg
    t0 = time.perf_counter()
    meng = T2IEngine(cfg, tokenizer=base.tokenizer,
                     mesh=device_mesh(["cuda:0"] * MESH_REPLICAS),
                     media_root=base.media_root)
    meng.load_state_dict({name: getattr(base, name).state_dict()
                          for name in ("unet", "vae", "text")})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rows = T2I_MESH_N // MESH_REPLICAS
    flash = flash_shapes(cfg, 2 * rows, cfg.latent_hw, T2I_MESH_STEPS,
                         cfg.text.context_length)
    per_replica = {"flash_attention": sum(flash.values()), "snake_aa": 0}

    def one():
        return base.txt2img(T2I_TEXT, n_samples=T2I_MESH_N,
                            steps=T2I_MESH_STEPS, seed=0)

    def two():
        return meng.txt2img(T2I_TEXT, n_samples=T2I_MESH_N,
                            steps=T2I_MESH_STEPS, seed=0)

    ref, one_cold_s, _ = counted(one)
    (img, seen), cold_s, counts = counted(lambda: recorded_flash_streams(two))
    shapes = check_replicas("t2i_mesh", meng, seen, flash, per_replica,
                            counts)
    runs = warm_replica_runs("t2i_mesh", meng, two, counts, per_replica)
    per = replica_launches(meng)
    one_warm = sorted(counted(one)[1] for _ in range(MESH_WARM_CALLS))
    if img.shape != (T2I_MESH_N, 512, 512, 3) or not np.isfinite(img).all():
        raise AssertionError(f"t2i_mesh images {img.shape}")
    diff = float(np.abs(img - ref).max())
    warm = sorted(r[1] for r in runs)
    emit({"phase": "t2i_mesh", "card": card_line(), "call": "txt2img",
          "mesh": "cuda:0 x 2", "replicas": MESH_REPLICAS,
          "n_samples": T2I_MESH_N, "size": "512x512", "sampler": "ddim",
          "steps": T2I_MESH_STEPS,
          "sampler_cut": f"DDIM-{T2I_STEPS} -> DDIM-{T2I_MESH_STEPS}, for "
                         f"the script's time limit",
          "scale": 7.5, "setup_s": setup_s, "cold_s": cold_s,
          "warm_s": statistics.median(warm), "warm_max_s": warm[-1],
          "warm_calls": len(warm), "one_replica_cold_s": one_cold_s,
          "one_replica_warm_s": statistics.median(one_warm),
          "launches": counts, "launches_per_replica": per,
          "flash_shapes_per_replica": {
              i: {str(list(k)): v for k, v in sh.items()}
              for i, sh in shapes.items()},
          "image_max_abs_diff_from_one_replica": diff,
          "image_mean_abs_diff_from_one_replica": float(
              np.abs(img - ref).mean()),
          "tolerance": MESH_TOL["image"],
          "rows_differ": float(np.abs(img[0] - img[1]).max())})
    if diff > MESH_TOL["image"]:
        raise AssertionError(f"t2i_mesh against one replica: {diff}")
    return {"launches": counts,
            "flash": Counter({k: MESH_REPLICAS * v for k, v in flash.items()})}


def path_record(k: dict, path: str, shapes: Counter, launches: int) -> dict:
    """A kernel's share of one path: its launches, which the counters read
    and the configs must give (``shapes``), and per-call times, each the
    per-launch time at a shape times the launches at that shape."""
    by_shape = {tuple(r["shape"]): r for r in k["results"]}
    missing = [s for s in shapes if s not in by_shape]
    if missing or sum(shapes.values()) != launches:
        raise AssertionError(f"{k['name']} on {path}: {launches} launches, "
                             f"shapes {dict(shapes)}, untimed {missing}")

    def total(key):
        if any(by_shape[s].get(key) is None for s in shapes):
            return None
        return sum(n * by_shape[s][key] for s, n in shapes.items())

    ops = all(by_shape[s]["bound_by"] == "operations" for s in shapes)
    rec = {"path": path, "launches": launches, "ms": total("ms"),
           "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
           "bound_by": "operations" if ops else "bytes",
           "library_ms": total("library_ms"),
           "shapes": {by_shape[s]["case"]: n for s, n in shapes.items()}}
    for key in ("ms_events", "fma_bound_ms", "copy_ms"):
        if key in k["results"][0]:
            rec[key] = total(key)
    return rec


def kernel_entry(k: dict, paths: list, source: str, replaces: str) -> dict:
    """One kernel of the JSON line: the top-level numbers are those of its
    first path (per-call sums over that path's launches); ``paths`` lists
    every path that launches it."""
    main = paths[0]
    entry = {"name": k["name"], "route": "cuda", "source": source,
             "replaces": replaces, "tpu_kernel": replaces,
             "launches": main["launches"],
             "launches_per_call": main["launches"],
             "max_abs_err": max(r["max_abs_err"] for r in k["results"]),
             "ms": main["ms"], "kernel_ms": main["ms"],
             "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
             "bound_by": main["bound_by"], "library_ms": main["library_ms"],
             "ms_basis": f"sum over one {main['path']} call's launches",
             "path_shapes": main["shapes"], "paths": paths}
    for key in ("ms_events", "fma_bound_ms", "copy_ms"):
        if key in main:
            entry[key] = main[key]
    return entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import audiogpt_tpu_torch  # noqa: F401  (fails outside the repo)

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "probe", "card": card,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    phase_build()
    gen = torch.Generator("cuda").manual_seed(0)
    flash = phase_flash(gen)
    snake = phase_snake(gen)
    main_path = phase_main_path(gen)
    bf16_path = phase_main_path_bf16(main_path)
    inpaint = phase_inpaint(main_path)
    vocoder_bf16 = phase_vocoder_bf16(main_path)
    phase_small_reference()
    phase_profile(main_path["engine"], main_path["warm_s"])
    t2a_mesh = phase_t2a_mesh(main_path)
    asr = phase_asr(gen)
    asr_long = phase_asr_long(asr)
    asr_bf16 = phase_asr_bf16(asr)
    phase_asr_batched(asr)
    phase_asr_small_reference()
    tts = phase_tts(gen)
    phase_tts_long(tts)
    phase_tts_batched(tts)
    phase_tts_vocoders(tts, gen)
    phase_tts_small_reference()
    with tempfile.TemporaryDirectory() as tmp:
        i2a = phase_i2a(main_path, gen, tmp)
        phase_i2a_small_reference()
        t2i = phase_t2i(gen, tmp)
        t2i_bf16 = phase_t2i_bf16(t2i)
        t2i_mesh = phase_t2i_mesh(t2i)
        phase_t2i_small_reference()
        i2t = phase_i2t(gen, tmp)
        phase_i2t_small_reference()
        sed = phase_sed(gen, tmp)
        tools = {"caption": phase_caption(gen), "sed": sed,
                 "tsd": phase_tsd(gen), "extraction": phase_extraction(gen)}
        sed_pvt = phase_sed_pvt(flash, gen)
        separation = phase_separation(gen)
        tools.update(enhance=separation["enhance"],
                     separate=separation["separate"],
                     binaural=phase_binaural(gen), wav16k=separation["wav"])
        phase_analysis_small_reference()
        phase_transform_small_reference()
        singing = {"svs": phase_svs(gen), "visinger": phase_visinger(gen),
                   "tts_ood": phase_tts_ood(gen)}
        phase_speech_small_reference()
        face = phase_geneface(gen, tmp)
        t2a_htsat = phase_t2a_htsat(main_path, phase_htsat(gen))
        quiet = {**singing, "geneface": face,
                 "tts_portaspeech": phase_portaspeech(
                     gen, "tts_portaspeech", False),
                 "syntaspeech": phase_portaspeech(gen, "syntaspeech", True)}
        phase_face_small_reference()
        phase_served(main_path, inpaint, asr, tts, i2a, t2i, i2t, tools,
                     singing, face, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        train = phase_train_ldm(tmp, bf16=False)
        train_bf16 = phase_train_ldm(tmp, bf16=True)
        phase_train_grad_check(train, gen)
        phase_train_resume(tmp)
        for run in (train, train_bf16):     # ≈ 3.3 GB of the card each
            run.pop("task")
            run.pop("trainer")
        ddp = phase_train_ddp_ldm(tmp, train)
        ddp_small = phase_train_ddp_gloo_small(tmp)
        bins = phase_binarize_tts(tmp)
        quiet.update(train_fs2=phase_train_fs2(bins, tmp),
                     train_fs2_cwt=phase_train_fs2_cwt(bins, tmp),
                     train_vocoder_gan=phase_train_vocoder_gan(bins, tmp))
        phase_train_tts_small_reference()
        bins.update(phase_binarize_tts_words(tmp))
        quiet.update(
            train_portaspeech=phase_train_portaspeech(bins, tmp),
            train_syntaspeech=phase_train_syntaspeech(bins, tmp),
            train_ps_adv=phase_train_ps_adv(bins, tmp),
            train_generspeech=phase_train_generspeech(bins, tmp),
            train_pe=phase_train_pe(bins, tmp))
        bins.update(phase_binarize_svs(tmp))
        quiet.update(
            train_diffsinger=phase_train_diffsinger(bins, tmp),
            train_visinger=phase_train_visinger(bins, tmp),
            train_audio2motion=phase_train_audio2motion(bins, tmp),
            train_vae=phase_train_vae(tmp),
            train_clap=phase_train_clap(tmp))
        phase_train_svs_small_reference()
        dirs = analysis_fixtures(Path(tmp) / "analysis")
        quiet.update(train_sed=phase_train_sed(dirs, tmp),
                     train_caption=phase_train_caption(dirs, tmp),
                     train_separation=phase_train_separation(dirs, tmp))
        phase_train_analysis_small_reference()
        cli = phase_import_cli(main_path, tts, separation,
                               quiet["train_separation"]["export"], tmp)
        quiet.update(import_cli=cli["import"],
                     infer_cli_separate=cli["infer_cli_separate"],
                     infer_cli_tts=cli["infer_cli_tts"],
                     infer_cli_enhance=cli["infer_cli_enhance"],
                     gpt2_refiner=phase_gpt2_refiner())
        train_ckpt = phase_train_ldm(tmp, bf16=True, checkpoint=True)
        quiet.update(train_portaspeech_spk=phase_train_portaspeech_spk(tmp),
                     t5=phase_t5(tmp), vq_ema=phase_t5_vq_small_reference())

    eng = main_path["engine"]
    t2a, inp = t2a_path(eng), inpaint_path(eng)
    i2a_p = i2a_path(i2a["engine"])
    t2i_p, i2t_p = t2i_path(t2i["engine"]), i2t_path(i2t["engine"])
    counts, counts_bf16 = main_path["launches"], bf16_path["launches"]
    wcfg = asr["engine"].cfg
    flash_src = "audiogpt_tpu_torch/csrc/flash_attention_sm90_f32.cu"
    flash_bf16_src = "audiogpt_tpu_torch/csrc/flash_attention_sm90.cu"
    flash_tpu = "audiogpt_tpu/ops/flash_attention.py:143"
    snake_src = "audiogpt_tpu_torch/csrc/snake_aa.cu"
    snake_tpu = "audiogpt_tpu/ops/snake_aa.py:117"

    def f32(c, name):
        return c[name] - c[f"{name}_bf16"]

    def none_launched(k, name):
        """The singing, style-transfer, GeneFace and PortaSpeech paths,
        the TTS, SVS, face, LDM-family and analysis training runs (FS2, the
        vocoder GAN, the PortaSpeech family, GenerSpeech, the pitch
        extractor, DiffSinger, VISinger, Audio2Motion, the VAE, CLAP, SED,
        captioning, separation, PortaSpeech with 400 speakers), the
        checkpoint import, ``infer_cli``'s ``tts`` and ``enhance``, the
        GPT-2 refiner, the T5 text tower and the VQ's EMA update, which
        launch neither kernel."""
        return [path_record(k, key, Counter(), f32(quiet[key]["launches"],
                                                   name))
                for key in quiet]

    emit({"kernels": [
        kernel_entry(flash["float32"], [
            path_record(flash["float32"], "main_path", t2a["flash"],
                        f32(counts, "flash_attention")),
            path_record(flash["float32"], "inpaint", inp["flash"],
                        f32(inpaint["launches"], "flash_attention")),
            path_record(flash["float32"], "asr",
                        asr_flash_shapes(wcfg, asr["batches"]),
                        f32(asr["launches"], "flash_attention")),
            path_record(flash["float32"], "asr_long",
                        asr_flash_shapes(wcfg, asr_long["batches"]),
                        f32(asr_long["launches"], "flash_attention")),
            path_record(flash["float32"], "i2a", i2a_p["flash"],
                        f32(i2a["launches"], "flash_attention")),
            path_record(flash["float32"], "t2i", t2i_p["flash"],
                        f32(t2i["launches"], "flash_attention")),
            path_record(flash["float32"], "i2t", i2t_p["flash"],
                        f32(i2t["launches"], "flash_attention")),
            *(path_record(flash["float32"], key,
                          sed_pvt[key]["path"]["flash"],
                          f32(sed_pvt[key]["launches"], "flash_attention"))
              for key in ("sed_pvt", "sed_pvt_32s")),
            path_record(flash["float32"], "t2a_htsat", t2a["flash"],
                        f32(t2a_htsat["launches"], "flash_attention")),
            path_record(flash["float32"], "t2a_mesh", t2a_mesh["flash"],
                        f32(t2a_mesh["launches"], "flash_attention")),
            path_record(flash["float32"], "t2i_mesh", t2i_mesh["flash"],
                        f32(t2i_mesh["launches"], "flash_attention")),
            path_record(flash["float32"], "train_ldm", train["shapes"],
                        f32(train["launches"], "flash_attention")),
            path_record(flash["float32"], "train_ddp_ldm", ddp["shapes"],
                        f32(ddp["launches"], "flash_attention")),
            path_record(flash["float32"], "train_ddp_gloo_small",
                        ddp_small["shapes"],
                        f32(ddp_small["launches"], "flash_attention")),
            path_record(flash["float32"], "infer_cli_t2a",
                        cli["t2a"]["flash"],
                        f32(cli["t2a"]["launches"], "flash_attention")),
            *none_launched(flash["float32"], "flash_attention")],
            flash_src, flash_tpu),
        kernel_entry(flash["bfloat16"], [
            path_record(flash["bfloat16"], "main_path_bf16", t2a["flash"],
                        counts_bf16["flash_attention_bf16"]),
            path_record(flash["bfloat16"], "asr_bf16",
                        asr_flash_shapes(wcfg, asr_bf16["batches"]),
                        asr_bf16["launches"]["flash_attention_bf16"]),
            path_record(flash["bfloat16"], "t2i_bf16", t2i_p["flash"],
                        t2i_bf16["launches"]["flash_attention_bf16"]),
            path_record(flash["bfloat16"], "train_ldm_bf16",
                        train_bf16["shapes"],
                        train_bf16["launches"]["flash_attention_bf16"]),
            path_record(flash["bfloat16"], "train_ldm_bf16_ckpt",
                        train_ckpt["shapes"],
                        train_ckpt["launches"]["flash_attention_bf16"])],
            flash_bf16_src, flash_tpu),
        kernel_entry(snake["float32"], [
            path_record(snake["float32"], "main_path", t2a["snake"],
                        f32(counts, "snake_aa")),
            path_record(snake["float32"], "main_path_bf16", t2a["snake"],
                        f32(counts_bf16, "snake_aa")),
            path_record(snake["float32"], "inpaint", inp["snake"],
                        f32(inpaint["launches"], "snake_aa")),
            path_record(snake["float32"], "i2a", i2a_p["snake"],
                        f32(i2a["launches"], "snake_aa")),
            path_record(snake["float32"], "t2a_htsat", t2a["snake"],
                        f32(t2a_htsat["launches"], "snake_aa")),
            path_record(snake["float32"], "t2a_mesh", t2a_mesh["snake"],
                        f32(t2a_mesh["launches"], "snake_aa")),
            path_record(snake["float32"], "t2i_mesh", Counter(),
                        f32(t2i_mesh["launches"], "snake_aa")),
            path_record(snake["float32"], "infer_cli_t2a",
                        cli["t2a"]["snake"],
                        f32(cli["t2a"]["launches"], "snake_aa")),
            *(path_record(snake["float32"], key, Counter(),
                          run["launches"]["snake_aa"])
              for key, run in (("train_ldm", train),
                               ("train_ldm_bf16", train_bf16),
                               ("train_ldm_bf16_ckpt", train_ckpt),
                               ("train_ddp_ldm", ddp),
                               ("train_ddp_gloo_small", ddp_small))),
            *none_launched(snake["float32"], "snake_aa")],
            snake_src, snake_tpu),
        kernel_entry(snake["bfloat16"], [
            path_record(snake["bfloat16"], "vocoder_bf16", t2a["snake"],
                        vocoder_bf16["launches"]["snake_aa_bf16"])],
            snake_src, snake_tpu)]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        sys.exit(ddp_small_child(sys.argv[1:]))
    sys.exit(main())
