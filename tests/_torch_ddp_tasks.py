"""The 17 recipes of the training CLI at tiny widths, with seeded batches,
for the data-parallel tests (``tests/test_torch_ddp.py``).

This module imports torch, numpy and the port only: the two gloo children
of ``tests/_torch_ddp_child.py`` import it beside the pytest process. The
widths are those of the port's ``tests/test_torch_*_train.py`` files; each
batch is built from a numpy seed with an even number of rows (two ranks),
a padded row of weight 0 where the recipe's collate makes one.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from audiogpt_tpu_torch.models.caption.captioner import CaptionConfig
from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config
from audiogpt_tpu_torch.models.diffusion import UNetConfig, VAEConfig
from audiogpt_tpu_torch.models.face.audio2motion import (
    Audio2MotionConfig, pseudo_motion_targets)
from audiogpt_tpu_torch.models.sed.panns_sed import SEDConfig
from audiogpt_tpu_torch.models.separation.convtasnet import ConvTasNetConfig
from audiogpt_tpu_torch.models.svs.diffsinger import (DiffNetConfig,
                                                      DiffSingerConfig)
from audiogpt_tpu_torch.models.svs.visinger import VISingerConfig
from audiogpt_tpu_torch.models.textenc import CLAPTextConfig
from audiogpt_tpu_torch.models.textenc.bert import BertConfig
from audiogpt_tpu_torch.models.tts import FastSpeech2Config
from audiogpt_tpu_torch.models.tts.generspeech import GenerSpeechConfig
from audiogpt_tpu_torch.models.tts.pitch_extractor import PitchExtractorConfig
from audiogpt_tpu_torch.models.tts.portaspeech import PortaSpeechConfig
from audiogpt_tpu_torch.models.vocoder.discriminators import \
    DiscriminatorConfig
from audiogpt_tpu_torch.models.vocoder.hifigan import HifiGANConfig
from audiogpt_tpu_torch.train import Trainer, TrainerConfig
from audiogpt_tpu_torch.train import tasks as T

#: steps of each recipe; the logged keys that are host times
STEPS = 2
TIMED = ("t", "steps_per_sec", "mfu")

# -- widths (the port's training tests) ---------------------------------------

UNET = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
            num_heads=4, context_dim=24, in_channels=4)
LDM_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
               in_channels=1, z_channels=4, resolution=16)
BERT = dict(vocab_size=100, hidden_size=16, num_layers=1, num_heads=2,
            intermediate_size=32)
VAE = dict(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
           resolution=16)
CHANNELS = (4, 4, 8, 8, 16, 16)
FS2 = dict(vocab_size=30, hidden_size=16, enc_layers=1, dec_layers=1,
           num_heads=2, enc_ffn_kernel_size=3, dec_ffn_kernel_size=3,
           dur_predictor_layers=1, predictor_layers=2, predictor_hidden=8,
           max_frames=64)
GEN = dict(in_channels=20, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))
DISC = dict(periods=(2, 3), scales=2, period_channels=(4, 8),
            scale_channels=(8, 16, 16), scale_groups=(1, 1, 1))
PH_VOCAB = 80
PS = dict(ph_vocab_size=PH_VOCAB, word_vocab_size=20, hidden_size=16,
          enc_layers=1, word_enc_layers=1, num_heads=2,
          enc_ffn_kernel_size=3, dur_predictor_layers=1, n_mels=16,
          max_frames=64, latent_size=4, fvae_hidden=8, fvae_enc_layers=2,
          fvae_dec_layers=1, prior_flow_hidden=8, prior_flow_blocks=2,
          graph_steps=2, num_spk=3)
WINDOWS, DISC_HIDDEN = (8, 16), 8
GS_MELS = 20
GS_FS2 = dict(vocab_size=90, hidden_size=16, enc_layers=1, dec_layers=1,
              num_heads=2, enc_ffn_kernel_size=3, dec_ffn_kernel_size=3,
              n_mels=GS_MELS, dur_predictor_layers=1, predictor_layers=1,
              predictor_hidden=8, max_frames=64)
GS = dict(n_vq=8, emb_dim=16, glow_hidden=16, glow_steps=2, glow_wn_layers=2)
PE = dict(n_mels=GS_MELS, hidden=16, prenet_layers=2, conv_layers=1,
          predictor_layers=2)
SVS_M = 16
SVS_FS2 = dict(use_midi=True, rel_pos=True, vocab_size=30, hidden_size=16,
               enc_layers=1, dec_layers=1, num_heads=2, enc_ffn_kernel_size=3,
               dec_ffn_kernel_size=3, dur_predictor_layers=1,
               predictor_layers=1, predictor_hidden=8, max_frames=64,
               n_mels=SVS_M)
NET = dict(mel_bins=SVS_M, encoder_hidden=16, residual_layers=2,
           residual_channels=8)
DS = dict(timesteps=50, K_step=40, spec_min=(-6.0,) * SVS_M,
          spec_max=(1.5,) * SVS_M)
VIS = dict(vocab_size=30, hidden=16, enc_layers=1, enc_heads=2, latent_dim=8,
           spec_bins=33, posterior_layers=2, flow_layers=2, flow_wn_layers=1,
           max_frames=64)
DEC = dict(in_channels=8, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))
A2M = dict(mel_bins=SVS_M, hidden=16, latent=4, conv_layers=2)
CAPTION = dict(rnn_hidden=8, vocab_size=40, emb_dim=16, nhead=2, nlayers=1,
               dim_feedforward=32, max_caption_len=8)
TASNET = dict(enc_dim=32, bottleneck=8, hidden=16, skip=8, n_blocks=2,
              n_repeats=1, sample_rate=8000)

# -- batches ------------------------------------------------------------------


def _alignment(rng, n_units, n_frames, width):
    """[B, width] 1-based unit of each frame: each row's units over its
    frames in random runs (0 past its frames)."""
    out = np.zeros((len(n_units), width), np.int32)
    for b, (u, f) in enumerate(zip(n_units, n_frames)):
        if not f:
            continue
        cuts = np.sort(rng.choice(np.arange(1, f), u - 1, replace=False))
        parts = np.diff(np.concatenate([[0], cuts, [f]]))
        out[b, :f] = np.repeat(np.arange(1, u + 1), parts)
    return out


def ldm_batch(seed):
    rng = np.random.default_rng(seed)
    b = 4
    return {"mels": np.tanh(rng.normal(size=(b, 16, 16, 1))).astype(
        np.float32),
        "text_ids": rng.integers(1, 100, (b, 6)).astype(np.int32),
        "text_mask": np.ones((b, 6), np.int32),
        "weight": np.asarray([1, 1, 1, 0], np.float32)}


def vae_batch(seed):
    rng = np.random.default_rng(seed)
    return {"mels": rng.uniform(-1, 1, (2, 16, 20, 1)).astype(np.float32),
            "weight": np.ones(2, np.float32)}


def clap_batch(seed):
    """Rows of at least 9 920 samples (a Cnn14 frame each)."""
    rng = np.random.default_rng(seed)
    b, n = 4, 16000
    t = np.arange(n) / 16000.0
    wav = 0.2 * rng.normal(size=(b, n)) + 0.5 * np.sin(
        2 * np.pi * rng.uniform(200, 3000, (b, 1)) * t)
    lens = np.asarray([n, 12000, 14000, 11000])
    wav = wav * (np.arange(n)[None] < lens[:, None])
    ids = np.zeros((b, 8), np.int32)
    for i, k in enumerate((8, 5, 6, 3)):
        ids[i, :k] = rng.integers(3, 100, k)
    return {"wav": wav.astype(np.float32), "wav_len": lens.astype(np.int32),
            "text_ids": ids, "text_mask": (ids != 0).astype(np.int32),
            "weight": np.asarray([1, 1, 1, 0], np.float32)}


def fs2_batch(seed, n_mels=80):
    """A short item, a dummy row of weight 0, unvoiced frames, energy and
    the CWT targets (``tests/test_torch_fs2_train.py``'s)."""
    rng = np.random.default_rng(seed)
    b, t, f = 4, 12, 64
    tok = rng.integers(3, 30, (b, t)).astype(np.int32)
    tok[1, 9:] = 0
    tok[3, 5:] = 0
    lens = (tok > 0).sum(1)
    mlen = np.array([60, 40, 64, 20])
    mel2ph = np.zeros((b, f), np.int32)
    for i in range(b):
        mel2ph[i, :mlen[i]] = np.minimum(
            np.arange(mlen[i]) * lens[i] // mlen[i] + 1, lens[i])
    valid = mel2ph > 0
    f0 = rng.uniform(100, 300, (b, f)) * (rng.random((b, f)) > 0.2) * valid
    return {"txt_tokens": tok, "txt_lengths": lens.astype(np.int32),
            "mels": (rng.normal(size=(b, f, n_mels)) * valid[..., None]
                     ).astype(np.float32),
            "mel_lengths": mlen.astype(np.int32), "mel2ph": mel2ph,
            "f0": f0.astype(np.float32),
            "weight": np.asarray([1, 1, 1, 0], np.float32),
            "energy": (rng.random((b, f)) * valid).astype(np.float32)}


def gan_batch(seed):
    rng = np.random.default_rng(seed)
    return {"mels": rng.normal(size=(4, 16, 20)).astype(np.float32),
            "wav": (rng.normal(size=(4, 256)) * 0.1).astype(np.float32),
            "weight": np.ones(4, np.float32)}


def ps_batch(seed, graph=False):
    """Three items over 6, 4 and 3 words (64, 48 and 36 frames) and a
    padded row of zeros (weight 0, mel length 0, speaker 0)."""
    rng = np.random.default_rng(seed)
    b, t, w, f = 4, 12, 6, 64
    n_ph, n_w, n_fr = (12, 9, 7, 0), (6, 4, 3, 0), (64, 48, 36, 0)
    batch = {"txt_tokens": np.zeros((b, t), np.int32),
             "ph2word": np.zeros((b, t), np.int32),
             "word_tokens": np.zeros((b, w), np.int32)}
    for i in range(3):
        batch["txt_tokens"][i, :n_ph[i]] = rng.integers(3, PH_VOCAB, n_ph[i])
        batch["ph2word"][i, :n_ph[i]] = np.sort(np.concatenate([
            np.arange(1, n_w[i] + 1),
            rng.integers(1, n_w[i] + 1, n_ph[i] - n_w[i])]))
        batch["word_tokens"][i, :n_w[i]] = rng.integers(3, 20, n_w[i])
    batch["mel2word"] = _alignment(rng, n_w, n_fr, f)
    valid = batch["mel2word"] > 0
    batch["mels"] = (rng.normal(size=(b, f, PS["n_mels"])) * valid[..., None]
                     ).astype(np.float32)
    batch["mel_lengths"] = np.asarray(n_fr, np.int32)
    batch["word_lengths"] = np.asarray(n_w, np.int32)
    batch["weight"] = np.asarray([1, 1, 1, 0], np.float32)
    batch["spk_ids"] = np.asarray((1, 2, 1, 0), np.int32)
    if graph:
        words = np.arange(w)[None] < batch["word_lengths"][:, None]
        adj = rng.random((b, 6, w, w)) < 0.3
        batch["graph_adj"] = (adj * words[:, None, :, None]
                              * words[:, None, None, :]).astype(np.float32)
    return batch


def gs_batch(seed):
    batch = {k: v for k, v in fs2_batch(seed, GS_MELS).items()
             if k in ("txt_tokens", "txt_lengths", "mels", "mel_lengths",
                      "mel2ph", "f0", "weight")}
    batch["mels"] = (batch["mels"] - 3.0 * (batch["mel2ph"] > 0)[..., None]
                     ).astype(np.float32)
    return batch


def pe_batch(seed):
    batch = gs_batch(seed)
    batch["uv"] = (batch["f0"] == 0).astype(np.float32)
    return batch


def score_batch(seed):
    """Three scored items (10, 7 and 4 phones over 64, 40 and 24 frames)
    and a row of zeros: the score fields, mel2ph, f0, a linear spec and the
    wav at hop 16."""
    rng = np.random.default_rng(seed)
    b, t, f = 4, 10, 64
    n_ph, n_fr = (10, 7, 4, 0), (64, 40, 24, 0)
    tok = np.zeros((b, t), np.int32)
    for i in range(3):
        tok[i, :n_ph[i]] = rng.integers(3, 30, n_ph[i])
    mel2ph = _alignment(rng, n_ph, n_fr, f)
    valid, nonpad = mel2ph > 0, tok > 0
    return {
        "txt_tokens": tok, "txt_lengths": np.asarray(n_ph, np.int32),
        "mels": (rng.uniform(-5.5, 1.0, (b, f, SVS_M)) * valid[..., None]
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
        "f0": (rng.uniform(100, 300, (b, f)) * (rng.random((b, f)) > 0.2)
               * valid).astype(np.float32),
        "weight": np.asarray([1, 1, 1, 0], np.float32)}


def motion_batch(seed):
    rng = np.random.default_rng(seed)
    tv = Audio2MotionConfig(**A2M).video_len(64)
    mels = rng.uniform(0, 1, (4, 64, SVS_M)).astype(np.float32)
    motion = np.stack([pseudo_motion_targets(m, tv) for m in mels])
    motion = motion + 0.01 * rng.normal(size=motion.shape)
    return {"mels": mels, "motion": motion.astype(np.float32),
            "weight": np.asarray([1, 1, 1, 0], np.float32)}


def _clips(rng, b, n, sr):
    t = np.arange(n) / sr
    f = rng.uniform(200, 4000, b)[:, None]
    return 0.2 * rng.normal(size=(b, n)) + 0.5 * np.sin(2 * np.pi * f * t)


def sed_batch(seed):
    """1 s clips at 32 kHz (three Cnn14 frames), strong labels over the
    first 32 frames, a weight-0 row."""
    rng = np.random.default_rng(seed)
    b, n = 4, 32000
    lens = np.asarray([n, 24000, 28000, 20000], np.int32)
    wav = _clips(rng, b, n, 32000) * (np.arange(n)[None] < lens[:, None])
    return {"wav": wav.astype(np.float32), "wav_len": lens,
            "target": (rng.random((b, 10)) < 0.3).astype(np.float32),
            "frame_target": (rng.random((b, 32, 10)) < 0.2
                             ).astype(np.float32),
            "weight": np.asarray([1, 1, 0, 1], np.float32)}


def caption_batch(seed):
    rng = np.random.default_rng(seed)
    b, n, text_len = 4, 32000, 7
    lens = np.asarray([n, 26000, 30000, 28000], np.int32)
    wav = _clips(rng, b, n, 32000) * (np.arange(n)[None] < lens[:, None])
    tok_len = np.asarray([6, 4, 5, 7], np.int32)
    tokens = np.zeros((b, text_len), np.int32)
    for i, k in enumerate(tok_len):
        tokens[i, 1:k] = rng.integers(1, CAPTION["vocab_size"], k - 1)
    return {"wav": wav.astype(np.float32), "wav_len": lens, "tokens": tokens,
            "token_len": tok_len,
            "weight": np.asarray([1, 0, 1, 1], np.float32)}


def mixture_batch(seed):
    rng = np.random.default_rng(seed)
    b, n = 4, 4000
    t = np.arange(n) / 8000.0
    src = (0.3 * rng.normal(size=(b, 2, n))
           + np.sin(2 * np.pi * rng.uniform(100, 1500, (b, 2, 1)) * t))
    src = src.astype(np.float32)
    return {"mix": src.sum(1), "sources": src,
            "weight": np.asarray([1, 1, 0, 1], np.float32)}


# -- the recipes --------------------------------------------------------------


def _ps(graph=False):
    return T.PortaSpeechTaskConfig(
        model=PortaSpeechConfig(**PS, use_graph=graph), lambda_sent_dur=0.5,
        kl_start_steps=100)


def _ps_adv(graph=False):
    return T.PortaSpeechAdvTaskConfig(ps=_ps(graph), disc_windows=WINDOWS,
                                      disc_hidden=DISC_HIDDEN)


#: name → (the task built on ``device``, the batch of a seed)
RECIPES = {
    "ldm": (lambda device: T.LDMTask(T.LDMTaskConfig(
        unet=UNetConfig(use_checkpoint=False, **UNET),
        vae=VAEConfig(**LDM_VAE),
        clap=CLAPTextConfig(bert=BertConfig(**BERT), d_proj=24),
        timesteps=50, cond_drop_prob=0.3, scale_factor=0.18215),
        device=device), ldm_batch),
    "vae": (lambda device: T.VAETask(T.VAETaskConfig(vae=VAEConfig(**VAE)),
                                     device=device), vae_batch),
    "clap": (lambda device: T.CLAPTask(T.CLAPTaskConfig(
        text=CLAPTextConfig(bert=BertConfig(**BERT, max_position=32),
                            d_proj=16),
        d_proj=16, audio=Cnn14Config(channels=CHANNELS)), device=device),
        clap_batch),
    "fs2": (lambda device: T.FS2Task(T.FS2TaskConfig(
        model=FastSpeech2Config(**FS2)), device=device), fs2_batch),
    "vocoder_gan": (lambda device: T.VocoderGANTask(T.VocoderGANTaskConfig(
        gen=HifiGANConfig(**GEN), disc=DiscriminatorConfig(**DISC),
        segment_frames=16, lambda_stft=1.0), device=device), gan_batch),
    "portaspeech": (lambda device: T.PortaSpeechTask(_ps(), device=device),
                    ps_batch),
    "syntaspeech": (lambda device: T.PortaSpeechTask(_ps(True),
                                                     device=device),
                    lambda seed: ps_batch(seed, graph=True)),
    "ps_adv": (lambda device: T.PortaSpeechAdvTask(_ps_adv(), device=device),
               ps_batch),
    "synta_adv": (lambda device: T.PortaSpeechAdvTask(_ps_adv(True),
                                                      device=device),
                  lambda seed: ps_batch(seed, graph=True)),
    "generspeech": (lambda device: T.GenerSpeechTask(T.GenerSpeechTaskConfig(
        model=GenerSpeechConfig(fs2=FastSpeech2Config(**GS_FS2), **GS)),
        device=device), gs_batch),
    "pe": (lambda device: T.PETask(T.PETaskConfig(
        model=PitchExtractorConfig(**PE)), device=device), pe_batch),
    "diffsinger": (lambda device: T.DiffSingerTask(T.DiffSingerTaskConfig(
        model=DiffSingerConfig(fs2=FastSpeech2Config(**SVS_FS2),
                               net=DiffNetConfig(**NET), **DS)),
        device=device), score_batch),
    "visinger": (lambda device: T.VISingerTask(T.VISingerTaskConfig(
        model=VISingerConfig(decoder=HifiGANConfig(**DEC), **VIS),
        disc=DiscriminatorConfig(**DISC)), device=device), score_batch),
    "audio2motion": (lambda device: T.Audio2MotionTask(
        T.Audio2MotionTaskConfig(model=Audio2MotionConfig(**A2M)),
        device=device), motion_batch),
    "sed": (lambda device: T.SEDTask(T.SEDTaskConfig(model=SEDConfig(
        cnn14=Cnn14Config(channels=CHANNELS), classes_num=10)),
        device=device), sed_batch),
    "caption": (lambda device: T.CaptionTask(T.CaptionTaskConfig(
        model=CaptionConfig(cnn14=Cnn14Config(channels=CHANNELS),
                            **CAPTION)), device=device), caption_batch),
    "separation": (lambda device: T.SeparationTask(T.SeparationTaskConfig(
        model=ConvTasNetConfig(n_src=2, **TASNET)), device=device),
        mixture_batch),
}


_NORMS = (torch.nn.LayerNorm, torch.nn.GroupNorm, torch.nn.BatchNorm1d,
          torch.nn.BatchNorm2d)


def fill_random(task, seed: int) -> None:
    """Every parameter of the task's modules refilled from a numpy seed, as
    the training tests fill JAX's tree (``test_torch_t2a._random_params``):
    kernels normal · fan_in^-½, norm scales 1 + 0.1·N, every other vector
    0.1·N, so no zero-initialised layer leaves a gradient at zero."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for key in sorted(task.modules):
            module = task.modules[key]
            owners = {f"{n}.weight" if n else "weight": m
                      for n, m in module.named_modules()}
            for name, p in module.named_parameters():
                if p.dim() == 0:
                    continue
                a = rng.randn(*p.shape)
                if p.dim() >= 2:
                    a = a / np.sqrt(p[0].numel())
                elif isinstance(owners.get(name), _NORMS):
                    a = 1.0 + 0.1 * a
                else:
                    a = 0.1 * a
                p.copy_(torch.from_numpy(a.astype(np.float32)))


def run_recipe(name: str, work_dir: str, mesh=None, device="cpu",
               steps: int = STEPS) -> dict:
    """``steps`` trainer steps of recipe ``name`` (its parameters refilled
    by :func:`fill_random`) on the batches of seeds 0, 1, ... after a
    sanity validation on the batch of seed 100, through ``Trainer.fit`` on
    ``mesh`` (None: the trainer's default) → {"log": the logged lines
    without their host times (rank 0; [] elsewhere), "params": each
    optimized group's parameters after the run, "grads": the gradients
    each optimizer step consumed (the ranks' mean), "lr": its rate}."""
    build, batch_of = RECIPES[name]
    task = build(device)
    fill_random(task, seed=sorted(RECIPES).index(name))
    trainer = Trainer(task, TrainerConfig(
        work_dir=work_dir, log_interval=1, val_check_interval=10 ** 6,
        num_sanity_val_steps=1, use_tensorboard=False), device=device,
        mesh=mesh)
    grads = {g: [] for g in trainer.groups}
    lrs = {g: [] for g in trainer.groups}
    for g, opt in trainer.opt.items():
        def step(gs, g=g, opt=opt, real=opt.step):
            grads[g].append([x.detach().cpu().clone() for x in gs])
            lrs[g].append(float(opt.schedule(opt.count)))
            real(gs)
        opt.step = step
    trainer.fit([batch_of(seed) for seed in range(steps)],
                lambda: [batch_of(100)], max_updates=steps)
    trainer.logger.close()
    log = []
    if trainer.logger.is_main:
        with open(os.path.join(work_dir, "metrics.jsonl")) as f:
            log = [{k: v for k, v in json.loads(line).items()
                    if k not in TIMED} for line in f]
    return {"log": log, "grads": grads, "lr": lrs,
            "params": {g: {n: p.detach().cpu().clone()
                           for n, p in trainer.named[g]}
                       for g in trainer.groups}}


def tp_fs2_config() -> FastSpeech2Config:
    """``tests/test_mesh.py``'s FS2 for the tensor-parallel forward."""
    return FastSpeech2Config(
        vocab_size=30, hidden_size=64, enc_layers=1, dec_layers=1,
        num_heads=2, enc_ffn_kernel_size=3, dec_ffn_kernel_size=3,
        n_mels=16, dur_predictor_layers=1, predictor_layers=1,
        predictor_hidden=64, max_frames=32)


def tp_fs2_inputs():
    """The seeded FS2 and its inputs: ``test_mesh.py``'s tokens with the
    ground-truth alignment and f0, so no rounded duration or pitch bin
    decides the output."""
    from audiogpt_tpu_torch.engines.base import seeded
    from audiogpt_tpu_torch.models.tts.fastspeech2 import FastSpeech2

    model = seeded(3, lambda: FastSpeech2(tp_fs2_config())).eval()
    tokens = torch.tensor([[3, 5, 7, 9]] * 4)
    mel2ph = torch.arange(1, 5).repeat_interleave(6)[None].repeat(4, 1)
    f0 = torch.linspace(-1.0, 1.0, 24)[None].repeat(4, 1)
    return model, {"tokens": tokens, "mel2ph": mel2ph, "f0": f0,
                   "uv": torch.zeros(4, 24)}

