"""Checkpoint import: the port's converters (``utils/torch_import.py``) and
``import_ckpt`` against the JAX package's, with no reference code.

For each of the 24 converter families the test writes a reference-layout
state dict at a tiny config: a port module of the family (its parameters
and statistics filled with seeded numbers) is renamed key by key to the
reference checkpoint's names (HiFi-GAN's convs as weight-norm pairs, the
GRUs as one bidirectional ``nn.GRU``, the captioner's packed in-projection
transposed, CLIP-HF's and BLIP's split or reshaped as the HF modules hold
them). The JAX converter and the port's give equal trees (names, shapes, dtypes, values: bitwise); the
tree loads strictly into a fresh port module, which then holds the first
module's numbers (bitwise, the weight-norm folds within 1e-6). HiFi-GAN's
and the captioner's forwards on the imported weights equal the JAX
modules' on the JAX-imported ones (f32, 1e-5)."""

import functools
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiogpt_tpu.import_ckpt as jic
from audiogpt_tpu_torch import import_ckpt as ic
from audiogpt_tpu_torch.dsp.mel import MelSpec
from audiogpt_tpu_torch.models.asr.whisper import WhisperConfig, WhisperModel
from audiogpt_tpu_torch.models.binaural.binaural import (BinauralConfig,
                                                         BinauralNetwork)
from audiogpt_tpu_torch.models.caption.blip import (BlipCaptioner,
                                                    BlipConfig,
                                                    BlipTextConfig,
                                                    BlipVisionConfig)
from audiogpt_tpu_torch.models.caption.captioner import (CaptionConfig,
                                                         CaptionModel)
from audiogpt_tpu_torch.models.caption.cnn14 import Cnn14Config, Cnn14Encoder
from audiogpt_tpu_torch.models.diffusion import (AutoencoderKL, UNetConfig,
                                                 UNetModel, VAEConfig)
from audiogpt_tpu_torch.models.extraction.lassnet import (LASSNet,
                                                          LASSNetConfig)
from audiogpt_tpu_torch.models.sed.pvt import PVTSED, PVTConfig
from audiogpt_tpu_torch.models.sed.tsd import TSDConfig, TSDModel
from audiogpt_tpu_torch.models.svs.diffsinger import (DiffNet, DiffNetConfig,
                                                      DiffSinger,
                                                      DiffSingerConfig)
from audiogpt_tpu_torch.models.textenc.bert import BertConfig, BertEncoder
from audiogpt_tpu_torch.models.textenc.clap import (CLAPTextConfig,
                                                    CLAPTextEncoder)
from audiogpt_tpu_torch.models.textenc.clip import (CLIPTextConfig,
                                                    CLIPTextTower,
                                                    CLIPVisionConfig,
                                                    CLIPVisionEncoder)
from audiogpt_tpu_torch.models.textenc.gpt2 import GPT2Config, GPT2LM
from audiogpt_tpu_torch.models.textenc.htsat import (HTSATAudioEncoder,
                                                     HTSATConfig)
from audiogpt_tpu_torch.models.textenc.t5 import T5Config, T5Encoder
from audiogpt_tpu_torch.models.tts.fastspeech2 import (FastSpeech2,
                                                       FastSpeech2Config)
from audiogpt_tpu_torch.models.vocoder import (BigVGANConfig,
                                               BigVGANGenerator,
                                               HifiGANConfig,
                                               HifiGANGenerator, PWGConfig,
                                               PWGGenerator)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(2)

BERT = BertConfig(vocab_size=50, hidden_size=16, num_layers=1, num_heads=2,
                  intermediate_size=32, max_position=16)
CNN = Cnn14Config(channels=(4, 4, 8, 8, 16, 16))
FS2 = FastSpeech2Config(hidden_size=16, enc_layers=1, dec_layers=1,
                        max_frames=64, predictor_layers=2,
                        enc_ffn_kernel_size=3, dec_ffn_kernel_size=3)
HIFI = dict(in_channels=8, upsample_initial_channel=16, upsample_rates=(4, 4),
            upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 3), (1, 3)))
CAPTION = dict(rnn_hidden=8, vocab_size=40, emb_dim=16, nhead=2, nlayers=1,
               dim_feedforward=32, max_caption_len=8)
NET = DiffNetConfig(mel_bins=8, encoder_hidden=16, residual_layers=2,
                    residual_channels=8)

#: family → (port config, module builder)
FAMILIES = {
    "hifigan": (HifiGANConfig(**HIFI), HifiGANGenerator),
    "bigvgan": (BigVGANConfig(
        num_mels=8, upsample_initial_channel=16, upsample_rates=(4, 4),
        upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
        resblock_dilation_sizes=((1, 3), (1, 3))), BigVGANGenerator),
    "whisper": (WhisperConfig(
        n_mels=8, n_audio_ctx=8, n_audio_state=16, n_audio_head=2,
        n_audio_layer=1, n_vocab=60, n_text_ctx=8, n_text_state=16,
        n_text_head=2, n_text_layer=1), WhisperModel),
    "fastspeech2": (FS2, FastSpeech2),
    "ldm_unet": (UNetConfig(model_channels=32, num_res_blocks=1,
                            channel_mult=(1, 2), num_heads=4, context_dim=32,
                            attention_resolutions=(2,)), UNetModel),
    "vae": (VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(8,), resolution=16), AutoencoderKL),
    "bert": (BERT, BertEncoder),
    "clap_text": (CLAPTextConfig(bert=BERT, d_proj=16), CLAPTextEncoder),
    "diffnet": (NET, DiffNet),
    "cnn14": (CNN, lambda c: Cnn14Encoder(c, with_head=True)),
    "pwg": (PWGConfig(layers=2, stacks=1, residual_channels=8,
                      gate_channels=16, skip_channels=8, aux_channels=8,
                      upsample_scales=(2, 3), upsample="conv_in"),
            PWGGenerator),
    "caption": (CaptionConfig(cnn14=CNN, **CAPTION), CaptionModel),
    "pvt": (PVTConfig(classes_num=10, embed_dims=(8, 16), depths=(1, 2),
                      num_heads=(1, 2), mlp_ratios=(2, 2), sr_ratios=(2, 1)),
            PVTSED),
    "lassnet": (LASSNetConfig(bert=BERT, cond_dim=16, enc_channels=(32, 8, 8)),
                LASSNet),
    "tsd": (TSDConfig(embedding_dim=8, gru_hidden=8, channels=(4, 4, 8, 8)),
            TSDModel),
    "binaural": (BinauralConfig(warpnet_channels=8, warpnet_layers=2),
                 BinauralNetwork),
    "clip_vision": (CLIPVisionConfig(image_size=32, patch_size=8, width=16,
                                     layers=2, heads=2, embed_dim=32),
                    CLIPVisionEncoder),
    "clip_text_tower": (CLIPTextConfig(vocab_size=100, context_length=16,
                                       width=16, layers=1, heads=2,
                                       embed_dim=32), CLIPTextTower),
    "diffsinger": (DiffSingerConfig(
        fs2=FastSpeech2Config(use_midi=True, rel_pos=True,
                              use_pitch_embed=False, hidden_size=16,
                              enc_layers=1, dec_layers=1, max_frames=64,
                              enc_ffn_kernel_size=3, dec_ffn_kernel_size=3),
        net=DiffNetConfig(mel_bins=80, encoder_hidden=16, residual_layers=2,
                          residual_channels=8)), DiffSinger),
    "htsat": (HTSATConfig(mel=MelSpec(32000, 1024, 320, 1024, 16, 50.0,
                                      14000.0), spec_size=64, embed_dim=32,
                          depths=(2, 2), num_heads=(2, 4), num_classes=10,
                          d_proj=16), HTSATAudioEncoder),
    "clip_text_hf": (CLIPTextConfig(vocab_size=100, context_length=16,
                                    width=16, layers=2, heads=2,
                                    embed_dim=16), CLIPTextTower),
    "blip": (BlipConfig(
        vision=BlipVisionConfig(image_size=32, width=32, layers=1, heads=2,
                                mlp_dim=64),
        text=BlipTextConfig(vocab_size=60, width=32, layers=1, heads=2,
                            mlp_dim=64, encoder_width=32, bos_id=58,
                            eos_id=59)), BlipCaptioner),
    "gpt2": (GPT2Config(vocab_size=60, n_positions=32, width=16, layers=2,
                        heads=2, eos_id=59), GPT2LM),
    "t5": (T5Config(vocab_size=50, d_model=16, d_kv=8, d_ff=32, num_layers=2,
                    num_heads=2), T5Encoder),
}


# -- reference names ----------------------------------------------------------

def _subs(rules):
    """A renamer from ``(pattern, replacement)`` rules, applied in order."""
    def rename(key):
        for pat, rep in rules:
            key = re.sub(pat, rep, key)
        return key
    return rename


_BERT = [(r"^word_emb\.", "embeddings.word_embeddings."),
         (r"^pos_emb\.", "embeddings.position_embeddings."),
         (r"^type_emb\.", "embeddings.token_type_embeddings."),
         (r"^emb_ln\.", "embeddings.LayerNorm."),
         (r"^layer_(\d+)\.q\.", r"encoder.layer.\1.attention.self.query."),
         (r"^layer_(\d+)\.k\.", r"encoder.layer.\1.attention.self.key."),
         (r"^layer_(\d+)\.v\.", r"encoder.layer.\1.attention.self.value."),
         (r"^layer_(\d+)\.attn_out\.",
          r"encoder.layer.\1.attention.output.dense."),
         (r"^layer_(\d+)\.attn_ln\.",
          r"encoder.layer.\1.attention.output.LayerNorm."),
         (r"^layer_(\d+)\.inter\.", r"encoder.layer.\1.intermediate.dense."),
         (r"^layer_(\d+)\.out\.", r"encoder.layer.\1.output.dense."),
         (r"^layer_(\d+)\.out_ln\.", r"encoder.layer.\1.output.LayerNorm.")]


def _under(prefix, rules, new_prefix):
    """``rules`` applied below ``prefix``, which becomes ``new_prefix``."""
    inner = _subs(rules)

    def rename(key):
        if not key.startswith(prefix):
            return key
        return new_prefix + inner(key[len(prefix):])
    return rename


def _chain(*fns):
    def rename(key):
        for fn in fns:
            key = fn(key)
        return key
    return rename


_FS2 = [(r"^embed_tokens\.", "encoder_embed_tokens."),
        (r"^(encoder|decoder)\.layer_(\d+)\.ln1\.",
         r"\1.layers.\2.op.layer_norm1."),
        (r"^(encoder|decoder)\.layer_(\d+)\.ln2\.",
         r"\1.layers.\2.op.layer_norm2."),
        (r"^(encoder|decoder)\.layer_(\d+)\.attn\.in_proj\.weight",
         r"\1.layers.\2.op.self_attn.in_proj_weight"),
        (r"^(encoder|decoder)\.layer_(\d+)\.attn\.out_proj\.",
         r"\1.layers.\2.op.self_attn.out_proj."),
        (r"^(encoder|decoder)\.layer_(\d+)\.ffn_conv\.",
         r"\1.layers.\2.op.ffn.ffn_1."),
        (r"^(encoder|decoder)\.layer_(\d+)\.ffn_out\.",
         r"\1.layers.\2.op.ffn.ffn_2."),
        (r"^(encoder|decoder)\.ln\.", r"\1.layer_norm."),
        (r"^(\w+)\.pos_alpha$", r"\1.pos_embed_alpha"),
        (r"^(\w+_predictor)\.conv_(\d+)\.", r"\1.conv.\2.1."),
        (r"^(\w+_predictor)\.ln_(\d+)\.", r"\1.conv.\2.3."),
        (r"^(\w+_predictor)\.out\.", r"\1.linear.")]
_DIFFNET = [(r"^mlp_(\d)\.", r"mlp.\1."),
            (r"^res_(\d+)_diff\.", r"residual_layers.\1.diffusion_projection."),
            (r"^res_(\d+)_dilated\.", r"residual_layers.\1.dilated_conv."),
            (r"^res_(\d+)_cond\.",
             r"residual_layers.\1.conditioner_projection."),
            (r"^res_(\d+)_out\.", r"residual_layers.\1.output_projection.")]
_CLIP_BLOCK = [(r"^block(\d+)\.ln_(\d)\.", r"transformer.resblocks.\1.ln_\2."),
               (r"^block(\d+)\.in_proj\.(weight|bias)",
                r"transformer.resblocks.\1.attn.in_proj_\2"),
               (r"^block(\d+)\.out_proj\.",
                r"transformer.resblocks.\1.attn.out_proj."),
               (r"^block(\d+)\.mlp_fc\.", r"transformer.resblocks.\1.mlp.c_fc."),
               (r"^block(\d+)\.mlp_proj\.",
                r"transformer.resblocks.\1.mlp.c_proj.")]
_FILM = [(r"\.film(1|2|_res)\.l1\.", r".film\1.linear.0."),
         (r"\.film(1|2|_res)\.l2\.", r".film\1.linear.2.")]


def _hifigan_like(cfg, amp):
    nk = len(cfg.resblock_kernel_sizes)

    def block(m):
        i, j, kind, n = (int(m.group(1)), int(m.group(2)), m.group(3),
                         int(m.group(4)))
        r = f"resblocks.{i * nk + j}"
        if kind == "SnakeAA":
            return f"{r}.activations.{n}.act."
        return f"{r}.convs{1 + n % 2}.{n // 2}."

    pre = "amp" if amp else "res"
    return _subs([(r"^conv_(pre|post)\.Conv_0\.", r"conv_\1."),
                  (r"^up_(\d+)\.", r"ups.\1.0." if amp else r"ups.\1."),
                  (rf"^{pre}_(\d+)_(\d+)\.(Conv1d|SnakeAA)_(\d+)\."
                   r"(?:Conv_0\.)?", block),
                  (r"^act_post\.", "activation_post.act.")])


def _unet(cfg):
    top = {"time_embed_0": "time_embed.0", "time_embed_2": "time_embed.2",
           "in_conv": "input_blocks.0.0", "out_norm": "out.0",
           "out_conv": "out.2", "mid_res1": "middle_block.0",
           "mid_attn": "middle_block.1", "mid_res2": "middle_block.2"}
    idx, ds, levels = 1, 1, len(cfg.channel_mult)
    for level in range(levels):
        for i in range(cfg.num_res_blocks):
            top[f"down_{level}_{i}_res"] = f"input_blocks.{idx}.0"
            if ds in cfg.attention_resolutions:
                top[f"down_{level}_{i}_attn"] = f"input_blocks.{idx}.1"
            idx += 1
        if level != levels - 1:
            top[f"down_{level}_ds"] = f"input_blocks.{idx}.0"
            idx, ds = idx + 1, ds * 2
    idx = 0
    for level in reversed(range(levels)):
        for i in range(cfg.num_res_blocks + 1):
            top[f"up_{level}_{i}_res"] = f"output_blocks.{idx}.0"
            sub = 1
            if ds in cfg.attention_resolutions:
                top[f"up_{level}_{i}_attn"] = f"output_blocks.{idx}.1"
                sub += 1
            if level and i == cfg.num_res_blocks:
                top[f"up_{level}_us"] = f"output_blocks.{idx}.{sub}"
                ds //= 2
            idx += 1
    inner = _subs([(r"^\.in_norm\.GroupNorm_0\.", ".in_layers.0."),
                   (r"^\.in_conv\.", ".in_layers.2."),
                   (r"^\.emb_proj\.", ".emb_layers.1."),
                   (r"^\.out_norm\.GroupNorm_0\.", ".out_layers.0."),
                   (r"^\.out_conv\.", ".out_layers.3."),
                   (r"^\.skip\.", ".skip_connection."),
                   (r"\.GroupNorm_0\.", "."),
                   (r"\.block_(\d+)\.", r".transformer_blocks.\1."),
                   (r"\.to_out\.", ".to_out.0."),
                   (r"\.ff\.proj\.", ".ff.net.0.proj."),
                   (r"\.ff\.out\.", ".ff.net.2.")])

    def rename(key):
        head, _, rest = key.partition(".")
        return "model.diffusion_model." + top[head] + inner("." + rest)
    return rename


def _whisper(key):
    return "model." + _subs([
        (r"\.block_(\d+)\.", r".layers.\1."),
        (r"\.attn\.(q|k|v)\.", r".self_attn.\1_proj."),
        (r"\.attn\.out\.", ".self_attn.out_proj."),
        (r"\.cross_attn\.(q|k|v)\.", r".encoder_attn.\1_proj."),
        (r"\.cross_attn\.out\.", ".encoder_attn.out_proj."),
        (r"\.attn_ln\.", ".self_attn_layer_norm."),
        (r"\.cross_attn_ln\.", ".encoder_attn_layer_norm."),
        (r"\.mlp_ln\.", ".final_layer_norm."),
        (r"^encoder\.ln_post\.", "encoder.layer_norm."),
        (r"^decoder\.ln\.", "decoder.layer_norm."),
        (r"^decoder\.token_embedding\.", "decoder.embed_tokens."),
        (r"^decoder\.positional_embedding$",
         "decoder.embed_positions.weight")])(key)


RENAMES = {
    "whisper": _whisper,
    "fastspeech2": lambda k: "model." + _subs(_FS2)(k),
    "vae": lambda k: "first_stage_model." + _subs([
        (r"\.GroupNorm_0\.", "."),
        (r"^(encoder|decoder)\.(down|up)_(\d+)_(block|attn)_(\d+)\.",
         r"\1.\2.\3.\4.\5."),
        (r"^(encoder|decoder)\.(down|up)_(\d+)_(downsample|upsample)\.",
         r"\1.\2.\3.\4."),
        (r"^(encoder|decoder)\.mid_", r"\1.mid.")])(k),
    "bert": lambda k: "bert." + _subs(_BERT)(k),
    "clap_text": lambda k: "caption_encoder." + _chain(
        _under("base.", _BERT, "base."),
        _subs([(r"^projection\.ln\.", "projection.layer_norm.")]))(k),
    "diffnet": lambda k: "denoise_fn." + _subs(_DIFFNET)(k),
    "cnn14": lambda k: k,
    "pwg": lambda k: "model_gen." + _subs([
        (r"^upsample_net\.up(\d+)\.",
         lambda m: f"upsample_net.upsample.up_layers."
                   f"{2 * int(m.group(1)) + 1}."),
        (r"^block(\d+)\.", r"conv_layers.\1."),
        (r"^post1\.", "last_conv_layers.1."),
        (r"^post2\.", "last_conv_layers.3.")])(k),
    "caption": lambda k: "model." + _subs([
        (r"^cnn\.", "encoder.cnn."),
        (r"^rnn\.fwd\.(\w+)$", r"encoder.rnn.network.\1"),
        (r"^rnn\.bwd\.(\w+)$", r"encoder.rnn.network.\1_reverse"),
        (r"^word_embedding\.", "decoder.word_embedding."),
        (r"^attn_proj_fc\.", "decoder.attn_proj.0."),
        (r"^attn_proj_ln\.", "decoder.attn_proj.3."),
        (r"^dec_layer_(\d+)\.", r"decoder.model.layers.\1."),
        (r"^classifier\.", "decoder.classifier.")])(k),
    "pvt": _subs([(r"^patch_embed(\d+)\.",
                   lambda m: f"pvt_transformer.patch_embed"
                             f"{int(m.group(1)) + 1}."),
                  (r"^stage(\d+)_block(\d+)\.",
                   lambda m: f"pvt_transformer.block{int(m.group(1)) + 1}."
                             f"{m.group(2)}."),
                  (r"^stage(\d+)_norm\.",
                   lambda m: f"pvt_transformer.norm{int(m.group(1)) + 1}."),
                  (r"\.attn\.sr_norm\.", ".attn.norm."),
                  (r"\.ffn\.dwconv\.", ".mlp.dwconv.dwconv."),
                  (r"\.ffn\.", ".mlp.")]),
    "lassnet": lambda k: "module." + _chain(
        _under("text_encoder.", _BERT, "text_embedder.bert_layer."),
        _subs([(r"^text_proj\.", "text_embedder.linear_layer.0."),
               (r"^unet\.enc_(\d+)\.cb(\d)\.",
                lambda m: f"UNet.encoder_block{int(m.group(1)) + 1}."
                          f"conv_block{m.group(2)}."),
               (r"^unet\.center\.", "UNet.conv_block7."),
               (r"^unet\.dec_(\d+)\.convT\.",
                lambda m: f"UNet.decoder_block{int(m.group(1)) + 1}.conv1."),
               (r"^unet\.dec_(\d+)\.cb(\d)\.",
                lambda m: f"UNet.decoder_block{int(m.group(1)) + 1}."
                          f"conv_block{m.group(2)}."),
               (r"^unet\.dec_(\d+)\.",
                lambda m: f"UNet.decoder_block{int(m.group(1)) + 1}."),
               (r"^unet\.after_cb\.", "UNet.after_conv_block1."),
               (r"^unet\.after_conv\.", "UNet.after_conv2."), *_FILM]))(k),
    "tsd": _subs([(r"^b(\d+)_(conv|bn)(\d)\.",
                   lambda m: f"features.conv_block{int(m.group(1)) + 1}."
                             f"{m.group(2)}{m.group(3)}."),
                  (r"^gru\.fwd\.(\w+)$", r"gru.\1"),
                  (r"^gru\.bwd\.(\w+)$", r"gru.\1_reverse")]),
    "binaural": lambda k: "module." + _subs([
        (r"^warp_conv_(\d+)\.", r"warper.layers.\1."),
        (r"^warp_linear\.", "warper.linear.")])(k),
    "clip_vision": lambda k: "visual." + _subs(
        [(r"^patch_embed\.", "conv1."), *_CLIP_BLOCK])(k),
    "clip_text_tower": _subs(_CLIP_BLOCK),
    "diffsinger": lambda k: "model." + _chain(
        _under("fs2.", _FS2, "fs2."),
        _under("denoiser.", _DIFFNET, "denoise_fn."))(k),
    "htsat": lambda k: "audio_branch." + _subs([
        (r"^bn0_scale$", "bn0.weight"), (r"^bn0_bias$", "bn0.bias"),
        (r"^bn0_mean$", "bn0.running_mean"),
        (r"^bn0_var$", "bn0.running_var"),
        (r"^swin\.patch_proj\.", "patch_embed.proj."),
        (r"^swin\.patch_norm\.", "patch_embed.norm."),
        (r"^swin\.layer(\d+)_block(\d+)\.", r"layers.\1.blocks.\2."),
        (r"\.attn\.rel_pos_bias$", ".attn.relative_position_bias_table"),
        (r"\.fc(\d)\.", r".mlp.fc\1."),
        (r"^swin\.downsample(\d+)\.", r"layers.\1.downsample."),
        (r"^swin\.", ""),
        (r"^projection\.mlp\.fc1\.", "audio_projection.0."),
        (r"^projection\.mlp\.fc2\.", "audio_projection.2.")])(k),
    "blip": _chain(
        _under("vision.", [
            (r"^patch_embed\.", "embeddings.patch_embedding."),
            (r"^class_embedding$", "embeddings.class_embedding"),
            (r"^position_embedding$", "embeddings.position_embedding"),
            (r"^block(\d+)\.ln_(\d)\.", r"encoder.layers.\1.layer_norm\2."),
            (r"^block(\d+)\.qkv\.", r"encoder.layers.\1.self_attn.qkv."),
            (r"^block(\d+)\.proj\.",
             r"encoder.layers.\1.self_attn.projection."),
            (r"^block(\d+)\.fc(\d)\.", r"encoder.layers.\1.mlp.fc\2."),
            (r"^post_ln\.", "post_layernorm.")], "vision_model."),
        _under("decoder.", [
            (r"^head_dense\.", "cls.predictions.transform.dense."),
            (r"^head_ln\.", "cls.predictions.transform.LayerNorm."),
            (r"^head_out\.weight", "cls.predictions.decoder.weight"),
            (r"^head_out\.bias", "cls.predictions.bias"),
            (r"^pos_emb$", "bert.embeddings.position_embeddings.weight"),
            (r"^layer_(\d+)\.xq\.",
             r"bert.encoder.layer.\1.crossattention.self.query."),
            (r"^layer_(\d+)\.xk\.",
             r"bert.encoder.layer.\1.crossattention.self.key."),
            (r"^layer_(\d+)\.xv\.",
             r"bert.encoder.layer.\1.crossattention.self.value."),
            (r"^layer_(\d+)\.x_out\.",
             r"bert.encoder.layer.\1.crossattention.output.dense."),
            (r"^layer_(\d+)\.x_ln\.",
             r"bert.encoder.layer.\1.crossattention.output.LayerNorm."),
            *[(p, "bert." + r) for p, r in _BERT]], "text_decoder.")),
    "gpt2": _subs([(r"^wte\.", "transformer.wte."),
                   (r"^wpe$", "transformer.wpe.weight"),
                   (r"^ln_f\.", "transformer.ln_f."),
                   (r"^h(\d+)\.(ln_\d)\.", r"transformer.h.\1.\2."),
                   (r"^h(\d+)\.c_(attn|proj)\.", r"transformer.h.\1.attn.c_\2."),
                   (r"^h(\d+)\.c_fc\.", r"transformer.h.\1.mlp.c_fc."),
                   (r"^h(\d+)\.mlp_proj\.", r"transformer.h.\1.mlp.c_proj.")]),
    # HF T5EncoderModel: the relative bias in block 0 only
    "t5": _subs([(r"^embed\.", "shared."),
                 (r"^final_ln\.", "encoder.final_layer_norm."),
                 (r"^block_(\d+)\.attn\.rel_bias$", r"encoder.block.\1.layer.0"
                  r".SelfAttention.relative_attention_bias.weight"),
                 (r"^block_(\d+)\.attn\.", r"encoder.block.\1.layer.0"
                  r".SelfAttention."),
                 (r"^block_(\d+)\.attn_ln\.",
                  r"encoder.block.\1.layer.0.layer_norm."),
                 (r"^block_(\d+)\.ff_ln\.",
                  r"encoder.block.\1.layer.1.layer_norm."),
                 (r"^block_(\d+)\.(wi_0|wi_1|wi|wo)\.",
                  r"encoder.block.\1.layer.1.DenseReluDense.\2.")]),
}


def _layout(family, ref_key, arr):
    """The reference checkpoint's layout of a tensor where it is not the
    port module's torch layout: → [(key, array), ...]."""
    if family == "caption" and ref_key.endswith("in_proj_weight"):
        return [(ref_key, arr.T)]              # the port keeps JAX's [d, 3d]
    if family == "pwg" and ".up_layers." in ref_key:
        return [(ref_key, arr.reshape(1, 1, 1, -1))]   # Conv2d [1, 1, 1, k]
    if family == "blip" and ref_key.endswith(("class_embedding",
                                              "position_embedding")):
        return [(ref_key, arr.reshape(1, *([1] if arr.ndim == 1 else []),
                                      *arr.shape))]
    if family == "gpt2" and arr.ndim == 2 and ".h." in ref_key:
        return [(ref_key, arr.T)]              # HF Conv1D holds [in, out]
    if family == "clip_text_hf" and ".self_attn.in_proj" in ref_key:
        stem, leaf = ref_key.rsplit(".in_proj.", 1)
        return [(f"{stem}.{n}_proj.{leaf}", part)
                for n, part in zip("qkv", np.split(arr, 3, axis=0))]
    if family == "hifigan" and arr.ndim == 3 and ref_key.endswith("weight") \
            and ("resblocks" in ref_key or "ups" in ref_key):
        # torch weight_norm (dim 0): g = ‖w‖ per output channel, v = 2w
        g = np.sqrt((arr.astype(np.float64) ** 2).sum(axis=(1, 2),
                                                      keepdims=True))
        stem = ref_key[:-len("weight")]
        return [(stem + "weight_g", g.astype(np.float32)),
                (stem + "weight_v", 2 * arr)]
    return [(ref_key, arr)]


RENAMES["clip_text_hf"] = lambda k: (
    "cond_stage_model.transformer.text_model." + _subs([
        (r"^token_embedding\.", "embeddings.token_embedding."),
        (r"^positional_embedding$", "embeddings.position_embedding.weight"),
        (r"^ln_final\.", "final_layer_norm."),
        (r"^block(\d+)\.ln_(\d)\.", r"encoder.layers.\1.layer_norm\2."),
        (r"^block(\d+)\.in_proj\.", r"encoder.layers.\1.self_attn.in_proj."),
        (r"^block(\d+)\.out_proj\.", r"encoder.layers.\1.self_attn.out_proj."),
        (r"^block(\d+)\.mlp_fc\.", r"encoder.layers.\1.mlp.fc1."),
        (r"^block(\d+)\.mlp_proj\.", r"encoder.layers.\1.mlp.fc2.")])(k))


def _renamer(family, cfg):
    if family == "hifigan":
        return lambda k: "generator." + _hifigan_like(cfg, amp=False)(k)
    if family == "bigvgan":
        return _hifigan_like(cfg, amp=True)
    if family == "ldm_unet":
        return _unet(cfg)
    return RENAMES[family]


def filled_module(family, seed=0):
    """The family's port module with every float parameter and statistic
    drawn from a seeded normal: N(0, ¼) for vectors, N(0, 1/fan-in) for
    matrices and kernels, variances 1 + |N(0, ¼)|."""
    cfg, build = FAMILIES[family]
    torch.manual_seed(seed)
    module = build(cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not t.is_floating_point():
                continue
            a = rng.normal(size=tuple(t.shape))
            a = a * 0.5 if t.ndim < 2 else a / np.sqrt(np.prod(t.shape[1:]))
            if name.endswith(("running_var", "bn0_var")):
                a = 1.0 + np.abs(a)
            t.copy_(torch.from_numpy(a.astype(np.float32)))
        if family == "clip_text_hf":
            # HF has no text projection: the converter installs the identity
            module.text_projection.copy_(torch.eye(cfg.width, cfg.embed_dim))
    return module


def reference_state_dict(family, seed=0):
    """(the filled port module, its reference-layout state dict: numpy)."""
    cfg, _ = FAMILIES[family]
    module = filled_module(family, seed)
    rename = _renamer(family, cfg)
    sd = {}
    for key, t in module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        for ref_key, arr in _layout(family, rename(key), t.numpy()):
            assert ref_key not in sd, ref_key
            sd[ref_key] = np.ascontiguousarray(arr)
    return module, sd


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, np.ndarray) and isinstance(w, np.ndarray), k
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@functools.lru_cache(maxsize=None)
def converted(family):
    """(port module, reference sd, the port's tree, JAX's tree)."""
    module, sd = reference_state_dict(family)
    cfg = FAMILIES[family][0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return module, sd, ic.convert(family, sd, cfg), \
            jic.convert(family, sd, cfg)


ALL = sorted(FAMILIES)


def test_the_family_table_is_jax_s():
    """24 families, the JAX table's names; an unknown one is a KeyError
    that names them."""
    assert len(ALL) == 24
    with pytest.raises(KeyError, match="unknown family 'nope'.*hifigan"):
        ic.convert("nope", {}, None)
    with pytest.raises(KeyError):
        jic.convert("nope", {}, None)


@pytest.mark.parametrize("family", ALL)
def test_converters_equal_jax_and_load_strictly(family):
    """The port's tree equals JAX's bitwise; it loads strictly into a
    fresh port module (other seed), which then holds the first module's
    parameters and statistics."""
    module, _, tree, jtree = converted(family)
    assert_trees_equal(tree, jtree)
    fresh = filled_module(family, seed=1)
    load_jax_params(fresh, tree)
    want = module.state_dict()
    for key, t in fresh.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        tol = 1e-6 if family == "hifigan" else 0.0
        np.testing.assert_allclose(t.numpy(), want[key].numpy(), rtol=tol,
                                   atol=tol * float(want[key].abs().max()),
                                   err_msg=key)


@pytest.mark.parametrize("wrap", ["state_dict", "model", "generator", None])
def test_load_torch_state_dict_unwraps_and_strips(tmp_path, wrap):
    """A trainer dict's ``state_dict`` / ``model`` / ``generator`` entry or a
    bare state dict; non-tensor entries are dropped; ``prefix`` keeps only
    its keys, stripped; JAX's loader reads the file the same."""
    sd = {"model.a.weight": torch.arange(6.0).reshape(2, 3),
          "model.b": torch.ones(2, dtype=torch.int64),
          "other.c": torch.zeros(1), "step": 7}
    path = str(tmp_path / "x.ckpt")
    torch.save({wrap: sd, "epoch": 3} if wrap else sd, path)
    for prefix, keys in ((None, ["model.a.weight", "model.b", "other.c"]),
                         ("model.", ["a.weight", "b"])):
        got = ic.load_torch_state_dict(path, prefix)
        want = jic.load_torch_state_dict(path, prefix)
        assert sorted(got) == sorted(want) == sorted(keys)
        for k in keys:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_main_writes_a_file_that_restores_leaf_for_leaf(tmp_path,
                                                        monkeypatch, capsys):
    """``main`` → ``params.pt`` → ``restore_params``: the converted tree
    (``{"params": ...}``), every leaf's name, dtype, shape and value; a
    ``.pt`` path is written as it is; ``restore_weights`` gives the same
    tree; a trainer checkpoint comes back as its groups (EMA where kept)."""
    _, sd, tree, _ = converted("fastspeech2")
    ckpt = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, ckpt)
    monkeypatch.setattr(ic, "default_config",
                        lambda family: FAMILIES[family][0])
    out = str(tmp_path / "params" / "fs2")
    ic.main(["--family", "fastspeech2", "--ckpt", ckpt, "--out", out])
    assert "imported fastspeech2" in capsys.readouterr().out
    assert_trees_equal(ic.restore_params(out), tree)
    assert_trees_equal(ic.restore_weights(out + "/params.pt"), tree)
    path = ic.save_params({"a": {"b": np.arange(3, dtype=np.int32)},
                           "c": np.float32(2.5) * np.ones((), np.float32)},
                          str(tmp_path / "t.pt"))
    assert path.endswith("t.pt")
    assert_trees_equal(ic.restore_params(path),
                       {"a": {"b": np.arange(3, dtype=np.int32)},
                        "c": np.asarray(2.5, np.float32)})
    trainer = {"params": {"model": {"w": torch.ones(2)}},
               "opt": {}, "ema": {"model": {"w": torch.zeros(2)}},
               "step": 3}
    torch.save(trainer, str(tmp_path / "3.pt"))
    got = ic.restore_weights(str(tmp_path / "3.pt"))
    assert set(got) == {"model"} and torch.equal(got["model"]["w"],
                                                 torch.zeros(2))


def test_hifigan_forward_on_imported_weights_matches_jax():
    """The port generator on the port-imported tree and the JAX generator
    on the JAX-imported one give the same wav (f32, 1e-5)."""
    from audiogpt_tpu.models.vocoder import hifigan as jh

    _, _, tree, jtree = converted("hifigan")
    cfg = FAMILIES["hifigan"][0]
    mel = np.random.default_rng(3).normal(size=(2, 12, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(jh.HifiGANGenerator(jh.HifiGANConfig(
        **HIFI)).apply)(jtree, jnp.asarray(mel)))
    model = HifiGANGenerator(cfg).eval()
    load_jax_params(model, tree)
    with torch.no_grad():
        got = model(torch.from_numpy(mel).transpose(1, 2)).numpy()
    assert got.shape == ref.shape == (2, 12 * 16)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_captioner_forward_on_imported_weights_matches_jax():
    """The captioner's teacher-forced logits (Cnn14 with its imported
    statistics, the bidirectional GRU from the reference's one
    ``nn.GRU``, the packed in-projections) against JAX's (f32, 1e-5)."""
    from audiogpt_tpu.models.caption import captioner as jcap
    from audiogpt_tpu.models.caption.cnn14 import Cnn14Config as JaxCnn14

    _, _, tree, jtree = converted("caption")
    rng = np.random.default_rng(4)
    wav = (0.3 * rng.normal(size=(2, 32000))).astype(np.float32)
    wav_len = np.asarray([32000, 25000], np.int32)
    words = rng.integers(0, CAPTION["vocab_size"], (2, 6)).astype(np.int32)
    jmodel = jcap.CaptionModel(jcap.CaptionConfig(
        cnn14=JaxCnn14(channels=CNN.channels), **CAPTION))
    ref = np.asarray(jax.jit(jmodel.apply)(jtree, wav, words, wav_len))
    model = CaptionModel(FAMILIES["caption"][0]).eval()
    load_jax_params(model, tree)
    with torch.no_grad():
        got = model(torch.from_numpy(wav), torch.from_numpy(words).long(),
                    torch.from_numpy(wav_len).long()).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
