"""Reference PyTorch checkpoints → flax-layout parameter trees.

The port's own copy of ``audiogpt_tpu/utils/torch_import.py``, numpy
only: one converter per model family (24), mapping the reference's
trained weights (weight-norm convs, transposed convs, GRU layouts, EMA
copies) into the JAX package's flax parameter trees. Each tree holds
numpy leaves in the flax layout, which ``utils/jax_params.py``
``load_jax_params`` carries into the port's module of that family, so a
port module gets the weights exactly as the JAX module does.

All functions take a flat ``{name: np.ndarray}`` state dict (call
``{k: v.numpy() for k, v in torch_sd.items()}`` at the torch boundary, as
``import_ckpt.load_torch_state_dict`` does).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def _warn_vocab_mismatch(family: str, vocab_hint: str) -> None:
    """Imported weights were trained against an UPSTREAM tokenizer vocab;
    the bundled derived vocabs (wordpiece_en.txt.gz / CLIP-codec whisper
    detok) use different token ids, so text I/O around these weights will be
    wrong until the matching vocab is wired (``--vocab`` / ``set_vocab``)."""
    import warnings

    warnings.warn(
        f"[{family}] imported weights were trained with {vocab_hint}; the "
        f"bundled derived vocab uses DIFFERENT token ids. Wire the original "
        f"vocab (app.py --vocab / engine.set_vocab) or text around this "
        f"model will be mistokenized.", stacklevel=3)


def _fold_wn(sd: Mapping[str, np.ndarray], prefix: str) -> np.ndarray:
    """Fold torch weight_norm (dim=0): w = g * v / ||v||_{dims≠0}."""
    if prefix + ".weight" in sd:
        return np.asarray(sd[prefix + ".weight"])
    g = np.asarray(sd[prefix + ".weight_g"])
    v = np.asarray(sd[prefix + ".weight_v"])
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v * v).sum(axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _conv1d(sd, prefix):
    """torch Conv1d [out,in,W] → flax nn.Conv {kernel [W,in,out], bias}."""
    w = _fold_wn(sd, prefix)
    out = {"kernel": w.transpose(2, 1, 0).astype(np.float32)}
    if prefix + ".bias" in sd:
        out["bias"] = np.asarray(sd[prefix + ".bias"]).astype(np.float32)
    return out


def _convT1d(sd, prefix):
    """torch ConvTranspose1d [in,out,W] → ours {kernel [W,out,in], bias}."""
    w = _fold_wn(sd, prefix)
    out = {"kernel": w.transpose(2, 1, 0).astype(np.float32)}
    if prefix + ".bias" in sd:
        out["bias"] = np.asarray(sd[prefix + ".bias"]).astype(np.float32)
    return out


def convert_hifigan(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """Reference ``HifiGanGenerator`` (NeuralSeq/modules/hifigan/hifigan.py:104)
    → :class:`audiogpt_tpu_torch.models.vocoder.HifiGANGenerator` params."""
    sd = {k.removeprefix("model_gen.").removeprefix("generator."): v for k, v in sd.items()}
    p: dict = {}
    p["conv_pre"] = {"Conv_0": _conv1d(sd, "conv_pre")}
    p["conv_post"] = {"Conv_0": _conv1d(sd, "conv_post")}
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        p[f"up_{i}"] = _convT1d(sd, f"ups.{i}")
        if cfg.use_nsf and f"noise_convs.{i}.weight" in sd:
            p[f"noise_conv_{i}"] = {"Conv_0": _conv1d(sd, f"noise_convs.{i}")}
        for j in range(nk):
            r = f"resblocks.{i * nk + j}"
            blk: dict = {}
            if cfg.resblock == "1":
                nd = len(cfg.resblock_dilation_sizes[j])
                for m in range(nd):
                    blk[f"Conv1d_{2 * m}"] = {"Conv_0": _conv1d(sd, f"{r}.convs1.{m}")}
                    blk[f"Conv1d_{2 * m + 1}"] = {"Conv_0": _conv1d(sd, f"{r}.convs2.{m}")}
            else:
                for m in range(len(cfg.resblock_dilation_sizes[j])):
                    blk[f"Conv1d_{m}"] = {"Conv_0": _conv1d(sd, f"{r}.convs.{m}")}
            p[f"res_{i}_{j}"] = blk
    return {"params": p}


def _snake(sd, prefix, variant):
    out = {"alpha": np.asarray(sd[prefix + ".alpha"]).astype(np.float32)}
    if variant == "snakebeta":
        out["beta"] = np.asarray(sd[prefix + ".beta"]).astype(np.float32)
    return out


def convert_bigvgan(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """Reference ``BigVGAN`` (Make_An_Audio/vocoder/bigvgan/models.py:133)
    → :class:`audiogpt_tpu_torch.models.vocoder.BigVGANGenerator` params."""
    sd = {k.removeprefix("generator."): v for k, v in sd.items()}
    p: dict = {}
    p["conv_pre"] = {"Conv_0": _conv1d(sd, "conv_pre")}
    p["conv_post"] = {"Conv_0": _conv1d(sd, "conv_post")}
    p["act_post"] = _snake(sd, "activation_post.act", cfg.activation)
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        p[f"up_{i}"] = _convT1d(sd, f"ups.{i}.0")
        for j in range(nk):
            r = f"resblocks.{i * nk + j}"
            blk: dict = {}
            nd = len(cfg.resblock_dilation_sizes[j])
            if cfg.resblock == "1":
                for m in range(nd):
                    blk[f"SnakeAA_{2 * m}"] = _snake(sd, f"{r}.activations.{2 * m}.act", cfg.activation)
                    blk[f"Conv1d_{2 * m}"] = {"Conv_0": _conv1d(sd, f"{r}.convs1.{m}")}
                    blk[f"SnakeAA_{2 * m + 1}"] = _snake(sd, f"{r}.activations.{2 * m + 1}.act", cfg.activation)
                    blk[f"Conv1d_{2 * m + 1}"] = {"Conv_0": _conv1d(sd, f"{r}.convs2.{m}")}
            else:
                for m in range(nd):
                    blk[f"SnakeAA_{m}"] = _snake(sd, f"{r}.activations.{m}.act", cfg.activation)
                    blk[f"Conv1d_{m}"] = {"Conv_0": _conv1d(sd, f"{r}.convs.{m}")}
            p[f"amp_{i}_{j}"] = blk
    return {"params": p}


# ---------------------------------------------------------------------------
# Whisper (HF `WhisperModel` or openai-whisper naming)
# ---------------------------------------------------------------------------

_OAI2HF = {
    ".attn.query.": ".self_attn.q_proj.",
    ".attn.key.": ".self_attn.k_proj.",
    ".attn.value.": ".self_attn.v_proj.",
    ".attn.out.": ".self_attn.out_proj.",
    ".attn_ln.": ".self_attn_layer_norm.",
    ".cross_attn.query.": ".encoder_attn.q_proj.",
    ".cross_attn.key.": ".encoder_attn.k_proj.",
    ".cross_attn.value.": ".encoder_attn.v_proj.",
    ".cross_attn.out.": ".encoder_attn.out_proj.",
    ".cross_attn_ln.": ".encoder_attn_layer_norm.",
    ".mlp.0.": ".fc1.",
    ".mlp.2.": ".fc2.",
    ".mlp_ln.": ".final_layer_norm.",
    ".blocks.": ".layers.",
    "decoder.token_embedding.weight": "decoder.embed_tokens.weight",
    "decoder.positional_embedding": "decoder.embed_positions.weight",
    "encoder.positional_embedding": "encoder.embed_positions.weight",
    "encoder.ln_post.": "encoder.layer_norm.",
    "decoder.ln.": "decoder.layer_norm.",
}


def _whisper_to_hf_names(sd):
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("model.")
        for a, b in _OAI2HF.items():
            k = k.replace(a, b)
        out[k] = np.asarray(v)
    return out


def _dense(sd, prefix):
    out = {"kernel": np.asarray(sd[prefix + ".weight"]).T.astype(np.float32)}
    if prefix + ".bias" in sd:
        out["bias"] = np.asarray(sd[prefix + ".bias"]).astype(np.float32)
    return out


def _ln(sd, prefix):
    return {
        "scale": np.asarray(sd[prefix + ".weight"]).astype(np.float32),
        "bias": np.asarray(sd[prefix + ".bias"]).astype(np.float32),
    }


def _whisper_mha(sd, prefix):
    return {
        "q": _dense(sd, prefix + ".q_proj"),
        "k": _dense(sd, prefix + ".k_proj"),
        "v": _dense(sd, prefix + ".v_proj"),
        "out": _dense(sd, prefix + ".out_proj"),
    }


def convert_whisper(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """HF/openai Whisper →
    :class:`audiogpt_tpu_torch.models.asr.WhisperModel`."""
    _warn_vocab_mismatch("whisper", "OpenAI's BPE ranks "
                         "(gpt2/multilingual.tiktoken)")
    sd = _whisper_to_hf_names(dict(sd))
    enc: dict = {
        "conv1": _conv1d(sd, "encoder.conv1"),
        "conv2": _conv1d(sd, "encoder.conv2"),
        "ln_post": _ln(sd, "encoder.layer_norm"),
    }
    for i in range(cfg.n_audio_layer):
        l = f"encoder.layers.{i}"
        enc[f"block_{i}"] = {
            "attn": _whisper_mha(sd, f"{l}.self_attn"),
            "attn_ln": _ln(sd, f"{l}.self_attn_layer_norm"),
            "fc1": _dense(sd, f"{l}.fc1"),
            "fc2": _dense(sd, f"{l}.fc2"),
            "mlp_ln": _ln(sd, f"{l}.final_layer_norm"),
        }
    dec: dict = {
        "token_embedding": {
            "embedding": np.asarray(sd["decoder.embed_tokens.weight"]).astype(np.float32)
        },
        "positional_embedding": np.asarray(sd["decoder.embed_positions.weight"]).astype(np.float32),
        "ln": _ln(sd, "decoder.layer_norm"),
    }
    for i in range(cfg.n_text_layer):
        l = f"decoder.layers.{i}"
        dec[f"block_{i}"] = {
            "attn": _whisper_mha(sd, f"{l}.self_attn"),
            "attn_ln": _ln(sd, f"{l}.self_attn_layer_norm"),
            "cross_attn": _whisper_mha(sd, f"{l}.encoder_attn"),
            "cross_attn_ln": _ln(sd, f"{l}.encoder_attn_layer_norm"),
            "fc1": _dense(sd, f"{l}.fc1"),
            "fc2": _dense(sd, f"{l}.fc2"),
            "mlp_ln": _ln(sd, f"{l}.final_layer_norm"),
        }
    return {"params": {"encoder": enc, "decoder": dec}}


# ---------------------------------------------------------------------------
# FastSpeech2 (NeuralSeq/modules/fastspeech/fs2.py)
# ---------------------------------------------------------------------------


def _fft_blocks(sd, prefix, n_layers, last_norm=True, pos_alpha=False):
    out: dict = {}
    if pos_alpha:
        out["pos_alpha"] = np.asarray(sd[f"{prefix}.pos_embed_alpha"]).astype(np.float32)
    for i in range(n_layers):
        l = f"{prefix}.layers.{i}.op"
        out[f"layer_{i}"] = {
            "ln1": _ln(sd, f"{l}.layer_norm1"),
            "ln2": _ln(sd, f"{l}.layer_norm2"),
            "attn": {
                "in_proj": {"kernel": np.asarray(sd[f"{l}.self_attn.in_proj_weight"]).T.astype(np.float32)},
                "out_proj": {"kernel": np.asarray(sd[f"{l}.self_attn.out_proj.weight"]).T.astype(np.float32)},
            },
            "ffn_conv": _conv1d(sd, f"{l}.ffn.ffn_1"),
            "ffn_out": _dense(sd, f"{l}.ffn.ffn_2"),
        }
    if last_norm:
        out["ln"] = _ln(sd, f"{prefix}.layer_norm")
    return out


def _conv_predictor(sd, prefix, n_layers, pos_alpha=False):
    out: dict = {"out": _dense(sd, f"{prefix}.linear")}
    if pos_alpha:
        out["pos_alpha"] = np.asarray(sd[f"{prefix}.pos_embed_alpha"]).astype(np.float32)
    for i in range(n_layers):
        out[f"conv_{i}"] = _conv1d(sd, f"{prefix}.conv.{i}.1")
        out[f"ln_{i}"] = _ln(sd, f"{prefix}.conv.{i}.3")
    return out


def convert_fastspeech2(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """Reference ``FastSpeech2`` (fs2.py:22) → ours. Handles the 'model.'
    prefix of NeuralSeq task checkpoints."""
    sd = {k.removeprefix("model."): np.asarray(v) for k, v in sd.items()}
    p: dict = {
        "embed_tokens": {"embedding": sd["encoder_embed_tokens.weight"].astype(np.float32)},
        "encoder": _fft_blocks(sd, "encoder", cfg.enc_layers),
        "decoder": _fft_blocks(sd, "decoder", cfg.dec_layers, pos_alpha=True),
        "mel_out": _dense(sd, "mel_out"),
        "dur_predictor": _conv_predictor(sd, "dur_predictor", cfg.dur_predictor_layers),
    }
    if cfg.use_pitch_embed:
        p["pitch_embed"] = {"embedding": sd["pitch_embed.weight"].astype(np.float32)}
        p["pitch_predictor"] = _conv_predictor(
            sd, "pitch_predictor", cfg.predictor_layers, pos_alpha=True)
    if cfg.use_energy_embed:
        p["energy_embed"] = {"embedding": sd["energy_embed.weight"].astype(np.float32)}
        p["energy_predictor"] = _conv_predictor(
            sd, "energy_predictor", cfg.predictor_layers, pos_alpha=True)
    if cfg.num_spk > 0 and "spk_embed_proj.weight" in sd:
        p["spk_embed"] = {"embedding": sd["spk_embed_proj.weight"].astype(np.float32)}
    if getattr(cfg, "use_midi", False):
        # FastSpeech2MIDI extras (modules/diffsinger_midi/fs2.py:51-53)
        p["midi_embed"] = {"embedding": sd["midi_embed.weight"].astype(np.float32)}
        p["midi_dur_layer"] = _dense(sd, "midi_dur_layer")
        p["is_slur_embed"] = {"embedding": sd["is_slur_embed.weight"].astype(np.float32)}
    return {"params": p}


# ---------------------------------------------------------------------------
# Latent diffusion: UNetModel + AutoencoderKL (Make_An_Audio/ldm)
# ---------------------------------------------------------------------------


def _conv2d(sd, prefix):
    """torch Conv2d [O,I,kh,kw] → flax {kernel [kh,kw,I,O], bias}."""
    w = np.asarray(sd[prefix + ".weight"])
    out = {"kernel": w.transpose(2, 3, 1, 0).astype(np.float32)}
    if prefix + ".bias" in sd:
        out["bias"] = np.asarray(sd[prefix + ".bias"]).astype(np.float32)
    return out


def _gn(sd, prefix):
    return {"GroupNorm_0": {
        "scale": np.asarray(sd[prefix + ".weight"]).astype(np.float32),
        "bias": np.asarray(sd[prefix + ".bias"]).astype(np.float32),
    }}


def _unet_res(sd, prefix):
    out = {
        "in_norm": _gn(sd, f"{prefix}.in_layers.0"),
        "in_conv": _conv2d(sd, f"{prefix}.in_layers.2"),
        "emb_proj": _dense(sd, f"{prefix}.emb_layers.1"),
        "out_norm": _gn(sd, f"{prefix}.out_layers.0"),
        "out_conv": _conv2d(sd, f"{prefix}.out_layers.3"),
    }
    if f"{prefix}.skip_connection.weight" in sd:
        out["skip"] = _conv2d(sd, f"{prefix}.skip_connection")
    return out


def _nobias_dense(sd, prefix):
    return {"kernel": np.asarray(sd[prefix + ".weight"]).T.astype(np.float32)}


def _xattn(sd, prefix):
    return {
        "to_q": _nobias_dense(sd, f"{prefix}.to_q"),
        "to_k": _nobias_dense(sd, f"{prefix}.to_k"),
        "to_v": _nobias_dense(sd, f"{prefix}.to_v"),
        "to_out": _dense(sd, f"{prefix}.to_out.0"),
    }


def _ln_t(sd, prefix):
    return {"scale": np.asarray(sd[prefix + ".weight"]).astype(np.float32),
            "bias": np.asarray(sd[prefix + ".bias"]).astype(np.float32)}


def _spatial_transformer(sd, prefix, depth=1):
    out = {
        "norm": _gn(sd, f"{prefix}.norm"),
        "proj_in": _conv2d(sd, f"{prefix}.proj_in"),
        "proj_out": _conv2d(sd, f"{prefix}.proj_out"),
    }
    for d in range(depth):
        t = f"{prefix}.transformer_blocks.{d}"
        out[f"block_{d}"] = {
            "attn1": _xattn(sd, f"{t}.attn1"),
            "attn2": _xattn(sd, f"{t}.attn2"),
            "norm1": _ln_t(sd, f"{t}.norm1"),
            "norm2": _ln_t(sd, f"{t}.norm2"),
            "norm3": _ln_t(sd, f"{t}.norm3"),
            "ff": {
                "proj": _dense(sd, f"{t}.ff.net.0.proj"),
                "out": _dense(sd, f"{t}.ff.net.2"),
            },
        }
    return out


def convert_ldm_unet(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """Reference ``UNetModel`` (openaimodel.py:413) → ours. Accepts keys with
    or without the LDM wrapper prefix ``model.diffusion_model.``."""
    sd = {k.removeprefix("model.diffusion_model.").removeprefix("diffusion_model."): v
          for k, v in sd.items()}
    p: dict = {
        "time_embed_0": _dense(sd, "time_embed.0"),
        "time_embed_2": _dense(sd, "time_embed.2"),
        "in_conv": _conv2d(sd, "input_blocks.0.0"),
        "out_norm": _gn(sd, "out.0"),
        "out_conv": _conv2d(sd, "out.2"),
        "mid_res1": _unet_res(sd, "middle_block.0"),
        "mid_attn": _spatial_transformer(sd, "middle_block.1", cfg.transformer_depth),
        "mid_res2": _unet_res(sd, "middle_block.2"),
    }
    idx = 1
    ds = 1
    for level in range(len(cfg.channel_mult)):
        for i in range(cfg.num_res_blocks):
            p[f"down_{level}_{i}_res"] = _unet_res(sd, f"input_blocks.{idx}.0")
            if ds in cfg.attention_resolutions:
                p[f"down_{level}_{i}_attn"] = _spatial_transformer(
                    sd, f"input_blocks.{idx}.1", cfg.transformer_depth)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            p[f"down_{level}_ds"] = {"op": _conv2d(sd, f"input_blocks.{idx}.0.op")}
            idx += 1
            ds *= 2
    idx = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            p[f"up_{level}_{i}_res"] = _unet_res(sd, f"output_blocks.{idx}.0")
            sub = 1
            if ds in cfg.attention_resolutions:
                p[f"up_{level}_{i}_attn"] = _spatial_transformer(
                    sd, f"output_blocks.{idx}.{sub}", cfg.transformer_depth)
                sub += 1
            if level and i == cfg.num_res_blocks:
                p[f"up_{level}_us"] = {"conv": _conv2d(sd, f"output_blocks.{idx}.{sub}.conv")}
                ds //= 2
            idx += 1
    return {"params": p}


def _vae_res(sd, prefix):
    out = {
        "norm1": _gn(sd, f"{prefix}.norm1"),
        "conv1": _conv2d(sd, f"{prefix}.conv1"),
        "norm2": _gn(sd, f"{prefix}.norm2"),
        "conv2": _conv2d(sd, f"{prefix}.conv2"),
    }
    if f"{prefix}.nin_shortcut.weight" in sd:
        out["nin_shortcut"] = _conv2d(sd, f"{prefix}.nin_shortcut")
    return out


def _vae_attn(sd, prefix):
    return {
        "norm": _gn(sd, f"{prefix}.norm"),
        "q": _conv2d(sd, f"{prefix}.q"),
        "k": _conv2d(sd, f"{prefix}.k"),
        "v": _conv2d(sd, f"{prefix}.v"),
        "proj_out": _conv2d(sd, f"{prefix}.proj_out"),
    }


def convert_vae(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """Reference ``AutoencoderKL`` (autoencoder.py:305) → ours."""
    sd = {k.removeprefix("first_stage_model."): v for k, v in sd.items()}
    enc: dict = {
        "conv_in": _conv2d(sd, "encoder.conv_in"),
        "mid_block_1": _vae_res(sd, "encoder.mid.block_1"),
        "mid_attn_1": _vae_attn(sd, "encoder.mid.attn_1"),
        "mid_block_2": _vae_res(sd, "encoder.mid.block_2"),
        "norm_out": _gn(sd, "encoder.norm_out"),
        "conv_out": _conv2d(sd, "encoder.conv_out"),
    }
    dec: dict = {
        "conv_in": _conv2d(sd, "decoder.conv_in"),
        "mid_block_1": _vae_res(sd, "decoder.mid.block_1"),
        "mid_attn_1": _vae_attn(sd, "decoder.mid.attn_1"),
        "mid_block_2": _vae_res(sd, "decoder.mid.block_2"),
        "norm_out": _gn(sd, "decoder.norm_out"),
        "conv_out": _conv2d(sd, "decoder.conv_out"),
    }
    n = len(cfg.ch_mult)
    curr_res = cfg.resolution
    for level in range(n):
        for i in range(cfg.num_res_blocks):
            enc[f"down_{level}_block_{i}"] = _vae_res(sd, f"encoder.down.{level}.block.{i}")
            if curr_res in cfg.attn_resolutions:
                enc[f"down_{level}_attn_{i}"] = _vae_attn(sd, f"encoder.down.{level}.attn.{i}")
        if level != n - 1:
            enc[f"down_{level}_downsample"] = {
                "conv": _conv2d(sd, f"encoder.down.{level}.downsample.conv")}
            curr_res //= 2
    curr_res = cfg.resolution // 2 ** (n - 1)
    for level in reversed(range(n)):
        for i in range(cfg.num_res_blocks + 1):
            dec[f"up_{level}_block_{i}"] = _vae_res(sd, f"decoder.up.{level}.block.{i}")
            if curr_res in cfg.attn_resolutions:
                dec[f"up_{level}_attn_{i}"] = _vae_attn(sd, f"decoder.up.{level}.attn.{i}")
        if level != 0:
            dec[f"up_{level}_upsample"] = {
                "conv": _conv2d(sd, f"decoder.up.{level}.upsample.conv")}
            curr_res *= 2
    return {"params": {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": _conv2d(sd, "quant_conv"),
        "post_quant_conv": _conv2d(sd, "post_quant_conv"),
    }}


# ---------------------------------------------------------------------------
# BERT (HF `BertModel`) + CLAP caption encoder
# ---------------------------------------------------------------------------


def convert_bert(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """HF ``BertModel`` state dict → :class:`BertEncoder` params. Accepts
    'bert.' / 'base.' / 'caption_encoder.base.' prefixes."""
    clean = {}
    for k, v in sd.items():
        for pre in ("caption_encoder.base.", "base.", "bert."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        clean[k] = np.asarray(v)
    sd = clean
    p: dict = {
        "word_emb": {"embedding": sd["embeddings.word_embeddings.weight"].astype(np.float32)},
        "pos_emb": {"embedding": sd["embeddings.position_embeddings.weight"].astype(np.float32)},
        "type_emb": {"embedding": sd["embeddings.token_type_embeddings.weight"].astype(np.float32)},
        "emb_ln": _ln(sd, "embeddings.LayerNorm"),
    }
    for i in range(cfg.num_layers):
        l = f"encoder.layer.{i}"
        p[f"layer_{i}"] = {
            "q": _dense(sd, f"{l}.attention.self.query"),
            "k": _dense(sd, f"{l}.attention.self.key"),
            "v": _dense(sd, f"{l}.attention.self.value"),
            "attn_out": _dense(sd, f"{l}.attention.output.dense"),
            "attn_ln": _ln(sd, f"{l}.attention.output.LayerNorm"),
            "inter": _dense(sd, f"{l}.intermediate.dense"),
            "out": _dense(sd, f"{l}.output.dense"),
            "out_ln": _ln(sd, f"{l}.output.LayerNorm"),
        }
    return {"params": p}


def convert_clap_text(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """CLAP ``caption_encoder`` (base BERT + Projection) → CLAPTextEncoder."""
    _warn_vocab_mismatch("clap_text", "the HF bert-base-uncased vocab.txt")
    sd = {k.removeprefix("caption_encoder."): np.asarray(v) for k, v in sd.items()}
    bert = convert_bert({k: v for k, v in sd.items() if k.startswith("base.")},
                        cfg.bert)["params"]
    proj = {
        "linear1": _nobias_dense(sd, "projection.linear1"),
        "linear2": _nobias_dense(sd, "projection.linear2"),
        "ln": _ln_t(sd, "projection.layer_norm"),
    }
    return {"params": {"base": bert, "projection": proj}}


# ---------------------------------------------------------------------------
# DiffSinger DiffNet (NeuralSeq/modules/diff/net.py)
# ---------------------------------------------------------------------------


def convert_diffnet(sd: Mapping[str, np.ndarray], cfg) -> dict:
    sd = {k.removeprefix("model.denoise_fn.").removeprefix("denoise_fn."): np.asarray(v)
          for k, v in sd.items()}
    p: dict = {
        "input_projection": _conv1d(sd, "input_projection"),
        "mlp_0": _dense(sd, "mlp.0"),
        "mlp_2": _dense(sd, "mlp.2"),
        "skip_projection": _conv1d(sd, "skip_projection"),
        "output_projection": _conv1d(sd, "output_projection"),
    }
    for i in range(cfg.residual_layers):
        r = f"residual_layers.{i}"
        p[f"res_{i}_diff"] = _dense(sd, f"{r}.diffusion_projection")
        p[f"res_{i}_dilated"] = _conv1d(sd, f"{r}.dilated_conv")
        p[f"res_{i}_cond"] = _conv1d(sd, f"{r}.conditioner_projection")
        p[f"res_{i}_out"] = _conv1d(sd, f"{r}.output_projection")
    return {"params": p}


# ---------------------------------------------------------------------------
# Cnn14 / PANN audio backbone (audio_to_text/captioning/models/encoder.py:336;
# also the open_clap PANN tower and the PANN SED family). Official
# audioset_tagging_cnn checkpoint names: bn0, conv_block{1..6}.{conv,bn}{1,2},
# fc1, fc_audioset.
# ---------------------------------------------------------------------------


def _bn(sd, prefix):
    """torch BatchNorm → (flax params, batch_stats)."""
    params = {"scale": np.asarray(sd[prefix + ".weight"]).astype(np.float32),
              "bias": np.asarray(sd[prefix + ".bias"]).astype(np.float32)}
    stats = {"mean": np.asarray(sd[prefix + ".running_mean"]).astype(np.float32),
             "var": np.asarray(sd[prefix + ".running_var"]).astype(np.float32)}
    return params, stats


def convert_cnn14(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """→ {'params': ..., 'batch_stats': ...} for
    :class:`audiogpt_tpu_torch.models.caption.cnn14.Cnn14Encoder` (tagging head
    included when fc_audioset is present)."""
    sd = {k.removeprefix("model.").removeprefix("backbone.")
          .removeprefix("encoder."): np.asarray(v) for k, v in sd.items()}
    params: dict = {}
    stats: dict = {}
    p0, s0 = _bn(sd, "bn0")
    params["bn0"], stats["bn0"] = p0, s0
    for i in range(len(cfg.channels)):
        blk = f"conv_block{i + 1}"
        bp: dict = {}
        bs: dict = {}
        for j in (1, 2):
            bp[f"conv{j}"] = _conv2d(sd, f"{blk}.conv{j}")
            pj, sj = _bn(sd, f"{blk}.bn{j}")
            bp[f"bn{j}"], bs[f"bn{j}"] = pj, sj
        params[blk] = bp
        stats[blk] = bs
    params["fc1"] = _dense(sd, "fc1")
    if "fc_audioset.weight" in sd:
        params["fc_audioset"] = _dense(sd, "fc_audioset")
    return {"params": params, "batch_stats": stats}


def convert_pwg(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """ParallelWaveGAN generator
    (``modules/parallel_wavegan/models/parallel_wavegan.py:22``; residual
    blocks residual_block.py, ConvInUpsampleNetwork upsample.py:125) →
    :class:`audiogpt_tpu_torch.models.vocoder.pwg.PWGGenerator` with
    ``upsample='conv_in'``. The torch ModuleList interleaves parameter-free
    Stretch2d with the smoothing convs, so conv indices are 1, 3, 5, …"""
    sd = {k.removeprefix("model_gen.").removeprefix("generator."): np.asarray(v)
          for k, v in sd.items()}
    p: dict = {"first_conv": _conv1d(sd, "first_conv")}
    up: dict = {"conv_in": _conv1d(sd, "upsample_net.conv_in")}
    for i, _s in enumerate(cfg.upsample_scales):
        w = _fold_wn(sd, f"upsample_net.upsample.up_layers.{2 * i + 1}")
        # torch Conv2d [1, 1, 1, 2s+1] → time-axis 1-D kernel [2s+1, 1, 1]
        up[f"up{i}"] = {"kernel": w[0, 0, 0][:, None, None].astype(np.float32)}
    p["upsample_net"] = up
    for i in range(cfg.layers):
        r = f"conv_layers.{i}"
        p[f"block{i}"] = {
            "conv": _conv1d(sd, f"{r}.conv"),
            "conv1x1_aux": _conv1d(sd, f"{r}.conv1x1_aux"),
            "conv1x1_out": _conv1d(sd, f"{r}.conv1x1_out"),
            "conv1x1_skip": _conv1d(sd, f"{r}.conv1x1_skip"),
        }
    p["post1"] = _conv1d(sd, "last_conv_layers.1")
    p["post2"] = _conv1d(sd, "last_conv_layers.3")
    return {"params": p}


def _gru(sd, prefix, bidirectional):
    """torch GRU (weight_ih_l0 [3H,D] …) → our GRU (fwd_/bwd_ [D,3H])."""
    out = {
        "fwd_w_ih": np.asarray(sd[f"{prefix}.weight_ih_l0"]).T.astype(np.float32),
        "fwd_w_hh": np.asarray(sd[f"{prefix}.weight_hh_l0"]).T.astype(np.float32),
        "fwd_b_ih": np.asarray(sd[f"{prefix}.bias_ih_l0"]).astype(np.float32),
        "fwd_b_hh": np.asarray(sd[f"{prefix}.bias_hh_l0"]).astype(np.float32),
    }
    if bidirectional:
        out.update({
            "bwd_w_ih": np.asarray(sd[f"{prefix}.weight_ih_l0_reverse"]).T.astype(np.float32),
            "bwd_w_hh": np.asarray(sd[f"{prefix}.weight_hh_l0_reverse"]).T.astype(np.float32),
            "bwd_b_ih": np.asarray(sd[f"{prefix}.bias_ih_l0_reverse"]).astype(np.float32),
            "bwd_b_hh": np.asarray(sd[f"{prefix}.bias_hh_l0_reverse"]).astype(np.float32),
        })
    return out


def convert_caption(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """AudioCapModel (Cnn14RnnEncoder + torch TransformerDecoder,
    ``audio_to_text/captioning/models``) →
    :class:`audiogpt_tpu_torch.models.caption.captioner.CaptionModel`.
    Key map: encoder.cnn.* (PANN names), encoder.rnn.network.* (GRU),
    decoder.model.layers.{i} (packed-in-proj MHA), decoder.attn_proj.0/.3,
    decoder.word_embedding, decoder.classifier."""
    sd = {k.removeprefix("model."): np.asarray(v) for k, v in sd.items()}
    cnn_sd = {k.removeprefix("encoder.cnn."): v for k, v in sd.items()
              if k.startswith("encoder.cnn.")}
    cnn = convert_cnn14(cnn_sd, cfg.cnn14)
    params: dict = {"cnn": cnn["params"]}
    stats: dict = {"cnn": cnn["batch_stats"]}
    params["rnn"] = _gru(sd, "encoder.rnn.network", cfg.rnn_bidirectional)
    params["word_embedding"] = {
        "embedding": np.asarray(sd["decoder.word_embedding.weight"]
                                ).astype(np.float32)}
    params["attn_proj_fc"] = _dense(sd, "decoder.attn_proj.0")
    params["attn_proj_ln"] = _ln(sd, "decoder.attn_proj.3")
    for i in range(cfg.nlayers):
        l = f"decoder.model.layers.{i}"
        layer: dict = {}
        for name in ("self_attn", "multihead_attn"):
            layer[name] = {
                "in_proj_weight": np.asarray(
                    sd[f"{l}.{name}.in_proj_weight"]).T.astype(np.float32),
                "in_proj_bias": np.asarray(
                    sd[f"{l}.{name}.in_proj_bias"]).astype(np.float32),
                "out_proj": _dense(sd, f"{l}.{name}.out_proj"),
            }
        layer["linear1"] = _dense(sd, f"{l}.linear1")
        layer["linear2"] = _dense(sd, f"{l}.linear2")
        for j in (1, 2, 3):
            layer[f"norm{j}"] = _ln(sd, f"{l}.norm{j}")
        params[f"dec_layer_{i}"] = layer
    params["classifier"] = _dense(sd, "decoder.classifier")
    return {"params": params, "batch_stats": stats}


def convert_pvt(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """PVT sound-event detector → :class:`audiogpt_tpu_torch.models.sed.pvt.PVTSED`.

    Reference layout: ``audio_detection/audio_infer/pytorch/models.py:141``
    (class ``PVT``) — ``bn0`` over 64 mel bins, a 4-stage
    ``PyramidVisionTransformerV2`` under ``pvt_transformer.`` (overlap patch
    embeds ``patch_embed{i}.{proj,norm}``, blocks ``block{i}.{j}`` with
    q/kv/sr spatial-reduction attention + mix-FFN depthwise conv, stage norms
    ``norm{i}``) and the framewise head ``fc_audioset``. Stage indices are
    1-based in torch, 0-based here.
    """
    sd = {k.removeprefix("model."): np.asarray(v) for k, v in sd.items()}
    params: dict = {}
    stats: dict = {}
    p0, s0 = _bn(sd, "bn0")
    params["bn0"], stats["bn0"] = p0, s0
    pvt = "pvt_transformer"
    for i, (depth, sr) in enumerate(zip(cfg.depths, cfg.sr_ratios)):
        params[f"patch_embed{i}"] = {
            "proj": _conv2d(sd, f"{pvt}.patch_embed{i + 1}.proj"),
            "norm": _ln(sd, f"{pvt}.patch_embed{i + 1}.norm"),
        }
        for d in range(depth):
            blk = f"{pvt}.block{i + 1}.{d}"
            attn = {
                "q": _dense(sd, f"{blk}.attn.q"),
                "kv": _dense(sd, f"{blk}.attn.kv"),
                "proj": _dense(sd, f"{blk}.attn.proj"),
            }
            if sr > 1:
                attn["sr"] = _conv2d(sd, f"{blk}.attn.sr")
                attn["sr_norm"] = _ln(sd, f"{blk}.attn.norm")
            params[f"stage{i}_block{d}"] = {
                "norm1": _ln(sd, f"{blk}.norm1"),
                "norm2": _ln(sd, f"{blk}.norm2"),
                "attn": attn,
                "ffn": {
                    "fc1": _dense(sd, f"{blk}.mlp.fc1"),
                    "dwconv": _conv2d(sd, f"{blk}.mlp.dwconv.dwconv"),
                    "fc2": _dense(sd, f"{blk}.mlp.fc2"),
                },
            }
        params[f"stage{i}_norm"] = _ln(sd, f"{pvt}.norm{i + 1}")
    params["fc_audioset"] = _dense(sd, "fc_audioset")
    return {"params": params, "batch_stats": stats}


def _film(sd, prefix):
    """Film MLP (sound_extraction/model/film.py:4): Sequential Linear/ReLU/
    Linear/ReLU → {l1, l2}."""
    return {"l1": _dense(sd, f"{prefix}.linear.0"),
            "l2": _dense(sd, f"{prefix}.linear.2")}


def _cbr_cond(sd, prefix, has_shortcut):
    """ConvBlockResCond (sound_extraction/model/modules.py:326) →
    (params, batch_stats) for our block of the same name."""
    p: dict = {"conv1": _conv2d(sd, f"{prefix}.conv1"),
               "conv2": _conv2d(sd, f"{prefix}.conv2"),
               "film1": _film(sd, f"{prefix}.film1"),
               "film2": _film(sd, f"{prefix}.film2")}
    s: dict = {}
    for j in (1, 2):
        p[f"bn{j}"], s[f"bn{j}"] = _bn(sd, f"{prefix}.bn{j}")
    if has_shortcut:
        p["shortcut"] = _conv2d(sd, f"{prefix}.shortcut")
        p["film_res"] = _film(sd, f"{prefix}.film_res")
    return p, s


def convert_lassnet(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """LASSNet (text-queried extraction) →
    :class:`audiogpt_tpu_torch.models.extraction.lassnet.LASSNet`.

    Reference layout (``sound_extraction/model/LASSNet.py:7``): HF bert-mini
    under ``text_embedder.bert_layer.``, the CLS projection
    ``text_embedder.linear_layer.0``, and the FiLM res-U-Net under ``UNet.``
    (``resunet_film.py:4``: encoder_block1-6 / conv_block7 /
    decoder_block1-6 / after_conv_block1 / after_conv2). Ckpts are saved
    from an ``nn.DataParallel`` wrapper → 'module.' is stripped.
    """
    sd = {k.removeprefix("module."): np.asarray(v) for k, v in sd.items()}
    _warn_vocab_mismatch("lassnet", "the HF bert vocab.txt")
    bert = convert_bert(
        {k.removeprefix("text_embedder.bert_layer."): v for k, v in sd.items()
         if k.startswith("text_embedder.bert_layer.")}, cfg.bert)["params"]
    params: dict = {"text_encoder": bert,
                    "text_proj": _dense(sd, "text_embedder.linear_layer.0")}
    unet_p: dict = {}
    unet_s: dict = {}
    cin = 1
    for i, ch in enumerate(cfg.enc_channels):
        ep: dict = {}
        es: dict = {}
        for j, cb_in in ((1, cin), (2, ch)):
            ep[f"cb{j}"], es[f"cb{j}"] = _cbr_cond(
                sd, f"UNet.encoder_block{i + 1}.conv_block{j}",
                has_shortcut=cb_in != ch)
        unet_p[f"enc_{i}"], unet_s[f"enc_{i}"] = ep, es
        cin = ch
    unet_p["center"], unet_s["center"] = _cbr_cond(
        sd, "UNet.conv_block7", has_shortcut=False)
    for i, ch in enumerate(reversed(cfg.enc_channels)):  # mirror of encoder
        blk = f"UNet.decoder_block{i + 1}"
        w = np.asarray(sd[f"{blk}.conv1.weight"])  # [in, out, kh, kw]
        dp: dict = {"convT": {"kernel": w.transpose(2, 3, 1, 0)
                              .astype(np.float32)}}
        ds: dict = {}
        dp["bn1"], ds["bn1"] = _bn(sd, f"{blk}.bn1")
        # conv_block2 input is cat(up, skip) = 2*ch channels → shortcut
        dp["cb2"], ds["cb2"] = _cbr_cond(sd, f"{blk}.conv_block2", True)
        dp["cb3"], ds["cb3"] = _cbr_cond(sd, f"{blk}.conv_block3", False)
        unet_p[f"dec_{i}"], unet_s[f"dec_{i}"] = dp, ds
    unet_p["after_cb"], unet_s["after_cb"] = _cbr_cond(
        sd, "UNet.after_conv_block1", has_shortcut=False)
    unet_p["after_conv"] = _conv2d(sd, "UNet.after_conv2")
    params["unet"] = unet_p
    return {"params": params, "batch_stats": {"unet": unet_s}}


def convert_tsd(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """CDur_CNN14 target-sound detector
    (``audio_detection/target_sound_detection/src/models.py:964``) →
    :class:`audiogpt_tpu_torch.models.sed.tsd.TSDModel`: Cnn10 feature blocks
    ``features.conv_block{1-4}`` → ``b{0-3}_conv/bn``, the bidirectional
    ``gru``, and the ``fc``/``outputlayer`` heads."""
    sd = {k.removeprefix("model."): np.asarray(v) for k, v in sd.items()}
    params: dict = {}
    stats: dict = {}
    for b in range(len(cfg.channels)):
        blk = f"features.conv_block{b + 1}"
        for j in (1, 2):
            params[f"b{b}_conv{j}"] = _conv2d(sd, f"{blk}.conv{j}")
            p, s = _bn(sd, f"{blk}.bn{j}")
            params[f"b{b}_bn{j}"], stats[f"b{b}_bn{j}"] = p, s
    params["gru"] = _gru(sd, "gru", bidirectional=True)
    params["fc"] = _dense(sd, "fc")
    params["outputlayer"] = _dense(sd, "outputlayer")
    return {"params": params, "batch_stats": stats}


def convert_binaural(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """BinauralNetwork (``mono2binaural/src/models.py:86``) →
    :class:`audiogpt_tpu_torch.models.binaural.binaural.BinauralNetwork`. Only the
    Warpnet has parameters (``warper.layers.{i}`` k2 causal convs +
    ``warper.linear`` k1 head); the geometric warper and the monotone time
    warper are parameter-free math."""
    sd = {k.removeprefix("module."): np.asarray(v) for k, v in sd.items()}
    params: dict = {}
    for i in range(cfg.warpnet_layers):
        params[f"warp_conv_{i}"] = _conv1d(sd, f"warper.layers.{i}")
    params["warp_linear"] = _conv1d(sd, "warper.linear")
    return {"params": params}


def _clip_resblock(sd, prefix):
    """open_clip ResidualAttentionBlock (packed-in-proj MHA + c_fc/c_proj
    quick-GELU MLP) → our :class:`models.textenc.clip.ResidualBlock`."""
    return {
        "ln_1": _ln(sd, f"{prefix}.ln_1"),
        "in_proj": {
            "kernel": np.asarray(sd[f"{prefix}.attn.in_proj_weight"]
                                 ).T.astype(np.float32),
            "bias": np.asarray(sd[f"{prefix}.attn.in_proj_bias"]
                               ).astype(np.float32),
        },
        "out_proj": _dense(sd, f"{prefix}.attn.out_proj"),
        "ln_2": _ln(sd, f"{prefix}.ln_2"),
        "mlp_fc": _dense(sd, f"{prefix}.mlp.c_fc"),
        "mlp_proj": _dense(sd, f"{prefix}.mlp.c_proj"),
    }


def convert_clip_vision(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """open_clip ``visual.`` tower (the I2A conditioner,
    ``ldm/modules/encoders/modules.py:315`` wraps ViT-H-14) →
    :class:`audiogpt_tpu_torch.models.textenc.clip.CLIPVisionEncoder`."""
    sd0 = {k.removeprefix("model."): v for k, v in sd.items()}
    if any(k.startswith("visual.") for k in sd0):
        # full CLIP state dict: keep ONLY the visual subtree (text-tower
        # keys like 'transformer.*'/'positional_embedding' would otherwise
        # collide with the stripped vision names)
        sd = {k[len("visual."):]: np.asarray(v) for k, v in sd0.items()
              if k.startswith("visual.")}
    else:
        sd = {k: np.asarray(v) for k, v in sd0.items()}
    p: dict = {
        "patch_embed": {"kernel": np.asarray(sd["conv1.weight"])
                        .transpose(2, 3, 1, 0).astype(np.float32)},
        "class_embedding": np.asarray(sd["class_embedding"]).astype(np.float32),
        "positional_embedding": np.asarray(sd["positional_embedding"]
                                           ).astype(np.float32),
        "ln_pre": _ln(sd, "ln_pre"),
        "ln_post": _ln(sd, "ln_post"),
        "proj": np.asarray(sd["proj"]).astype(np.float32),
    }
    for i in range(cfg.layers):
        p[f"block{i}"] = _clip_resblock(sd, f"transformer.resblocks.{i}")
    return {"params": p}


def convert_clip_text_tower(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """open_clip text tower → :class:`CLIPTextTower` (EOT pooling)."""
    sd = {k.removeprefix("model."): np.asarray(v) for k, v in sd.items()
          if not k.startswith(("visual.", "model.visual."))}
    p: dict = {
        "token_embedding": {"embedding": np.asarray(
            sd["token_embedding.weight"]).astype(np.float32)},
        "positional_embedding": np.asarray(sd["positional_embedding"]
                                           ).astype(np.float32),
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": np.asarray(sd["text_projection"]).astype(np.float32),
    }
    for i in range(cfg.layers):
        p[f"block{i}"] = _clip_resblock(sd, f"transformer.resblocks.{i}")
    return {"params": p}


def convert_diffsinger(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """Full DiffSinger E2E checkpoint (``GaussianDiffusion`` with the
    FastSpeech2MIDI conditioner under ``fs2.`` and the WaveNet denoiser under
    ``denoise_fn.``, ``modules/diff/shallow_diffusion_tts.py:71``) →
    :class:`audiogpt_tpu_torch.models.svs.diffsinger.DiffSinger` (submodules
    ``fs2`` / ``denoiser``)."""
    sd = {k.removeprefix("model."): np.asarray(v) for k, v in sd.items()}
    fs2 = convert_fastspeech2(
        {k.removeprefix("fs2."): v for k, v in sd.items()
         if k.startswith("fs2.")}, cfg.fs2)["params"]
    net = convert_diffnet(
        {k: v for k, v in sd.items() if k.startswith("denoise_fn.")},
        cfg.net)["params"]
    return {"params": {"fs2": fs2, "denoiser": net}}


# ---------------------------------------------------------------------------
# HTSAT (open_clap/htsat.py HTSAT_Swin_Transformer) — the CLAP audio tower
# ---------------------------------------------------------------------------


def convert_htsat(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """``HTSAT_Swin_Transformer`` state dict →
    :class:`audiogpt_tpu_torch.models.textenc.htsat.HTSATAudioEncoder` params.

    Accepts bare tower dicts and the ``audio_branch.``-prefixed keys inside a
    full CLAP checkpoint (open_clap/model.py:467); when ``audio_projection.*``
    keys are present (model.py:540 Linear-ReLU-Linear) they map onto the
    ``projection`` module. The reference's ``head`` linear is dead code in
    ``forward_features`` (htsat.py:964) and is ignored.
    """
    sd = {k.removeprefix("sed_model.").removeprefix("audio_branch.")
          .removeprefix("module."): np.asarray(v) for k, v in sd.items()}

    def conv2d(prefix):
        out = {"kernel": np.asarray(sd[prefix + ".weight"]).transpose(
            2, 3, 1, 0).astype(np.float32)}
        if prefix + ".bias" in sd:
            out["bias"] = np.asarray(sd[prefix + ".bias"]).astype(np.float32)
        return out

    swin: dict = {
        "patch_proj": conv2d("patch_embed.proj"),
        "patch_norm": _ln_t(sd, "patch_embed.norm"),
        "norm": _ln_t(sd, "norm"),
        "tscam_conv": conv2d("tscam_conv"),
    }
    for i, depth in enumerate(cfg.depths):
        for d in range(depth):
            b = f"layers.{i}.blocks.{d}"
            swin[f"layer{i}_block{d}"] = {
                "norm1": _ln_t(sd, f"{b}.norm1"),
                "norm2": _ln_t(sd, f"{b}.norm2"),
                "attn": {
                    "qkv": _dense(sd, f"{b}.attn.qkv"),
                    "proj": _dense(sd, f"{b}.attn.proj"),
                    "rel_pos_bias": np.asarray(
                        sd[f"{b}.attn.relative_position_bias_table"]
                    ).astype(np.float32),
                },
                "fc1": _dense(sd, f"{b}.mlp.fc1"),
                "fc2": _dense(sd, f"{b}.mlp.fc2"),
            }
        if i < len(cfg.depths) - 1:
            swin[f"downsample{i}"] = {
                "norm": _ln_t(sd, f"layers.{i}.downsample.norm"),
                "reduction": _nobias_dense(sd, f"layers.{i}.downsample.reduction"),
            }
    params: dict = {
        "bn0_scale": np.asarray(sd["bn0.weight"]).astype(np.float32),
        "bn0_bias": np.asarray(sd["bn0.bias"]).astype(np.float32),
        "bn0_mean": np.asarray(sd["bn0.running_mean"]).astype(np.float32),
        "bn0_var": np.asarray(sd["bn0.running_var"]).astype(np.float32),
        "swin": swin,
    }
    if "audio_projection.0.weight" in sd:
        params["projection"] = {"fc1": _dense(sd, "audio_projection.0"),
                                "fc2": _dense(sd, "audio_projection.2")}
    return {"params": params}


def convert_t5(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """HF ``T5EncoderModel`` state dict (t5-v1_1-* / flan-t5-*) → the JAX
    package's ``models/textenc/t5.py`` ``T5Encoder`` params
    (``FrozenT5Embedder``/``FrozenFLANEmbedder`` towers,
    ``ldm/modules/encoders/modules.py:143,287``). All T5 Linears are
    bias-free; layer norms are RMS (weight only). The tree loads into the
    port's ``models/textenc/t5.py`` ``T5Encoder`` of the same ``cfg``
    (``T5Config``)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    emb_key = "shared.weight" if "shared.weight" in sd else \
        "encoder.embed_tokens.weight"
    p: dict = {"embed": {"embedding": sd[emb_key].astype(np.float32)},
               "final_ln": {"weight":
                            sd["encoder.final_layer_norm.weight"
                               ].astype(np.float32)}}
    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}.layer"
        attn = {
            "q": _dense(sd, f"{b}.0.SelfAttention.q"),
            "k": _dense(sd, f"{b}.0.SelfAttention.k"),
            "v": _dense(sd, f"{b}.0.SelfAttention.v"),
            "o": _dense(sd, f"{b}.0.SelfAttention.o"),
        }
        if i == 0:
            attn["rel_bias"] = sd[
                f"{b}.0.SelfAttention.relative_attention_bias.weight"
            ].astype(np.float32)
        layer = {
            "attn": attn,
            "attn_ln": {"weight": sd[f"{b}.0.layer_norm.weight"
                                     ].astype(np.float32)},
            "ff_ln": {"weight": sd[f"{b}.1.layer_norm.weight"
                                   ].astype(np.float32)},
            "wo": _dense(sd, f"{b}.1.DenseReluDense.wo"),
        }
        if cfg.feed_forward == "gated-gelu":
            layer["wi_0"] = _dense(sd, f"{b}.1.DenseReluDense.wi_0")
            layer["wi_1"] = _dense(sd, f"{b}.1.DenseReluDense.wi_1")
        else:
            layer["wi"] = _dense(sd, f"{b}.1.DenseReluDense.wi")
        p[f"block_{i}"] = layer
    return {"params": p}


def convert_clip_text_hf(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """HF ``CLIPTextModel`` layout (StableDiffusion ``cond_stage_model.
    transformer.text_model.*``) → :class:`CLIPTextTower`. Separate
    q/k/v Linears repack into the tower's fused ``in_proj``; HF has no text
    projection — identity is installed so the pooled path stays callable."""
    clean = {}
    for k, v in sd.items():
        for pre in ("cond_stage_model.transformer.text_model.",
                    "text_model.", "transformer.text_model."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        clean[k] = np.asarray(v)
    sd = clean
    p: dict = {
        "token_embedding": {"embedding": sd[
            "embeddings.token_embedding.weight"].astype(np.float32)},
        "positional_embedding": sd[
            "embeddings.position_embedding.weight"].astype(np.float32),
        "ln_final": _ln(sd, "final_layer_norm"),
        "text_projection": np.eye(cfg.width, cfg.embed_dim,
                                  dtype=np.float32),
    }
    for i in range(cfg.layers):
        b = f"encoder.layers.{i}"
        w = np.concatenate([sd[f"{b}.self_attn.{n}_proj.weight"]
                            for n in "qkv"], axis=0)
        bias = np.concatenate([sd[f"{b}.self_attn.{n}_proj.bias"]
                               for n in "qkv"], axis=0)
        p[f"block{i}"] = {
            "ln_1": _ln(sd, f"{b}.layer_norm1"),
            "ln_2": _ln(sd, f"{b}.layer_norm2"),
            "in_proj": {"kernel": w.T.astype(np.float32),
                        "bias": bias.astype(np.float32)},
            "out_proj": _dense(sd, f"{b}.self_attn.out_proj"),
            "mlp_fc": _dense(sd, f"{b}.mlp.fc1"),
            "mlp_proj": _dense(sd, f"{b}.mlp.fc2"),
        }
    return {"params": p}


def convert_blip(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """HF ``BlipForConditionalGeneration`` (``Salesforce/blip-image-
    captioning-base``, the reference ImageCaptioning tool's checkpoint —
    ``audio-chatgpt.py:126-137``) → :class:`BlipCaptioner`.

    Vision tower: fused ``qkv`` Linear maps 1:1; patch Conv2d transposes to
    NHWC. Text decoder: BERT-style q/k/v + cross q/k/v + post-LN trees; the
    LM head's ``predictions.decoder``/``predictions.bias`` pair (HF ties
    ``decoder.bias = bias``) lands in ``head_out``.
    """
    vis: dict = {
        "patch_embed": _conv2d(sd, "vision_model.embeddings.patch_embedding"),
        "class_embedding": np.asarray(
            sd["vision_model.embeddings.class_embedding"]).reshape(-1)
            .astype(np.float32),
        "position_embedding": np.asarray(
            sd["vision_model.embeddings.position_embedding"])[0]
            .astype(np.float32),
        "post_ln": _ln(sd, "vision_model.post_layernorm"),
    }
    for i in range(cfg.vision.layers):
        b = f"vision_model.encoder.layers.{i}"
        vis[f"block{i}"] = {
            "ln_1": _ln(sd, f"{b}.layer_norm1"),
            "ln_2": _ln(sd, f"{b}.layer_norm2"),
            "qkv": _dense(sd, f"{b}.self_attn.qkv"),
            "proj": _dense(sd, f"{b}.self_attn.projection"),
            "fc1": _dense(sd, f"{b}.mlp.fc1"),
            "fc2": _dense(sd, f"{b}.mlp.fc2"),
        }
    txt: dict = {
        "word_emb": {"embedding": np.asarray(
            sd["text_decoder.bert.embeddings.word_embeddings.weight"])
            .astype(np.float32)},
        "pos_emb": np.asarray(
            sd["text_decoder.bert.embeddings.position_embeddings.weight"])
            .astype(np.float32),
        "emb_ln": _ln(sd, "text_decoder.bert.embeddings.LayerNorm"),
        "head_dense": _dense(sd, "text_decoder.cls.predictions.transform.dense"),
        "head_ln": _ln(sd, "text_decoder.cls.predictions.transform.LayerNorm"),
        "head_out": {
            "kernel": np.asarray(
                sd["text_decoder.cls.predictions.decoder.weight"]).T
                .astype(np.float32),
            "bias": np.asarray(sd["text_decoder.cls.predictions.bias"])
                .astype(np.float32),
        },
    }
    for i in range(cfg.text.layers):
        b = f"text_decoder.bert.encoder.layer.{i}"
        txt[f"layer_{i}"] = {
            "q": _dense(sd, f"{b}.attention.self.query"),
            "k": _dense(sd, f"{b}.attention.self.key"),
            "v": _dense(sd, f"{b}.attention.self.value"),
            "attn_out": _dense(sd, f"{b}.attention.output.dense"),
            "attn_ln": _ln(sd, f"{b}.attention.output.LayerNorm"),
            "xq": _dense(sd, f"{b}.crossattention.self.query"),
            "xk": _dense(sd, f"{b}.crossattention.self.key"),
            "xv": _dense(sd, f"{b}.crossattention.self.value"),
            "x_out": _dense(sd, f"{b}.crossattention.output.dense"),
            "x_ln": _ln(sd, f"{b}.crossattention.output.LayerNorm"),
            "inter": _dense(sd, f"{b}.intermediate.dense"),
            "out": _dense(sd, f"{b}.output.dense"),
            "out_ln": _ln(sd, f"{b}.output.LayerNorm"),
        }
    return {"params": {"vision": vis, "decoder": txt}}


def convert_gpt2(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """HF ``GPT2LMHeadModel`` (e.g. ``Gustavosta/MagicPrompt-Stable-
    Diffusion``, the reference T2I tool's prompt refiner —
    ``audio-chatgpt.py:112-113``) → :class:`GPT2LM`.

    HF's ``Conv1D`` stores weights ``[in, out]`` — already the flax Dense
    kernel layout, so attention/MLP weights map WITHOUT the transpose every
    ``nn.Linear`` needs. The LM head is tied to ``wte`` (no separate
    tensor to import).
    """
    def _c1d(prefix):
        return {"kernel": np.asarray(sd[f"{prefix}.weight"]).astype(np.float32),
                "bias": np.asarray(sd[f"{prefix}.bias"]).astype(np.float32)}

    p: dict = {
        "wte": {"embedding": np.asarray(
            sd["transformer.wte.weight"]).astype(np.float32)},
        "wpe": np.asarray(sd["transformer.wpe.weight"]).astype(np.float32),
        "ln_f": _ln(sd, "transformer.ln_f"),
    }
    for i in range(cfg.layers):
        b = f"transformer.h.{i}"
        p[f"h{i}"] = {
            "ln_1": _ln(sd, f"{b}.ln_1"),
            "c_attn": _c1d(f"{b}.attn.c_attn"),
            "c_proj": _c1d(f"{b}.attn.c_proj"),
            "ln_2": _ln(sd, f"{b}.ln_2"),
            "c_fc": _c1d(f"{b}.mlp.c_fc"),
            "mlp_proj": _c1d(f"{b}.mlp.c_proj"),
        }
    return {"params": p}
