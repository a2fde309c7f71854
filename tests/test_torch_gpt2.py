"""The T2I prompt refiner (``models/textenc/gpt2.py``) against the JAX
package's on the CPU: ``GPT2LM``'s logits on a left-padded prefill and
over the KV cache (f32, 1e-5), ``greedy_generate``'s ids on prompts of two
lengths in one bucket (equal), ``MagicPromptRefiner``'s string with the
BPE fixture's codec (equal), and ``--ckpt t2i_refiner=DIR`` wiring the
refiner into ``T2IEngine``.

The vocabulary is the fixture's (``tests/test_bpe.py`` ``_write_fixture``:
256 bytes, the fixture merges and ``<|endoftext|>`` as EOS), the width 128
with two heads of 64 (what ``GPT2Config.from_tree`` infers from a tree).
JAX's variables come from ``jax.eval_shape`` filled with seeded numpy."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.textenc import gpt2 as jg
from audiogpt_tpu.ops.attention import KVCache as JaxKVCache
from audiogpt_tpu.text.bpe import load_gpt2_bpe as jax_load_gpt2_bpe
from audiogpt_tpu_torch import app
from audiogpt_tpu_torch.import_ckpt import save_params
from audiogpt_tpu_torch.models.textenc.gpt2 import (GPT2Config, GPT2LM,
                                                    MagicPromptRefiner,
                                                    bucket_prompt,
                                                    greedy_generate)
from audiogpt_tpu_torch.ops.attention import KVCache, attention
from audiogpt_tpu_torch.ops.flash_attention import flash_attention
from audiogpt_tpu_torch.text.bpe import load_gpt2_bpe
from audiogpt_tpu_torch.utils.jax_params import load_jax_params
from test_bpe import _fixture_vocab, _write_fixture

torch.set_num_threads(2)

VOCAB = len(_fixture_vocab())
CFG = dict(vocab_size=VOCAB, n_positions=64, width=128, layers=2, heads=2,
           eos_id=VOCAB - 1)


@functools.lru_cache(maxsize=None)
def reference():
    """JAX's model and variables (kernels N(0, 1/fan-in), the rest
    N(0, 0.02²) plus ones on the norm scales), and the port model on them."""
    jmodel = jg.GPT2LM(jg.GPT2Config(**CFG))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(0)

    def leaf(path, s):
        a = rng.normal(size=s.shape)
        if path[-1].key == "scale":
            a = 1.0 + 0.1 * a
        elif path[-1].key == "kernel":
            a = a / np.sqrt(s.shape[0])
        else:
            a = 0.3 * a
        return a.astype(np.float32)

    params = jax.tree.map(np.asarray,
                          jax.tree_util.tree_map_with_path(leaf, shapes))
    model = GPT2LM(GPT2Config(**CFG)).eval()
    load_jax_params(model, params)
    return jmodel, params, model


def test_logits_match_jax_on_prefill_and_over_the_cache():
    """A left-padded batch of two (5 and 8 real tokens in 8): the prefill's
    logits at the real positions, then two decode steps over the cache with
    the causal-and-padding mask."""
    jmodel, params, model = reference()
    rng = np.random.default_rng(1)
    b, L, new = 2, 8, 2
    toks = rng.integers(0, VOCAB - 1, (b, L)).astype(np.int32)
    valid = np.ones((b, L), np.int32)
    valid[0, :3] = 0
    toks[0, :3] = CFG["eos_id"]
    kv_valid = np.concatenate([valid, np.ones((b, new), np.int32)], 1)
    pos = np.maximum(np.cumsum(valid, 1) - 1, 0)
    heads, d = CFG["heads"], CFG["width"] // CFG["heads"]
    steps = rng.integers(0, VOCAB - 1, (new, b)).astype(np.int32)

    def jax_run(p):
        caches = [JaxKVCache.create(b, L + new, heads, d)
                  for _ in range(CFG["layers"])]
        outs = []
        logits, caches = jmodel.apply(p, toks, pos, caches, kv_valid)
        outs.append(logits)
        plen = valid.sum(1)
        for i in range(new):
            logits, caches = jmodel.apply(p, steps[i][:, None],
                                          (plen + i)[:, None], caches,
                                          kv_valid)
            outs.append(logits)
        return outs

    want = [np.asarray(o) for o in jax.jit(jax_run)(params)]
    caches = [KVCache.create(b, L + new, heads, d)
              for _ in range(CFG["layers"])]
    t = {k: torch.from_numpy(v).long() for k, v in
         (("toks", toks), ("pos", pos), ("kv", kv_valid))}
    with torch.no_grad():
        got = [model(t["toks"], t["pos"], caches, t["kv"])]
        plen = torch.from_numpy(valid.sum(1)).long()
        for i in range(new):
            got.append(model(torch.from_numpy(steps[i][:, None]).long(),
                             (plen + i)[:, None], caches, t["kv"]))
        plain = model(t["toks"], t["pos"], None, t["kv"][:, :L])
    real = valid.astype(bool)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy()[real], want[0][real], rtol=0,
                               atol=1e-5)
    # without a cache the prefill is the same program
    np.testing.assert_allclose(plain.numpy()[real], want[0][real], rtol=0,
                               atol=1e-5)


def test_greedy_ids_equal_jax_on_two_prompt_lengths_in_one_bucket():
    """Prompts of 5 and 7 ids, both left-padded to the bucket of 8: the
    continuations equal JAX's ``greedy_generate`` (one compiled program for
    the bucket)."""
    jmodel, params, model = reference()
    rng = np.random.default_rng(2)
    for n in (5, 7):
        prompt = [int(x) for x in rng.integers(0, VOCAB - 1, n)]
        assert bucket_prompt(prompt, CFG["eos_id"])[0].shape == (1, 8)
        want = jg.greedy_generate(jmodel, params, prompt, max_new=12)
        got = greedy_generate(model, prompt, max_new=12)
        assert got == want and len(got) > 3


@pytest.fixture()
def fixture_codecs(tmp_path):
    _, vj, mt = _write_fixture(tmp_path)
    return load_gpt2_bpe(vj, mt), jax_load_gpt2_bpe(vj, mt), tmp_path


def test_refiner_string_equals_jax(fixture_codecs):
    """Prompt + decoded greedy continuation, the same string as JAX's
    refiner (12 new tokens: the greedy test's compiled JAX program);
    without a codec the prompt comes back unrefined, with a warning."""
    codec, jcodec, _ = fixture_codecs
    jmodel, params, _ = reference()
    jref = jg.MagicPromptRefiner(jg.GPT2Config(**CFG), params=params,
                                 codec=jcodec, max_new_tokens=12)
    ref = MagicPromptRefiner(GPT2Config(**CFG), params=params, codec=codec,
                             max_new_tokens=12, device="cpu")
    for text in ("the word", "at the rate"):
        want = jref(text)
        assert ref(text) == want and want.startswith(text)
        assert len(want) > len(text)
    bare = MagicPromptRefiner(GPT2Config(**CFG), params=params,
                              max_new_tokens=12, device="cpu")
    with pytest.warns(UserWarning, match="unrefined"):
        assert bare("hello") == "hello"


def test_ckpt_t2i_refiner_wires_the_refiner_into_t2i(fixture_codecs,
                                                     tmp_path):
    """``load_engine_ckpts(engines, ["t2i_refiner=DIR"])`` with a tree that
    ``import_ckpt`` wrote and the vocab beside it: the T2I engine's refiner
    gives the refiner's string; without a T2I engine it is a
    ``SystemExit``."""
    from audiogpt_tpu_torch.engines.t2i import T2IConfig, T2IEngine
    from audiogpt_tpu_torch.models.diffusion import UNetConfig, VAEConfig
    from audiogpt_tpu_torch.models.textenc.clip import CLIPTextConfig

    codec, _, root = fixture_codecs
    _, params, _ = reference()
    save_params(params, str(root))
    cfg = T2IConfig(unet=UNetConfig(model_channels=32, num_res_blocks=1,
                                    num_heads=4, context_dim=32),
                    vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                  attn_resolutions=(), in_channels=3,
                                  out_ch=3),
                    text=CLIPTextConfig(width=32, layers=1, heads=2,
                                        embed_dim=32), height=32, width=32)
    eng = T2IEngine(cfg, tokenizer=None,
                    media_root=str(tmp_path), device="cpu")
    app.load_engine_ckpts({"t2i": eng}, [f"t2i_refiner={root}"])
    assert isinstance(eng.text_refiner, MagicPromptRefiner)
    assert eng.text_refiner.cfg == GPT2Config(**CFG)
    direct = MagicPromptRefiner(GPT2Config(**CFG), params=params, codec=codec,
                                device="cpu")
    assert eng.text_refiner("the word") == direct("the word")
    with pytest.raises(SystemExit, match="t2i engine not enabled"):
        app.load_engine_ckpts({}, [f"t2i_refiner={root}"])


def test_prefill_causal_mask_agrees_between_the_kernel_and_the_plain_path():
    """A prefill has Tq = Tk: the kernel's top-left causal masking (its
    plain version, ``flash_attention`` on CPU tensors) and the plain path's
    bottom-right one give the same rows wherever a row has a valid key
    (left padding masked as keys)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 12, 2, 64))
                                .astype(np.float32)) for _ in range(3))
    kv = torch.ones(2, 12, dtype=torch.long)
    kv[0, :5] = 0
    plain = attention(q, k, v, is_causal=True, kv_mask=kv)
    kernel = flash_attention(q, k, v, kv_mask=kv, causal=True)
    rows = torch.ones(2, 12, dtype=torch.bool)
    rows[0, :5] = False
    torch.testing.assert_close(kernel[rows], plain[rows], rtol=0, atol=1e-6)
