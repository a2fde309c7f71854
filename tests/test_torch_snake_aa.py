"""Port snake-AA (``audiogpt_tpu_torch.ops.snake_aa``) against the JAX
package: the Pallas kernel in interpret mode and the literal ``SnakeAA``
chain, on the same numpy inputs. On the CPU the port's wrapper runs its
plain version; the CUDA kernel's index math is checked here through a
float64 numpy replay of its per-lane runs, warp-shuffle neighbour exchange
and edge substitutions."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.models.vocoder.bigvgan import SnakeAA as JaxSnakeAA
from audiogpt_tpu.models.vocoder.bigvgan import \
    kaiser_sinc_filter1d as jax_kaiser
from audiogpt_tpu.ops.snake_aa import snake_aa_pallas
from audiogpt_tpu_torch.models.vocoder.bigvgan import SnakeAA
from audiogpt_tpu_torch.ops.snake_aa import (
    kaiser_sinc_filter1d,
    snake_aa,
    snake_aa_reference,
)
from audiogpt_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(2)

#: f32, one activation: both sides run the same FIR taps in another
#: summation order; outputs are O(1), so 1e-5 absolute holds with margin
ATOL = 1e-5
CU = Path(__file__).resolve().parent.parent / "audiogpt_tpu_torch" / "csrc" \
    / "snake_aa.cu"


def _inputs(b, t, c, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, c).astype(np.float32)          # JAX layout [B, T, C]
    log_a = (0.3 * rng.randn(c)).astype(np.float32)
    log_b = (0.3 * rng.randn(c)).astype(np.float32)
    return x, log_a, log_b


def _port(x_btc, alpha, beta):
    x = torch.from_numpy(x_btc).transpose(1, 2).contiguous()
    y = snake_aa(x, torch.from_numpy(alpha), torch.from_numpy(beta))
    return y.transpose(1, 2).numpy()


@pytest.mark.parametrize("cutoff,half_width,k", [(0.25, 0.3, 12),
                                                 (0.125, 0.15, 24),
                                                 (0.5, 0.6, 7)])
def test_filter_matches_jax(cutoff, half_width, k):
    np.testing.assert_array_equal(kaiser_sinc_filter1d(cutoff, half_width, k),
                                  jax_kaiser(cutoff, half_width, k))


def test_kernel_taps_are_the_filter():
    """The taps compiled into the CUDA kernel are the f32 filter, exactly."""
    body = CU.read_text().split("kDn[12] = {", 1)[1].split("}", 1)[0]
    taps = np.asarray([float(v) for v in re.findall(r"[-+0-9.e]+(?=f)", body)],
                      np.float32)
    np.testing.assert_array_equal(taps, kaiser_sinc_filter1d(0.25, 0.3, 12))


@pytest.mark.parametrize("variant", ["snake", "snakebeta"])
@pytest.mark.parametrize("t", [37, 53])
def test_matches_jax_pallas(variant, t):
    x, log_a, log_b = _inputs(2, t, 8, seed=t)
    alpha = np.exp(log_a)
    beta = alpha if variant == "snake" else np.exp(log_b)
    ref = snake_aa_pallas(jnp.asarray(x), jnp.asarray(alpha),
                          jnp.asarray(beta), interpret=True)
    np.testing.assert_allclose(_port(x, alpha, beta), np.asarray(ref),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["snake", "snakebeta"])
def test_module_matches_jax_literal(variant):
    """Port ``SnakeAA`` with JAX params carried across vs JAX
    ``SnakeAA(impl='literal')`` (α, β log-scale, shifted off zero)."""
    x, log_a, log_b = _inputs(2, 41, 8, seed=3)
    tree = {"params": {"alpha": log_a}}
    if variant == "snakebeta":
        tree["params"]["beta"] = log_b
    ref = jax.jit(JaxSnakeAA(8, variant, True, impl="literal").apply)(
        {"params": {k: jnp.asarray(v) for k, v in tree["params"].items()}},
        jnp.asarray(x))
    mod = SnakeAA(8, variant, True)
    load_jax_params(mod, tree)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).transpose(1, 2).contiguous())
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)


def _kernel_replay(x, alpha, beta, seg, run=8):
    """float64 replay of ``csrc/snake_aa.cu`` on x [B, C, T]. A warp writes
    ``seg`` outputs with ``seg // run`` storing lanes; lane l of the warp at
    s0 owns the run starting at p0 = s0 + (l - 1)·run (lane 0 and the last
    lane are halos and store nothing), loads it clamped to the row, takes 3
    samples on each side and the 2-3 phase values its down FIR reaches from
    the neighbouring lanes (a shuffle from past the warp's ends returns the
    lane's own value), and applies the edge substitutions."""
    dn = kaiser_sinc_filter1d(0.25, 0.3, 12).astype(np.float64)
    up = 2.0 * dn
    t_len = x.shape[-1]
    lanes = seg // run + 2
    out = np.full_like(x, np.nan)
    a = alpha[None, :, None, None]
    inv_b = 1.0 / (beta[None, :, None, None] + 1e-9)

    def from_left(v):       # __shfl_up_sync(v, 1): lane l reads lane l - 1
        return np.concatenate([v[..., :1, :], v[..., :-1, :]], axis=-2)

    def from_right(v):      # __shfl_down_sync(v, 1): lane l reads lane l + 1
        return np.concatenate([v[..., 1:, :], v[..., -1:, :]], axis=-2)

    def snake(v):
        return v + inv_b * np.sin(v * a) ** 2

    for s0 in range(0, t_len, seg):
        p0 = s0 + (np.arange(lanes) - 1) * run                 # [lanes]
        pos = p0[:, None] + np.arange(run)                       # [lanes, run]
        xv = x[..., np.clip(pos, 0, t_len - 1)]                  # [B,C,L,run]
        xw = np.concatenate([from_left(xv)[..., -3:], xv,
                             from_right(xv)[..., :3]], axis=-1)
        e = sum(up[2 * k] * xw[..., k:k + run] for k in range(6))
        o = sum(up[2 * k + 1] * xw[..., k + 1:k + 1 + run] for k in range(6))
        se, so = snake(e), snake(o)
        # sew[i] = SE[p0 - 2 + i], sow[i] = SO[p0 - 3 + i]
        sew = np.concatenate([from_left(se)[..., -2:], se,
                              from_right(se)[..., :3]], axis=-1)
        sow = np.concatenate([from_left(so)[..., -3:], so,
                              from_right(so)[..., :2]], axis=-1)
        pe = p0[:, None] - 2 + np.arange(run + 5)
        po = p0[:, None] - 3 + np.arange(run + 5)
        sew = np.where(pe < 0, se[..., :1], sew)
        sow = np.where(po < 0, se[..., :1], sow)
        last = np.where(po == t_len - 1, sow, 0.0).sum(-1, keepdims=True)
        sew = np.where(pe > t_len - 1, last, sew)
        sow = np.where(po > t_len - 1, last, sow)
        y = sum(dn[2 * b + 1] * sew[..., b:b + run]
                + dn[2 * b] * sow[..., b:b + run] for b in range(6))
        for lane in range(1, lanes - 1):
            n = min(run, t_len - p0[lane])
            if n > 0:
                out[..., p0[lane]:p0[lane] + n] = y[..., lane, :n]
    return out


@pytest.mark.parametrize("t,tile", [(37, 16), (53, 1024), (64, 16), (3, 16),
                                    (1, 240), (241, 240), (500, 240)])
def test_kernel_index_math_float64(t, tile):
    """The kernel's runs, neighbour exchange and edge substitutions
    reproduce the literal chain (with its replicate pads) in float64, with
    warps of ``tile`` outputs (240 on the card), including warps that end
    within 6 samples of either edge and rows shorter than one run."""
    rng = np.random.RandomState(t)
    x = rng.randn(2, 3, t)
    alpha = np.exp(0.3 * rng.randn(3))
    beta = np.exp(0.3 * rng.randn(3))
    ref = snake_aa_reference(torch.from_numpy(x), torch.from_numpy(alpha),
                             torch.from_numpy(beta)).numpy()
    np.testing.assert_allclose(_kernel_replay(x, alpha, beta, tile), ref,
                               atol=1e-12, rtol=0)


def test_bf16_input_keeps_dtype():
    x, log_a, log_b = _inputs(1, 48, 8, seed=0)
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    a, b = torch.from_numpy(np.exp(log_a)), torch.from_numpy(np.exp(log_b))
    got = snake_aa(xt.bfloat16(), a, b)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               snake_aa(xt.bfloat16().float(), a, b).numpy(),
                               atol=1e-6, rtol=2 ** -8)


def test_non_cpu_tensor_never_falls_back():
    x = torch.empty(1, 4, 16, device="meta")
    with pytest.raises(ValueError):
        snake_aa(x, torch.ones(4, device="meta"), torch.ones(4, device="meta"))


def test_kernel_refuses_what_needs_a_gradient():
    """The CUDA kernel has no backward: ``needs_grad`` (the refusal's
    predicate) holds when grad mode is on and x, α or β requires grad; the
    plain version on the CPU stays differentiable."""
    from audiogpt_tpu_torch.ops.snake_aa import needs_grad

    x, a, b = torch.randn(1, 4, 16), torch.ones(4), torch.ones(4)
    assert not needs_grad(x, a, b)
    for t in (x, a, b):
        t.requires_grad_()
        assert needs_grad(x, a, b)
        with torch.no_grad():
            assert not needs_grad(x, a, b)
        t.requires_grad_(False)
    a.requires_grad_()
    snake_aa(x, a, b).sum().backward()
    assert a.grad is not None and torch.isfinite(a.grad).all()
