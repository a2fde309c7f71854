"""Port snake-AA (``audiogpt_tpu_torch.ops.snake_aa``) against the JAX
package: the Pallas kernel in interpret mode and the literal ``SnakeAA``
chain, on the same numpy inputs. On the CPU the port's wrapper runs its
plain version; the CUDA kernel's index math is checked here through a
float64 numpy replay of its tiles, halos and edge clamps."""

import re
from pathlib import Path

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
    ref = JaxSnakeAA(8, variant, True, impl="literal").apply(
        {"params": {k: jnp.asarray(v) for k, v in tree["params"].items()}},
        jnp.asarray(x))
    mod = SnakeAA(8, variant, True)
    load_jax_params(mod, tree)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).transpose(1, 2).contiguous())
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)


def _kernel_replay(x, alpha, beta, tile):
    """float64 replay of ``csrc/snake_aa.cu`` on x [B, C, T]: per tile, the
    clamped halo load, both phases at the clamped positions with the edge
    substitutions, and the down FIR."""
    dn = kaiser_sinc_filter1d(0.25, 0.3, 12).astype(np.float64)
    up = 2.0 * dn
    b, c, t_len = x.shape
    out = np.empty_like(x)
    a = alpha[None, :, None]
    inv_b = 1.0 / (beta[None, :, None] + 1e-9)
    for t0 in range(0, t_len, tile):
        xs = x[..., np.clip(np.arange(t0 - 6, t0 + tile + 6), 0, t_len - 1)]
        u = np.arange(t0 - 3, t0 + tile + 3)
        uu = np.clip(u, 0, t_len - 1)
        base = uu - t0 + 6                      # xs index of x[uu]
        e = sum(up[2 * k] * xs[..., base + k - 3] for k in range(6))
        o = sum(up[2 * k + 1] * xs[..., base + k - 2] for k in range(6))
        s_e = e + inv_b * np.sin(e * a) ** 2
        s_o = o + inv_b * np.sin(o * a) ** 2
        se = np.where(u > t_len - 1, s_o, s_e)
        so = np.where(u < 0, s_e, s_o)
        n = min(tile, t_len - t0)
        i = np.arange(n)
        out[..., t0:t0 + n] = sum(dn[2 * k + 1] * se[..., i + k + 1]
                                  + dn[2 * k] * so[..., i + k]
                                  for k in range(6))
    return out


@pytest.mark.parametrize("t,tile", [(37, 16), (53, 1024), (64, 16), (3, 16)])
def test_kernel_index_math_float64(t, tile):
    """The kernel's tiling and edge clamps reproduce the literal chain (with
    its replicate pads) in float64, including tiles that end within 6
    samples of either edge."""
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
