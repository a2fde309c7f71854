"""Port attention (``audiogpt_tpu_torch.ops.attention`` / ``flash_attention``)
against the JAX package on the same numpy inputs: the plain flash version
vs the Pallas kernel in interpret mode, and ``attention()`` on both
dispatch branches. The CUDA kernel's tile loop (online softmax over 64-key
tiles, causal tile skipping, -inf masking) is replayed in numpy here.

JAX's two flash versions agree with each other only with no fully masked
row and with causal at Tq == Tk, so the JAX comparisons stay there; the
port's own semantics for a fully masked row (0) are tested separately."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.ops.attention import attention as jax_attention
from audiogpt_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from audiogpt_tpu_torch.ops.attention import attention
from audiogpt_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

torch.set_num_threads(2)

#: f32 softmax-weighted sums of O(1) values over ≤ 200 keys, summed in
#: another order (blockwise vs full rows): 1e-5 absolute holds with margin
ATOL = 1e-5


def _qkv(b, tq, tk, h, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, tq, h, d).astype(np.float32),
            rng.randn(b, tk, h, d).astype(np.float32),
            rng.randn(b, tk, h, d).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("d", [40, 64, 80])
def test_reference_matches_pallas_unaligned(d):
    q, k, v = _qkv(2, 100, 200, 2, d, seed=d)
    ref = jax_flash_attention(*_j(q, k, v), interpret=True)
    got = flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_reference_matches_pallas_kv_mask():
    q, k, v = _qkv(2, 100, 200, 2, 40, seed=1)
    mask = (np.arange(200)[None] < np.asarray([[37], [200]])).astype(np.float32)
    ref = jax_flash_attention(*_j(q, k, v), kv_mask=jnp.asarray(mask),
                              interpret=True)
    got = flash_attention(*_t(q, k, v), kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_reference_matches_pallas_causal():
    q, k, v = _qkv(1, 150, 150, 2, 80, seed=2)
    ref = jax_flash_attention(*_j(q, k, v), causal=True, interpret=True)
    got = flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_fully_masked_row_is_zero():
    q, k, v = _qkv(2, 20, 30, 1, 8, seed=3)
    mask = np.ones((2, 30), np.float32)
    mask[1] = 0.0
    got = flash_attention(*_t(q, k, v), kv_mask=torch.from_numpy(mask))
    assert torch.all(got[1] == 0)
    ref = flash_attention(*_t(q[:1], k[:1], v[:1]))
    np.testing.assert_allclose(got[:1].numpy(), ref.numpy(), atol=1e-6)


def _kernel_replay(q, k, v, kv_mask, causal, bq=64, bk=64):
    """numpy replay of ``csrc/flash_attention.cu`` for one (batch, head):
    q [Tq, D], k/v [Tk, D], kv_mask [Tk] or None."""
    tq, d = q.shape
    tk = k.shape[0]
    out = np.zeros_like(q)
    scale = np.float32(d ** -0.5)
    for q0 in range(0, tq, bq):
        rows = np.arange(q0, min(q0 + bq, tq))
        acc = np.zeros((len(rows), d), np.float32)
        m = np.full(len(rows), -np.inf, np.float32)
        l = np.zeros(len(rows), np.float32)
        n_tiles = -(-tk // bk)
        if causal:
            n_tiles = min(n_tiles, (q0 + bq - 1) // bk + 1)
        for k0 in range(0, n_tiles * bk, bk):
            cols = np.arange(k0, min(k0 + bk, tk))
            valid = np.ones((len(rows), len(cols)), bool)
            if kv_mask is not None:
                valid &= kv_mask[cols][None] > 0
            if causal:
                valid &= cols[None] <= rows[:, None]
            s = np.where(valid, (q[rows] @ k[cols].T) * scale, -np.inf)
            m_new = np.maximum(m, s.max(axis=1))
            none = m_new == -np.inf
            with np.errstate(invalid="ignore"):
                alpha = np.where(none, 1.0, np.exp(m - m_new))
                p = np.where(none[:, None], 0.0, np.exp(s - m_new[:, None]))
            l = alpha * l + p.sum(axis=1)
            acc = acc * alpha[:, None] + p @ v[cols]
            m = m_new
        out[rows] = acc / np.where(l == 0, 1.0, l)[:, None]
    return out


@pytest.mark.parametrize("tq,tk,causal,masked", [
    (100, 200, False, False), (150, 150, True, False),
    (130, 70, False, True), (200, 200, True, True)])
def test_kernel_tile_loop_matches_reference(tq, tk, causal, masked):
    q, k, v = _qkv(1, tq, tk, 1, 40, seed=tq + tk)
    mask = None
    if masked:
        mask = (np.random.RandomState(0).rand(1, tk) > 0.5).astype(np.float32)
        mask[0, 0] = 1.0   # query rows see key 0 at least (causal included)
    got = _kernel_replay(q[0, :, 0], k[0, :, 0], v[0, :, 0],
                         None if mask is None else mask[0], causal)
    ref = flash_attention_reference(
        *_t(q, k, v), kv_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    np.testing.assert_allclose(got, ref[0, :, 0].numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["plain", "mask", "kv_mask", "causal"])
def test_attention_plain_branch_matches_jax(case):
    q, k, v = _qkv(2, 24, 24, 2, 16, seed=5)
    kw_j, kw_t = {}, {}
    if case == "mask":
        m = np.random.RandomState(6).rand(2, 1, 1, 24) > 0.3
        m[..., 0] = True
        kw_j["mask"], kw_t["mask"] = jnp.asarray(m), torch.from_numpy(m)
    elif case == "kv_mask":
        km = (np.arange(24)[None] < np.asarray([[10], [24]])).astype(np.int32)
        kw_j["kv_mask"], kw_t["kv_mask"] = jnp.asarray(km), torch.from_numpy(km)
    elif case == "causal":
        kw_j["is_causal"] = kw_t["is_causal"] = True
    ref = jax_attention(*_j(q, k, v), use_flash=False, **kw_j)
    got = attention(*_t(q, k, v), use_flash=False, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_flash_branch_matches_jax(masked):
    q, k, v = _qkv(2, 300, 260, 2, 40, seed=7)
    km = None
    if masked:
        km = (np.arange(260)[None] < np.asarray([[100], [260]])).astype(
            np.float32)
    ref = jax_attention(*_j(q, k, v), use_flash=True,
                        kv_mask=None if km is None else jnp.asarray(km))
    got = attention(*_t(q, k, v), use_flash=True,
                    kv_mask=None if km is None else torch.from_numpy(km))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_dispatch_rule_stays_plain_on_cpu():
    """``use_flash=None`` takes the flash path only for tensors on the card,
    so a CPU call never counts a kernel launch."""
    q, k, v = _qkv(1, 260, 260, 1, 8, seed=8)
    before = flash_attention.launches
    attention(*_t(q, k, v))
    assert flash_attention.launches == before


def test_non_cpu_tensor_never_falls_back():
    q = torch.empty(1, 16, 1, 8, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
