"""Port attention (``audiogpt_tpu_torch.ops.attention`` / ``flash_attention``)
against the JAX package on the same numpy inputs: the plain flash version
vs the Pallas kernel in interpret mode, and ``attention()`` on both
dispatch branches, in f32 and bf16, at head dims up to the T2I UNet's 160.
The CUDA kernels' tile loops (online softmax in base 2, causal tile
skipping, -inf masking, per-lane partial sums) are replayed in numpy here,
with their tensor-core arithmetic emulated: both kernels' (``wgmma``) 64-,
128- or 192-row blocks in warpgroups of 64, their key tiles and head dims
padded to their compiled widths; the f32 kernel's 3xTF32 products (each
operand split into a truncated TF32 part and the rest, P split in
registers), the bf16 kernel's p rounded to bf16.

JAX's two flash versions agree with each other only with no fully masked
row and with causal at Tq == Tk, so the JAX comparisons stay there; the
port's own semantics for a fully masked row (0) are tested separately."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogpt_tpu.ops.attention import attention as jax_attention
from audiogpt_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from audiogpt_tpu_torch.ops.attention import attention, flash_takes
from audiogpt_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

torch.set_num_threads(2)

#: f32 softmax-weighted sums of O(1) values over ≤ 200 keys, summed in
#: another order (blockwise vs full rows): 1e-5 absolute holds with margin
ATOL = 1e-5
#: bf16 inputs: the Pallas kernel rounds p to bf16 before normalising, the
#: plain versions after (2^-9 of each weight), and each side rounds its
#: output to bf16 once (2^-7 of the value at most): 2^-7 relative + 1e-2
BF16_TOL = dict(atol=1e-2, rtol=2 ** -7)


def _qkv(b, tq, tk, h, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, tq, h, d).astype(np.float32),
            rng.randn(b, tk, h, d).astype(np.float32),
            rng.randn(b, tk, h, d).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("d", [40, 64, 80])
def test_reference_matches_pallas_unaligned(d):
    q, k, v = _qkv(2, 100, 200, 2, d, seed=d)
    ref = jax_flash_attention(*_j(q, k, v), interpret=True)
    got = flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", [40, 64])
def test_reference_matches_pallas_bf16(d):
    q, k, v = _qkv(2, 100, 200, 2, d, seed=d)
    ref = jax_flash_attention(*_j(q, k, v, dtype=jnp.bfloat16),
                              interpret=True)
    got = flash_attention(*_t(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d,tk", [(160, 200), (40, 77)])
def test_reference_matches_pallas_t2i_shapes(d, tk, dtype):
    """The T2I UNet's widest head (D = 160, its ds-4 level) and its
    cross-attention on the 77 CLIP tokens (one partial key tile)."""
    q, k, v = _qkv(2, 100, tk, 2, d, seed=d + tk)
    if dtype == "f32":
        ref = jax_flash_attention(*_j(q, k, v), interpret=True)
        got = flash_attention(*_t(q, k, v))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
        return
    ref = jax_flash_attention(*_j(q, k, v, dtype=jnp.bfloat16),
                              interpret=True)
    got = flash_attention(*_t(q, k, v, dtype=torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reference_matches_pallas_pvt_shape(dtype):
    """PVT's spatial-reduction attention, narrowed: one head, Tq >> Tk, and a
    key count that is no multiple of the 64-key tile (Tq = 512, Tk = 25)."""
    q, k, v = _qkv(1, 512, 25, 1, 64, seed=25)
    if dtype == "f32":
        ref = jax_flash_attention(*_j(q, k, v), interpret=True)
        got = flash_attention(*_t(q, k, v))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
        return
    ref = jax_flash_attention(*_j(q, k, v, dtype=jnp.bfloat16),
                              interpret=True)
    got = flash_attention(*_t(q, k, v, dtype=torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **BF16_TOL)


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


def _tf32(x):
    """float32 → TF32 as the tensor core reads an f32 register: the low 13
    mantissa bits dropped (a 10-bit mantissa, truncated). The kernel's split
    takes hi the same way and passes lo = x - hi whole."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _mma(a, b, mode):
    """a [m, k] @ b [k, n] as the kernel's tensor-core products with f32
    accumulators: "tf32x3" (hi·hi + hi·lo + lo·hi of the TF32 split, the f32
    entry), "tf32x1" (one TF32 product) or "bf16" (operands already bf16)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if mode == "bf16":
        return (a.astype(np.float64) @ b).astype(np.float32)
    ah, bh = _tf32(a), _tf32(b)
    out = ah.astype(np.float64) @ bh
    if mode == "tf32x3":
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out += ah.astype(np.float64) @ bl + al.astype(np.float64) @ bh
    return out.astype(np.float32)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float() \
        .numpy()


#: the bf16 kernel's tiles (``csrc/flash_attention_sm90.cu`` ``Tile``,
#: ``consumers``; change them together): the compiled head dims, the query
#: rows an SM computes per unit of time with 1, 2, 3 consumer warpgroups a
#: block (64, 128, 192 rows) by padded head dim, and the card's SMs
WGMMA_WIDTHS = (16, 32, 48, 64, 80, 96, 128, 160)
WGMMA_RATES = {48: (1.0, 1.82, 2.17), 64: (1.0, 0.96, 1.21),
               96: (1.0, 1.19, 1.56), 160: (1.0, 1.19, 1.41)}
H100_SMS = 132


def _wgmma_tiles(b, tq, h, d):
    """(padded head dim, keys a tile, query rows a block) of the bf16
    kernel for q [b, tq, h, d] on a card of ``H100_SMS`` SMs: the block's
    rows cost the least ceil(blocks / SMs) * rows / rate."""
    dp = next(w for w in WGMMA_WIDTHS if w >= d)
    rate = next(r for top, r in WGMMA_RATES.items() if dp <= top)
    cost = {n: -(-(-(-tq // (64 * n)) * h * b) // H100_SMS) * 64 * n
            / rate[n - 1] for n in (3, 2, 1)}
    return dp, 128 if dp <= 96 else 64, 64 * min(
        cost, key=lambda n: (cost[n], -n))


#: the f32 kernel's tiles (``csrc/flash_attention_sm90_f32.cu`` ``Tile``,
#: ``consumers``; change them together): the compiled head dims, and by
#: padded head dim the keys a tile, the most consumer warpgroups a block
#: and the query rows an SM computes per unit of time with 1, 2, 3 of them
F32_WIDTHS = (8, 16, 32, 40, 48, 64, 80, 96, 128, 160)
F32_RATES = {48: (1.0, 1.53, 1.81), 64: (1.0, 1.45, 1.81),
             160: (1.0, 1.54)}


def _f32_tiles(b, tq, h, d):
    """(padded head dim, keys a tile, query rows a block) of the f32
    kernel for q [b, tq, h, d] on a card of ``H100_SMS`` SMs: at most 3
    consumer warpgroups to DP = 64, 2 to 96, 1 above; the block's rows cost
    the least ceil(blocks / SMs) * rows / rate."""
    dp = next(w for w in F32_WIDTHS if w >= d)
    bk = 64 if dp <= 48 else 32 if dp <= 128 else 16
    most = 3 if dp <= 64 else 2 if dp <= 96 else 1
    rate = next(r for top, r in F32_RATES.items() if dp <= top)
    cost = {n: -(-(-(-tq // (64 * n)) * h * b) // H100_SMS) * 64 * n
            / rate[n - 1] for n in range(most, 0, -1)}
    return dp, bk, 64 * min(cost, key=lambda n: (cost[n], -n))


def _kernel_replay(q, k, v, kv_mask, causal, mode="tf32x3", bq=64, bk=64):
    """numpy replay of ``csrc/flash_attention_sm90_f32.cu`` (``mode``
    "tf32x3"; "tf32x1" takes one TF32 product in place of three) for one
    (batch, head): q [Tq, D], k/v [Tk, D], kv_mask [Tk] or None. q, k and v
    zero-padded to the compiled head dim (TMA's fill), ``bq`` query rows a
    block (64, 128 or 192) in warpgroups of 64, the key tile of that head
    dim (the ragged tail zero-filled and masked; ``bk`` is not read), tiles
    past the block's last row not loaded, a tile above a warpgroup's rows or
    whose keys the mask all drops not computed, logits scaled to base 2, the
    exponent base 0 while a row has no valid key, the row sum kept as 4
    per-lane partials (lane c holds keys 8n + 2c, 2c + 1); both products
    3xTF32 with the truncating split, P split as it leaves the softmax.

    ``mode="wgmma"`` replays ``csrc/flash_attention_sm90.cu`` (the bf16
    kernel: its widths and tiles, bf16 products and p rounded to bf16);
    ``mode="bf16"`` the same arithmetic in plain ``bq``-row blocks and
    ``bk``-key tiles, every tile computed."""
    tq, d = q.shape
    tk = k.shape[0]
    out = np.zeros((tq, d), np.float32)
    scale_log2 = np.float32(d ** -0.5) * np.float32(1.4426950408889634)
    wgmma = mode != "bf16"
    if mode == "wgmma":
        dp, bk, _ = _wgmma_tiles(1, 1, 1, d)
        mode = "bf16"
    elif wgmma:
        dp, bk, _ = _f32_tiles(1, 1, 1, d)
    if wgmma:
        q, k, v = (np.pad(a, ((0, 0), (0, dp - d))) for a in (q, k, v))
    lane = (np.arange(bk) % 8) // 2
    for q0 in range(0, tq, bq):
        n_tiles = -(-tk // bk)
        if causal:
            n_tiles = min(n_tiles, (q0 + bq - 1) // bk + 1)
        # one warpgroup's 64 rows, or the plain loop's block
        for w0 in range(q0, min(q0 + bq, tq), 64 if wgmma else bq):
            rows = np.arange(w0, min(w0 + (64 if wgmma else bq), tq))
            acc = np.zeros((len(rows), q.shape[1]), np.float32)
            m = np.full(len(rows), -np.inf, np.float32)
            l_part = np.zeros((len(rows), 4), np.float32)
            for k0 in range(0, n_tiles * bk, bk):
                cols = np.arange(k0, k0 + bk)
                inside = cols < tk
                kt = np.where(inside[:, None], k[np.minimum(cols, tk - 1)], 0)
                vt = np.where(inside[:, None], v[np.minimum(cols, tk - 1)], 0)
                keys = inside.copy()
                if kv_mask is not None:
                    keys &= kv_mask[np.minimum(cols, tk - 1)] > 0
                if wgmma and ((causal and k0 > w0 + 63) or not keys.any()):
                    continue
                valid = np.broadcast_to(keys, (len(rows), bk)).copy()
                if causal:
                    valid &= cols[None] <= rows[:, None]
                x = np.where(valid, _mma(q[rows], kt.T, mode) * scale_log2,
                             np.float32(-np.inf))
                m_new = np.maximum(m, x.max(axis=1))
                base = np.where(m_new == -np.inf, np.float32(0), m_new)
                alpha = np.exp2(m - base)
                p = np.exp2(x - base[:, None])
                l_part = alpha[:, None] * l_part + np.stack(
                    [p[:, lane == c].sum(axis=1) for c in range(4)], axis=1)
                if mode == "bf16":
                    p = _bf16(p)
                acc = acc * alpha[:, None] + _mma(p, vt, mode)
                m = m_new
            l = l_part.sum(axis=1)
            out[rows] = (acc * np.where(l == 0, 0, 1 / np.where(l == 0, 1, l))[
                :, None])[:, :d]
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


@pytest.mark.parametrize("mode", ["tf32x3", "bf16"])
def test_kernel_tile_loop_matches_reference_at_pvt_shape(mode):
    """PVT's stage-0 spatial-reduction attention (one head, D = 64, 100
    keys: a full 64-key tile and a 36-key tail) with 400 queries, both
    entries' replays against the plain version."""
    q, k, v = _qkv(1, 400, 100, 1, 64, seed=500)
    dtype = torch.float32
    if mode == "bf16":
        q, k, v = (_bf16(a) for a in (q, k, v))
        dtype = torch.bfloat16
    got = _kernel_replay(q[0, :, 0], k[0, :, 0], v[0, :, 0], None, False,
                         mode)
    ref = flash_attention_reference(*_t(q, k, v, dtype=dtype))
    if mode == "bf16":
        np.testing.assert_allclose(_bf16(got), ref[0, :, 0].float().numpy(),
                                   **BF16_TOL)
    else:
        np.testing.assert_allclose(got, ref[0, :, 0].numpy(), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, True)])
def test_kernel_tile_loop_bf16_matches_reference(causal, masked):
    """The bf16 entry's replay (bf16 operands, p rounded to bf16 before the
    product, f32 sums) against the plain version on the same bf16 inputs,
    with a fully masked row."""
    q, k, v = (_bf16(a) for a in _qkv(1, 130, 200, 1, 48, seed=11))
    mask = None
    if masked:
        mask = (np.random.RandomState(1).rand(1, 200) > 0.5).astype(np.float32)
        mask[0, :2] = [0.0, 1.0]   # query row 0 sees no key under causal
    got = _kernel_replay(q[0, :, 0], k[0, :, 0], v[0, :, 0],
                         None if mask is None else mask[0], causal, "bf16")
    ref = flash_attention_reference(
        *_t(q, k, v, dtype=torch.bfloat16),
        kv_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    if masked:
        assert np.all(got[0] == 0) and torch.all(ref[0, 0, 0] == 0)
    np.testing.assert_allclose(_bf16(got), ref[0, :, 0].float().numpy(),
                               **BF16_TOL)


#: the bf16 paths' attention shapes (``chip_smoke.py`` ``FLASH_CASES``),
#: cut to one head: (B, Tq, Tk, H, D) as the card runs them (the block's
#: rows follow from B and H), replayed at one (batch, head)
WGMMA_PATH_SHAPES = {
    "unet_level0": (6, 780, 780, 8, 40),
    "inpaint_cross_l0": (1, 1060, 77, 8, 40),
    "t2i_self_ds2": (2, 1024, 1024, 8, 80),
    "t2i_self_ds4": (2, 256, 256, 8, 160),
    "asr_encoder": (1, 1500, 1500, 8, 64),
    "blip_vision": (1, 577, 577, 12, 64),
}


def _wgmma_check(got, q, k, v, mask=None, causal=False):
    ref = flash_attention_reference(
        *_t(q, k, v, dtype=torch.bfloat16),
        kv_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    np.testing.assert_allclose(_bf16(got), ref[0, :, 0].float().numpy(),
                               **BF16_TOL)


@pytest.mark.parametrize("case", list(WGMMA_PATH_SHAPES))
def test_wgmma_tile_loop_matches_reference_at_path_shapes(case):
    """The bf16 kernel's replay (its block rows, its key tile and head-dim
    padding at each width) at the paths' shapes, one head, against the
    plain version on the same bf16 inputs."""
    b, tq, tk, h, d = WGMMA_PATH_SHAPES[case]
    q, k, v = (_bf16(a) for a in _qkv(1, tq, tk, 1, d, seed=tq + d))
    got = _kernel_replay(q[0, :, 0], k[0, :, 0], v[0, :, 0], None, False,
                         "wgmma", bq=_wgmma_tiles(b, tq, h, d)[2])
    _wgmma_check(got, q, k, v)


@pytest.mark.parametrize("bq", [64, 128, 192])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
def test_wgmma_tile_loop_masks(causal, masked, bq):
    """The bf16 kernel's replay with Tq != Tk, causal top-left, a key mask
    that drops a whole 128-key tile and leaves query row 0 no key under
    causal (its output is 0), at both block shapes."""
    q, k, v = (_bf16(a) for a in _qkv(1, 300, 340, 1, 40, seed=21))
    mask = None
    if masked:
        mask = (np.random.RandomState(2).rand(1, 340) > 0.5).astype(
            np.float32)
        mask[0, :2] = [0.0, 1.0]
        mask[0, 128:256] = 0.0
    got = _kernel_replay(q[0, :, 0], k[0, :, 0], v[0, :, 0],
                         None if mask is None else mask[0], causal, "wgmma",
                         bq=bq)
    if causal and masked:
        assert np.all(got[0] == 0)
    _wgmma_check(got, q, k, v, mask, causal)


@pytest.mark.parametrize("d", list(range(8, 161, 8)))
def test_wgmma_tile_loop_every_head_dim(d):
    """Every head dim the bf16 kernel takes, zero-padded to its compiled
    width, on lengths that are no multiple of a tile."""
    q, k, v = (_bf16(a) for a in _qkv(1, 77, 129, 1, d, seed=d))
    got = _kernel_replay(q[0, :, 0], k[0, :, 0], v[0, :, 0], None, False,
                         "wgmma")
    _wgmma_check(got, q, k, v)


#: the f32 paths' attention shapes (``chip_smoke.py`` ``FLASH_CASES``),
#: cut to one head as ``WGMMA_PATH_SHAPES`` is, with the key mask and the
#: causal cell: (B, Tq, Tk, H, D), key length of the one head or None,
#: causal
F32_PATH_SHAPES = {
    "unet_level0": ((6, 780, 780, 8, 40), None, False),
    "inpaint_cross_l0": ((1, 1060, 77, 8, 40), None, False),
    "t2i_self_ds2": ((2, 1024, 1024, 8, 80), None, False),
    "t2i_self_ds4": ((2, 256, 256, 8, 160), None, False),
    "asr_encoder": ((1, 1500, 1500, 8, 64), None, False),
    "pvt_s2_32s": ((1, 800, 200, 5, 64), None, False),
    "kv_mask": ((2, 1500, 1500, 6, 64), 1100, False),
    "causal": ((1, 256, 256, 2, 80), None, True),
}


@pytest.mark.parametrize("case", list(F32_PATH_SHAPES))
def test_f32_tile_loop_matches_reference_at_path_shapes(case):
    """The f32 kernel's replay (its block rows by the cost rule, its key
    tile and head-dim padding at each width, 3xTF32) at the paths' shapes,
    one head, against the plain version on the same f32 inputs."""
    (b, tq, tk, h, d), length, causal = F32_PATH_SHAPES[case]
    q, k, v = _qkv(1, tq, tk, 1, d, seed=tq + d)
    mask = None
    if length is not None:
        mask = (np.arange(tk)[None] < length).astype(np.float32)
    got = _kernel_replay(q[0, :, 0], k[0, :, 0], v[0, :, 0],
                         None if mask is None else mask[0], causal,
                         bq=_f32_tiles(b, tq, h, d)[2])
    ref = flash_attention_reference(
        *_t(q, k, v), kv_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    np.testing.assert_allclose(got, ref[0, :, 0].numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("bq", [64, 128, 192])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
def test_f32_tile_loop_masks_against_pallas(causal, masked, bq):
    """The f32 kernel's replay at the three block shapes, with Tq != Tk
    under a key mask that drops a whole 64-key tile, and causal at Tq == Tk
    (where JAX's flash versions agree), against the Pallas kernel in
    interpret mode; and a mask that leaves query row 0 no key under causal
    (its output is 0), against the plain version."""
    tq, tk = (200, 200) if causal else (150, 260)
    q, k, v = _qkv(1, tq, tk, 1, 40, seed=31)
    mask = None
    if masked:
        mask = (np.random.RandomState(3).rand(1, tk) > 0.4).astype(np.float32)
        mask[0, 0] = 1.0
        mask[0, 64:128] = 0.0
    got = _kernel_replay(q[0, :, 0], k[0, :, 0], v[0, :, 0],
                         None if mask is None else mask[0], causal, bq=bq)
    ref = jax_flash_attention(
        *_j(q, k, v), kv_mask=None if mask is None else jnp.asarray(mask),
        causal=causal, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref)[0, :, 0], atol=ATOL,
                               rtol=0)
    if causal and masked:
        mask[0, :2] = [0.0, 1.0]
        got = _kernel_replay(q[0, :, 0], k[0, :, 0], v[0, :, 0], mask[0],
                             True, bq=bq)
        ref = flash_attention_reference(*_t(q, k, v),
                                        kv_mask=torch.from_numpy(mask),
                                        causal=True)
        assert np.all(got[0] == 0) and torch.all(ref[0, 0, 0] == 0)
        np.testing.assert_allclose(got, ref[0, :, 0].numpy(), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("d", list(range(4, 161, 4)))
def test_f32_tile_loop_every_head_dim(d):
    """Every head dim the f32 kernel takes (a multiple of 4: rows of 16
    bytes), zero-padded to its compiled width, on lengths that are no
    multiple of a tile."""
    q, k, v = _qkv(1, 77, 129, 1, d, seed=d)
    got = _kernel_replay(q[0, :, 0], k[0, :, 0], v[0, :, 0], None, False)
    ref = flash_attention_reference(*_t(q, k, v))
    np.testing.assert_allclose(got, ref[0, :, 0].numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["tf32x3", "tf32x1"])
@pytest.mark.parametrize("d", [40, 64, 80])
def test_tf32_split_error_against_f64(d, mode):
    """The f32 entry's 3xTF32 products (the kernel's tile loop: Q, K, P
    and V split with the tensor core's truncation) keep the replay within
    1e-5 of the float64 softmax at the UNet's 780 keys; one TF32 product
    (~2^-10 per operand) does not, which is why the kernel pays for
    three."""
    q, k, v = (a[0, :, 0].astype(np.float64) for a in
               _qkv(1, 128, 780, 1, d, seed=d + 1))
    logits = q @ k.T * d ** -0.5
    w = np.exp(logits - logits.max(axis=1, keepdims=True))
    ref = (w / w.sum(axis=1, keepdims=True)) @ v
    got = _kernel_replay(*(a.astype(np.float32) for a in (q, k, v)), None,
                         False, mode)
    err = np.abs(got - ref).max()
    assert (err <= 1e-5) == (mode == "tf32x3"), err


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


def _meta(b, t, h, d, dtype=torch.float32):
    return torch.empty(b, t, h, d, dtype=dtype, device="meta")


def _clip_views(dtype=torch.float32, device="meta"):
    """q/k/v of CLIP ViT-H/14's block: strided views of one fused
    projection, [1, 257, 16, 80]."""
    qkv = torch.empty(1, 257, 3 * 1280, dtype=dtype, device=device)
    return tuple(u.reshape(1, 257, 16, 80) for u in qkv.chunk(3, dim=-1))


@pytest.mark.parametrize("case,takes", [
    ("d160", True), ("d160_bf16", True), ("d192", False),
    ("row_24_bytes", False), ("dense_mask", False),
    ("f16", False), ("mixed_dtypes", False), ("below_min_pairs", False),
    ("clip_chunked_views", True), ("clip_chunked_bf16", True),
    ("whisper_encoder", True)])
def test_flash_takes_only_what_the_kernel_takes(case, takes):
    """The dispatch's shape and dtype rule, device aside: the kernel's own
    limits (``ops/flash_attention.py``: D ≤ 160, the T2I UNet's ds-4 head)
    and the pair count. A strided view passes: ``attention()`` copies it
    contiguous for the kernel."""
    mask = None
    if case == "d160":
        q = k = v = _meta(2, 256, 8, 160)
    elif case == "d160_bf16":
        q = k = v = _meta(2, 256, 8, 160, torch.bfloat16)
    elif case == "d192":
        q = k = v = _meta(2, 256, 8, 192)
    elif case == "row_24_bytes":
        q = k = v = _meta(1, 300, 2, 12, torch.bfloat16)
    elif case == "dense_mask":
        q = k = v = _meta(1, 300, 2, 64)
        mask = torch.ones(1, 1, 300, 300, dtype=torch.bool, device="meta")
    elif case == "f16":
        q = k = v = _meta(1, 300, 2, 64, torch.float16)
    elif case == "mixed_dtypes":
        q, k, v = (_meta(1, 300, 2, 64, torch.bfloat16), _meta(1, 300, 2, 64),
                   _meta(1, 300, 2, 64))
    elif case == "below_min_pairs":
        q = k = v = _meta(1, 255, 2, 64)
    elif case == "clip_chunked_views":
        q, k, v = _clip_views()
        assert not q.is_contiguous()
    elif case == "clip_chunked_bf16":
        q, k, v = _clip_views(torch.bfloat16)
    else:
        q = k = v = _meta(1, 1500, 8, 64)
    assert flash_takes(q, k, v, mask) is takes


def test_forced_flash_gets_contiguous_copies(monkeypatch):
    """``attention(use_flash=True)`` hands the kernel's wrapper contiguous
    q/k/v; the CLIP block's strided views give the plain path's result."""
    seen = []

    def recorder(q, k, v, kv_mask=None, causal=False):
        seen.append([t.is_contiguous() for t in (q, k, v)])
        return flash_attention(q, k, v, kv_mask=kv_mask, causal=causal)

    # the module (``ops/__init__.py`` exports a function of the same name)
    module = importlib.import_module("audiogpt_tpu_torch.ops.attention")
    monkeypatch.setattr(module, "flash_attention", recorder)
    gen = torch.Generator().manual_seed(9)
    qkv = torch.randn(1, 257, 3 * 160, generator=gen)
    q, k, v = (u.reshape(1, 257, 2, 80) for u in qkv.chunk(3, dim=-1))
    got = attention(q, k, v, use_flash=True)
    assert seen == [[True, True, True]]
    np.testing.assert_allclose(got.numpy(),
                               attention(q, k, v, use_flash=False).numpy(),
                               atol=ATOL, rtol=0)


#: gradients of f32 softmax attention over ≤ 160 keys, O(1) values: the
#: port's autograd of its plain version against JAX's ``_reference`` vjp
#: (the ``custom_vjp`` backward), summed in another order
GRAD_ATOL = 2e-5


@pytest.mark.parametrize("case", ["no_mask", "kv_mask", "causal"])
def test_flash_attention_grads_match_jax(case):
    """``FlashAttention``'s dq, dk, dv against JAX's ``flash_attention``
    (interpret mode) gradients, where both forwards agree: no fully masked
    row, causal with Tq == Tk."""
    import jax

    tk = 96 if case == "causal" else 160
    q, k, v = _qkv(2, 96, tk, 2, 40, seed=17)
    g = np.random.RandomState(18).randn(*q.shape).astype(np.float32)
    mask = None
    if case == "kv_mask":
        mask = (np.arange(tk)[None] < np.array([160, 70])[:, None]) \
            .astype(np.float32)
    causal = case == "causal"
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_attention(
        q_, k_, v_, kv_mask=None if mask is None else jnp.asarray(mask),
        causal=causal, interpret=True), *_j(q, k, v))
    ref = vjp(jnp.asarray(g))
    tq, tk_, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk_, tv, causal=causal,
                          kv_mask=None if mask is None
                          else torch.from_numpy(mask))
    got = torch.autograd.grad(out, (tq, tk_, tv), torch.from_numpy(g))
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=0, err_msg=f"d{name}")


def test_flash_attention_saves_nothing_without_grad():
    """Serving costs no memory: no input requiring grad (or ``no_grad``)
    gives an output without autograd history; with one, only the inputs
    that require grad get a gradient."""
    q, k, v = _t(*_qkv(1, 40, 40, 2, 8, seed=3))
    assert flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert flash_attention(q, k, v.requires_grad_()).grad_fn is None
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert v.grad is not None and q.grad is None and k.grad is None
