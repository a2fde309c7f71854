"""The port's CUDA kernels against their plain versions, on the card, at the
edges of what each kernel takes, and ``attention()``'s dispatch around
them: head dims that are and are not multiples
of 16, unaligned and unequal sequence lengths (the inpaint path's
cross-attention of 1060 queries on 77 keys among them), causal masking with
Tq != Tk, fully masked rows, rows shorter than one tile, rows whose length
is not a multiple of 16 bytes or is shorter than one thread's run, f32 and
bf16, up to the T2I UNet's widest head (D = 160); BLIP's fused-qkv views;
PVT's spatial-reduction attention (one head, Tq >> Tk, a ragged key tail);
both kernels from a worker thread on its own stream, on a card that is not
the current one (with two cards), and a T2A engine on a mesh that names
the card twice. Both flash kernels (``wgmma`` fed by TMA) at every head
dim they take, every pair of lengths around their tiles, one to three
consumer warpgroups a block, and a CUDA graph's replay against the eager
call.

These tests need an NVIDIA card and ``nvcc``; elsewhere they skip. They
import neither JAX nor the JAX package, so they run where only PyTorch is
installed::

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import importlib
import threading
from collections import Counter

import pytest
import torch

from audiogpt_tpu_torch.models.sed.pvt import SRAttention
from audiogpt_tpu_torch.ops.attention import attention
from audiogpt_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from audiogpt_tpu_torch.ops.snake_aa import snake_aa, snake_aa_reference

# the ASR engine card-vs-CPU check
import numpy as np  # noqa: E402

from audiogpt_tpu_torch.engines import ASREngine  # noqa: E402
from audiogpt_tpu_torch.models.asr import WhisperConfig, whisper  # noqa: E402


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _qkv(gen, b, tq, tk, h, d, dtype=torch.float32):
    return (torch.randn(b, tq, h, d, generator=gen, device="cuda").to(dtype),
            torch.randn(b, tk, h, d, generator=gen, device="cuda").to(dtype),
            torch.randn(b, tk, h, d, generator=gen, device="cuda").to(dtype))


#: f32 (3xTF32 products, f32 softmax): blockwise against full rows, 1e-4
#: absolute. bf16: both sides round the output to bf16 (one step, 2^-7 of
#: the value) and round p to bf16 at another point (the kernel before
#: normalising, the plain version after: 2^-9 of each weight, over values
#: of O(1)), so 2^-7 relative + 1e-2 absolute.
FLASH_TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
             torch.bfloat16: dict(atol=1e-2, rtol=2 ** -7)}
DTYPES = [torch.float32, torch.bfloat16]


def _flash_check(q, k, v, kv_mask=None, causal=False):
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_mask=kv_mask, causal=causal)
    ref = flash_attention_reference(q, k, v, kv_mask=kv_mask, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == q.dtype
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[q.dtype])
    return out


@pytest.mark.parametrize("d,dtype", [
    (d, dtype) for dtype in DTYPES for d in range(8, 161, 8)]
    + [(d, torch.float32) for d in (4, 12, 36, 44, 156)])
def test_flash_head_dims_unaligned(gen, d, dtype):
    """Every head dim both kernels take in steps of 8, and the f32 head dims
    that are 4 mod 8 (16-byte rows of f32): each kernel pads D to its
    compiled width by TMA's zero fill (bf16 16 to 160, in column blocks of
    16, 32 or 64 dims; f32 8 to 160, in blocks of 8, 16 or 32 dims: a
    swizzle of 32, 64 or 128 bytes), on lengths no multiple of any tile."""
    _flash_check(*_qkv(gen, 2, 100, 200, 3, d, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tq,tk", [(150, 150), (100, 200), (200, 70), (1, 65)])
def test_flash_causal_top_left(gen, tq, tk, dtype):
    _flash_check(*_qkv(gen, 2, tq, tk, 2, 64, dtype), causal=True)


#: lengths around the tiles: 64 query rows a warpgroup, 64 or 128 keys
FLASH_LENGTHS = [1, 63, 64, 65, 77, 129, 1060]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tq,tk", [(1060, 77), (300, 77), (77, 300),
                                   (130, 1), (65, 1000)]
                         + [(tq, tk) for tq in FLASH_LENGTHS
                            for tk in FLASH_LENGTHS])
def test_flash_unequal_lengths(gen, tq, tk, dtype):
    """Tq and Tk with partial tiles: the inpaint path's level-0
    cross-attention ([1, 1060, 8, 40] on 77 keys) and every pair of the
    lengths around the tiles."""
    _flash_check(*_qkv(gen, 1, tq, tk, 8, 40, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_inpaint_level1_head_dim_80(gen, dtype):
    """The inpaint path's level-1 self-attention, [1, 265, 8, 80]."""
    _flash_check(*_qkv(gen, 1, 265, 265, 8, 80, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 4])
def test_flash_whisper_encoder_shape(gen, b, dtype):
    """whisper-base's encoder self-attention, [B, 1500, 8, 64]: one 30 s
    window, and the 4-window batch of a 60 s clip."""
    _flash_check(*_qkv(gen, b, 1500, 1500, 8, 64, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kv_mask_with_fully_masked_row(gen, dtype):
    q, k, v = _qkv(gen, 3, 130, 300, 2, 40, dtype)
    lens = torch.tensor([300, 17, 0], device="cuda")
    mask = (torch.arange(300, device="cuda")[None] < lens[:, None]).float()
    out = _flash_check(q, k, v, kv_mask=mask)
    assert torch.all(out[2] == 0)


# -- the bf16 kernel (``csrc/flash_attention_sm90.cu``: wgmma fed by TMA) ----


def _masked_row_and_causal(gen, b, tq, h, d, dtype):
    q, k, v = _qkv(gen, b, tq, tq + 37, h, d, dtype)
    lens = torch.tensor([tq + 37, 0, 130, 1][:b], device="cuda")
    mask = (torch.arange(tq + 37, device="cuda")[None]
            < lens[:, None]).float()
    out = _flash_check(q, k, v, kv_mask=mask)
    if b > 1:
        assert torch.all(out[1] == 0)
    _flash_check(q, k, v, causal=True)
    _flash_check(*_qkv(gen, b, tq + 37, tq, h, d, dtype), causal=True)


@pytest.mark.parametrize("b,tq,h", [(1, 300, 2), (2, 1024, 8), (4, 1500, 8)])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_flash_bf16_masked_row_and_causal(gen, b, tq, h, d):
    """A key mask that drops one row's keys wholly (its output is 0), and
    causal with Tq != Tk, aligned top-left, on grids of one, two and three
    consumer warpgroups a block (the rule picks by head dim)."""
    _masked_row_and_causal(gen, b, tq, h, d, torch.bfloat16)


# -- the f32 kernel (``csrc/flash_attention_sm90_f32.cu``: 3xTF32 on wgmma) --


@pytest.mark.parametrize("b,tq,h", [(1, 300, 2), (2, 1024, 8), (4, 1500, 8)])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_flash_f32_masked_row_and_causal(gen, b, tq, h, d):
    """The f32 twin: a wholly masked row (0) and causal with Tq != Tk on
    grids of the f32 kernel's block shapes at its 64-, 32- and 16-key
    tiles."""
    _masked_row_and_causal(gen, b, tq, h, d, torch.float32)


#: the bf16 kernel's rule for its block's rows (``csrc/flash_attention_sm90.cu``
#: ``consumers``; change them together): query rows an SM computes per unit
#: of time with 1, 2, 3 consumer warpgroups, by padded head dim
BF16_RATES = {48: (1.0, 1.82, 2.17), 64: (1.0, 0.96, 1.21),
              96: (1.0, 1.19, 1.56), 160: (1.0, 1.19, 1.41)}


def _bf16_block_rows(b, tq, h, d, sms):
    dp = next(w for w in (16, 32, 48, 64, 80, 96, 128, 160) if w >= d)
    rate = next(r for top, r in BF16_RATES.items() if dp <= top)
    cost = {n: -(-(-(-tq // (64 * n)) * h * b) // sms) * 64 * n / rate[n - 1]
            for n in (3, 2, 1)}
    return 64 * min(cost, key=lambda n: (cost[n], -n))


#: shapes whose grids take one, two and three consumer warpgroups a block
BF16_BLOCK_SHAPES = [(1, 1500, 1500, 8, 64), (2, 1024, 1024, 8, 80),
                     (4, 1500, 1500, 8, 64)]


def test_flash_bf16_block_shape(gen):
    """The bf16 kernel's block takes 64, 128 or 192 query rows (one to three
    consumer warpgroups) by its cost rule; each shape of
    ``BF16_BLOCK_SHAPES`` takes another."""
    from audiogpt_tpu_torch.ops.flash_attention import launch_grid

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for b, tq, tk, h, d in BF16_BLOCK_SHAPES:
        q = torch.empty(b, tq, h, d, device="cuda", dtype=torch.bfloat16)
        rows.append(launch_grid(q)["block_q"])
        assert rows[-1] == _bf16_block_rows(b, tq, h, d, sms)
    if sms == 132:
        assert rows == [64, 128, 192]


#: the f32 kernel's rule for its block's rows
#: (``csrc/flash_attention_sm90_f32.cu`` ``Tile``, ``consumers``; change
#: them together): the most consumer warpgroups by padded head dim, and the
#: query rows an SM computes per unit of time with 1, 2, 3 of them
F32_MOST = {64: 3, 96: 2, 160: 1}
F32_RATES = {48: (1.0, 1.53, 1.81), 64: (1.0, 1.45, 1.81),
             160: (1.0, 1.54)}


def _f32_block_rows(b, tq, h, d, sms):
    dp = next(w for w in (8, 16, 32, 40, 48, 64, 80, 96, 128, 160) if w >= d)
    most = next(n for top, n in F32_MOST.items() if dp <= top)
    rate = next(r for top, r in F32_RATES.items() if dp <= top)
    cost = {n: -(-(-(-tq // (64 * n)) * h * b) // sms) * 64 * n / rate[n - 1]
            for n in range(most, 0, -1)}
    return 64 * min(cost, key=lambda n: (cost[n], -n))


#: shapes whose f32 grids take one, two and three consumer warpgroups a
#: block on 132 SMs
F32_BLOCK_SHAPES = [(2, 256, 256, 8, 160), (2, 1024, 1024, 8, 80),
                    (6, 780, 780, 8, 40)]


def test_flash_f32_block_shape(gen):
    """The f32 kernel's block takes 64, 128 or 192 query rows (one to three
    consumer warpgroups, fewer where the head dim leaves no shared memory
    for more) by its cost rule; each shape of ``F32_BLOCK_SHAPES`` takes
    another."""
    from audiogpt_tpu_torch.ops.flash_attention import launch_grid

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for b, tq, tk, h, d in F32_BLOCK_SHAPES:
        q = torch.empty(b, tq, h, d, device="cuda")
        rows.append(launch_grid(q)["block_q"])
        assert rows[-1] == _f32_block_rows(b, tq, h, d, sms)
    if sms == 132:
        assert rows == [64, 128, 192]


def _graph_replay_is_bitwise_eager(gen, shape, dtype):
    b, tq, tk, h, d = shape
    q, k, v = _qkv(gen, b, tq, tk, h, d, dtype)
    mask = (torch.arange(tk, device="cuda")[None]
            < torch.tensor([tk - 100 * i for i in range(b)],
                           device="cuda")[:, None]).float()
    eager = flash_attention(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        flash_attention(q, k, v, kv_mask=mask)    # warm-up off the capture
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            replayed = flash_attention(q, k, v, kv_mask=mask)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)


@pytest.mark.parametrize("shape", BF16_BLOCK_SHAPES + [(2, 256, 256, 8, 160)])
def test_flash_bf16_graph_replay_is_bitwise_eager(gen, shape):
    """The TMA descriptors are kernel parameters, encoded at each call: a
    CUDA graph captures them with the launch, and its replay gives the
    eager call's output bit for bit."""
    _graph_replay_is_bitwise_eager(gen, shape, torch.bfloat16)


@pytest.mark.parametrize("shape", F32_BLOCK_SHAPES + [(4, 1500, 1500, 8, 64)])
def test_flash_f32_graph_replay_is_bitwise_eager(gen, shape):
    """The f32 twin: a CUDA graph's replay of the f32 kernel (its TMA
    descriptors captured as parameters) equals the eager call bit for
    bit."""
    _graph_replay_is_bitwise_eager(gen, shape, torch.float32)


def test_flash_rejects_what_the_kernel_does_not_take(gen):
    q, k, v = _qkv(gen, 1, 16, 16, 1, 192)  # wider than any compiled width
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
    q, k, v = _qkv(gen, 1, 16, 16, 2, 32)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q.bfloat16(), k, v)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    q, k, v = _qkv(gen, 1, 16, 16, 2, 6)    # 24-byte rows: no 16-byte copies
    with pytest.raises(ValueError):
        flash_attention(q, k, v)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_takes_chunked_clip_views_to_the_kernel(gen, dtype):
    """CLIP ViT-H/14's self-attention: q/k/v are strided views of one fused
    projection, 257 tokens at D = 80; ``attention()`` launches the kernel
    on contiguous copies."""
    qkv = torch.randn(1, 257, 3 * 1280, generator=gen, device="cuda").to(
        dtype)
    q, k, v = (u.reshape(1, 257, 16, 80) for u in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    before = flash_attention.launches
    out = attention(q, k, v)
    ref = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_head_dim_160_takes_the_kernel(gen, dtype):
    """D = 160 (the T2I UNet's ds-4 level, [2, 256, 8, 160]): the automatic
    dispatch launches the kernel (f32 keeps Q in shared memory at this
    width); D = 192 is wider than any compiled width: the dispatch runs the
    plain product and forcing the kernel raises."""
    q, k, v = _qkv(gen, 2, 256, 256, 8, 160, dtype)
    before = flash_attention.launches
    out = attention(q, k, v)
    ref = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])
    q, k, v = _qkv(gen, 2, 256, 256, 8, 192, dtype)
    before = flash_attention.launches
    out = attention(q, k, v)
    assert flash_attention.launches == before
    torch.testing.assert_close(out.float(),
                               flash_attention_reference(q, k, v).float(),
                               **FLASH_TOL[dtype])
    with pytest.raises(ValueError):
        attention(q, k, v, use_flash=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_takes_blip_fused_qkv_views_to_the_kernel(gen, dtype):
    """BLIP-base's vision block: q/k/v are strided views of one fused qkv
    projection, [1, 577, 12, 64]; ``attention()`` launches the kernel on
    contiguous copies."""
    qkv = torch.randn(1, 577, 3 * 768, generator=gen, device="cuda").to(
        dtype)
    q, k, v = (u.reshape(1, 577, 12, 64) for u in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    before = flash_attention.launches
    out = attention(q, k, v)
    ref = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sr,heads,hw", [(8, 1, (400, 16)), (4, 2, (200, 8))])
def test_pvt_sr_attention_takes_the_kernel(gen, sr, heads, hw, dtype):
    """PVT's spatial-reduction attention at a 10 s clip's stage-0 and
    stage-1 shapes ([1, 6400 → 100, 1, 64], [1, 1600 → 100, 2, 64]): one
    or two heads, Tq >> Tk, a key count that is no multiple of the 64-key
    tile, k and v strided views of one kv projection. The module launches
    the kernel once and matches its plain dispatch."""
    dim = 64 * heads
    attn = SRAttention(dim, heads, sr).cuda().to(dtype).eval()
    x = torch.randn(1, hw[0] * hw[1], dim, generator=gen, device="cuda").to(
        dtype)
    # the module (``ops/__init__.py`` exports a function of its name)
    ops_attention = importlib.import_module("audiogpt_tpu_torch.ops.attention")
    before = flash_attention.launches
    with torch.no_grad():
        out = attn(x, hw)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        real = ops_attention.flash_takes
        try:
            ops_attention.flash_takes = lambda *a: False
            ref = attn(x, hw)
        finally:
            ops_attention.flash_takes = real
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])


SNAKE_LENGTHS = [1, 3, 5, 37, 1024, 1025, 5003]


@pytest.mark.parametrize("t", SNAKE_LENGTHS)
def test_snake_f32_lengths(gen, t):
    _snake_check(gen, t, torch.float32)


@pytest.mark.parametrize("t", SNAKE_LENGTHS)
def test_snake_bf16_lengths(gen, t):
    _snake_check(gen, t, torch.bfloat16)


def _snake_check(gen, t, dtype):
    x = torch.randn(2, 5, t, generator=gen, device="cuda").to(dtype)
    alpha = torch.exp(0.3 * torch.randn(5, generator=gen, device="cuda"))
    beta = torch.exp(0.3 * torch.randn(5, generator=gen, device="cuda"))
    before = snake_aa.launches
    out = snake_aa(x, alpha, beta)
    ref = snake_aa_reference(x, alpha, beta)
    torch.cuda.synchronize()
    assert snake_aa.launches == before + 1
    assert out.dtype == dtype
    if dtype == torch.float32:
        # f32 FIR taps summed in another order than cuDNN's depthwise convs,
        # and the range-reduced __sinf (~1e-6 / beta)
        assert (out - ref).abs().max().item() <= 1e-5
    else:
        # both compute in f32 and round once to bf16: one bf16 step apart
        diff = (out.float() - ref.float()).abs()
        assert torch.all(diff <= 2 ** -7 * ref.float().abs() + 1e-3)


def test_snake_bf16_keeps_dtype(gen):
    x = torch.randn(2, 7, 2049, generator=gen, device="cuda").bfloat16()
    alpha = torch.exp(0.3 * torch.randn(7, generator=gen, device="cuda"))
    beta = torch.exp(0.3 * torch.randn(7, generator=gen, device="cuda"))
    out = snake_aa(x, alpha, beta)
    ref = snake_aa_reference(x, alpha, beta)
    assert out.dtype == torch.bfloat16
    # both compute in f32 and round once to bf16: one bf16 step apart at most
    diff = (out.float() - ref.float()).abs()
    assert torch.all(diff <= 2 ** -7 * ref.float().abs() + 1e-3)


def test_snake_unaligned_storage(gen):
    """A view that starts off a 16-byte boundary takes the scalar path."""
    base = torch.randn(2 * 3 * 1001 + 1, generator=gen, device="cuda")
    x = base[1:].view(2, 3, 1001)
    alpha = torch.exp(0.3 * torch.randn(3, generator=gen, device="cuda"))
    beta = torch.exp(0.3 * torch.randn(3, generator=gen, device="cuda"))
    out = snake_aa(x, alpha, beta)
    ref = snake_aa_reference(x, alpha, beta)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-5


def test_snake_rejects_what_the_kernel_does_not_take(gen):
    x = torch.randn(2, 4, 64, generator=gen, device="cuda")
    ones = torch.ones(4, device="cuda")
    with pytest.raises(ValueError):
        snake_aa(x.transpose(1, 2), ones, ones)
    with pytest.raises(TypeError):
        snake_aa(x.half(), ones, ones)
    with pytest.raises(ValueError):
        snake_aa(x, torch.ones(3, device="cuda"), ones)


def _on_worker(fn):
    """``fn()`` on a new thread under a CUDA stream of its own, as an
    engine replica runs (``engines/base.py`` ``ReplicaRunner``) →
    (output, the stream's handle)."""
    box = {}

    def work():
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            box["out"] = fn()
        stream.synchronize()
        box["stream"] = stream.cuda_stream

    thread = threading.Thread(target=work)
    thread.start()
    thread.join()
    return box["out"], box["stream"]


def _snake_inputs(gen, b, c, t, dtype, device="cuda"):
    x = torch.randn(b, c, t, generator=gen, device="cuda").to(dtype)
    alpha = torch.exp(0.3 * torch.randn(c, generator=gen, device="cuda"))
    beta = torch.exp(0.3 * torch.randn(c, generator=gen, device="cuda"))
    return tuple(a.to(device) for a in (x, alpha, beta))


def _close(out, ref, dtype):
    if dtype == torch.float32:
        return (out.float() - ref.float()).abs().max().item() <= 1e-5
    return bool(torch.all((out.float() - ref.float()).abs()
                          <= 2 ** -7 * ref.float().abs() + 1e-3))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 256, 256, 8, 160),
                                   (4, 1500, 1500, 8, 64)])
def test_kernels_launch_from_a_worker_thread_on_its_stream(gen, dtype,
                                                           shape):
    """Both kernels called from another thread under its own stream (K1 at
    the T2I D = 160 shape and whisper's batch of 4): they launch there,
    count on that stream and match their plain versions."""
    q, k, v = _qkv(gen, *shape, dtype)
    x, alpha, beta = _snake_inputs(gen, 2, 64, 4993, dtype)
    dev = torch.cuda.current_device()
    flash_before = Counter(flash_attention.launches_by_stream)
    snake_before = Counter(snake_aa.launches_by_stream)
    (out, y), stream = _on_worker(
        lambda: (flash_attention(q, k, v), snake_aa(x, alpha, beta)))
    assert flash_attention.launches_by_stream[(dev, stream)] \
        == flash_before[(dev, stream)] + 1
    assert snake_aa.launches_by_stream[(dev, stream)] \
        == snake_before[(dev, stream)] + 1
    torch.testing.assert_close(out.float(), flash_attention_reference(
        q, k, v).float(), **FLASH_TOL[dtype])
    assert _close(y, snake_aa_reference(x, alpha, beta), dtype)


def _second_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    return torch.device("cuda", 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 256, 256, 8, 160),
                                   (4, 1500, 1500, 8, 64)])
def test_flash_d160_on_the_second_card_after_the_first(gen, dtype, shape):
    """K1 at D = 160 (209 KB of dynamic shared memory in f32; one consumer
    warpgroup a block in bf16) and at whisper's batch of 4 (two in bf16)
    on cuda:1 after a launch on cuda:0, with cuda:0 current and from a
    worker thread: the shared-memory set-up holds on each card."""
    card1 = _second_card()
    _flash_check(*_qkv(gen, *shape, dtype))
    q, k, v = (t.to(card1) for t in _qkv(gen, *shape, dtype))
    before = flash_attention.launches_by_device[1]
    with torch.cuda.device(0):
        out = flash_attention(q, k, v)
    thread_out, _ = _on_worker(lambda: flash_attention(q, k, v))
    torch.cuda.synchronize(card1)
    assert out.device == card1 and thread_out.device == card1
    assert flash_attention.launches_by_device[1] == before + 2
    ref = flash_attention_reference(q, k, v)
    for o in (out, thread_out):
        torch.testing.assert_close(o.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_snake_on_a_card_that_is_not_current(gen, dtype):
    card1 = _second_card()
    x, alpha, beta = _snake_inputs(gen, 2, 64, 4993, dtype, device=card1)
    before = snake_aa.launches_by_device[1]
    with torch.cuda.device(0):
        y = snake_aa(x, alpha, beta)
    torch.cuda.synchronize(card1)
    assert y.device == card1
    assert snake_aa.launches_by_device[1] == before + 1
    assert _close(y, snake_aa_reference(x, alpha, beta), dtype)


def test_t2a_mesh_of_one_card_twice_matches_one_replica(gen):
    """A narrow T2A engine (K1 at its level 0, K2 in BigVGAN) on a mesh
    that names the card twice: each replica's stream launches both kernels
    as one replica does at the rounded n, and the ranked call equals the
    one-replica call (TF32 off)."""
    from audiogpt_tpu_torch.engines import T2AConfig, T2AEngine, VocoderEngine
    from audiogpt_tpu_torch.models.caption import Cnn14Config
    from audiogpt_tpu_torch.models.diffusion import UNetConfig, VAEConfig
    from audiogpt_tpu_torch.models.textenc import (BertConfig, CLAPScorer,
                                                   CLAPTextConfig)
    from audiogpt_tpu_torch.models.vocoder import BigVGANConfig
    from audiogpt_tpu_torch.ops import _build
    from audiogpt_tpu_torch.parallel import device_mesh

    bert = BertConfig(vocab_size=2000, hidden_size=32, num_layers=1,
                      num_heads=2, intermediate_size=64, max_position=80)
    cfg = T2AConfig(
        unet=UNetConfig(model_channels=32, num_res_blocks=1,
                        channel_mult=(1, 2), num_heads=4, context_dim=32),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=()),
        clap=CLAPTextConfig(bert=bert, d_proj=32, max_length=16),
        mel_bins=16, mel_len=64, timesteps=100)
    voc = VocoderEngine("bigvgan", cfg=BigVGANConfig(
        num_mels=16, upsample_initial_channel=16, upsample_rates=(8, 8, 4),
        upsample_kernel_sizes=(16, 16, 8), resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 2),)), buckets=(64,), device="cuda")
    scorer = CLAPScorer(CLAPTextConfig(bert=bert, d_proj=32, max_length=16),
                        audio_cfg=Cnn14Config(channels=(4, 4, 8, 8, 16, 16)),
                        sample_rate=16000, device="cuda")
    eng = T2AEngine(cfg, vocoder=voc, scorer=scorer, device="cuda")
    # seeded noise in every parameter (weights · fan_in^-½, norm scales
    # 1 + 0.1·N, other vectors 0.1·N): no zero-initialised out conv leaves
    # the candidates equal
    fill = torch.Generator("cuda").manual_seed(5)
    norms = (torch.nn.LayerNorm, torch.nn.GroupNorm, torch.nn.BatchNorm2d)
    with torch.no_grad():
        for top in (eng.unet, eng.vae, eng.clap, voc.model, scorer.text,
                    scorer.audio):
            for mod in top.modules():
                for name, p in mod.named_parameters(recurse=False):
                    z = torch.randn(p.shape, generator=fill, device="cuda")
                    if isinstance(mod, norms) and name == "weight":
                        p.copy_(1.0 + 0.1 * z)
                    elif p.ndim >= 2:
                        p.copy_(z / p[0].numel() ** 0.5)
                    else:
                        p.copy_(0.1 * z)
    mesh = device_mesh(["cuda", "cuda"])
    meng = T2AEngine(cfg, vocoder=voc, scorer=scorer, mesh=mesh)
    meng.load_state_dict({name: getattr(eng, name).state_dict()
                          for name in ("unet", "vae", "clap")})
    for w in (flash_attention, snake_aa):
        _build.reset_counts(w)
    one = eng.txt2audio_best("a dog barks", n_samples=4, seed=3)
    torch.cuda.synchronize()
    single = {w: w.launches for w in (flash_attention, snake_aa)}
    for w in (flash_attention, snake_aa):
        _build.reset_counts(w)
    two = meng.txt2audio_best("a dog barks", n_samples=3, seed=3)
    torch.cuda.synchronize()
    dev = torch.cuda.current_device()
    for w in (flash_attention, snake_aa):
        assert single[w] > 0
        assert [w.launches_by_stream[(dev, s.cuda_stream)]
                for s in meng.runner.streams] == [single[w]] * 2
    assert two[2].shape == (4,)
    for a, b in zip(one, two):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_grads_on_the_card(gen, dtype, masked):
    """``FlashAttention`` on the card: the forward launches the kernel, the
    backward (the plain version's recompute, as JAX's ``custom_vjp``) gives
    the plain version's autograd gradients; the key mask gets none."""
    q, k, v = (t.requires_grad_() for t in
               _qkv(gen, 2, 300, 300, 4, 40, dtype))
    mask = None
    if masked:
        mask = (torch.arange(300, device="cuda")[None]
                < torch.tensor([300, 170], device="cuda")[:, None]).float()
    g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_mask=mask)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert flash_attention.launches == before + 1
    ref = torch.autograd.grad(flash_attention_reference(q, k, v, mask),
                              (q, k, v), g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), **FLASH_TOL[dtype])


def test_unet_gradients_through_the_kernel(gen):
    """A UNet forward under autograd on the card gives the level-0
    attention (16 x 16 latent: 256² pairs, the kernel) the plain path's
    gradients: every UNet parameter's within 1e-4 of the largest."""
    from audiogpt_tpu_torch.models.diffusion import UNetConfig, UNetModel

    torch.manual_seed(0)
    unet = UNetModel(UNetConfig(model_channels=32, num_res_blocks=1,
                                num_heads=4, context_dim=16)).cuda()
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                    / (p[0].numel() ** 0.5 if p.ndim > 1 else 10.0))
    x = torch.randn(2, 4, 16, 16, generator=gen, device="cuda")
    ctx = torch.randn(2, 5, 16, generator=gen, device="cuda")
    t = torch.tensor([10, 500], device="cuda")

    def grads():
        out = unet(x, t, ctx)
        return torch.autograd.grad((out ** 2).sum(), list(unet.parameters()))

    before = flash_attention.launches
    kernel = grads()
    # 3 level-0 blocks, run again in the backward (use_checkpoint)
    assert flash_attention.launches == before + 6
    attn = importlib.import_module("audiogpt_tpu_torch.ops.attention")
    takes = attn.flash_takes
    attn.flash_takes = lambda *a, **kw: False
    try:
        plain = grads()
    finally:
        attn.flash_takes = takes
    scale = max(float(b.abs().max()) for b in plain)
    assert all(float(b.abs().max()) > 0 for b in plain)
    assert max(float((a - b).abs().max())
               for a, b in zip(kernel, plain)) <= 1e-4 * scale


def test_snake_refuses_a_call_that_needs_a_gradient(gen):
    """The kernel has no backward: under grad with x, α or β requiring
    grad the wrapper raises (and names why) instead of falling back."""
    x = torch.randn(2, 4, 64, generator=gen, device="cuda")
    a = torch.ones(4, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        snake_aa(x, a, torch.ones(4, device="cuda"))
    with torch.no_grad():
        snake_aa(x, a, torch.ones(4, device="cuda"))


#: a narrow whisper whose encoder still takes the flash kernel on the card
#: (300 positions: 300² pairs ≥ 256²), with the full vocab's blocks
NARROW_WHISPER = dict(n_audio_ctx=300, n_audio_state=128, n_audio_head=2,
                      n_audio_layer=2, n_text_ctx=64, n_text_state=128,
                      n_text_head=2, n_text_layer=2, chunk_length=6)


def test_asr_engine_on_the_card_matches_the_cpu(gen, monkeypatch):
    """The same weights on the CPU (plain attention) and on the card (the
    flash kernel in the encoder): the encoder output and the prime's logits
    within 1e-3, and the t = 0 tokens equal at every step whose top-2 margin
    on the CPU exceeds 100× the logit error seen."""
    cfg = WhisperConfig(**NARROW_WHISPER)
    cpu = ASREngine(cfg, max_tokens=16, temperatures=(0.0,), device="cpu")
    card = ASREngine(cfg, max_tokens=16, temperatures=(0.0,))
    card.load_state_dict(cpu.model.state_dict())
    rng = np.random.RandomState(0)
    wav = (0.1 * rng.randn(1, cfg.n_samples)).astype(np.float32)
    prompt = torch.tensor([card.sot_sequence()])
    out, real = {}, whisper._pick
    for name, eng in (("cpu", cpu), ("cuda", card)):
        picks = []
        monkeypatch.setattr(whisper, "_pick", lambda lg, t, g, picks=picks: (
            picks.append(lg.cpu()) or real(lg, t, g)))
        before = flash_attention.launches
        mel = eng._mel(wav)
        with torch.inference_mode():
            xa = eng.model.encode(mel)
        launched = flash_attention.launches - before
        logits = whisper.prime(eng.model, mel, prompt.to(mel.device), 4)[2]
        toks = eng.transcribe_tokens(wav)[0, 4:]
        out[name] = (xa.cpu(), logits.cpu(), toks, picks, launched)
    assert out["cpu"][4] == 0 and out["cuda"][4] == cfg.n_audio_layer
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-3,
                               rtol=0)
    err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    assert err <= 1e-3
    compared = 0
    n = len(out["cpu"][2])       # the last step's pick is not emitted
    for step, (lg_cpu, lg_card) in enumerate(zip(out["cpu"][3][:n],
                                                 out["cuda"][3][:n])):
        kept = torch.isfinite(lg_cpu)          # suppressed ids are -inf
        err = max(err, (lg_card - lg_cpu)[kept].abs().max().item())
        top2 = torch.topk(lg_cpu, 2, dim=-1).values
        if (top2[:, 0] - top2[:, 1]).min().item() <= 100 * err:
            break
        assert out["cuda"][2][step] == out["cpu"][2][step]
        compared += 1
    assert compared >= 1


# -- the singing and style-transfer engines, card against CPU --------------
# Neither path launches a kernel (dense-mask attentions, no snake): the
# card's cuDNN and cuBLAS f32 (TF32 off) against the CPU on the same
# weights and draws.

from audiogpt_tpu_torch.engines import (  # noqa: E402
    StyleTransferEngine,
    SVSEngine,
    VISingerEngine,
    VocoderEngine,
)
from audiogpt_tpu_torch.models.svs import (  # noqa: E402
    DiffNetConfig,
    DiffSingerConfig,
    VISingerConfig,
)
from audiogpt_tpu_torch.models.tts import FastSpeech2Config  # noqa: E402
from audiogpt_tpu_torch.models.tts.generspeech import (  # noqa: E402
    GenerSpeechConfig,
)
from audiogpt_tpu_torch.models.tts.pitch_extractor import (  # noqa: E402
    PitchExtractor,
    PitchExtractorConfig,
)
from audiogpt_tpu_torch.models.vocoder import HifiGANConfig  # noqa: E402

SONG = ("ni hao SP shi jie AP", "C4 | D4 E4 | rest | F#4/Gb4 | G4 | rest",
        "0.1 | 0.3 0.2 | 0.25 | 0.2 | 0.15 | 0.3")
NARROW_HIFI = dict(upsample_initial_channel=32, upsample_rates=(8, 8, 4),
                   upsample_kernel_sizes=(16, 16, 8),
                   resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),))
NARROW_FS2 = dict(hidden_size=64, enc_layers=2, dec_layers=2,
                  predictor_layers=2, max_frames=256)


def _pair(build, dur_head=None):
    """``build(device)`` on the CPU and on the card, the card's weights and
    buffers copied from the CPU's; ``dur_head(model)``, the duration
    head's output layer, held at 4 frames a phone mid-way between rounding
    edges (weights · 1e-3)."""
    cpu, card = build("cpu"), build(None)
    if dur_head is not None:
        with torch.no_grad():
            dur_head(cpu.model).weight.mul_(1e-3)
            dur_head(cpu.model).bias.fill_(float(np.log(5.0)))
    card.model.load_state_dict(cpu.model.state_dict())
    if hasattr(cpu, "vocoder"):
        card.vocoder.load_state_dict(cpu.vocoder.model.state_dict())
    return cpu, card


def test_svs_engine_on_the_card_matches_the_cpu(gen):
    """DiffSinger (DDPM, 8 steps, replayed draws) and the pitch
    extractor's f0 on the mel padded onto the vocoder's bucket."""
    cfg = DiffSingerConfig(
        fs2=FastSpeech2Config(use_midi=True, rel_pos=True,
                              use_pitch_embed=False, **NARROW_FS2),
        net=DiffNetConfig(encoder_hidden=64, residual_layers=4,
                          residual_channels=64), timesteps=8, K_step=8)
    pe = {}

    def build(device):
        pe[device] = PitchExtractor(PitchExtractorConfig(hidden=32,
                                                         predictor_layers=2))
        if device is None:
            pe[None].load_state_dict(pe["cpu"].state_dict())
        voc = VocoderEngine("hifigan", HifiGANConfig(**NARROW_HIFI),
                            buckets=(256,), device=device)
        return SVSEngine(cfg, vocoder=voc, pitch_extractor=pe[device],
                         token_buckets=(16,), pndm_speedup=1, device=device)

    cpu, card = _pair(build, lambda m: m.fs2.dur_predictor.out)
    g = torch.Generator().manual_seed(1)
    shape = (1, 256, 80)
    x_t = torch.randn(shape, generator=g)
    noise = [torch.randn(shape, generator=g) for _ in range(8)]
    out = {}
    for name, eng in (("cpu", cpu), ("cuda", card)):
        dev = eng.device
        mel, f0 = eng.synthesize_mel(*SONG, draws=(
            x_t.to(dev), [n.to(dev) for n in noise]))
        out[name] = (mel.cpu(), f0.cpu())
    assert out["cpu"][0].shape == (44, 80)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=5e-4,
                               rtol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-2,
                               rtol=1e-4)


def test_visinger_engine_on_the_card_matches_the_cpu(gen):
    cfg = VISingerConfig(hidden=64, latent_dim=32, enc_layers=2,
                         posterior_layers=1, flow_layers=2, flow_wn_layers=2,
                         max_frames=256,
                         decoder=HifiGANConfig(in_channels=32,
                                               **NARROW_HIFI))
    cpu, card = _pair(lambda device: VISingerEngine(
        cfg, token_buckets=(16,), device=device))
    z = torch.randn(1, 256, 32, generator=torch.Generator().manual_seed(2))
    a = cpu.synthesize(*SONG, draws=z)
    b = card.synthesize(*SONG, draws=z.to("cuda"))
    assert a.shape == b.shape and a.size > 0
    np.testing.assert_allclose(b, a, atol=5e-4, rtol=0)


def test_style_transfer_engine_on_the_card_matches_the_cpu(gen):
    cfg = GenerSpeechConfig(fs2=FastSpeech2Config(**NARROW_FS2), n_vq=16,
                            emb_dim=32, glow_hidden=32, glow_steps=2,
                            glow_wn_layers=2)
    cpu, card = _pair(lambda device: StyleTransferEngine(
        cfg, vocoder=VocoderEngine("hifigan", HifiGANConfig(**NARROW_HIFI),
                                   buckets=(256,), device=device),
        device=device), lambda m: m.dur_predictor.out)
    rng = np.random.RandomState(3)
    ref = (0.2 * np.sin(np.arange(44100) / 9.0)
           + 0.01 * rng.randn(44100)).astype(np.float32)
    z = torch.randn(1, 128, 160, generator=torch.Generator().manual_seed(4))
    mels = [e.synthesize_mel("Hello from the card.", ref,
                             draws=z.to(e.device)).cpu()
            for e in (cpu, card)]
    assert mels[0].shape[0] > 10
    torch.testing.assert_close(mels[1], mels[0], atol=5e-4, rtol=0)


# the GeneFace, HTSAT and PortaSpeech card-vs-CPU checks
from audiogpt_tpu_torch.engines import (  # noqa: E402
    GeneFaceEngine,
    PortaSpeechTTSEngine,
)
from audiogpt_tpu_torch.models.face import Audio2MotionConfig  # noqa: E402
from audiogpt_tpu_torch.models.textenc import (  # noqa: E402
    HTSATAudioEncoder,
    HTSATConfig,
)
from audiogpt_tpu_torch.models.tts import PortaSpeechConfig  # noqa: E402


def test_geneface_engine_on_the_card_matches_the_cpu(gen):
    """Landmarks within 1e-5 with the same draws; frames at most one level
    off on at most 0.1 % of the values."""
    cpu, card = _pair(lambda device: GeneFaceEngine(
        Audio2MotionConfig(hidden=64, latent=8, conv_layers=2),
        video_size=64, buckets=(256,), device=device))
    mel = torch.rand(200, 80, generator=torch.Generator().manual_seed(5))
    z = torch.randn(1, 102, 8, generator=torch.Generator().manual_seed(6))
    lm = [e.motion(mel.to(e.device), z.to(e.device)).cpu()
          for e in (cpu, card)]
    assert lm[0].shape == (80, 68, 2)
    torch.testing.assert_close(lm[1], lm[0], atol=1e-5, rtol=0)
    frames = [e.warper.render(e.portrait, lm[0]) for e in (cpu, card)]
    diff = np.abs(frames[0].astype(np.int16) - frames[1])
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_htsat_on_the_card_matches_the_cpu(gen):
    """A narrow HTSAT at the full 256² image (the clamp rule at stage 4),
    embedding and clip probabilities within 1e-4."""
    cfg = HTSATConfig(embed_dim=16, num_heads=(2, 2, 4, 4), d_proj=32)
    cpu = HTSATAudioEncoder(cfg).eval()
    card = HTSATAudioEncoder(cfg).cuda().eval()
    with torch.no_grad():
        cpu.bn0_var.uniform_(0.5, 1.5)
    card.load_state_dict(cpu.state_dict())
    wav = 0.1 * torch.randn(2, 96000, generator=torch.Generator()
                            .manual_seed(7))
    with torch.no_grad():
        a = cpu(wav, return_dict=True)
        b = card(wav.cuda(), return_dict=True)
    for key in ("projected", "clipwise"):
        torch.testing.assert_close(b[key].cpu(), a[key], atol=1e-4, rtol=0)


def test_syntaspeech_engine_on_the_card_matches_the_cpu(gen):
    """SyntaSpeech (the graph on) at a narrow width, the same draws: the
    mel within 5e-4."""
    cfg = PortaSpeechConfig(hidden_size=64, enc_layers=2, word_enc_layers=2,
                            fvae_hidden=64, prior_flow_hidden=32,
                            max_frames=256, use_graph=True)
    cpu, card = _pair(lambda device: PortaSpeechTTSEngine(
        cfg, vocoder=VocoderEngine("hifigan", HifiGANConfig(**NARROW_HIFI),
                                   buckets=(256,), device=device),
        device=device), lambda m: m.dur_predictor.out)
    z = torch.randn(1, 64, 16, generator=torch.Generator().manual_seed(8))
    mels = [e.text_to_mel("Hello from the card, again.", draws=z.to(e.device))
            for e in (cpu, card)]
    assert mels[0].shape[0] > 20
    np.testing.assert_allclose(mels[1], mels[0], atol=5e-4, rtol=0)
