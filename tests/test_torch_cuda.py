"""The hand-written CUDA flash-attention kernels against their plain twins,
on an NVIDIA GPU (skipped without one). Small and odd shapes the path test
in chip_smoke.py does not reach: D from 12 to 128, Tq = 1, ragged
tiles, GQA groups of 1 to 20, strided views, both dtypes; the forward K1
with and without its logsumexp on each of its routes (the split-KV decode
at Tq = 1, the wgmma/TMA body over the cell map), the backward K5a (dq) and
K5b (dk/dv), autograd through `flash_attention`, and a bf16 training run of
the tiny config, whose 12-wide ViT heads TMA cannot read unpadded.

Run on a machine with a card (the repository's conftest needs jax, which
that machine may lack):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: bf16 outputs atol = rtol = 1e-2; fp32 outputs 1e-4 (fp32 FMA
sums in another order than the twin's matmul). bf16 gradients 2e-2: they
are sums over many more terms than an output row, in another order, each
rounded once to bf16.
"""

import pytest

torch = pytest.importorskip("torch")

from oryx_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

pytestmark = pytest.mark.cuda

TOLS = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, B, Tq, Tk, Hq, Hk, D, *, causal, segments, mask,
          seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)

    kw = dict(causal=causal)
    if causal:
        kw["q_positions"] = torch.randint(
            0, Tk, (B, Tq), generator=g, device=dev
        )
    if segments:
        kw["kv_segment_ids"] = torch.randint(
            0, 4, (B, Tk), generator=g, device=dev
        )
        kw["q_segment_ids"] = torch.randint(
            0, 4, (B, Tq), generator=g, device=dev
        )
    if mask:
        lens = torch.randint(1, Tk + 1, (B, 1), generator=g, device=dev)
        kw["kv_mask"] = (torch.arange(Tk, device=dev)[None] < lens).int()
    return rnd(B, Tq, Hq, D), rnd(B, Tk, Hk, D), rnd(B, Tk, Hk, D), kw


def _check(q, k, v, kw):
    args, flags = fa._prepare(
        q, k, v, kw.get("q_positions"), None, kw.get("q_segment_ids"),
        kw.get("kv_segment_ids"), kw.get("kv_mask"), kw["causal"], None,
    )
    before = sum(fa.LAUNCHES.values())
    decode = sum(fa.LAUNCHES_DECODE.values())
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert sum(fa.LAUNCHES.values()) == before + 1
    route = q.dtype == torch.bfloat16 and q.shape[1] == 1
    assert sum(fa.LAUNCHES_DECODE.values()) == decode + route
    ref = fa._mha_forward_reference(*args, **flags).transpose(1, 2)
    # Rows with at least one visible key (fully masked rows are discarded
    # by every caller and differ with the kernel's tile skipping).
    qp, kp, _, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    vis = kv_valid[:, None, :] > 0
    if flags["causal"]:
        vis = vis & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if flags["has_segments"]:
        vis = vis & (q_seg[:, :, None] == kv_seg[:, None, :])
    keep = vis.any(-1)
    tol = TOLS[q.dtype]
    torch.testing.assert_close(
        got[keep].float(), ref[keep].float(), atol=tol, rtol=tol
    )
    assert got.shape == q.shape and got.dtype == q.dtype


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [12, 16, 72, 128])
def test_causal_prefill_gqa(card, dtype, D):
    _check(*_case(card, dtype, 2, 37, 130, 14, 2, D, causal=True,
                  segments=False, mask=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 5])
def test_decode_single_query(card, dtype, B):
    _check(*_case(card, dtype, B, 1, 300, 28, 4, 128, causal=True,
                  segments=False, mask=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [12, 72])
def test_segments_self_and_cross(card, dtype, D):
    _check(*_case(card, dtype, 1, 200, 200, 4, 4, D, causal=False,
                  segments=True, mask=False))
    _check(*_case(card, dtype, 1, 50, 333, 4, 4, D, causal=False,
                  segments=True, mask=True, seed=1))


def test_strided_cache_view(card):
    """A layer view of an [L, B, S, Hk, D] cache goes in without a copy."""
    cache = torch.randn(3, 2, 96, 2, 16, device=card).to(torch.bfloat16)
    q = torch.randn(2, 5, 4, 16, device=card).to(torch.bfloat16)
    pos = torch.tensor([[40, 41, 42, 43, 44], [7, 8, 9, 10, 11]],
                       device=card)
    _check(q, cache[1], cache[2], dict(causal=True, q_positions=pos))


# ---- K1's routes: the split-KV decode and the wgmma/TMA body ---------------


def _decode_case(dev, B, S, Hk, G, D, pos, seed=0):
    """One decode step over a dense cache: q [B, 1, Hk G, D] at positions
    `pos`, k/v [B, S, Hk, D], the kv mask slots <= pos."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    pos = torch.tensor(pos, device=dev)[:, None]
    mask = (torch.arange(S, device=dev)[None] <= pos).int()
    return (rnd(B, 1, Hk * G, D), rnd(B, S, Hk, D), rnd(B, S, Hk, D),
            dict(causal=True, q_positions=pos, kv_mask=mask))


@pytest.mark.parametrize("G", [1, 2, 7, 8, 16, 20])
def test_decode_route_groups(card, G):
    """Tq = 1, bf16: the split-KV route at every group size (20: two chunks
    of q heads per kv head), rows whose visible keys end inside, at and just
    past a split boundary."""
    _check(*_decode_case(card, 4, 1000, 2, G, 128, [999, 63, 64, 700]))


@pytest.mark.parametrize("D", [12, 16, 40, 72])
def test_decode_route_widths(card, D):
    _check(*_decode_case(card, 2, 300, 2, 7, D, [299, 130]))


def test_decode_route_empty_split_and_row(card):
    """A split whose range holds no visible key (a hole in the kv mask of
    row 1), a row that sees no key at all (row 2: zeros and lse FLT_MAX),
    and the logsumexp at Tq = 1 against the twin's."""
    q, k, v, kw = _decode_case(card, 3, 700, 4, 7, 128, [650, 300, 500])
    kw["kv_mask"][1, 64:256] = 0
    kw["kv_mask"][2] = 0
    _check(q, k, v, kw)
    args, flags = fa._prepare(q, k, v, kw["q_positions"], None, None, None,
                              kw["kv_mask"], True, None)
    o, lse = fa._mha_forward(*args, **flags, with_lse=True)
    ro, rlse = fa._mha_forward_reference(*args, **flags, with_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse[:2], rlse[:2], atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(o[:2].float(), ro[:2].float(), atol=1e-2,
                               rtol=1e-2)
    assert (o[2] == 0).all() and (lse[2] == fa.FLT_MAX).all()


def test_decode_route_is_deterministic_at_chat_batch_shape(card):
    """The chat_batch decode step (B 4, 28 / 4 heads, D 128, a 4,096-slot
    cache, rows of 1,153-141 tokens plus 16): two calls give the same bits,
    and both match the twin."""
    q, k, v, kw = _decode_case(card, 4, 4096, 4, 7, 128,
                               [1169, 674, 440, 157])
    _check(q, k, v, kw)
    a = fa.flash_attention(q, k, v, **kw)
    b = fa.flash_attention(q, k, v, **kw)
    assert torch.equal(a, b)


def _compressor_segments(grids, pads, dev):
    """Pooled queries (one per 4 x 4-patch region) against their patches,
    images one after another, `pads` (q, kv) pad rows (id 0) at the end:
    the layouts of tests/test_torch_flash_bwd_schedule.py."""
    kv, q, base = [], [], 0
    for h, w in grids:
        r = ((torch.arange(h)[:, None] // 4) * (-(-w // 4))
             + torch.arange(w)[None] // 4).reshape(-1) + 1 + base
        kv.append(r)
        q.append(torch.unique(r))
        base = int(r.max())
    q_seg = torch.cat(q + [torch.zeros(pads[0], dtype=torch.long)])
    kv_seg = torch.cat(kv + [torch.zeros(pads[1], dtype=torch.long)])
    return q_seg[None].to(dev), kv_seg[None].to(dev)


@pytest.mark.parametrize("grids,pads", [
    ([(16, 16)], (11, 40)),
    ([(28, 44), (8, 12)], (0, 63)),
    ([(44, 44)] * 4, (37, 5)),
])
def test_forward_compressor_regions_with_pads(card, grids, pads):
    """The map forward on the compressor's layout: the pad id 0 beside real
    regions in one tile must not make every tile meet."""
    q_seg, kv_seg = _compressor_segments(grids, pads, card)
    q, k, v, _ = _case(card, torch.bfloat16, 1, q_seg.shape[1],
                       kv_seg.shape[1], 4, 4, 72, causal=False,
                       segments=False, mask=False)
    _check(q, k, v, dict(causal=False, q_segment_ids=q_seg,
                         kv_segment_ids=kv_seg))


def test_forward_segments_straddle_tiles(card):
    """ViT-like packed images whose boundaries fall inside cells, pads
    attending pads."""
    sizes = [50, 100, 37, 129, 64]
    seg = torch.cat([torch.full((n,), i + 1) for i, n in enumerate(sizes)]
                    + [torch.zeros(20, dtype=torch.long)]).to(card)[None]
    q, k, v, _ = _case(card, torch.bfloat16, 1, seg.shape[1], seg.shape[1],
                       4, 4, 72, causal=False, segments=False, mask=False)
    _check(q, k, v, dict(causal=False, q_segment_ids=seg,
                         kv_segment_ids=seg))


@pytest.mark.parametrize("D", [12, 16, 40, 64, 72, 128])
@pytest.mark.parametrize("G", [1, 7])
def test_tma_body_widths_and_groups(card, D, G):
    """Every width the body takes (12: the wrapper pads it; 40 and 64: one
    64-column box; 72: a 64- and a 16-column box) under every mask at
    once."""
    _check(*_case(card, torch.bfloat16, 2, 200, 333, 2 * G, 2, D,
                  causal=True, segments=True, mask=True))


@pytest.mark.parametrize("Tq,Tk", [(2, 1), (63, 63), (65, 65), (129, 200),
                                   (200, 65), (1000, 1000)])
def test_tma_body_tile_edges(card, Tq, Tk):
    _check(*_case(card, torch.bfloat16, 1, Tq, Tk, 7, 1, 128, causal=True,
                  segments=False, mask=True))


def test_tma_body_head_major_views(card):
    """q, k, v as strided views of head-major [B, H, T, D] storage."""
    q, k, v, kw = _case(card, torch.bfloat16, 2, 130, 200, 8, 2, 128,
                        causal=True, segments=False, mask=True)
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in (q, k, v))
    _check(q, k, v, kw)


def test_tma_body_lse_at_decoder_layout(card):
    """The training decoder's layout (slot positions over right-padded rows)
    through the body with its logsumexp, against the twin's."""
    B, T = 3, 640
    live = torch.arange(T, device=card)[None] < torch.tensor(
        [[640], [333], [128]], device=card)
    pos = torch.where(live, torch.arange(T, device=card)[None], 0)
    q, k, v, _ = _case(card, torch.bfloat16, B, T, T, 14, 2, 128,
                       causal=False, segments=False, mask=False)
    args, flags = fa._prepare(q, k, v, pos, pos, None, None, live.int(),
                              True, None, True)
    o, lse = fa._mha_forward(*args, **flags, with_lse=True)
    ro, rlse = fa._mha_forward_reference(*args, **flags, with_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-2, rtol=1e-2)


def test_rejects_what_the_kernel_does_not_take(card):
    q = torch.randn(1, 4, 2, 16, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 4, 2, 160, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D <= 128"):
        fa.flash_attention(q, q, q)


def _pool_case(dev, dtype, *, ps, D, G, lengths, Hk=2, seed=0):
    """A random page pool with one sink page, block tables holding distinct
    random pages for each row's `lengths` slots and sentinel tails."""
    from oryx_tpu_torch.ops import paged_kv

    g = torch.Generator(device="cpu").manual_seed(seed)
    maxp = max(-(-n // ps) for n in lengths) + 1
    need = sum(-(-n // ps) for n in lengths)
    P = need + 3
    k = paged_kv.init_paged_pool(1, P, ps, Hk, D, dtype=dtype, device=dev)[0]
    v = paged_kv.init_paged_pool(1, P, ps, Hk, D, dtype=dtype, device=dev)[0]
    k.copy_(torch.randn(k.shape, generator=g).to(dtype))
    v.copy_(torch.randn(v.shape, generator=g).to(dtype))
    perm = torch.randperm(P, generator=g).tolist()
    bt = torch.full((len(lengths), maxp), P, dtype=torch.int32)
    for s, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            bt[s, j] = perm.pop()
    q = torch.randn((len(lengths), Hk * G, D), generator=g).to(dtype)
    return q.to(dev), k, v, bt.to(dev)


PAGED_GRID = [
    (dtype, ps, D, G)
    for dtype in (torch.bfloat16, torch.float32)
    for ps in (16, 64)
    for D in (16, 128)
    for G in (1, 2, 7)
]


@pytest.mark.parametrize("dtype,ps,D,G", PAGED_GRID)
def test_paged_decode_kernel(card, dtype, ps, D, G):
    """K3 against its plain twin: lengths of 1, on page boundaries, one past
    a boundary, and long rows with sentinel tails."""
    from oryx_tpu_torch.ops import paged_kv
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    lengths = [1, ps, ps + 1, 2 * ps, 3 * ps - 5, 200]
    q, k, v, bt = _pool_case(card, dtype, ps=ps, D=D, G=G, lengths=lengths)
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=card)
    before = sum(n for key, n in pa.LAUNCHES.items()
                 if key[0] == "paged_decode")
    got = pa.ragged_decode_attention(q, k, v, bt, kv_len)
    torch.cuda.synchronize()
    assert sum(n for key, n in pa.LAUNCHES.items()
               if key[0] == "paged_decode") == before + 1
    ref = paged_kv.ragged_decode_attention(q, k, v, bt, kv_len)
    tol = TOLS[dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    assert got.shape == q.shape and got.dtype == dtype
    # [B, 1, Hq, D] queries give the same numbers.
    got4 = pa.ragged_decode_attention(q[:, None], k, v, bt, kv_len)
    torch.testing.assert_close(got4[:, 0], got, atol=0, rtol=0)


@pytest.mark.parametrize("dtype,ps,D,G", PAGED_GRID)
def test_ragged_paged_kernel(card, dtype, ps, D, G):
    """K4 against its plain twin on a mixed dispatch: decode rows of every
    slot, prefill rows of one slot at consecutive positions, an empty slot
    (segment past S clamps) and a row with no visible key."""
    from oryx_tpu_torch.ops import paged_kv
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    lengths = [1, ps, 2 * ps + 3, 150]
    q, k, v, bt = _pool_case(card, dtype, ps=ps, D=D, G=G, lengths=lengths,
                             seed=1)
    Hq = q.shape[1]
    seg = list(range(4)) + [2] * (2 * ps + 3) + [9, 0]
    pos = [n - 1 for n in lengths] + list(range(2 * ps + 3)) + [40, -1]
    R = len(seg)
    g = torch.Generator(device="cpu").manual_seed(2)
    qr = torch.randn((R, Hq, D), generator=g).to(dtype).to(card)
    seg_t = torch.tensor(seg, dtype=torch.int32, device=card)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=card)
    got = pa.ragged_paged_attention(qr, k, v, bt, seg_t, pos_t)
    torch.cuda.synchronize()
    ref = paged_kv.ragged_paged_attention(qr, k, v, bt, seg_t, pos_t)
    keep = pos_t >= 0  # rows with at least one visible key
    tol = TOLS[dtype]
    torch.testing.assert_close(
        got[keep].float(), ref[keep].float(), atol=tol, rtol=tol
    )
    assert bool((got[~keep] == 0).all())  # no visible key: zeros


def test_paged_kernels_reject_what_they_do_not_take(card):
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    q, k, v, bt = _pool_case(card, torch.bfloat16, ps=16, D=16, G=2,
                             lengths=[5, 9])
    n = torch.tensor([5, 9], device=card)
    with pytest.raises(ValueError, match="dtype"):
        pa.ragged_decode_attention(q.half(), k, v, bt, n)
    q17 = torch.zeros((2, 2 * 17, 16), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="Hq // Hk"):
        pa.ragged_decode_attention(q17, k, v, bt, n)
    # bf16 pages are read in 16-byte chunks: D % 8 and aligned pools only.
    buf = torch.zeros(k.numel() + 1, dtype=k.dtype, device=card)
    k_off = buf[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte alignment"):
        pa.ragged_decode_attention(q, k_off, v, bt, n)
    q12, k12 = q[..., :12].contiguous(), k[..., :12].contiguous()
    with pytest.raises(ValueError, match="D % 8"):
        pa.ragged_decode_attention(q12, k12, k12, bt, n)


def _quant_pools(dev, dtype, fmt, *, ps, D, G, lengths, Hk=2, seed=0):
    """`_pool_case` with QuantPages planes: every pool row written through
    the quantizing writer from random values (realistic codes and per-row
    scales), dequantized into `dtype`."""
    from oryx_tpu_torch.ops import paged_kv

    q, k, v, bt = _pool_case(dev, torch.float32, ps=ps, D=D, G=G,
                             lengths=lengths, Hk=Hk, seed=seed)
    P = k.shape[0]
    planes = []
    for dense in (k, v):
        plane = paged_kv.init_quant_pages(1, P, ps, Hk, D, fmt=fmt,
                                          dequant_dtype=dtype, device=dev)[0]
        paged_kv.scatter_rows(plane, torch.arange(P * ps, device=dev),
                              dense.reshape(P * ps, Hk, D))
        planes.append(plane)
    return q.to(dtype), planes[0], planes[1], bt


QUANT_GRID = [
    (fmt, dtype, ps, D, G)
    for fmt in ("int8", "fp8_e4m3")
    for dtype in (torch.bfloat16, torch.float32)
    for ps in (16, 64)
    for D in (64, 128)
    for G in (1, 7)
]


@pytest.mark.parametrize("fmt,dtype,ps,D,G", QUANT_GRID)
def test_quant_paged_decode_kernel(card, fmt, dtype, ps, D, G):
    """K3 on an int8 / fp8 pool (the dequantizing branch) against its plain
    twin, which dequantizes in `gather_pages`: lengths of 1, on and one past
    page boundaries, and long rows with sentinel tails."""
    from oryx_tpu_torch.ops import paged_kv
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    lengths = [1, ps, ps + 1, 2 * ps, 3 * ps - 5, 200]
    q, k, v, bt = _quant_pools(card, dtype, fmt, ps=ps, D=D, G=G,
                               lengths=lengths)
    kv_len = torch.tensor(lengths, dtype=torch.int32, device=card)
    name = f"paged_decode_{fmt}"
    before = sum(n for key, n in pa.LAUNCHES.items() if key[0] == name)
    got = pa.ragged_decode_attention(q, k, v, bt, kv_len)
    torch.cuda.synchronize()
    assert sum(n for key, n in pa.LAUNCHES.items()
               if key[0] == name) == before + 1
    ref = paged_kv.ragged_decode_attention(q, k, v, bt, kv_len)
    tol = QUANT_TOLS[dtype]
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    assert got.shape == q.shape and got.dtype == dtype


@pytest.mark.parametrize("fmt,dtype,ps,D,G", QUANT_GRID)
def test_quant_ragged_paged_kernel(card, fmt, dtype, ps, D, G):
    """K4 on an int8 / fp8 pool against its plain twin on a mixed dispatch
    (decode rows, prefill rows of one slot, a clamped segment, a row with
    no visible key)."""
    from oryx_tpu_torch.ops import paged_kv
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    lengths = [1, ps, 2 * ps + 3, 150]
    q, k, v, bt = _quant_pools(card, dtype, fmt, ps=ps, D=D, G=G,
                               lengths=lengths, seed=1)
    Hq = q.shape[1]
    seg = list(range(4)) + [2] * (2 * ps + 3) + [9, 0]
    pos = [n - 1 for n in lengths] + list(range(2 * ps + 3)) + [40, -1]
    g = torch.Generator(device="cpu").manual_seed(2)
    qr = torch.randn((len(seg), Hq, D), generator=g).to(dtype).to(card)
    seg_t = torch.tensor(seg, dtype=torch.int32, device=card)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=card)
    got = pa.ragged_paged_attention(qr, k, v, bt, seg_t, pos_t)
    torch.cuda.synchronize()
    assert (f"ragged_paged_{fmt}", len(seg), 2, G, D, k.shape[0], ps,
            bt.shape[1]) in pa.LAUNCHES
    ref = paged_kv.ragged_paged_attention(qr, k, v, bt, seg_t, pos_t)
    keep = pos_t >= 0
    torch.testing.assert_close(got[keep].float(), ref[keep].float(),
                               **QUANT_TOLS[dtype])
    assert bool((got[~keep] == 0).all())


# Quantized pools: bf16 as the dense kernel; fp32 at the CPU tests' bar.
QUANT_TOLS = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2),
              torch.float32: dict(atol=2e-4, rtol=2e-3)}


def test_quant_paged_kernels_reject_what_they_do_not_take(card):
    from oryx_tpu_torch.ops import paged_kv
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    q, k, v, bt = _quant_pools(card, torch.bfloat16, "int8", ps=16, D=64,
                               G=2, lengths=[5, 9])
    n = torch.tensor([5, 9], device=card)
    dense = torch.zeros(k.shape, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="both planes"):
        pa.ragged_decode_attention(q, k, dense, bt, n)
    u8 = paged_kv.QuantPages(k.q.view(torch.uint8), k.scale, torch.bfloat16)
    with pytest.raises(ValueError, match="code dtype"):
        pa.ragged_decode_attention(q, u8, u8, bt, n)
    with pytest.raises(ValueError, match="dtype"):
        pa.ragged_decode_attention(q.half(), k, v, bt, n)
    # The bf16 kernel reads codes in 16-byte chunks: aligned planes only.
    buf = torch.zeros(k.q.numel() + 1, dtype=torch.int8, device=card)
    off = paged_kv.QuantPages(buf[1:].view(k.q.shape), k.scale,
                              torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte alignment"):
        pa.ragged_decode_attention(q, off, off, bt, n)
    bad_scale = paged_kv.QuantPages(k.q, k.scale.t().contiguous().t(),
                                    torch.bfloat16)
    with pytest.raises(ValueError, match="k_scale"):
        pa.ragged_decode_attention(q, bad_scale, v, bt, n)


# ---- K3/K4's split-KV route: layouts of the plan and the row tiles ---------

PAGED_FMTS = ["bf16", "int8", "fp8_e4m3"]


def _pools_of(fmt, dev, **kw):
    """`_pool_case` (bf16) or `_quant_pools` (int8 / fp8), bf16 compute."""
    if fmt == "bf16":
        return _pool_case(dev, torch.bfloat16, **kw)
    return _quant_pools(dev, torch.bfloat16, fmt, **kw)


def _check_paged(name, q, k, v, bt, ints, visible):
    """The kernel through its public wrapper against the plain twin
    (bf16: atol = rtol = 1e-2) on the rows that see a slot, zeros on the
    others, one LAUNCHES count a call, and two calls bitwise equal."""
    from oryx_tpu_torch.ops import paged_kv
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    kern = (pa.ragged_decode_attention if name == "paged_decode"
            else pa.ragged_paged_attention)
    plain = (paged_kv.ragged_decode_attention if name == "paged_decode"
             else paged_kv.ragged_paged_attention)
    before = sum(pa.LAUNCHES.values())
    got, again = kern(q, k, v, bt, *ints), kern(q, k, v, bt, *ints)
    torch.cuda.synchronize()
    assert sum(pa.LAUNCHES.values()) == before + 2
    assert torch.equal(got, again)
    ref = plain(q, k, v, bt, *ints)
    keep = torch.as_tensor(visible, device=q.device) > 0
    torch.testing.assert_close(got[keep].float(), ref[keep].float(),
                               atol=1e-2, rtol=1e-2)
    assert bool((got[~keep] == 0).all())


@pytest.mark.parametrize("fmt", PAGED_FMTS)
def test_paged_split_serving_layout(card, fmt):
    """K4 at the ragged engine's R = 68 dispatch (4 decode rows, 64 lanes of
    one slot at consecutive positions) and K3 / K4 decode at its R = 4, on
    the serving pool: row tiles of 64 // G = 9 rows at R = 68, one row
    otherwise, more than one split, the same split plan for both."""
    from oryx_tpu_torch.ops.cuda import measure
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    gen = torch.Generator("cuda").manual_seed(7)
    code = None if fmt == "bf16" else fmt
    for shape in ("decode", "ragged_decode", "ragged_prefill"):
        c = measure.paged_case(shape, gen, code)
        R, Hq, _ = c["q"].shape
        S, maxp = c["bt"].shape
        plan = pa.plan_of(c["kind"], R, S, 4, Hq // 4, maxp, 64,
                          pa._sm_count(card))
        assert plan["splits"] > 1
        assert plan["row_tile"] == (9 if shape == "ragged_prefill" else 1)
        _check_paged(c["kind"], c["q"], c["k"], c["v"], c["bt"], c["ints"],
                     c["visible"])
    # A row's bits do not depend on the dispatch it is packed in: the
    # decode rows of the R = 68 dispatch (row tiles of 9, beside lanes)
    # equal the same rows dispatched alone (one row a block).
    q, k, v, bt, (seg, pos) = (c[n] for n in ("q", "k", "v", "bt", "ints"))
    both = pa.ragged_paged_attention(q, k, v, bt, seg, pos)[:4]
    alone = pa.ragged_paged_attention(q[:4].contiguous(), k, v, bt, seg[:4],
                                      pos[:4])
    assert torch.equal(both, alone)


@pytest.mark.parametrize("fmt", PAGED_FMTS)
@pytest.mark.parametrize("G", [1, 7])
def test_paged_split_ranges_cross_rows(card, fmt, G):
    """K3 rows whose visible slots end on, just before and just past the
    64-slot split boundaries, a kv length 0 row (zeros), and a row that
    fills the table."""
    lengths = [0, 63, 64, 65, 127, 129, 700, 1024]
    q, k, v, bt = _pools_of(fmt, card, ps=64, D=128, G=G, lengths=lengths)
    bt = bt[:, :16].contiguous()  # exactly 1,024 slots: 16 tiles
    n = torch.tensor(lengths, dtype=torch.int32, device=card)
    _check_paged("paged_decode", q, k, v, bt, (n,), lengths)


@pytest.mark.parametrize("fmt", PAGED_FMTS)
@pytest.mark.parametrize("G,ps", [(4, 16), (7, 64)])
def test_paged_split_mixed_row_tiles(card, fmt, G, ps):
    """K4 with 30 prefill lanes of slot 1 behind 4 decode rows: row tiles of
    64 // G rows that mix decode rows and lanes, lanes straddling tile and
    split boundaries (positions 50..79), a segment past S (clamps), a row
    at position -1 (zeros) and R a multiple of no row tile."""
    lengths = [1, 80, 150, 300]
    q, k, v, bt = _pools_of(fmt, card, ps=ps, D=128, G=G, lengths=lengths,
                            seed=3)
    seg = [0, 1, 2, 3] + [1] * 30 + [7, 2]
    pos = [0, 49, 149, 299] + list(range(50, 80)) + [120, -1]
    g = torch.Generator(device="cpu").manual_seed(4)
    qr = torch.randn((len(seg), q.shape[1], 128), generator=g).to(
        q.dtype).to(card)
    ints = tuple(torch.tensor(x, dtype=torch.int32, device=card)
                 for x in (seg, pos))
    _check_paged("ragged_paged", qr, k, v, bt, ints, [p + 1 for p in pos])
    # q rows 4 elements apart from 16-byte multiples (the wrapper copies
    # them for the kernel's 16-byte reads): the same bits.
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    R, Hq, D = qr.shape
    wide = torch.zeros((R, Hq * D + 4), dtype=qr.dtype, device=card)
    wide[:, :Hq * D] = qr.reshape(R, -1)
    odd = wide[:, :Hq * D].view(R, Hq, D)
    assert odd.stride(0) % 8
    torch.testing.assert_close(pa.ragged_paged_attention(odd, k, v, bt, *ints),
                               pa.ragged_paged_attention(qr, k, v, bt, *ints),
                               atol=0, rtol=0)


def test_tiny_pipeline_on_card_matches_cpu(card):
    """The whole slice on the card (kernel path, fp32) gives the CPU
    twin's greedy replies on the same weights."""
    import dataclasses

    import numpy as np

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.serve.pipeline import Pipeline

    class Tok:
        def encode(self, text, add_special_tokens=False):
            return [min(ord(c), 500) for c in text]

        def decode(self, ids, skip_special_tokens=True):
            return "".join(chr(i) for i in ids if 0 < i < 500)

    cfg = dataclasses.replace(config.oryx_tiny(), attn_impl="pallas")
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with torch.no_grad():
        for p in params.parameters():
            if p.dim() >= 2:
                p.mul_(20)  # input-sensitive replies
    rng = np.random.default_rng(0)

    def img(h, w):
        return rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)

    reqs = [
        {"question": "hi there"},
        {"question": "what is this?", "images": [img(40, 56)]},
        {"question": "compare", "images": [img(60, 30), img(28, 28)]},
        {"question": "what happens?", "images": [img(42, 42)] * 4,
         "is_video": True},
    ]
    want = Pipeline(Tok(), params, cfg, device="cpu").chat_batch(
        reqs, max_new_tokens=8, return_token_counts=True
    )
    got = Pipeline(Tok(), params, cfg, device=card).chat_batch(
        reqs, max_new_tokens=8, return_token_counts=True
    )
    assert got == want


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_tiny_scheduler_on_card_matches_cpu(card, ragged):
    """The serving engine on the card (paged kernels, fp32) gives the CPU
    engine's replies, finish reasons and usage on the same weights."""
    import dataclasses

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    class Tok:
        def encode(self, text, add_special_tokens=False):
            return [min(ord(c), 500) for c in text]

        def decode(self, ids, skip_special_tokens=True):
            return "".join(chr(i) for i in ids if 0 < i < 500)

    cfg = dataclasses.replace(config.oryx_tiny(), attn_impl="pallas")
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with torch.no_grad():
        for p in params.parameters():
            if p.dim() >= 2:
                p.mul_(20)
    reqs = [("hi there", 9), ("what now?", 4), ("tell me more", 7)]
    out = []
    for device in ("cpu", card):
        sched = ContinuousScheduler(
            Pipeline(Tok(), params, cfg, device=device), autostart=False,
            num_slots=2, page_size=16, chunk=4, max_ctx=256, ragged=ragged,
            prefill_chunk=32 if ragged else None,
        )
        handles = [sched.submit({"question": q}, n) for q, n in reqs]
        pa.LAUNCHES.clear()
        sched.start()
        out.append([h.result(timeout=300) for h in handles])
        sched.close()
    assert out[1] == out[0]
    kind = "ragged_paged" if ragged else "paged_decode"
    assert {key[0] for key in pa.LAUNCHES} == {kind}


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_tiny_int8_scheduler_on_card_matches_cpu(card, ragged):
    """The engine over an int8 pool with the prefix cache on (look-alike
    prompts splice): the card (K3/K4 on codes, fp32 compute) gives the CPU
    engine's replies."""
    import dataclasses

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    class Tok:
        def encode(self, text, add_special_tokens=False):
            return [min(ord(c), 500) for c in text]

        def decode(self, ids, skip_special_tokens=True):
            return "".join(chr(i) for i in ids if 0 < i < 500)

    cfg = dataclasses.replace(config.oryx_tiny(), attn_impl="pallas")
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with torch.no_grad():
        for p in params.parameters():
            if p.dim() >= 2:
                p.mul_(20)
    sys_ = "You are a careful assistant. Answer briefly. "
    reqs = [(sys_ + "hi there", 9), (sys_ + "what now?", 4),
            (sys_ + "hi there", 7)]
    out, cached = [], []
    for device in ("cpu", card):
        sched = ContinuousScheduler(
            Pipeline(Tok(), params, cfg, device=device), autostart=False,
            num_slots=2, page_size=16, chunk=4, max_ctx=256, ragged=ragged,
            prefill_chunk=32 if ragged else None, kv_dtype="int8",
            host_cache_bytes=1 << 20,
        )
        handles = [sched.submit({"question": q}, n) for q, n in reqs]
        pa.LAUNCHES.clear()
        sched.start()
        out.append([h.result(timeout=300) for h in handles])
        cached.append([h.debug["cached_tokens"] for h in handles])
        sched.close()
        sched.check_pool_invariant()
    assert out[1] == out[0] and cached[1] == cached[0]
    assert sum(cached[1]) > 0
    kind = "ragged_paged_int8" if ragged else "paged_decode_int8"
    assert {key[0] for key in pa.LAUNCHES} == {kind}


# ---- the output auditor's twin (serve/audit.py) ------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_audit_twin_decode_k3_one_row(card, dtype):
    """The audit twin's decode: K3 at one row over the auditor's private
    pool (an identity block table of max_ctx / page_size pages), at
    lengths from one slot to the whole table, against its plain twin."""
    from oryx_tpu_torch.ops import paged_kv
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    P, ps, Hk, G, D = 64, 64, 4, 7, 128
    g = torch.Generator().manual_seed(0)
    k, v = (paged_kv.init_paged_pool(1, P, ps, Hk, D, dtype=dtype,
                                     device=card)[0] for _ in range(2))
    k.copy_(torch.randn(k.shape, generator=g).to(dtype))
    v.copy_(torch.randn(v.shape, generator=g).to(dtype))
    bt = torch.arange(P, dtype=torch.int32, device=card)[None]
    for n in (1, ps, ps + 1, 1153, P * ps):
        q = torch.randn((1, 1, Hk * G, D), generator=g).to(dtype).to(card)
        lens = torch.tensor([n], dtype=torch.int32, device=card)
        before = sum(c for key, c in pa.LAUNCHES.items()
                     if key[0] == "paged_decode")
        got = pa.ragged_decode_attention(q, k, v, bt, lens)
        torch.cuda.synchronize()
        assert sum(c for key, c in pa.LAUNCHES.items()
                   if key[0] == "paged_decode") == before + 1
        ref = paged_kv.ragged_decode_attention(q, k, v, bt, lens)
        tol = TOLS[dtype]
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_tiny_audited_engine_on_card(card, ragged, kv_dtype):
    """The tiny fp32 engine (its init as drawn) with every request audited
    and the numerics probe every 2 steps: replies equal to the unarmed
    engine's; no fail verdict, a dense pool only pass verdicts (the twin's
    K1 prefill and K3 / K3q decode against plain attention); the twin
    reproduces the client's bytes."""
    import dataclasses
    import time

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    class Tok:
        def encode(self, text, add_special_tokens=False):
            return [min(ord(c), 500) for c in text]

        def decode(self, ids, skip_special_tokens=True):
            return "".join(chr(i) for i in ids if 0 < i < 500)

    cfg = dataclasses.replace(config.oryx_tiny(), attn_impl="pallas")
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    pipe = Pipeline(Tok(), params, cfg, device=card)
    reqs = [("hi there", 9), ("what now?", 4), ("tell me more", 7)]
    out = []
    for kw in ({}, dict(audit_sample_every=1, numerics_every=2)):
        sched = ContinuousScheduler(
            pipe, autostart=False, num_slots=2, page_size=16, chunk=4,
            max_ctx=256, ragged=ragged, prefill_chunk=32 if ragged else None,
            kv_dtype=kv_dtype, **kw)
        handles = [sched.submit({"question": q}, n) for q, n in reqs]
        pa.LAUNCHES.clear()
        sched.start()
        out.append([h.result(timeout=300) for h in handles])
        end = time.monotonic() + 120
        while kw and (sched.auditor.pending() or sched.auditor.to_dict()[
                "total"] < len(reqs)) and time.monotonic() < end:
            time.sleep(0.02)
        d = sched.auditor.to_dict()
        samples = sched.metrics.registry.get("oryx_numerics_samples_total",
                                             raw_name=True)
        sched.close()
    assert out[1] == out[0]
    assert d["total"] == len(reqs) and d["verdicts"]["fail"] == 0
    assert all(r["first_divergence"] == -1 for r in d["records"])
    if kv_dtype == "bf16":
        assert d["verdicts"]["pass"] == len(reqs)
    assert samples >= 1
    twin = "paged_decode" + ("_int8" if kv_dtype == "int8" else "")
    assert twin in {key[0] for key in pa.LAUNCHES}


def _tiny_bf16_pipe(card):
    import dataclasses

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.serve.replay import CharTokenizer
    from oryx_tpu_torch.serve.pipeline import Pipeline

    cfg = dataclasses.replace(config.oryx_tiny(), attn_impl="pallas",
                              dtype="bfloat16")
    params = oryx.init_params(cfg, torch.Generator(card).manual_seed(0),
                              device=card, dtype=torch.bfloat16)
    return Pipeline(CharTokenizer(), params, cfg, device=card)


def test_sampled_device_time_counts_k4_on_card(card, monkeypatch):
    """profile_sample_every=1 on a tiny bf16 ragged engine: every dispatch
    is captured (CUPTI through torch.profiler); each sampled record's
    device_us is positive and within its window, and the captures' K4
    kernels (paged_split) equal the K4 wrapper's launches inside the
    captured windows; replies equal the unsampled engine's, no capture
    error."""
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler
    from oryx_tpu_torch.utils import xplane

    def k4() -> int:
        return sum(n for key, n in pa.LAUNCHES.items()
                   if key[0] == "ragged_paged")

    kernels, launched = [], []
    planes_of = xplane.planes_from_kineto

    def counting(events):
        planes = planes_of(events)
        kernels.append(sum(
            1 for p in planes if p.name.startswith("/device:GPU")
            for ln in p.lines for e in ln.events if "paged_split" in e.name))
        return planes

    pipe = _tiny_bf16_pipe(card)
    reqs = [("hi there", 9), ("what now?", 4), ("tell me more", 7)]
    out = []
    for every in (0, 1):
        sched = ContinuousScheduler(
            pipe, autostart=False, num_slots=2, page_size=16, chunk=4,
            max_ctx=256, ragged=True, prefill_chunk=32,
            profile_sample_every=every)
        if every:
            monkeypatch.setattr(xplane, "planes_from_kineto", counting)
            begin, end = sched.profiler.begin, sched.profiler.end
            mark = []

            def begin_marked():
                mark.append(k4())
                return begin()

            def end_marked(kind, t0, t1):
                launched.append(k4() - mark.pop())
                return end(kind, t0, t1)

            monkeypatch.setattr(sched.profiler, "begin", begin_marked)
            monkeypatch.setattr(sched.profiler, "end", end_marked)
        handles = [sched.submit({"question": q}, n) for q, n in reqs]
        sched.start()
        out.append([h.result(timeout=300) for h in handles])
        sched.close()
    assert out[1] == out[0]
    recs = sched.timeline.snapshot()
    assert recs and all(r["device_us"] is not None for r in recs)
    assert all(0 < r["device_us"] <= round(r["dur_s"] * 1e6) for r in recs)
    assert kernels == launched and sum(launched) > 0
    errs = sched.metrics.registry.existing(
        "oryx_profile_capture_errors_total", raw_name=True)
    assert errs is None or not any(
        c.value for c in errs.children().values())


def test_armed_unfired_faults_leave_graph_replies_equal(card):
    """Every fault site armed on a schedule that never fires: the ragged
    engine's pure-decode dispatches still replay their CUDA graphs (a
    fault point runs on the host before a replay, never inside one), and
    replies, usage and dispatch counts equal the unarmed engine's."""
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler
    from oryx_tpu_torch.utils import faults

    pipe = _tiny_bf16_pipe(card)
    reqs = [("hi there", 9), ("what now?", 4), ("tell me more", 7)]
    sites = ("engine_crash", "prefill_dispatch", "decode_dispatch",
             "page_alloc_oom", "host_spill_upload")
    out = []
    try:
        for spec in (None, ";".join(f"{s}:after=1000000" for s in sites)):
            faults.configure(spec)
            sched = ContinuousScheduler(
                pipe, autostart=False, num_slots=2, page_size=16, chunk=4,
                max_ctx=256, ragged=True, prefill_chunk=32)
            handles = [sched.submit({"question": q}, n) for q, n in reqs]
            sched.start()
            out.append(([h.result(timeout=300) for h in handles],
                        sched.metrics.by_label("dispatches_total"),
                        sched.engine_stats["graph_captures_total"]))
            sched.close()
            if spec:
                assert faults.injected_count() == 0
    finally:
        faults.reset()
    assert out[1] == out[0]
    assert out[1][2] >= 1  # the graph route ran


def test_journal_replays_on_card(card, tmp_path):
    """A journal captured from a tiny bf16 ragged engine on the card (a
    crash and supervised restart included) replays cold through
    serve/replay.run_replay on the card with no divergence."""
    from oryx_tpu_torch.serve import journal as journal_lib
    from oryx_tpu_torch.serve import replay
    from oryx_tpu_torch.serve.api_server import EngineSupervisor
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler
    from oryx_tpu_torch.utils import faults

    pipe = _tiny_bf16_pipe(card)
    path = str(tmp_path / "journal.jsonl")
    j = journal_lib.DecisionJournal(path)
    j.stamp_header(faults_spec="engine_crash:after=3")
    faults.configure("engine_crash:after=3")
    try:
        sched = ContinuousScheduler(
            pipe, autostart=False, journal=j, num_slots=2, page_size=16,
            chunk=4, max_ctx=256, ragged=True, prefill_chunk=32)
        handles = [sched.submit({"question": q}, n, request_id=f"c{i}")
                   for i, (q, n) in enumerate(
                       [("hi there", 9), ("what now?", 4),
                        ("tell me more", 7)])]
        sched.start()
        sup = EngineSupervisor(sched, poll_s=0.05)
        sup.start()
        for h in handles:
            h.result(timeout=300)
        sup.stop()
        sched.close()
    finally:
        j.close()
        faults.reset()
    header, entries = journal_lib.read_journal(path)
    assert {"fault", "restart"} <= {e["kind"] for e in entries}
    res = replay.run_replay(header, entries, pipe=pipe, timeout_s=300)
    assert replay.first_divergence(entries, res["entries"]) is None
    matched, total, _ = replay.reply_match(entries, res["entries"])
    assert matched == total == 3
    assert not (res["feed_errors"] or res["timed_out"] or res["gave_up"])


# ---- backward: K1 with lse, K5a, K5b ----------------------------------------

BWD_TOLS = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _visible(args, flags):
    _, _, _, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    vis = kv_valid[:, None, :] > 0
    if flags["causal"]:
        vis = vis & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if flags["has_segments"]:
        vis = vis & (q_seg[:, :, None] == kv_seg[:, None, :])
    return vis.any(-1)  # [B, Tq]: the row sees a key


def _check_bwd(q, k, v, kw, seed=0):
    """K1 with lse, then K5a/K5b on a cotangent zero on fully masked rows,
    against the twins; then the same through autograd. bf16 operands TMA
    cannot read as they are (a D that is no multiple of 8) go in as they
    are: the wrapper pads them."""
    slot = kw.pop("slot_positions", False)
    args, flags = fa._prepare(
        q, k, v, kw.get("q_positions"), kw.get("kv_positions"),
        kw.get("q_segment_ids"), kw.get("kv_segment_ids"),
        kw.get("kv_mask"), kw["causal"], None, slot,
    )
    keep = _visible(args, flags)
    g = torch.Generator(device=q.device).manual_seed(seed + 7)
    do = (torch.randn(q.shape, generator=g, device=q.device)
          * keep[:, :, None, None]).to(q.dtype)
    tol = BWD_TOLS[q.dtype]
    o, lse = fa._mha_forward(*args, **flags, with_lse=True)
    ro, rlse = fa._mha_forward_reference(*args, **flags, with_lse=True)
    kt = keep[:, None, :].expand(lse.shape)
    torch.testing.assert_close(lse[kt], rlse[kt], atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(o.transpose(1, 2)[keep].float(),
                               ro.transpose(1, 2)[keep].float(), atol=tol,
                               rtol=tol)
    dot = do.transpose(1, 2)
    delta = torch.einsum("bhqd,bhqd->bhq", dot.float(),
                         o.float()).contiguous()
    before = (sum(fa.LAUNCHES_DQ.values()), sum(fa.LAUNCHES_DKV.values()))
    got = fa._mha_backward(*args[:3], dot, lse, delta, *args[3:], **flags)
    torch.cuda.synchronize()
    assert (sum(fa.LAUNCHES_DQ.values()),
            sum(fa.LAUNCHES_DKV.values())) == (before[0] + 1, before[1] + 1)
    want = fa._mha_backward_reference(*args[:3], dot, lse, delta, *args[3:],
                                      **flags)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == q.dtype, name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{name}: {m}")
    # Autograd: one launch of each kernel, the launchers' gradients.
    tq, tk, tv = (x.detach().requires_grad_() for x in (q, k, v))
    n = (sum(fa.LAUNCHES_LSE.values()), sum(fa.LAUNCHES_DQ.values()),
         sum(fa.LAUNCHES_DKV.values()))
    out = fa.flash_attention(tq, tk, tv, slot_positions=slot, **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), do)
    torch.cuda.synchronize()
    assert (sum(fa.LAUNCHES_LSE.values()), sum(fa.LAUNCHES_DQ.values()),
            sum(fa.LAUNCHES_DKV.values())) == tuple(x + 1 for x in n)
    for a, b in zip(grads, got):
        assert torch.equal(a, b.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [12, 16, 72, 128])
@pytest.mark.parametrize("G", [1, 7])
def test_backward_causal_gqa_mask(card, dtype, D, G):
    _check_bwd(*_case(card, dtype, 2, 37, 130, 2 * G, 2, D, causal=True,
                      segments=False, mask=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_padded_prefill_slot_positions(card, dtype):
    """The decoder's training layout: arange on real slots, 0 on pads,
    slot_positions, a kv mask; several 64-row tiles."""
    B, T = 2, 200
    lens = torch.tensor([[200], [77]], device=card)
    live = torch.arange(T, device=card)[None] < lens
    pos = torch.where(live, torch.arange(T, device=card)[None], 0)
    q, k, v, _ = _case(card, dtype, B, T, T, 8, 2, 128, causal=False,
                       segments=False, mask=False)
    _check_bwd(q, k, v, dict(causal=True, q_positions=pos, kv_positions=pos,
                             kv_mask=live.int(), slot_positions=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [12, 72])
def test_backward_segments(card, dtype, D):
    """Random segments (fully masked rows included), self and cross."""
    _check_bwd(*_case(card, dtype, 1, 200, 200, 4, 4, D, causal=False,
                      segments=True, mask=False))
    _check_bwd(*_case(card, dtype, 1, 70, 333, 4, 4, D, causal=False,
                      segments=True, mask=True, seed=1), seed=1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_decode_rows(card, dtype):
    """Tq = 1 and Tq = 5 at late positions into a longer kv stream."""
    _check_bwd(*_case(card, dtype, 3, 1, 300, 28, 4, 128, causal=True,
                      segments=False, mask=True))
    _check_bwd(*_case(card, dtype, 2, 5, 150, 4, 2, 16, causal=True,
                      segments=False, mask=True, seed=2), seed=2)


def test_backward_is_deterministic(card):
    """No atomics: two runs give the same bits."""
    q, k, v, kw = _case(card, torch.bfloat16, 2, 130, 130, 14, 2, 128,
                        causal=True, segments=False, mask=True)
    args, flags = fa._prepare(q, k, v, kw["q_positions"], None, None, None,
                              kw["kv_mask"], True, None)
    o, lse = fa._mha_forward(*args, **flags, with_lse=True)
    do = torch.randn_like(o)
    delta = torch.einsum("bhqd,bhqd->bhq", do.float(), o.float()).contiguous()
    a = fa._mha_backward(*args[:3], do, lse, delta, *args[3:], **flags)
    b = fa._mha_backward(*args[:3], do, lse, delta, *args[3:], **flags)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _slot_case(dev, B, T, lens, Hq, Hk, D, seed=0):
    """The decoder's training layout: arange on real slots, 0 on pads,
    slot_positions, a kv mask."""
    live = torch.arange(T, device=dev)[None] < torch.tensor(
        lens, device=dev)[:, None]
    pos = torch.where(live, torch.arange(T, device=dev)[None], 0)
    q, k, v, _ = _case(dev, torch.bfloat16, B, T, T, Hq, Hk, D, causal=False,
                       segments=False, mask=False, seed=seed)
    return q, k, v, dict(causal=True, q_positions=pos, kv_positions=pos,
                         kv_mask=live.int(), slot_positions=True)


@pytest.mark.parametrize("Tq,Tk", [(1, 1), (63, 63), (65, 65), (200, 200),
                                   (2048, 2048), (63, 200), (200, 65)])
def test_backward_tile_edges(card, Tq, Tk):
    """bf16 at the edges of the 64-row cells and 128-row blocks: causal on
    random q positions with a kv mask, D = 128, G = 7."""
    _check_bwd(*_case(card, torch.bfloat16, 1, Tq, Tk, 7, 1, 128,
                      causal=True, segments=False, mask=True))


@pytest.mark.parametrize("D", [72, 128])
@pytest.mark.parametrize("G", [1, 7])
def test_backward_widths_and_groups(card, D, G):
    """Both bf16 widths the models use, with and without GQA, under every
    mask at once."""
    _check_bwd(*_case(card, torch.bfloat16, 2, 200, 333, 2 * G, 2, D,
                      causal=True, segments=True, mask=True))


def test_backward_slot_positions_padded_rows(card):
    """Padded decoder rows at the training layout, rows ending inside and at
    the edge of a 64-row cell."""
    _check_bwd(*_slot_case(card, 3, 640, [640, 333, 128], 14, 2, 128))


def test_backward_segments_straddle_tiles(card):
    """ViT-like packed images whose boundaries fall inside cells, pads
    attending pads."""
    sizes = [50, 100, 37, 129, 64]
    seg = torch.cat([torch.full((n,), i + 1) for i, n in enumerate(sizes)]
                    + [torch.zeros(20, dtype=torch.long)]).to(card)[None]
    q, k, v, _ = _case(card, torch.bfloat16, 1, seg.shape[1], seg.shape[1],
                       4, 4, 72, causal=False, segments=False, mask=False)
    _check_bwd(q, k, v, dict(causal=False, q_segment_ids=seg,
                             kv_segment_ids=seg))


def test_backward_compressor_regions(card):
    """Pooled queries against their 4 x 4-patch regions (a region's patches
    are not contiguous), pads at the end of both sides."""
    h, w = 28, 44
    reg = ((torch.arange(h)[:, None] // 4) * (w // 4)
           + torch.arange(w)[None] // 4).reshape(-1) + 1
    kv_seg = torch.cat([reg, torch.zeros(40, dtype=torch.long)])[None]
    q_seg = torch.cat([torch.arange(1, int(reg.max()) + 1),
                       torch.zeros(11, dtype=torch.long)])[None]
    q, k, v, _ = _case(card, torch.bfloat16, 1, q_seg.shape[1],
                       kv_seg.shape[1], 4, 4, 72, causal=False,
                       segments=False, mask=False)
    _check_bwd(q, k, v, dict(causal=False, q_segment_ids=q_seg.to(card),
                             kv_segment_ids=kv_seg.to(card)))


def test_backward_head_major_views(card):
    """q, k, v as strided views of head-major [B, H, T, D] storage."""
    q, k, v, kw = _case(card, torch.bfloat16, 2, 130, 200, 8, 2, 128,
                        causal=True, segments=False, mask=True)
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in (q, k, v))
    _check_bwd(q, k, v, kw)


def _witness_check(q, k, v, kw, seed=0):
    """K1-lse, K5a and K5b on bf16 q/k/v against the fp32 witness (the twins
    on the same values upcast): the relative L2 error of the output and of
    each gradient at most 1.5x the bf16 twins' (chip_smoke's NOISE_RATIO)."""
    args, flags = fa._prepare(
        q, k, v, kw.get("q_positions"), None, kw.get("q_segment_ids"),
        kw.get("kv_segment_ids"), kw.get("kv_mask"), kw["causal"], None)
    keep = _visible(args, flags)
    g = torch.Generator(device=q.device).manual_seed(seed + 11)
    do = (torch.randn(q.shape, generator=g, device=q.device)
          * keep[:, :, None, None]).to(q.dtype).transpose(1, 2)
    ints = args[3:]

    def run(fwd, bwd, qkv, d):
        o, lse = fwd(*qkv, *ints, **flags, with_lse=True)
        delta = torch.einsum("bhqd,bhqd->bhq", d.float(),
                             o.float()).contiguous()
        return (o,) + tuple(bwd(*qkv, d, lse, delta, *ints, **flags))

    got = run(fa._mha_forward, fa._mha_backward, args[:3], do)
    twin = run(fa._mha_forward_reference, fa._mha_backward_reference,
               args[:3], do)
    wit = run(fa._mha_forward_reference, fa._mha_backward_reference,
              [x.float() for x in args[:3]], do.float())
    torch.cuda.synchronize()
    rows = keep[:, None, :, None]  # the output's rows with a visible key
    for name, a, b, w in zip(("o", "dq", "dk", "dv"), got, twin, wit):
        assert a.shape == w.shape and a.dtype == q.dtype, name
        if name == "o":
            a, b, w = (x * rows for x in (a.float(), b.float(), w))
        ek = float((a.float() - w).norm() / w.norm())
        ep = float((b.float() - w).norm() / w.norm())
        assert torch.isfinite(a).all() and ek <= 1.5 * ep, (name, ek, ep)


def test_backward_rejects_layouts_tma_cannot_take(card):
    """bf16 layouts TMA cannot read as they are now run (the wrapper copies
    them into padded storage; this test asserted a ValueError before): q, k,
    v of D = 12 packed in one projection, as the tiny ViT's are, and a q
    whose base is not 16-byte aligned, each within bf16 noise of the fp32
    witness."""
    B, T, H, D = 1, 130, 2, 12
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(B, T, 3 * H * D, generator=g, device=card).to(
        torch.bfloat16)
    q, k, v = (x[..., i * H * D:(i + 1) * H * D].view(B, T, H, D)
               for i in range(3))
    pos = torch.arange(T, device=card)[None]
    _witness_check(q, k, v, dict(causal=True, q_positions=pos))
    store = torch.zeros(1 + B * T * H * 16, dtype=torch.bfloat16,
                        device=card)
    shifted = store[1:].view(B, T, H, 16)
    q16, k16, v16, _ = _case(card, torch.bfloat16, B, T, T, H, H, 16,
                             causal=True, segments=False, mask=False)
    shifted.copy_(q16)
    assert shifted.data_ptr() % 16
    _witness_check(shifted, k16, v16, dict(causal=True, q_positions=pos))


@pytest.mark.parametrize("seed", range(4))
def test_tile_flags_on_card_match_the_rules(card, seed):
    """The bf16 kernels' cell map as the card computes it equals
    `_tile_flags` (held against the dense mask by the CPU tests), for random
    positions, segments, kv masks and ragged lengths, causal or not."""
    g = torch.Generator(device=card).manual_seed(seed)
    B = 2
    Tq, Tk = (int(x) for x in torch.randint(1, 700, (2,), generator=g,
                                            device=card))
    ints = (
        torch.randint(0, Tk, (B, Tq), generator=g, device=card),
        torch.randint(0, Tk, (B, Tk), generator=g, device=card),
        torch.randint(0, 3, (B, Tq), generator=g, device=card),
        torch.randint(0, 3, (B, Tk), generator=g, device=card),
        (torch.rand((B, Tk), generator=g, device=card) < 0.9),
    )
    ints = tuple(x.int().contiguous() for x in ints)
    if seed % 2:  # slot positions over right-padded rows
        live = torch.arange(Tk, device=card)[None] < torch.tensor(
            [[Tk], [Tk // 2 + 1]], device=card)
        pos = torch.where(live, torch.arange(Tk, device=card)[None], 0).int()
        ints = (pos, pos, ints[3], ints[3], live.int())
    for causal in (False, True):
        for segs in (False, True):
            got = fa._tile_flags_cuda(*ints, causal, segs)
            assert torch.equal(got.cpu(), fa._tile_flags(
                *(x.cpu() for x in ints), causal, segs))


def test_backward_is_deterministic_at_decoder_shape(card):
    """The training decoder's call (B 4, T 2048, 28 / 4 heads, D 128, slot
    positions): two launches of each kernel give the same bits."""
    q, k, v, kw = _slot_case(card, 4, 2048, [2048, 1800, 1500, 1153], 28, 4,
                             128)
    args, flags = fa._prepare(q, k, v, kw["q_positions"],
                              kw["kv_positions"], None, None, kw["kv_mask"],
                              True, None, True)
    o, lse = fa._mha_forward(*args, **flags, with_lse=True)
    do = torch.randn_like(o)
    delta = torch.einsum("bhqd,bhqd->bhq", do.float(), o.float()).contiguous()
    a = fa._mha_backward(*args[:3], do, lse, delta, *args[3:], **flags)
    b = fa._mha_backward(*args[:3], do, lse, delta, *args[3:], **flags)
    for x, y in zip(a, b):
        assert torch.isfinite(x).all() and torch.equal(x, y)


def _tiny_host_batch():
    """One collated batch of the tiny config: two images, two text rows."""
    import numpy as np

    from oryx_tpu_torch.models import splice
    from oryx_tpu_torch.ops import packing

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8)
            for h, w in ((40, 56), (28, 42))]
    packed = packing.pack_raw_images(imgs, patch_size=14, base_grid=8,
                                     buckets=(64, 128))
    ids = [np.array([5, -200, 7, 8, 9, 10]), np.array([3, -200, 11, 12])]
    labels = [np.where(x < 0, -100, x) for x in ids]
    mm = splice.build_mm_batch(ids, splice.query_slots(packed),
                               labels=labels, buckets=(64, 128))
    host = {"patches": packed.patches, "segment_ids": packed.segment_ids,
            "pos_coords": packed.pos_coords, "region_ids": packed.region_ids,
            "q_region_ids": packed.q_region_ids, "token_ids": mm.token_ids,
            "visual_idx": mm.visual_idx, "is_visual": mm.is_visual,
            "attn_mask": mm.attn_mask, "positions": mm.positions,
            "labels": mm.labels}
    return host


def test_train_step_on_card_matches_cpu(card):
    """The tiny fp32 config, tune full, 3 steps of train_step: card
    (kernels) against CPU (plain twins)."""
    import dataclasses

    import numpy as np

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.train import step, trainer
    from oryx_tpu_torch.train.optimizer import make_optimizer

    cfg = config.oryx_tiny()
    cfg = dataclasses.replace(cfg, attn_impl="pallas", train=dataclasses.replace(
        cfg.train, tune="full", learning_rate=1e-5, num_train_steps=10,
        warmup_ratio=0.1, remat_policy="attn"))
    host = _tiny_host_batch()
    runs = {}
    for dev in ("cpu", "cuda"):
        model = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu").to(dev)
        tx = make_optimizer(cfg.train, model)
        trainer.prepare_params(model, tx.mask, torch.float32)
        state = step.init_state(model, tx)
        batch = {k: torch.from_numpy(v[None]).to(dev)
                 for k, v in host.items()}
        losses = []
        for _ in range(3):
            state, m = step.train_step(state, batch, cfg, tx)
            losses.append(m["loss"].item())
        runs[dev] = (losses, {n: p.detach().cpu()
                              for n, p in model.named_parameters()})
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for n, p in runs["cpu"][1].items():
        torch.testing.assert_close(runs["cuda"][1][n], p, atol=2e-4,
                                   rtol=2e-3)


def test_train_step_numerics_on_card_changes_no_bit(card):
    """train_step(numerics=True) on the card: the probes are finite and
    the loss, the grad norm, the params and the moments are the bits of
    numerics=False (the tiny config, bf16, the flash kernels)."""
    import dataclasses

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.train import step, trainer
    from oryx_tpu_torch.train.optimizer import make_optimizer

    base = config.oryx_tiny()
    cfg = dataclasses.replace(base, dtype="bfloat16", attn_impl="pallas",
                              train=dataclasses.replace(
                                  base.train, tune="full", num_train_steps=10,
                                  warmup_ratio=0.1, remat_policy="attn"))
    host = _tiny_host_batch()
    batch = {k: torch.from_numpy(v[None]).to(card) for k, v in host.items()}
    runs = {}
    for numerics in (False, True):
        model = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu").to(card)
        tx = make_optimizer(cfg.train, model)
        trainer.prepare_params(model, tx.mask, torch.bfloat16)
        state = step.init_state(model, tx)
        metrics = []
        for _ in range(3):
            state, m = step.train_step(state, batch, cfg, tx,
                                       numerics=numerics)
            metrics.append(m)
        runs[numerics] = (metrics, state)
    (m0, s0), (m1, s1) = runs[False], runs[True]
    for a, b in zip(m0, m1):
        for k in ("loss", "grad_norm", "num_tokens"):
            assert torch.equal(a[k], b[k]), k
        for k in ("act_absmax", "grad_absmax", "param_absmax"):
            assert b[k].device.type == "cuda"
            assert bool(torch.isfinite(b[k])) and float(b[k]) > 0, k
        assert b["grad_layer_absmax"].shape == (cfg.llm.num_layers,)
    for (n, a), (_, b) in zip(s0.params.named_parameters(),
                              s1.params.named_parameters()):
        assert torch.equal(a, b), n
    for kind in ("mu", "nu"):
        for n, x in s0.opt_state[kind].items():
            assert torch.equal(s1.opt_state[kind][n], x), n


def test_tiny_cli_on_card_matches_cpu(card, tmp_path, monkeypatch):
    """python -m oryx_tpu_torch.train.cli's main on the tiny fp32 config
    (images and a video directory as PNG files, 3 steps, telemetry and
    numerics probes armed), on the card and with --device cpu from the same
    --init-from weights: the JSONL losses and grad norms and the params
    agree, the kernels launched on the card."""
    import dataclasses
    import json

    import numpy as np

    from chip_smoke import ByteTokenizer, encode_png
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.serve import builder
    from oryx_tpu_torch.train import cli

    rng = np.random.default_rng(0)
    recs = []
    for i, (h, w) in enumerate(((40, 56), (28, 42), (56, 28))):
        (tmp_path / f"img{i}.png").write_bytes(
            encode_png(rng.integers(0, 256, (h, w, 3), np.uint8)))
        recs.append({"id": f"img{i}", "image": f"img{i}.png",
                     "conversations": [
                         {"from": "human", "value": "<image>\nWhat is it?"},
                         {"from": "gpt", "value": "A boat. " * (i + 1)}]})
    (tmp_path / "vid").mkdir()
    for f in range(4):
        (tmp_path / "vid" / f"frame_{f}.png").write_bytes(
            encode_png(rng.integers(0, 256, (28, 28, 3), np.uint8)))
    recs.append({"id": "vid", "video": "vid", "conversations": [
        {"from": "human", "value": "<image>\nWhat happens?"},
        {"from": "gpt", "value": "Gulls circle."}]})
    (tmp_path / "data.json").write_text(json.dumps(recs))
    base = config.oryx_tiny()
    cfg = dataclasses.replace(base, attn_impl="pallas",
                              train=dataclasses.replace(
                                  base.train, tune="full", learning_rate=1e-5,
                                  num_train_steps=3, warmup_ratio=0.1,
                                  global_batch_size=2, log_every=1,
                                  remat_policy="attn"))
    init = tmp_path / "init"
    builder.save_pretrained(str(init), cfg, oryx.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    monkeypatch.setattr(builder, "load_tokenizer",
                        lambda path: ByteTokenizer())
    out = {}
    for dev in ("cpu", "cuda"):
        run_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=str(tmp_path / f"ckpt_{dev}")))
        (tmp_path / f"{dev}.json").write_text(run_cfg.to_json())
        fa.LAUNCHES_DQ.clear()
        t = cli.main([
            "--config", str(tmp_path / f"{dev}.json"),
            "--data", str(tmp_path / "data.json"),
            "--media-root", str(tmp_path), "--tokenizer-path", "unused",
            "--template", "plain", "--video-frames", "4",
            "--init-from", str(init), "--metrics-port", "0",
            "--numerics-every", "1", "--device", dev,
            "--metrics-path", str(tmp_path / f"{dev}.jsonl"),
        ])
        try:
            recs_out = [json.loads(x) for x in
                        (tmp_path / f"{dev}.jsonl").read_text().splitlines()]
            out[dev] = (recs_out, {n: p.detach().cpu() for n, p in
                                   t.state.params.named_parameters()},
                        sum(fa.LAUNCHES_DQ.values()))
            assert t.telemetry.registry.get("steps_total") == 3
        finally:
            t.close()
    (rc, pc, _), (rg, pg, launched) = out["cpu"], out["cuda"]
    assert launched > 0
    assert [r["step"] for r in rg] == [r["step"] for r in rc] == [1, 2, 3]
    for k in ("loss", "grad_norm", "grad_absmax", "act_absmax"):
        np.testing.assert_allclose([r[k] for r in rg], [r[k] for r in rc],
                                   rtol=1e-4, err_msg=k)
    for n, p in pc.items():
        torch.testing.assert_close(pg[n], p, atol=2e-4, rtol=2e-3,
                                   msg=lambda m: f"{n}: {m}")


def test_tiny_bf16_fit_with_head_dim_12_on_card(card, tmp_path):
    """bf16 Trainer.fit with attn_impl="pallas" on the tiny config: the ViT
    and compressor heads are 12 wide, q/k/v views of one projection, a
    layout TMA cannot read as it is. Two steps run on the card through
    K1-lse, K5a and K5b at D = 12, with the CPU twins' losses (bf16 GEMMs
    round differently on the two devices: rtol 2e-2)."""
    import dataclasses

    import numpy as np

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.train.trainer import Trainer

    base = config.oryx_tiny()
    assert base.vision.head_dim == 12
    cfg = dataclasses.replace(
        base, dtype="bfloat16", attn_impl="pallas",
        train=dataclasses.replace(
            base.train, tune="full", learning_rate=1e-5, num_train_steps=4,
            warmup_ratio=0.1, remat_policy="attn",
            checkpoint_dir=str(tmp_path / "ckpt")))
    host = _tiny_host_batch()
    losses = {}
    for dev in ("cpu", "cuda"):
        counters = (fa.LAUNCHES_LSE, fa.LAUNCHES_DQ, fa.LAUNCHES_DKV)
        for c in counters:
            c.clear()
        model = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu").to(dev)
        t = Trainer(cfg, params=model, device=dev)
        t.fit(iter([host, host]), num_steps=2, resume=False, prefetch=0)
        losses[dev] = [h["loss"] for h in t.history]
        if dev == "cuda":
            for c in counters:
                assert sum(n for key, n in c.items() if key[-1] == 12) > 0
    assert len(losses["cuda"]) == 2 and np.isfinite(losses["cuda"]).all()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=2e-2)


# ---- LoRA and packed text on the card ---------------------------------------


def _packed_layout(dev, B, T, seed):
    """Packed training rows: samples of 5-90 tokens end to end with RoPE
    positions restarting, segment ids 1, 2, ... and pad slots (segment 0,
    no valid key) after the last sample of each row."""
    import numpy as np

    rng = np.random.default_rng(seed)
    segs = np.zeros((B, T), np.int32)
    for b in range(B):
        off, s = 0, 1
        while True:
            n = int(rng.integers(5, 90))
            if off + n > T - 10 * (b + 1):
                break
            segs[b, off:off + n] = s
            off, s = off + n, s + 1
    segs = torch.from_numpy(segs).to(dev)
    return segs, torch.arange(T, device=dev).expand(B, T)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_packed_causal_segments_pad_rows(card, dtype):
    """K1-lse, K5a and K5b at the packed decoder's mask (causal in slot
    order, segment equality, kv mask segs > 0, slot positions) against the
    twins; then through autograd with the cotangent training gives (zero
    on the pad rows, whose labels are ignored): the pad rows' dq and the
    pad keys' dk/dv are exactly zero, every gradient finite. (A pad row
    sees no key: the bf16 kernels give it zeros and lse FLT_MAX, the fp32
    kernel and the twins Pallas's mean over the masked keys.)"""
    segs, pos = _packed_layout(card, 2, 300, 0)
    g = torch.Generator(device=card).manual_seed(1)

    def rnd(*s):
        return torch.randn(s, generator=g, device=card).to(dtype)

    q, k, v = rnd(2, 300, 14, 64), rnd(2, 300, 2, 64), rnd(2, 300, 2, 64)
    kw = dict(causal=True, q_positions=pos, kv_positions=pos,
              q_segment_ids=segs, kv_segment_ids=segs,
              kv_mask=(segs > 0).to(torch.int32))
    _check_bwd(q, k, v, dict(kw, slot_positions=True))
    tq, tk, tv = (x.detach().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, slot_positions=True, **kw)
    pad = segs == 0
    do = rnd(*q.shape) * (~pad)[:, :, None, None]
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), do)
    assert int(pad.sum()) > 0
    for x in (dq, dk, dv):
        assert bool(torch.isfinite(x).all())
    assert not bool(dq[pad].any())
    assert not bool(dk[pad].any()) and not bool(dv[pad].any())
    assert bool(dq[~pad].any())


def _fit_card_vs_cpu(cfg, batches, steps=3):
    """Trainer.fit of `cfg` (tiny, fp32) from the same init on the CPU and
    on the card: (losses by device, params by device, K5 launches on the
    card)."""
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.train.trainer import Trainer

    out, launched = {}, 0
    for dev in ("cpu", "cuda"):
        fa.LAUNCHES_DQ.clear()
        model = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        if cfg.train.lora.enable:
            oryx.enable_lora(model, cfg, torch.Generator().manual_seed(1))
            g = torch.Generator().manual_seed(2)
            with torch.no_grad():
                for n, p in model.named_parameters():
                    if n.endswith("lora_b"):
                        p.normal_(0.0, 0.05, generator=g)
        t = Trainer(cfg, params=model.to(dev), device=dev)
        t.fit(iter(batches), num_steps=steps, resume=False, prefetch=0)
        out[dev] = ([h["loss"] for h in t.history],
                    {n: p.detach().cpu()
                     for n, p in t.state.params.named_parameters()})
        if dev == "cuda":
            launched = sum(fa.LAUNCHES_DQ.values())
    return out, launched


def _tiny_train_cfg(tmp_path, tune="lora"):
    import dataclasses

    from oryx_tpu_torch import config

    base = config.oryx_tiny()
    return dataclasses.replace(base, attn_impl="pallas", train=dataclasses.replace(
        base.train, tune=tune, learning_rate=1e-5, num_train_steps=10,
        warmup_ratio=0.1, remat_policy="attn_o",
        checkpoint_dir=str(tmp_path / "ckpt"),
        lora=config.LoraConfig(enable=True, r=4, alpha=8.0, targets=(
            "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
            "down_proj"))))


def _assert_fits_agree(out, launched):
    import numpy as np

    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for n, p in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][n], p, atol=2e-4,
                                   rtol=2e-3, msg=lambda m: f"{n}: {m}")
    assert launched > 0


def test_tiny_lora_fit_on_card_matches_cpu(card, tmp_path):
    """tune='lora' (r = 4 on all seven projections, remat "attn_o"), 3
    steps of Trainer.fit: card (kernels) against CPU (twins)."""
    host = _tiny_host_batch()
    _assert_fits_agree(*_fit_card_vs_cpu(_tiny_train_cfg(tmp_path),
                                         [host] * 3))


def test_tiny_packed_fit_on_card_matches_cpu(card, tmp_path):
    """Packed text (collate_packed_text, two 64-wide rows and a pad row)
    under the LoRA config, 3 steps: card against CPU."""
    import numpy as np

    from oryx_tpu_torch.train import data

    rng = np.random.default_rng(0)
    exs = []
    for n in (30, 21, 17, 40, 9):
        ids = rng.integers(3, 500, size=n)
        labels = np.where(np.arange(n) >= n // 2, ids, -100)
        exs.append(data.Example(ids, labels, [], "image", 1))
    host = data.collate_packed_text(exs, bucket=64, num_rows=3, base_grid=8,
                                    buckets=(64, 128))
    assert int((host["text_segment_ids"].max(1) > 0).sum()) == 2
    _assert_fits_agree(*_fit_card_vs_cpu(_tiny_train_cfg(tmp_path),
                                         [host] * 3))


# ---- the dense decode loop as CUDA graphs; K1 at the prefix-reuse shapes ---


def _tiny_model(dev, dtype):
    """The tiny config (pallas, `dtype` compute) with input-sensitive x20
    weights on `dev`: (OryxModel, OryxConfig)."""
    import dataclasses

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx

    cfg = dataclasses.replace(
        config.oryx_tiny(), attn_impl="pallas",
        dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with torch.no_grad():
        for p in params.parameters():
            if p.dim() >= 2:
                p.mul_(20)
    return params.to(device=dev, dtype=dtype), cfg


def _eager_generate(llm, cfg, gen_cfg, embeds, lengths, max_new, cache_len,
                    seed, kv_cache=None, start=None):
    """The eager witness: generate's prefill, then `_decode_while` with no
    graph (each chunk's steps launched one by one)."""
    from oryx_tpu_torch.models import generate as gen_lib
    from oryx_tpu_torch.models import qwen2

    dt = embeds.dtype
    gen = torch.Generator(device=embeds.device).manual_seed(seed)
    with torch.inference_mode():
        cache = (qwen2.init_kv_cache(cfg, embeds.shape[0], cache_len,
                                     dtype=dt, device=embeds.device)
                 if kv_cache is None
                 else {n: x.clone() for n, x in kv_cache.items()})
        carry = gen_lib._prefill_carry(
            llm, cfg, gen_cfg, embeds, lengths, gen, cache=cache,
            start=start, attn_impl="pallas", compute_dtype=dt, stop_L=0)
        step = gen_lib._make_decode_step(
            llm, cfg, gen_cfg, None, cache_len=cache_len,
            attn_impl="pallas", compute_dtype=dt, generator=gen)
        carry, toks, fin, _ = gen_lib._decode_while(
            step, carry, max_new, gen_cfg.eos_token_id)
    return toks, carry[0]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_decode_graphs_match_the_eager_loop(card, temperature):
    """bf16 tiny decode: generate's graph replays (21 steps: two replays of
    8 and a last chunk of 5 run eagerly) give the eager loop's tokens,
    greedy and sampled from the same seed; the graph is reused by the next
    call, whose launches are counted per replay (layers x steps decode
    launches, none for the capture)."""
    import dataclasses

    from oryx_tpu_torch.models import generate as gen_lib

    model, cfg = _tiny_model(card, torch.bfloat16)
    llm = model.llm
    gen_cfg = dataclasses.replace(cfg.generation, temperature=temperature)
    g = torch.Generator(device=card).manual_seed(1)
    embeds = torch.randn(3, 20, cfg.llm.hidden_size, generator=g,
                         device=card).to(torch.bfloat16)
    lengths = torch.tensor([20, 13, 6], dtype=torch.int32, device=card)
    kw = dict(max_new_tokens=21, cache_len=256, attn_impl="pallas",
              compute_dtype=torch.bfloat16)

    def run(seed, timings=None):
        return gen_lib.generate(
            llm, cfg.llm, gen_cfg, inputs_embeds=embeds, lengths=lengths,
            generator=torch.Generator(device=card).manual_seed(seed),
            timings=timings, **kw)[0]

    first = run(5)
    fa.LAUNCHES_DECODE.clear()
    timings = {}
    again = run(5, timings)
    assert timings["capture_s"] == 0.0 and timings["decode_steps"] == 21
    assert sum(fa.LAUNCHES_DECODE.values()) == cfg.llm.num_layers * 21
    want, _ = _eager_generate(llm, cfg.llm, gen_cfg, embeds, lengths, 21,
                              256, 5)
    assert torch.equal(first, again) and torch.equal(first, want)
    if temperature:
        assert not torch.equal(run(6), first)


def test_stream_equals_generate_and_prefix_reuse_on_card(card):
    """Sampled at 0.7: generate_stream's blocks (one replay each) joined
    are generate's tokens, and a suffix prefilled at start = 45 into a
    returned cache decodes as the eager witness does."""
    import dataclasses

    import numpy as np

    from oryx_tpu_torch.models import generate as gen_lib

    model, cfg = _tiny_model(card, torch.bfloat16)
    llm = model.llm
    gen_cfg = dataclasses.replace(cfg.generation, temperature=0.7)
    g = torch.Generator(device=card).manual_seed(2)
    embeds = torch.randn(1, 70, cfg.llm.hidden_size, generator=g,
                         device=card).to(torch.bfloat16)
    common = dict(attn_impl="pallas", compute_dtype=torch.bfloat16)

    def gen(seed):
        return torch.Generator(device=card).manual_seed(seed)

    lengths = torch.tensor([45], dtype=torch.int32, device=card)
    toks, _, _, cache = gen_lib.generate(
        llm, cfg.llm, gen_cfg, inputs_embeds=embeds[:, :45],
        lengths=lengths, max_new_tokens=24, cache_len=256, generator=gen(3),
        return_cache=True, **common)
    blocks = list(gen_lib.generate_stream(
        llm, cfg.llm, gen_cfg, inputs_embeds=embeds[:, :45],
        lengths=lengths, max_new_tokens=24, cache_len=256, generator=gen(3),
        chunk=8, **common))
    assert [b.shape for b in blocks] == [(1, 8)] * 3
    np.testing.assert_array_equal(np.concatenate(blocks, 1),
                                  toks.cpu().numpy())
    assert len({tuple(b[0]) for b in blocks}) == 3

    suffix = torch.zeros(1, 32, cfg.llm.hidden_size, dtype=torch.bfloat16,
                         device=card)
    suffix[:, :25] = embeds[:, 45:]
    full = torch.tensor([70], dtype=torch.int32, device=card)
    got = gen_lib.generate(
        llm, cfg.llm, gen_cfg, inputs_embeds=suffix, lengths=full,
        max_new_tokens=13, cache_len=256, generator=gen(4), kv_cache=cache,
        start=45, **common)[0]
    want, _ = _eager_generate(llm, cfg.llm, gen_cfg, suffix, full, 13, 256,
                              4, kv_cache=cache, start=45)
    assert torch.equal(got, want)


def test_interleaved_streams_hold_graphs_of_their_own(card):
    """Two generate_stream generators of one key alive at once each hold a
    decode graph of their own: interleaved block by block, each gives the
    tokens it gives alone."""
    import numpy as np

    from oryx_tpu_torch.models import generate as gen_lib

    model, cfg = _tiny_model(card, torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(4)
    prompts = [torch.randn(1, 16, cfg.llm.hidden_size, generator=g,
                           device=card).to(torch.bfloat16) for _ in range(2)]
    lengths = torch.tensor([16], dtype=torch.int32, device=card)

    def stream(e):
        return gen_lib.generate_stream(
            model.llm, cfg.llm, cfg.generation, inputs_embeds=e,
            lengths=lengths, max_new_tokens=16, cache_len=256, chunk=4,
            attn_impl="pallas", compute_dtype=torch.bfloat16)

    alone = [np.concatenate(list(stream(e)), 1) for e in prompts]
    assert not np.array_equal(alone[0], alone[1])
    a, b = (stream(e) for e in prompts)
    got = [[], []]
    for _ in range(4):
        got[0].append(next(a))
        got[1].append(next(b))
    for blocks, want in zip(got, alone):
        np.testing.assert_array_equal(np.concatenate(blocks, 1), want)


def test_counted_graph_counts_each_replay(card):
    """K1 decode calls captured in a CountedGraph count nothing at capture
    and one launch per call per replay, and the replays give the eager
    call's bits."""
    from oryx_tpu_torch.ops.cuda import graphs

    q, k, v, kw = _decode_case(card, 2, 300, 2, 7, 128, [299, 130])
    want = fa.flash_attention(q, k, v, **kw)  # builds the kernel
    before = sum(fa.LAUNCHES.values()), sum(fa.LAUNCHES_DECODE.values())
    graph = graphs.CountedGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with graph.capture(stream):
        out = [fa.flash_attention(q, k, v, **kw) for _ in range(3)]
    assert (sum(fa.LAUNCHES.values()),
            sum(fa.LAUNCHES_DECODE.values())) == before
    for n in (1, 2):
        graph.replay()
        assert sum(fa.LAUNCHES.values()) == before[0] + 3 * n
        assert sum(fa.LAUNCHES_DECODE.values()) == before[1] + 3 * n
    torch.cuda.synchronize()
    for o in out:
        assert torch.equal(o, want)


def test_graph_replays_draw_a_new_stream_each(card):
    """sample_token captured with a registered generator: two replays draw
    different tokens from near-uniform logits, and together they are the
    eager draws of 16 steps from the same seed (an unregistered generator
    would replay one Philox offset)."""
    from oryx_tpu_torch.models.generate import sample_token
    from oryx_tpu_torch.ops.cuda import graphs

    logits = torch.randn(4, 1000, device=card) * 0.01
    kw = dict(temperature=0.7, top_p=1.0, top_k=0)
    eager_gen = torch.Generator(device=card).manual_seed(9)
    want = torch.stack([sample_token(logits, eager_gen, **kw)
                        for _ in range(16)])
    gen = torch.Generator(device=card)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        sample_token(logits, gen, **kw)
    graph = graphs.CountedGraph()
    with graph.capture(stream, [gen]):
        out = torch.stack([sample_token(logits, gen, **kw)
                           for _ in range(8)])
    gen.set_state(torch.Generator(device=card).manual_seed(9).get_state())
    draws = []
    for _ in range(2):
        graph.replay()
        draws.append(out.clone())
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(torch.cat(draws), want)


@pytest.mark.parametrize("start,n,k", [(1153, 30, 0), (1200, 0, 4)],
                         ids=["suffix_prefill", "score"])
def test_k1_at_prefix_reuse_shapes(card, start, n, k):
    """K1's wgmma body at the two new call shapes: a 256-row suffix bucket
    with q positions from `start` (not a multiple of 64) over a
    2,048-slot cache masked at start + n (suffix prefill), or at
    start + k (an option of k tokens teacher-forced after the prompt)."""
    g = torch.Generator(device=card).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=card).to(
            torch.bfloat16)

    S, Tq = 2048, 256
    pos = (start + torch.arange(Tq, device=card))[None]
    mask = (torch.arange(S, device=card)[None] < start + n + k).int()
    decode = sum(fa.LAUNCHES_DECODE.values())
    _check(rnd(1, Tq, 28, 128), rnd(1, S, 4, 128), rnd(1, S, 4, 128),
           dict(causal=True, q_positions=pos, kv_mask=mask))
    assert sum(fa.LAUNCHES_DECODE.values()) == decode


def test_tiny_sessions_on_card_match_cpu(card):
    """fp32 tiny sessions on the card (graph route) and on the CPU: a
    three-turn cached ChatSession over an image, a streamed turn and
    score_options give the same replies, deltas and scores."""
    import numpy as np

    from oryx_tpu_torch.serve.pipeline import ChatSession, Pipeline

    class Tok:
        def encode(self, text, add_special_tokens=False):
            return [min(ord(c), 500) for c in text]

        def decode(self, ids, skip_special_tokens=True):
            return "".join(chr(i) for i in ids if 0 < i < 500)

    img = np.random.default_rng(7).integers(0, 255, size=(30, 44, 3),
                                            dtype=np.uint8)
    out = {}
    for dev in ("cpu", "cuda"):
        model, cfg = _tiny_model("cpu", torch.float32)
        pipe = Pipeline(Tok(), model, cfg, device=dev)
        s = ChatSession(pipe, images=[img])
        replies = [s.ask(q, max_new_tokens=6)
                   for q in ("what is this?", "why?")]
        replies.append("".join(s.ask_stream("sure?", max_new_tokens=6)))
        out[dev] = (replies, pipe.score_options("pick", ["cat", "dog"]))
    assert out["cuda"][0] == out["cpu"][0]
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=1e-3)


# ---- the paged engine's pure-decode step as CUDA graphs ---------------------


class _CharTok:
    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


_ENGINE_REQS = [("hi there", 40), ("what is going on with all of this", 48),
                ("tell me more", 32)]


def _engine_run(card, *, eager, kv_dtype="bf16", sampling=None,
                reqs=_ENGINE_REQS, sched_out=None, **kw):
    """The tiny bf16 ragged engine on the card, on the graph route or the
    eager witness: (results, metrics, K4 launches)."""
    from oryx_tpu_torch.ops.cuda import graphs
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    model, cfg = _tiny_model(card, torch.bfloat16)
    sched = ContinuousScheduler(
        Pipeline(_CharTok(), model, cfg, device=card), autostart=False,
        num_slots=2, page_size=16, chunk=4, max_ctx=256, ragged=True,
        prefill_chunk=16, kv_dtype=kv_dtype, **kw)
    handles = [sched.submit({"question": q}, n, sampling) for q, n in reqs]
    pa.LAUNCHES.clear()
    sched.start()
    try:
        with graphs.routes(not eager):
            out = [h.result(timeout=300) for h in handles]
    finally:
        if sched_out is None:
            sched.close()
    if sched_out is not None:
        sched_out.append(sched)
    sched.check_pool_invariant()
    stats = dict(sched.engine_stats,
                 dispatches_total=sched.metrics.by_label("dispatches_total"))
    return out, stats, sum(pa.LAUNCHES.values())


def _neural(cfg_vocab=512):
    from oryx_tpu_torch.models.generate import NeuralDrafter

    return NeuralDrafter.init(cfg_vocab, 8, window=8, seed=0)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("kind", ["k1", "fused4", "fused_spec"])
def test_engine_graphs_match_the_eager_witness(card, kind, kv_dtype):
    """Pure-decode ragged dispatches replay one captured logical step (K
    times for a megastep): the replies equal the eager witness's in the
    same bf16 run, and the K4 launches replayed are the eager route's plus
    the one eager warm-up step of each capture (layers x its iterations)."""
    from oryx_tpu_torch.config import oryx_tiny

    kw = {"k1": {}, "fused4": dict(fuse_steps=4),
          "fused_spec": dict(speculate=3, fuse_steps=4)}[kind]
    if kind == "fused_spec":
        kw["drafter"] = _neural(oryx_tiny().llm.vocab_size)
    got, m, launches = _engine_run(card, eager=False, kv_dtype=kv_dtype, **kw)
    want, me, eager = _engine_run(card, eager=True, kv_dtype=kv_dtype, **kw)
    assert got == want
    assert me["graph_captures_total"] == 0
    assert m["graph_captures_total"] >= 1
    iters = 1 if kind == "fused_spec" else 4
    layers = oryx_tiny().llm.num_layers
    assert launches == eager + m["graph_captures_total"] * layers * iters
    if kind != "k1":
        assert sum(m["megasteps_total"].values()) > 0
        assert m["megasteps_total"] == me["megasteps_total"]
    assert m["dispatches_total"] == me["dispatches_total"]


def test_engine_graph_sampled_stream(card):
    """A sampled slot on the graph route draws the eager witness's numbers
    (its generator is copied into the graph's registered one and back), so
    its tokens equal the witness's; consecutive replays draw new numbers,
    so the chunks of its stream differ."""
    sampling = {"temperature": 1.5, "seed": 5}
    reqs = [("hi there", 24)]
    kw = dict(fuse_steps=4, reqs=reqs, sampling=sampling)
    got, m, _ = _engine_run(card, eager=False, **kw)
    want, _, _ = _engine_run(card, eager=True, **kw)
    assert got == want
    assert sum(m["megasteps_total"].values()) > 0
    toks = [ord(c) for c in got[0][0]]
    assert len(toks) >= 12 and toks[:4] != toks[4:8] != toks[8:12]
    other, _, _ = _engine_run(card, eager=False, reqs=reqs,
                              sampling={"temperature": 1.5, "seed": 6})
    assert other != got


def test_engine_reset_pool_drops_the_graphs(card):
    """The graphs are captured on the pool in place: `_reset_pool` drops
    them, and the next pure-decode dispatch captures anew on the new pool
    and serves what the eager witness serves."""
    held = []
    _engine_run(card, eager=False, sched_out=held, reqs=_ENGINE_REQS[:1])
    sched = held[0]
    assert len(sched._graphs) == 1
    sched._reset_pool()
    assert not sched._graphs
    h = sched.submit({"question": "tell me more"}, 12)
    got = h.result(timeout=300)
    assert len(sched._graphs) == 1
    assert sched.engine_stats["graph_captures_total"] == 2
    sched.close()
    want, _, _ = _engine_run(card, eager=True, reqs=[("tell me more", 12)])
    assert [got] == want


def test_engine_failed_capture_raises(card, monkeypatch):
    """A capture that fails (a host sync inside the captured step) errors
    the dispatch's requests out; nothing falls back to the eager route."""
    from oryx_tpu_torch.models import generate as gen_lib

    real = gen_lib.paged_fused_steps

    def syncing(*args, **kw):
        args[4].sum().item()  # tok: a host read, refused under capture
        return real(*args, **kw)

    monkeypatch.setattr(gen_lib, "paged_fused_steps", syncing)
    with pytest.raises(RuntimeError):
        _engine_run(card, eager=False, reqs=[("hi there", 12)])
    torch.cuda.synchronize()
    monkeypatch.setattr(gen_lib, "paged_fused_steps", real)
    got, _, _ = _engine_run(card, eager=False, reqs=[("hi there", 12)])
    want, _, _ = _engine_run(card, eager=True, reqs=[("hi there", 12)])
    assert got == want


# ---- the int8-weight product (csrc/q8_linear.cu) ---------------------------


Q8_ROWS = [1, 4, 20, 64, 65, 68, 128, 129, 516, 2048]


@pytest.mark.parametrize("K,N", [(3584, 512), (3584, 3584), (18944, 3584),
                                 (72, 100), (130, 37), (80, 48)])
@pytest.mark.parametrize("M", Q8_ROWS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_q8_kernel_matches_twin(card, K, N, M, dtype):
    """Decoder shapes and tails (K, N not multiples of 16; K a multiple of
    16 but not of the 64-column k block) on every route (bf16 up to 64
    rows: the cp.async ring with the cluster merge; past 64: wgmma; fp32:
    the SIMT routes): within tolerance of the twin, one launch, the same
    bits twice, and a row's bits the same at other row counts of its
    route."""
    from oryx_tpu_torch.ops.cuda import measure
    from oryx_tpu_torch.ops.cuda import q8_linear as q8

    kw = measure.q8_case(K, (N,), M, N % 2 == 0, torch.Generator(
        card).manual_seed(K + N + M), dtype)
    before = sum(q8.LAUNCHES.values())
    q8.q8_linear(kw["x"], *kw["members"][0])
    assert sum(q8.LAUNCHES.values()) == before + 1
    r = measure.q8_compare(kw, TOLS[dtype], TOLS[dtype])
    assert r["within"] and r["finite"], r
    assert r["same_bits"] and r["rows_independent"], r


@pytest.mark.parametrize("K,N", [(3584, 152064), (72, 100), (130, 37),
                                 (80, 48)])
@pytest.mark.parametrize("M", [1, 4, 20, 68, 516])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_q8_kernel_column_scale_matches_twin(card, K, N, M, dtype):
    """The tied head: the int8 table's codes [V, H] with one scale per
    column (oryx_7b's V and H, and tails), as for the per-channel scales,
    on both routes of each dtype."""
    from oryx_tpu_torch.ops.cuda import measure

    kw = measure.q8_case(K, (N,), M, False, torch.Generator(card).manual_seed(
        K + N + M), dtype, column_scale=True)
    r = measure.q8_compare(kw, TOLS[dtype], TOLS[dtype])
    assert r["within"] and r["finite"], r
    assert r["same_bits"] and r["rows_independent"], r


@pytest.mark.parametrize("K,Ns", [(3584, (3584, 512, 512)),
                                  (3584, (18944, 18944)), (130, (37, 20)),
                                  (72, (100, 48, 16, 8))])
@pytest.mark.parametrize("M", [1, 4, 20, 68, 516])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_q8_grouped_equals_separate_launches(card, K, Ns, M, dtype):
    """A grouped launch (q/k/v, gate/up, tails, four members) is one
    launch, and gives each member the bits of its own launch."""
    from oryx_tpu_torch.ops.cuda import measure
    from oryx_tpu_torch.ops.cuda import q8_linear as q8

    kw = measure.q8_case(K, Ns, M, True, torch.Generator(card).manual_seed(
        K + M), dtype)
    x = kw["x"][:, None]  # a leading shape of two dims
    before = sum(q8.LAUNCHES.values())
    got = q8.q8_linear_group(x, kw["members"])
    assert sum(q8.LAUNCHES.values()) == before + 1
    for y, (q, s, b) in zip(got, kw["members"]):
        assert y.shape == (M, 1, q.shape[0])
        assert torch.equal(y, q8.q8_linear(x, q, s, b))


@pytest.mark.parametrize("M", [4, 516])
def test_q8_kernel_in_a_graph_equals_eager(card, M):
    """A replay of the captured kernel (the cluster merge included) gives
    the eager bits on both bf16 routes, and CountedGraph counts each
    replay's launch."""
    from oryx_tpu_torch.ops.cuda import graphs, measure
    from oryx_tpu_torch.ops.cuda import q8_linear as q8

    kw = measure.q8_case(3584, (3584, 512, 512), M, True,
                         torch.Generator(card).manual_seed(0))
    eager = q8.q8_linear_group(kw["x"], kw["members"])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = graphs.CountedGraph()
    with torch.cuda.stream(stream):
        with graph.capture(stream):
            out = q8.q8_linear_group(kw["x"], kw["members"])
    torch.cuda.current_stream().wait_stream(stream)
    before = sum(q8.LAUNCHES.values())
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, eager))
    assert sum(q8.LAUNCHES.values()) == before + 2


def test_q8_kernel_rejects_operands_it_does_not_take(card):
    from oryx_tpu_torch.ops.cuda import q8_linear as q8

    x = torch.randn(4, 64, device=card, dtype=torch.bfloat16)
    q = torch.zeros(32, 64, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="scale"):
        q8.q8_linear(x, q, torch.ones(32, device=card, dtype=torch.float16))
    with pytest.raises(ValueError, match="x must be"):
        q8.q8_linear(x.half(), q, torch.ones(32, device=card))
    with pytest.raises(ValueError, match="x must be"):
        q8.q8_linear(x[:, :48], q, torch.ones(32, device=card))


def _tiny_int8(dev, tied=False, dtype=torch.float32):
    """The tiny config widened so its large weights quantize
    (tests/test_quant.py's `_quantizable_cfg`), x20 weights, int8 on `dev`,
    `dtype` compute (the other floats cast to it), the head tied to the
    embedding table if `tied`: (OryxModel, OryxConfig)."""
    import dataclasses

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.utils.quant import quantize_params

    t = config.oryx_tiny()
    cfg = dataclasses.replace(
        t, attn_impl="pallas",
        dtype="bfloat16" if dtype == torch.bfloat16 else "float32",
        llm=dataclasses.replace(
            t.llm, vocab_size=1024, hidden_size=128, intermediate_size=512,
            num_heads=8, head_dim=16, tie_word_embeddings=tied))
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with torch.no_grad():
        for p in params.parameters():
            if p.dim() >= 2:
                p.mul_(20)
    return quantize_params(params, cast=lambda t: t.to(dtype) if (
        t.is_floating_point()) else t).to(dev), cfg


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_tiny_int8_engines_on_card_match_cpu(card, ragged):
    """fp32 int8-weight engines (and a dense chat) on the card, the q8
    kernels taking every product, and on the CPU (the twins): the same
    replies."""
    from oryx_tpu_torch.ops.cuda import q8_linear as q8
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    out = {}
    for dev in ("cpu", "cuda"):
        model, cfg = _tiny_int8(dev)
        pipe = Pipeline(_CharTok(), model, cfg, device=dev)
        sched = ContinuousScheduler(
            pipe, autostart=False, num_slots=2, page_size=16, chunk=4,
            max_ctx=256, ragged=ragged,
            prefill_chunk=16 if ragged else None)
        q8.LAUNCHES.clear()
        handles = [sched.submit({"question": q}, n) for q, n in _ENGINE_REQS]
        sched.start()
        try:
            served = [h.result(timeout=300) for h in handles]
        finally:
            sched.close()
        out[dev] = (served, pipe.chat("hello there", max_new_tokens=8),
                    sum(q8.LAUNCHES.values()))
    assert out["cuda"][:2] == out["cpu"][:2]
    assert out["cuda"][2] > 0 and out["cpu"][2] == 0


def test_tiny_tied_int8_on_card_matches_cpu(card):
    """A tied int8 head (the Q8Embedding table as the head) runs through
    the q8 kernel with its per-column scales on the card, and the ragged
    engine and a dense chat give the CPU's replies."""
    from oryx_tpu_torch.ops.cuda import q8_linear as q8
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    out = {}
    for dev in ("cpu", "cuda"):
        model, cfg = _tiny_int8(dev, tied=True)
        pipe = Pipeline(_CharTok(), model, cfg, device=dev)
        sched = ContinuousScheduler(
            pipe, autostart=False, num_slots=2, page_size=16, chunk=4,
            max_ctx=256, ragged=True, prefill_chunk=16)
        q8.LAUNCHES.clear()
        handles = [sched.submit({"question": q}, n) for q, n in _ENGINE_REQS]
        sched.start()
        try:
            served = [h.result(timeout=300) for h in handles]
        finally:
            sched.close()
        out[dev] = (served, pipe.chat("hello there", max_new_tokens=8),
                    dict(q8.LAUNCHES))
    assert out["cuda"][:2] == out["cpu"][:2]
    V, H = cfg.llm.vocab_size, cfg.llm.hidden_size
    assert any(key[1:3] == (V, H) for key in out["cuda"][2])
    assert not out["cpu"][2]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_int8_prefill_and_large_dispatch_never_take_the_twin(
        card, monkeypatch, dtype):
    """With the plain twin made to raise on a card tensor, an int8
    `chat_batch` (an image, a prefill of more than 128 rows) and a ragged
    engine dispatch of more than 128 rows run on the card: every product,
    the ViT's and the prefill's included, takes a kernel."""
    import numpy as np

    from oryx_tpu_torch.ops.cuda import q8_linear as q8
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    real = q8.q8_linear_reference

    def guarded(x, *args, **kw):
        if x.device.type == "cuda":
            raise AssertionError("q8_linear_reference reached on the card")
        return real(x, *args, **kw)

    monkeypatch.setattr(q8, "q8_linear_reference", guarded)
    model, cfg = _tiny_int8(card, dtype=dtype)
    pipe = Pipeline(_CharTok(), model, cfg, device=card)
    img = np.random.default_rng(0).integers(0, 255, (40, 56, 3), np.uint8)
    long_q = "tell me about the picture and all of its colours " * 4
    q8.LAUNCHES.clear()
    out = pipe.chat_batch([{"question": long_q, "images": [img]},
                           {"question": "hi"}], max_new_tokens=4)
    assert len(out) == 2
    assert max(k[0] for k in q8.LAUNCHES) > 128, dict(q8.LAUNCHES)
    sched = ContinuousScheduler(
        pipe, autostart=False, num_slots=2, page_size=16, chunk=4,
        max_ctx=512, ragged=True, prefill_chunk=640)
    q8.LAUNCHES.clear()
    handles = [sched.submit({"question": long_q}, 6),
               sched.submit({"question": "hello"}, 6)]
    sched.start()
    try:
        served = [h.result(timeout=300) for h in handles]
    finally:
        sched.close()
    assert len(served) == 2
    assert any(k[0] > 128 for k in q8.LAUNCHES), dict(q8.LAUNCHES)


def test_graph_dropped_during_a_capture_waits_for_its_end(card):
    """A graph whose last reference goes while this thread captures another
    (a collection of garbage that held it) is reset after that capture,
    not during it: the capture succeeds and replays."""
    import gc

    from oryx_tpu_torch.ops.cuda import graphs

    x = torch.zeros(8, device=card)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())

    class Holder:
        pass

    old = Holder()
    old.me, old.graph = old, graphs.CountedGraph()  # a cycle: only gc frees it
    with torch.cuda.stream(stream):
        with old.graph.capture(stream):
            x.add_(1)
        new = graphs.CountedGraph()
        with new.capture(stream):
            del old
            gc.collect()
            x.add_(2)
    torch.cuda.current_stream().wait_stream(stream)
    new.replay()
    torch.cuda.synchronize()
    assert torch.equal(x, torch.full_like(x, 2.0))


def test_engine_close_releases_its_graphs(card, monkeypatch):
    """close() resets the engine's captured steps itself, so no collection
    frees them later, perhaps while another engine captures."""
    from oryx_tpu_torch.ops.cuda import graphs

    released = []
    real = graphs.CountedGraph.release

    def counting(self):
        released.append(self)
        real(self)

    monkeypatch.setattr(graphs.CountedGraph, "release", counting)
    sched = []
    _engine_run(card, eager=False, reqs=[("hi there", 12)], sched_out=sched)
    assert sched[0]._graphs and not released
    n = len(sched[0]._graphs)
    sched[0].close()
    assert len(released) == n and not sched[0]._graphs



def _http(base, path, body=None):
    import json
    import urllib.request

    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read().decode()


@pytest.mark.parametrize("engine", ["window", "split", "ragged"])
def test_server_on_card_matches_cpu(card, engine):
    """The tiny fp32 server on the card (its kernels) answers a text, a PNG
    image and a streamed request as the same server on the CPU (the plain
    twins) does, and its /metrics shows the card's memory."""
    import json
    import re
    import threading

    import numpy as np
    from chip_smoke import png_data_uri

    from oryx_tpu_torch.serve import api_server
    from oryx_tpu_torch.serve.pipeline import Pipeline

    kw = {"window": dict(engine="window"),
          "split": dict(engine="continuous", num_slots=2, page_size=16,
                        decode_chunk=4, max_ctx=256),
          "ragged": dict(engine="continuous", num_slots=2, page_size=16,
                         decode_chunk=4, max_ctx=256, ragged=True,
                         prefill_chunk=16)}[engine]
    img = np.random.default_rng(0).integers(0, 256, (40, 56, 3),
                                            dtype=np.uint8)
    bodies = [
        {"messages": [{"role": "user", "content": "hello there"}],
         "max_tokens": 12},
        {"messages": [{"role": "user", "content": [
            {"type": "text", "text": "what is this?"},
            {"type": "image_url", "image_url": {"url": png_data_uri(img)}}]}],
         "max_tokens": 8},
        {"messages": [{"role": "user", "content": "tell me more"}],
         "max_tokens": 10, "stream": True},
    ]
    out = {}
    for dev in (card, torch.device("cpu")):
        model, cfg = _tiny_model(dev, torch.float32)
        srv = api_server.build_server(
            Pipeline(_CharTok(), model, cfg, device=dev), port=0, **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            replies = []
            for b in bodies:
                text = _http(base, "/v1/chat/completions", b)
                if b.get("stream"):
                    chunks = [json.loads(ln[6:]) for ln in text.split("\n\n")
                              if ln.startswith("data: {")]
                    replies.append("".join(
                        c["choices"][0]["delta"].get("content", "")
                        for c in chunks if c["choices"]))
                else:
                    d = json.loads(text)
                    replies.append((d["choices"][0], d["usage"]))
            out[dev.type] = replies
            if dev.type == "cuda":
                metrics = _http(base, "/metrics")
                for g in ("hbm_live_bytes", "hbm_bytes_in_use",
                          "hbm_peak_bytes", "hbm_limit_bytes"):
                    v = re.search(rf"^oryx_serving_{g} (\S+)$", metrics,
                                  re.M)
                    assert v and float(v.group(1)) > 0, g
        finally:
            if srv.scheduler is not None:
                srv.scheduler.close()
                srv.supervisor.stop()
            srv.shutdown()
            srv.server_close()
    assert out["cuda"] == out["cpu"]


def test_router_on_card_two_replicas(card):
    """Two tiny fp32 ragged replicas over one model on the card behind the
    prefix-affinity router, the lock-order sanitizer and race detector
    armed and the capture watchdog counting: both engines capture their
    engine-step graph at once (one capture a replica) while r0 samples the
    device time of every dispatch (its profiler sessions start and stop
    beside r1's capture, and its windows close on its own stream), replies
    through the router equal the direct replies and the same fleet's on
    the CPU, a shared-prefix burst lands on one replica, no violation."""
    import json
    import threading

    from oryx_tpu_torch.analysis import sanitizers
    from oryx_tpu_torch.serve import api_server
    from oryx_tpu_torch.serve import router as router_lib
    from oryx_tpu_torch.serve.pipeline import Pipeline

    kw = dict(engine="continuous", num_slots=2, page_size=16, decode_chunk=4,
              max_ctx=256, ragged=True, prefill_chunk=16)
    sys_prompt = "You are a careful assistant who counts boats. " * 2
    bodies = [{"messages": [{"role": "system", "content": sys_prompt},
                            {"role": "user", "content": f"question {i}?"}],
               "max_tokens": 10} for i in range(3)]

    def profiled(s):
        """(device-time captures, capture errors) of a replica."""
        reg = s.scheduler.metrics.registry
        errs = reg.existing("oryx_profile_capture_errors_total",
                            raw_name=True)
        return (reg.get("oryx_profile_captures_total", raw_name=True),
                sum(c.value for c in errs.children().values()) if errs else 0)

    def fleet(dev):
        model, cfg = _tiny_model(dev, torch.float32)
        reps = [api_server.build_server(
            Pipeline(_CharTok(), model, cfg, device=dev), port=0,
            replica_id=f"r{i}", profile_sample_every=1 - i, **kw)
            for i in range(2)]
        rsrv = router_lib.build_router(
            [(f"r{i}", f"http://127.0.0.1:{s.server_address[1]}")
             for i, s in enumerate(reps)], port=0, probe=False)
        for s in (*reps, rsrv):
            threading.Thread(target=s.serve_forever, daemon=True).start()
        bases = [f"http://127.0.0.1:{s.server_address[1]}"
                 for s in (*reps, rsrv)]
        try:
            warm = [None, None]

            def one(i):
                warm[i] = _http(bases[i], "/v1/chat/completions",
                                {"messages": [{"role": "user",
                                               "content": "warm up"}],
                                 "max_tokens": 12})

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            out = [json.loads(_http(bases[2], "/v1/chat/completions", b))
                   for b in bodies]
            direct = [json.loads(_http(bases[1], "/v1/chat/completions", b))
                      for b in bodies]
            snap = json.loads(_http(bases[2], "/debug/replicas"))
            return ([(o["choices"][0]["message"]["content"],
                      o["usage"]) for o in out],
                    [(d["choices"][0]["message"]["content"], d["usage"])
                     for d in direct],
                    [json.loads(w)["choices"][0]["message"]["content"]
                     for w in warm], snap,
                    [s.scheduler.graph_owner for s in reps],
                    [s.scheduler.engine_stats["graph_captures_total"]
                     for s in reps],
                    [profiled(s) for s in reps])
        finally:
            rsrv.shutdown()
            rsrv.server_close()
            for s in reps:
                s.scheduler.close()
                if s.supervisor is not None:
                    s.supervisor.stop()
                s.shutdown()
                s.server_close()

    sanitizers.arm_lock_sanitizer(action="record")
    try:
        with sanitizers.recompile_watchdog(budget=1, action="record") as caps:
            on_card = fleet(card)
        stats = sanitizers.lock_stats()
        assert stats.violations == [] and sanitizers.race_violations() == []
        assert stats.acquires["router._lock"] > 0
    finally:
        sanitizers.disarm_lock_sanitizer()
    on_cpu = fleet(torch.device("cpu"))
    replies, direct, warm, snap, owners, graphs, profiled = on_card
    assert replies == direct == on_cpu[0] and warm[0] == warm[1]
    assert graphs == [1, 1] and on_cpu[5] == [0, 0]
    assert profiled[0][0] > 0 and profiled[0][1] == 0
    assert profiled[1] == (0, 0)
    assert sorted(caps.counts.values()) == [1, 1]
    assert {k.split("/")[0] for k in caps.counts} == set(owners)
    assert all(r["healthy"] for r in snap["replicas"].values())


def test_tp_two_ranks_share_the_card(card):
    """`--shard tp=2` on one card: this process rank 0, rank 1 started by
    parse_shard_arg, both over gloo (NCCL refuses two ranks on one card).
    The tiny fp32 model at one KV head a rank: chat_batch and the sharded
    engines (split bf16 pool, ragged int8 pool) give the one-process
    pipeline's replies on the same card, and both ranks sampled the same
    tokens."""
    import dataclasses

    import numpy as np

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.parallel import mesh as mesh_lib
    from oryx_tpu_torch.parallel import tp as tp_lib
    from oryx_tpu_torch.serve.engine import create_engine
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from torch_tp_common import GEOM, CharTokenizer

    cfg = dataclasses.replace(config.oryx_tiny(), attn_impl="pallas")
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with torch.no_grad():
        for p in params.parameters():
            if p.dim() >= 2:
                p.mul_(20)
    img = np.random.default_rng(0).integers(0, 255, size=(40, 56, 3),
                                            dtype=np.uint8)
    reqs = [{"question": "hi there"},
            {"question": "what is this?", "images": [img]}]
    texts = [("hello there", 12), ("hello there friend", 12)]

    def serve(pipe, engine, **kw):
        sched = create_engine(engine, pipe, autostart=False, **GEOM, **kw)
        hs = [sched.submit({"question": q}, n) for q, n in texts]
        sched.start()
        try:
            return [h.result(timeout=300)[0] for h in hs]
        finally:
            sched.close()

    one = Pipeline(CharTokenizer(), params, cfg, device=card)
    want = (one.chat_batch(reqs, max_new_tokens=8),
            serve(one, "continuous"),
            serve(one, "continuous", ragged=True, prefill_chunk=16,
                  kv_dtype="int8"))
    mesh, _ = mesh_lib.parse_shard_arg("tp=2")
    world = tp_lib.current()
    try:
        assert world.backend == "gloo"
        tpipe = Pipeline(CharTokenizer(), params, cfg, device=card,
                         mesh=mesh)
        got = (tpipe.chat_batch(reqs, max_new_tokens=8),
               serve(tpipe, "sharded"),
               serve(tpipe, "sharded", ragged=True, prefill_chunk=16,
                     kv_dtype="int8"))
        assert got == want
        assert len(set(world.digests())) == 1
    finally:
        world.shutdown()
