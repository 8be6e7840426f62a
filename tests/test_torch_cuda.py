"""The hand-written CUDA flash-attention kernels against their plain twins,
on an NVIDIA GPU (skipped without one). Small and odd shapes the path test
in chip_smoke.py does not reach: D of 12, 16, 72 and 128, Tq = 1, ragged
tiles, GQA groups of 7, strided views, both dtypes; the forward K1 with and
without its logsumexp, the backward K5a (dq) and K5b (dk/dv), and autograd
through `flash_attention`.

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
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert sum(fa.LAUNCHES.values()) == before + 1
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
    against the twins; then the same through autograd."""
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


def test_train_step_on_card_matches_cpu(card):
    """The tiny fp32 config, tune full, 3 steps of train_step: card
    (kernels) against CPU (plain twins)."""
    import dataclasses

    import numpy as np

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.ops import packing
    from oryx_tpu_torch.models import splice
    from oryx_tpu_torch.train import step, trainer
    from oryx_tpu_torch.train.optimizer import make_optimizer

    cfg = config.oryx_tiny()
    cfg = dataclasses.replace(cfg, attn_impl="pallas", train=dataclasses.replace(
        cfg.train, tune="full", learning_rate=1e-5, num_train_steps=10,
        warmup_ratio=0.1, remat_policy="attn"))
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
