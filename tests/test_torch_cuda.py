"""The hand-written CUDA flash-attention kernel against its plain twin, on
an NVIDIA GPU (skipped without one). Small and odd shapes the path test in
chip_smoke.py does not reach: D of 12, 16, 72 and 128, Tq = 1, ragged
tiles, GQA groups of 7, strided views, both dtypes.

Run on a machine with a card (the repository's conftest needs jax, which
that machine may lack):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: bf16 outputs atol = rtol = 1e-2; fp32 outputs 1e-4 (fp32 FMA
sums in another order than the twin's matmul).
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
