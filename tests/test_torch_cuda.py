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
