"""The int8-weight product's launch plans and grouped twin
(`oryx_tpu_torch/ops/cuda/q8_linear.py`), on the CPU.

The plans (`plan`, `plan_blocks`, `split_plan`) are host numbers that the
CUDA kernels follow block for block: on the byte-bound route the splits
times their k blocks cover every k block of every channel tile once, on
the large routes the tiles cover [M, N] once, and the k-block order of a
product depends on K alone (so a row's bits do not depend on M, the group
or the tile). The grouped product's plain twin is the separate twins, bit
for bit, and JAX's `x @ Q8Weight.astype(x.dtype)` within fp32 tolerance
(atol 2e-4, rtol 2e-3: fp32 on both sides, sums in another order). On a
CPU tensor `q8_linear` takes the twin at any row count.
"""

import collections
import ctypes
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu.utils import quant as jquant  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.ops.cuda import q8_linear as q8  # noqa: E402
from oryx_tpu_torch.utils import quant as tquant  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3


def _launches(llm):
    """{name: (K, output widths)} of an int8 decoder step's launches."""
    H, Dq = llm.hidden_size, llm.num_heads * llm.head_dim
    Dkv, I = llm.num_kv_heads * llm.head_dim, llm.intermediate_size
    return {"qkv": (H, (Dq, Dkv, Dkv)), "q": (H, (Dq,)), "kv": (H, (Dkv,)),
            "o": (Dq, (H,)), "gate_up": (H, (I, I)), "down": (I, (H,)),
            "lm_head": (H, (llm.vocab_size,))}


SHAPES = dict(_launches(tcfg.oryx_7b().llm))
SHAPES.update({"vit_qkv": (1152, (1152,) * 3), "vit_fc2": (4304, (1152,)),
               "patch_embed": (588, (1152,)), "tail": (130, (37, 20)),
               "tail_k72": (72, (100,)), "tail_k80": (80, (48,))})
ROWS = (1, 4, 20, 64, 65, 68, 129, 516, 2048)


def _check_cover(p, Ns, K, M):
    """Every (member, channel, row, k block) is computed by exactly one
    block, no block is empty, and each (tile, row tile)'s splits run in k
    order."""
    nkb = -(-K // q8.KB)
    seen = collections.defaultdict(lambda: collections.defaultdict(list))
    for i, n0, n1, m0, m1, kb0, kb1 in q8.plan_blocks(p, Ns, K, M):
        assert n0 < n1 <= Ns[i] and m0 < m1 <= M and kb0 < kb1 <= nkb
        seen[(i, n0, n1)][(m0, m1)].append((kb0, kb1))

    def contiguous(spans, end):
        return (spans[0][0] == 0 and spans[-1][1] == end and all(
            a[1] == b[0] for a, b in zip(spans, spans[1:])))

    for i, N in enumerate(Ns):
        assert contiguous(sorted((a, b) for j, a, b in seen if j == i), N)
    for rows in seen.values():
        assert contiguous(sorted(rows), M)
        assert all(contiguous(ks, nkb) for ks in rows.values())


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
def test_plan_blocks_cover_each_output_and_k_block_once(name, bf16):
    K, Ns = SHAPES[name]
    for M in ROWS:
        p = q8.plan(K, M, bf16)
        _check_cover(p, Ns, K, M)
        assert p.route == q8.route_of(M, bf16)
        lo, hi = q8.route_rows(p.route)
        assert lo <= M and (hi is None or M <= hi)
        small = M <= q8.SMALL_ROWS
        assert (p.rows >= M) if small else p.rows == 0
        assert p.splits in (1, 2, 4, 8)
        if p.route == q8.BF16_SMALL:
            assert p.tile == q8.SMALL_TILE


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("route", [q8.BF16_SMALL, q8.BF16_LARGE,
                                   q8.BF16_WIDE])
def test_k_order_depends_on_K_and_route_alone(name, route):
    """Splits and k blocks a split are those of `split_plan(K, route)` at
    every M of the route (the output widths do not enter the plan); each
    split keeps the route's MIN_KB_PER_SPLIT blocks and none is empty."""
    K, Ns = SHAPES[name]
    want = q8.split_plan(K, route)
    nkb = -(-K // q8.KB)
    splits, kps = want
    assert (splits - 1) * kps < nkb <= splits * kps
    assert splits == 1 or nkb // splits >= q8.MIN_KB_PER_SPLIT[route]
    lo, hi = q8.route_rows(route)
    for M in [m for m in ROWS + (256, 257) if lo <= m and (
            hi is None or m <= hi)]:
        p = q8.plan(K, M, True)
        assert p.route == route and (p.splits, p.kps) == want


def test_oryx_7b_decoder_splits():
    """The splits the decoder's products take: at decode K = 3584 in 8
    ranges of 7 k blocks, the down projection's K = 18944 in 8 of 37; on
    the wgmma route up to 256 rows 4 of 14 and 8 of 37; past 256 rows one
    range, and two of 148 for the down projection."""
    S, L, W = q8.BF16_SMALL, q8.BF16_LARGE, q8.BF16_WIDE
    assert q8.split_plan(3584, S) == (8, 7)
    assert q8.split_plan(18944, S) == (8, 37)
    assert q8.split_plan(3584, L) == (4, 14)
    assert q8.split_plan(18944, L) == (8, 37)
    assert q8.split_plan(3584, W) == (1, 56)
    assert q8.split_plan(18944, W) == (2, 148)
    assert q8.split_plan(1152, L) == (2, 9)
    assert q8.split_plan(128, S) == (1, 2)


def test_route_boundaries_are_constants():
    for M in (1, 64):
        assert q8.plan(3584, M, True).route == q8.BF16_SMALL
        assert q8.plan(3584, M, False).route == q8.F32_SMALL
    for M in (65, 256):
        assert q8.plan(3584, M, True).route == q8.BF16_LARGE
    for M in (257, 10_000):
        assert q8.plan(3584, M, True).route == q8.BF16_WIDE
    for M in (65, 10_000):
        assert q8.plan(3584, M, False).route == q8.F32_LARGE


def test_weights_struct_layout():
    """`_Weights` mirrors csrc/q8_linear.cu's OryxQ8Weights: three arrays
    of MAXG pointers, MAXG ints, four ints, no padding."""
    p, i = ctypes.sizeof(ctypes.c_void_p), ctypes.sizeof(ctypes.c_int)
    assert ctypes.sizeof(q8._Weights) == 3 * q8.MAXG * p + (q8.MAXG + 4) * i
    assert q8._Weights.n.offset == 3 * q8.MAXG * p
    assert q8._Weights.aligned.offset == 3 * q8.MAXG * p + (q8.MAXG + 3) * i


def _members(rng, K, Ns, bias=True):
    ws = [jnp.asarray(rng.standard_normal((K, N)) * 0.05, jnp.float32)
          for N in Ns]
    bs = [rng.standard_normal(N).astype(np.float32) for N in Ns]
    qws = [jquant.quantize_array(w) for w in ws]
    members = [(torch.from_numpy(np.asarray(qw.q).T.copy()),
                torch.from_numpy(np.asarray(qw.scale)[0].copy()),
                torch.from_numpy(b) if bias else None)
               for qw, b in zip(qws, bs)]
    return qws, bs, members


@pytest.mark.parametrize("M", [1, 4, 65, 130])
@pytest.mark.parametrize("Ns", [(100, 20, 20), (37, 48)])
def test_group_twin_equals_separate_twins_and_jax(M, Ns):
    rng = np.random.default_rng(M + sum(Ns))
    K = 72
    qws, bs, members = _members(rng, K, Ns)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xt = torch.from_numpy(x)
    got = q8.q8_linear_group(xt, members)
    for (q, s, b), qw, bb, y in zip(members, qws, bs, got):
        assert torch.equal(y, q8.q8_linear_reference(xt, q, s, b))
        assert torch.equal(y, q8.q8_linear(xt, q, s, b))
        with jax.default_matmul_precision("highest"):
            want = np.asarray(jnp.asarray(x) @ qw.astype(jnp.float32) + bb)
        np.testing.assert_allclose(y.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("M", [1, 64, 65, 129, 300])
def test_cpu_tensor_of_any_M_takes_the_twin(M, monkeypatch):
    """No kernel path is reached from a CPU tensor, at any row count and
    leading shape, grouped or not."""
    def no_kernel(*a, **k):
        raise AssertionError("the kernel path was reached from the CPU")

    monkeypatch.setattr(q8, "_launch", no_kernel)
    rng = np.random.default_rng(M)
    _, _, members = _members(rng, 80, (48, 16))
    x = torch.from_numpy(rng.standard_normal((M, 2, 80)).astype(np.float32))
    q, s, b = members[0]
    want = q8.q8_linear_reference(x, q, s, b)
    assert want.shape == (M, 2, 48)
    assert torch.equal(q8.q8_linear(x, q, s, b), want)
    assert torch.equal(q8.q8_linear_group(x, members)[0], want)
    assert torch.equal(
        q8.q8_linear(x.bfloat16(), q, s, b),
        q8.q8_linear_reference(x.bfloat16(), q, s, b))


def test_linear_group_equals_linear():
    """`quant.linear_group` gives each module's `linear` output: Q8Linears
    of one width through the grouped product, float layers and mixed
    groups one by one."""
    torch.manual_seed(0)
    fl = [torch.nn.Linear(64, n) for n in (32, 16, 16)]
    ql = [tquant.quantize_params(torch.nn.ModuleDict({"m": m}))["m"]
          for m in (torch.nn.Linear(64, 96 * 1024), torch.nn.Linear(
              64, 1024, bias=False))]
    assert all(isinstance(m, tquant.Q8Linear) for m in ql)
    x = torch.randn(3, 5, 64)
    for mods in (fl, ql, [fl[0], ql[1]]):
        got = tquant.linear_group(x, mods)
        assert len(got) == len(mods)
        for y, m in zip(got, mods):
            assert torch.equal(y, tquant.linear(x, m))


def test_prepared_operands_are_checked_and_dropped_with_the_codes():
    """`_prepare` checks dtype, shape and contiguity once, hands back the
    same preparation for the same tensors, and forgets it when the codes
    go."""
    q = torch.zeros(32, 64, dtype=torch.int8)
    s = torch.ones(32)
    with pytest.raises(ValueError, match="scale"):
        q8._prepare(((q, s.half(), None),), False)
    with pytest.raises(ValueError, match="q must be"):
        q8._prepare(((q.t(), s, None),), False)
    with pytest.raises(ValueError, match="bias"):
        q8._prepare(((q, s, torch.ones(31)),), False)
    with pytest.raises(ValueError, match="products a launch"):
        q8._prepare(((q, s, None),) * (q8.MAXG + 1), False)
    a = q8._prepare(((q, s, None),), False)
    assert q8._prepare(((q, s, None),), False) is a
    assert (a.Ns, a.N, a.K, a.aligned) == ((32,), 32, 64, 1)
    n = len(q8._PREPARED)
    del a, q
    gc.collect()
    assert len(q8._PREPARED) == n - 1
