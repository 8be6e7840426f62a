"""The split-KV schedule of the paged-attention kernels K3/K4
(`csrc/paged_attention.cu`, bf16 route) on the CPU.

`_paged_plan` must cut the table's 64-slot tiles into ranges that cover
every tile exactly once. `schedule_model` is the kernel's schedule in plain
PyTorch, over the plain twins' math (the dequantizing `gather_pages`, fp32
logits): row tiles of `_row_tile` rows (one a tile for the leading decode
rows of a dispatch with prefill lanes), one walk per distinct segment of a
tile over each split's fixed slot range, clipped at the largest visible end
among the tile's rows of that segment, p = 0 for another segment's rows and
for slots past a row's position, fp32 partials (m, l, acc) per split, and
their merge in split order over the non-empty ones. It is held against the
Pallas kernels in interpret mode (`oryx_tpu.ops.pallas.paged_attention`)
on dense, int8 and fp8-e4m3 pools at atol 2e-4, rtol 2e-3 (fp32
throughout; the sums run in another order than Pallas's page walk).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu.ops import paged_kv as jpk  # noqa: E402
from oryx_tpu.ops.pallas import paged_attention as jppa  # noqa: E402
from oryx_tpu_torch.ops import paged_kv as tpk  # noqa: E402
from oryx_tpu_torch.ops.cuda import paged_attention as tpa  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3
NEG = -0.7 * float(np.finfo(np.float32).max)
TILE = tpa.TILE


def _ranges(splits, tps, nk):
    return [(s * tps, min((s + 1) * tps, nk)) for s in range(splits)]


# ---- the plan -------------------------------------------------------------


@pytest.mark.parametrize("sm_count", [1, 8, 132])
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("Hk", [1, 4, 8])
def test_plan_covers_every_tile_once(Hk, ps, sm_count):
    for S in (1, 4, 5, 68, 300):
        for maxp in (1, 3, 64, 257):
            splits, tps = tpa._paged_plan(S, Hk, maxp, ps, sm_count)
            nk = -(-maxp * ps // TILE)
            assert 1 <= splits <= tpa.MAX_SPLITS and tps >= 1
            seen = [t for a, b in _ranges(splits, tps, nk)
                    for t in range(a, b)]
            assert seen == list(range(nk))
            assert (splits - 1) * tps < nk  # no split past the end
            want = tpa.BLOCKS_PER_SM * sm_count
            assert Hk * S * splits >= min(want, Hk * S * nk) or tps > 1


def test_row_tile_and_plan_of_the_serving_shapes():
    """K3 and a K4 decode dispatch take one row a block; the R = 68
    dispatch (4 decode rows + 64 lanes) one a tile for the 4 decode rows
    and row tiles of 64 // G (at most 64 (row, q head) pairs) for the
    lanes; all three cut the 4,096-slot table alike, in more than one range
    on 132 SMs."""
    assert tpa._row_tile(4, 4, 7, decode=True) == 1
    assert tpa._row_tile(4, 4, 7, decode=False) == 1
    assert tpa._row_tile(68, 68, 7, decode=False) == 1
    for G in range(1, tpa.GMAX + 1):
        rt = tpa._row_tile(68, 4, G, decode=False)
        assert rt == 64 // G and rt * G <= tpa.A_ROWS
    plans = [tpa.plan_of(name, R, 4, 4, 7, 64, 64, 132) for name, R in (
        ("paged_decode", 4), ("ragged_paged", 4), ("ragged_paged", 68))]
    assert [p["row_tile"] for p in plans] == [1, 1, 9]
    assert [p["lead"] for p in plans] == [0, 0, 4]
    assert [p["row_tiles"] for p in plans] == [4, 4, 4 + 8]
    assert len({(p["splits"], p["tps"]) for p in plans}) == 1
    assert plans[0]["splits"] > 1 and plans[0]["splits"] * plans[0]["tps"] >= 64


# ---- the schedule model ---------------------------------------------------


def schedule_model(q, k_pages, v_pages, bt, seg, lens, *, row_tile, lead,
                   splits, tps, scale):
    """o [R, Hq, D] of the bf16 kernel's schedule, in the pages' dtype
    (fp32 here), for rows of table row seg[r] seeing slots < lens[r]
    (already clamped: seg into [0, S - 1], lens into [0, width]), the
    first `lead` rows one a row tile and the rest `row_tile` a tile. Also
    returns the number of 64-slot K/V tiles the blocks load."""
    R, Hq, D = q.shape
    Hk = k_pages.shape[2]
    G = Hq // Hk
    K = tpk.gather_pages(k_pages, bt)  # [S, width, Hk, D]
    V = tpk.gather_pages(v_pages, bt)
    width = K.shape[1]
    o = torch.zeros_like(q)
    loads = 0
    tiles = [[r] for r in range(lead)] + [
        list(range(r0, min(R, r0 + row_tile)))
        for r0 in range(lead, R, row_tile)]
    for rows in tiles:
        n = len(rows)
        # One pass per distinct segment with a visible slot, in row order,
        # to the largest visible end among the tile's rows of it.
        ends: dict[int, int] = {}
        for r in rows:
            if lens[r] > 0:
                ends[seg[r]] = max(ends.get(seg[r], 0), lens[r])
        qt = q[rows].reshape(n, Hk, G, D)
        rseg = torch.tensor([seg[r] for r in rows])[:, None]
        rlen = torch.tensor([lens[r] for r in rows])[:, None]
        parts = []
        for s in range(splits):
            m = torch.full((n, Hk, G), NEG)
            l = torch.zeros((n, Hk, G))
            acc = torch.zeros((n, Hk, G, D))
            for sg, end in ends.items():
                for tile in range(s * tps, min((s + 1) * tps, -(-end // TILE))):
                    loads += 1
                    sl = torch.arange(TILE * tile, TILE * (tile + 1))
                    inside = (sl < end)[:, None, None]  # zero past the end
                    at = sl.clamp(max=width - 1)
                    kt = torch.where(inside, K[sg, at], 0.0)  # [64, Hk, D]
                    vt = torch.where(inside, V[sg, at], 0.0)
                    logits = torch.einsum("rhgd,jhd->rhgj", qt, kt) * scale
                    vis = ((rseg == sg) & (sl[None] < rlen))[:, None, None]
                    x = torch.where(vis, logits, NEG)
                    m_new = torch.maximum(m, x.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.where(vis, torch.exp(x - m_new[..., None]), 0.0)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "rhgj,jhd->rhgd", p, vt)
                    m = m_new
            parts.append((torch.where(l > 0, m, NEG), l, acc))
        M = torch.full((n, Hk, G), NEG)
        for m, l, _ in parts:
            M = torch.where(l > 0, torch.maximum(M, m), M)
        L = torch.zeros((n, Hk, G))
        A = torch.zeros((n, Hk, G, D))
        for m, l, acc in parts:  # split order; empty partials skipped
            w = torch.where(l > 0, torch.exp(m - M), 0.0)
            L = L + l * w
            A = A + acc * w[..., None]
        o[rows] = (A / torch.where(L == 0, 1.0, L)[..., None]).reshape(
            n, Hq, D)
    return o, loads


def _pools(rng, fmt, P, ps, Hk, D):
    """(jax plane, torch plane) pairs for K and V: random fp32 pages, or
    random int8 / fp8-e4m3 codes (every finite e4m3 pattern) and per-row
    scales."""
    out = []
    for _ in range(2):
        if fmt == "bf16":  # the dense pool, in fp32 here
            x = rng.standard_normal((P, ps, Hk, D)).astype(np.float32)
            out.append((jnp.asarray(x), torch.from_numpy(x)))
            continue
        b = rng.integers(0, 256, (P, ps, Hk, D), dtype=np.uint8)
        if fmt == "fp8_e4m3":
            b[(b & 0x7F) == 0x7F] -= 1  # no NaN pattern
        sc = rng.uniform(0.01, 0.1, (P, ps)).astype(np.float32)
        jdt = jnp.int8 if fmt == "int8" else jnp.float8_e4m3fn
        tdt = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
        jq = jax.lax.bitcast_convert_type(jnp.asarray(b), jdt)
        tq = torch.from_numpy(b).view(tdt)
        out.append((jpk.QuantPages(jq, jnp.asarray(sc)),
                    tpk.QuantPages(tq, torch.from_numpy(sc))))
    return out


def _tables(rng, lens, ps, maxp, P):
    """Distinct random pages for each slot's `lens` slots, the sentinel P
    past them."""
    perm = list(rng.permutation(P))
    bt = np.full((len(lens), maxp), P, np.int32)
    for s, n in enumerate(lens):
        for j in range(-(-n // ps)):
            bt[s, j] = perm.pop()
    return bt


FMTS = ["bf16", "int8", "fp8_e4m3"]
GRID = [(fmt, G, ps) for fmt in FMTS for G in (1, 4, 7) for ps in (16, 64)]


@pytest.mark.parametrize("fmt,G,ps", GRID)
def test_ragged_schedule_matches_pallas(fmt, G, ps):
    """K4: decode rows of four slots, then 13 prefill lanes of slot 2 at
    positions 55..67 (straddling the 64-slot tile boundary), a segment
    past S (clamps to 3), a row at position -1 (no visible slot: zeros);
    R = 19 is a multiple of no row tile (9 at G = 7, 16 at G = 4), the
    last tile mixes lanes with rows of other segments, and slot 3's table
    holds a sentinel inside its visible range. The table is two 64-slot
    tiles wider than every row's reach, so the last splits see nothing.
    The schedule is run with the wrapper's tiling (one a tile for the 4
    decode rows) and with row tiles from row 0 (decode rows and lanes in
    one tile)."""
    rng = np.random.default_rng(10 * G + ps)
    Hk, D = 2, 16
    maxp = 256 // ps
    slot_lens = [1, 64, 68, 71]
    P = sum(-(-n // ps) for n in slot_lens) + 2
    bt = _tables(rng, slot_lens, ps, maxp, P)
    bt[3, 1] = P  # a sentinel the row reads (clamped to page P - 1)
    seg = np.array([0, 1, 2, 3] + [2] * 13 + [9, 0], np.int32)
    pos = np.array([0, 63, 54, 70] + list(range(55, 68)) + [30, -1],
                   np.int32)
    R, S = len(seg), len(slot_lens)
    q = rng.standard_normal((R, Hk * G, D)).astype(np.float32)
    (jk, tk), (jv, tv) = _pools(rng, fmt, P, ps, Hk, D)
    kern = np.asarray(jppa.ragged_paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(seg),
        jnp.asarray(pos), interpret=True))
    width = maxp * ps
    segc = [min(max(int(s), 0), S - 1) for s in seg]
    lens = [max(0, min(int(p) + 1, width)) for p in pos]
    rt = tpa._row_tile(R, S, G, decode=False)
    assert rt == 64 // G and (R % rt or R < rt)
    for sm_count, lead in ((132, S), (1, S), (132, 0)):
        splits, tps = tpa._paged_plan(S, Hk, maxp, ps, sm_count)
        got, loads = schedule_model(
            torch.from_numpy(q), tk, tv, torch.from_numpy(bt), segc, lens,
            row_tile=rt, lead=lead, splits=splits, tps=tps, scale=D ** -0.5)
        np.testing.assert_allclose(got.numpy(), kern, atol=ATOL, rtol=RTOL)
        assert not got[-1].any()  # the row with no visible slot
        if sm_count > 1 and lead:  # the last split is past every row's end
            assert splits > 1 and (splits - 1) * tps * TILE >= max(lens)
    # One walk per segment: the lanes' tiles are loaded once per row tile,
    # not once a row as with one row a block.
    _, loads_one = schedule_model(
        torch.from_numpy(q), tk, tv, torch.from_numpy(bt), segc, lens,
        row_tile=1, lead=0, splits=splits, tps=tps, scale=D ** -0.5)
    assert loads < loads_one


@pytest.mark.parametrize("fmt,G,ps", GRID)
def test_decode_schedule_matches_pallas(fmt, G, ps):
    """K3: rows of 0 (zeros), 1, 64 and 65 slots (a split boundary at one
    tile a split) and 130, over a table two tiles wider than the longest."""
    rng = np.random.default_rng(100 + 10 * G + ps)
    Hk, D = 2, 16
    lengths = [0, 1, 64, 65, 130]
    maxp = 256 // ps
    P = sum(-(-n // ps) for n in lengths) + 2
    bt = _tables(rng, lengths, ps, maxp, P)
    R = len(lengths)
    q = rng.standard_normal((R, 1, Hk * G, D)).astype(np.float32)
    (jk, tk), (jv, tv) = _pools(rng, fmt, P, ps, Hk, D)
    kern = np.asarray(jppa.ragged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt),
        jnp.asarray(np.array(lengths, np.int32)), interpret=True))[:, 0]
    rt = tpa._row_tile(R, R, G, decode=True)
    assert rt == 1
    splits, tps = tpa._paged_plan(R, Hk, maxp, ps, 132)
    assert tps == 1 and splits == maxp * ps // TILE
    got, _ = schedule_model(
        torch.from_numpy(q[:, 0]), tk, tv, torch.from_numpy(bt),
        list(range(R)), lengths, row_tile=rt, lead=0, splits=splits, tps=tps,
        scale=D ** -0.5)
    np.testing.assert_allclose(got.numpy(), kern, atol=ATOL, rtol=RTOL)
    assert not got[0].any()
