"""The tile schedule of the bf16 backward kernels K5a/K5b: the per-cell map
`_tile_flags` that the wrapper computes once per call (0: no visible pair,
the kernels never load or visit the cell; 2: every pair visible, they skip
the per-element mask; 1: masked element by element), held against the
dense visibility mask `_mask` of the plain twins.

Inputs are made from a seed with numpy: arange, slot (right-padded rows)
and arbitrary positions, contiguous image segments (the ViT, pads attending
pads), the compressor's non-contiguous 4 x 4-patch regions, random kv masks
and ragged lengths around the 64-row cells. Exact: the flags are integers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oryx_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

T = fa.TILE


def _check(q_pos, kv_pos, q_seg, kv_seg, kv_valid, causal, has_segments):
    """Flags against the dense mask; returns the flags."""
    args = [torch.from_numpy(np.ascontiguousarray(x, np.int32))
            for x in (q_pos, kv_pos, q_seg, kv_seg, kv_valid)]
    flags = fa._tile_flags(*args, causal, has_segments)
    B, Tq = args[0].shape
    Tk = args[1].shape[1]
    nq, nk = -(-Tq // T), -(-Tk // T)
    assert flags.dtype == torch.int8 and tuple(flags.shape) == (B, nq, nk)
    for b in range(B):
        mask = fa._mask(b, *args, causal, has_segments).expand(Tq, Tk)
        full = torch.zeros((nq * T, nk * T), dtype=torch.bool)
        full[:Tq, :Tk] = mask
        cells = full.view(nq, T, nk, T).transpose(1, 2)  # [nq, nk, T, T]
        # Pairs outside [Tq, Tk) do not exist: a full cell needs only the
        # real ones, and is never ragged (rows past T are not live).
        real = torch.zeros_like(full)
        real[:Tq, :Tk] = True
        real = real.view(nq, T, nk, T).transpose(1, 2)
        f = flags[b]
        visible = cells.any(-1).any(-1)
        assert not (visible & (f == 0)).any(), "visible pair in a dead cell"
        all_vis = (cells | ~real).all(-1).all(-1) & real.all(-1).all(-1)
        assert not ((f == 2) & ~all_vis).any(), "a masked pair in a full cell"
        if has_segments:
            _check_segment_sets(f, args, b)
    return flags


def _segment_sets(seg, live):
    """The live segment ids of each 64-row tile."""
    return [set(seg[i:i + T][live[i:i + T]].tolist())
            for i in range(0, len(seg), T)]


def _check_segment_sets(f, args, b):
    """Tiles of at most two segments each (one of them pads, say) whose
    sets are disjoint are skipped: the stats keep {min} and [second, max],
    which is exact for two ids."""
    q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    qs = _segment_sets(q_seg[b], torch.ones_like(q_seg[b], dtype=torch.bool))
    ks = _segment_sets(kv_seg[b], kv_valid[b] > 0)
    for i, a in enumerate(qs):
        for j, c in enumerate(ks):
            if len(a) <= 2 and len(c) <= 2 and not (a & c):
                assert f[i, j] == 0, (i, j, a, c)


def _slot_rows(rng, B, Tmax):
    lens = rng.integers(1, Tmax + 1, size=B)
    live = np.arange(Tmax)[None] < lens[:, None]
    pos = np.where(live, np.arange(Tmax)[None], 0)
    return pos, live


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("Tq,Tk", [(1, 1), (63, 65), (200, 200),
                                   (130, 333), (2048, 2048)])
def test_arange_causal_with_kv_mask(seed, Tq, Tk):
    """kv positions arange, q positions arange or random (decode rows),
    random kv validity."""
    rng = np.random.default_rng(seed)
    B = 2
    kv_pos = np.broadcast_to(np.arange(Tk), (B, Tk))
    if seed % 2 and Tq <= Tk:
        q_pos = np.broadcast_to(np.arange(Tq), (B, Tq))
    else:
        q_pos = rng.integers(0, Tk, size=(B, Tq))
    lens = rng.integers(1, Tk + 1, size=B)
    valid = np.arange(Tk)[None] < lens[:, None]
    zq, zk = np.zeros((B, Tq)), np.zeros((B, Tk))
    _check(q_pos, kv_pos, zq, zk, valid, True, False)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("Tmax", [65, 200, 2048])
def test_slot_positions_clamp(seed, Tmax):
    """The decoder's training layout: arange on real slots, 0 on pads, a kv
    mask. The rule is the index clamp: a kv cell starting past a q cell's
    last row is dead; the cells strictly below the diagonal of live rows
    are full; at least one diagonal cell is partial."""
    rng = np.random.default_rng(seed)
    B = 3
    pos, live = _slot_rows(rng, B, Tmax)
    seg = np.zeros((B, Tmax))
    flags = _check(pos, pos, seg, seg, live, True, False)
    n = flags.shape[1]
    qi, ki = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    assert not flags[:, torch.from_numpy(ki > qi)].any()
    lens = live.sum(1)
    for b in range(B):
        for i in range(n):
            for j in range(i):
                if (i + 1) * T <= lens[b]:
                    assert flags[b, i, j] == 2
        assert flags[b, 0, 0] == 1 or lens[b] == 1


def _images(rng, P, n):
    """Contiguous image segments 1..n over P patch slots; pads are 0 and
    attend pads (the ViT's buffers)."""
    sizes = rng.integers(1, max(2, P // n), size=n)
    seg = np.zeros(P, np.int64)
    at = 0
    for i, s in enumerate(sizes):
        seg[at:at + s] = i + 1
        at += s
    return seg


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("P,n", [(200, 3), (1000, 4), (4096, 4)])
def test_vit_segments(seed, P, n):
    rng = np.random.default_rng(seed)
    seg = _images(rng, P, n)[None]
    pos = np.broadcast_to(np.arange(P), (1, P))
    valid = np.ones((1, P))
    flags = _check(pos, pos, seg, seg, valid, False, True)
    # A cell inside one image is full.
    cells = seg[0, : (P // T) * T].reshape(-1, T)
    one = (cells == cells[:, :1]).all(1)
    for i in np.nonzero(one)[0]:
        assert flags[0, i, i] == 2


def _regions(h, w):
    """Patch region ids of an h x w grid in 4 x 4 regions, row-major patches:
    a region's patches are not contiguous."""
    r = (np.arange(h)[:, None] // 4) * (-(-w // 4)) + np.arange(w)[None] // 4
    return r.reshape(-1) + 1


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("grids", [[(16, 16)], [(28, 44), (8, 12)],
                                   [(44, 44)] * 4])
def test_compressor_regions(seed, grids):
    """Pooled queries (one per region) against the patches of their region,
    images one after another, pads at the end of both."""
    rng = np.random.default_rng(seed)
    kv, q = [], []
    base = 0
    for h, w in grids:
        r = _regions(h, w) + base
        kv.append(r)
        q.append(np.unique(r))
        base = r.max()
    kv_seg = np.concatenate(kv + [np.zeros(int(rng.integers(0, 70)))])
    q_seg = np.concatenate(q + [np.zeros(int(rng.integers(0, 70)))])
    q_seg, kv_seg = q_seg[None], kv_seg[None]
    q_pos = np.zeros_like(q_seg)
    kv_pos = np.zeros_like(kv_seg)
    valid = np.ones_like(kv_seg)
    _check(q_pos, kv_pos, q_seg, kv_seg, valid, False, True)


@pytest.mark.parametrize("seed", range(6))
def test_random_segments_positions_and_masks(seed):
    """Everything at once, random: causal on arbitrary positions, segments
    from a small alphabet (fully masked rows included), a random kv mask,
    ragged lengths."""
    rng = np.random.default_rng(seed)
    B = 2
    Tq, Tk = (int(x) for x in rng.integers(1, 400, size=2))
    q_pos = rng.integers(0, Tk, size=(B, Tq))
    kv_pos = rng.integers(0, Tk, size=(B, Tk))
    q_seg = rng.integers(0, 3, size=(B, Tq))
    kv_seg = rng.integers(0, 3, size=(B, Tk))
    valid = rng.random((B, Tk)) < 0.9
    for causal in (False, True):
        for segs in (False, True):
            _check(q_pos, kv_pos, q_seg, kv_seg, valid, causal, segs)
