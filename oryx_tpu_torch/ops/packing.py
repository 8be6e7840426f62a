"""Host-side packing of variable-resolution visual inputs into one buffer.

All images/frames of a batch go into ONE padded patch buffer with:

  * segment ids   - per-patch image membership; ViT attention masks on
                    equality, so each image attends only within itself.
  * region ids    - per-patch compressor-region membership; the Dynamic
                    Compressor's region cross-attention masks on these.
  * pos coords    - continuous source-space coordinates into the learned
                    position-embedding table (bilinear, align_corners=False).

Buffer lengths are rounded up to a small set of buckets. Everything here is
numpy on the host and matches `oryx_tpu.ops.packing` byte for byte.

Convention: id 0 is padding everywhere; real images/regions count from 1.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# Packed-length buckets (patches, and decoder tokens): a powers-of-two
# ladder bounds padding waste at <2x.
DEFAULT_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)


def round_up_bucket(n: int, buckets: tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} patches exceed the largest bucket {buckets[-1]}")


def patchify(image: np.ndarray, patch_size: int) -> tuple[np.ndarray, tuple[int, int]]:
    """[H, W, C] (H, W multiples of patch_size) -> ([h*w, p*p*C], (h, w)).
    Patch-internal pixel order is (py, px, c)."""
    H, W, C = image.shape
    p = patch_size
    if H % p or W % p:
        raise ValueError(f"image {H}x{W} not a multiple of {p}")
    h, w = H // p, W // p
    x = image.reshape(h, p, w, p, C).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(x.reshape(h * w, p * p * C)), (h, w)


def posemb_source_coords(h: int, w: int, base_grid: int) -> np.ndarray:
    """Continuous coords [h*w, 2] into the base_grid x base_grid posemb
    table: src = (dst + 0.5) * (G / size) - 0.5, edge-clamped by the
    device-side gather."""
    ys = (np.arange(h, dtype=np.float32) + 0.5) * (base_grid / h) - 0.5
    xs = (np.arange(w, dtype=np.float32) + 0.5) * (base_grid / w) - 0.5
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([yy.reshape(-1), xx.reshape(-1)], axis=-1)


@dataclasses.dataclass
class PackedVisual:
    """One batch of packed visual inputs (all numpy, host-side).

    Patch stream (length P, bucketed):
      patches      [P, patch_dim] float32 - raw patch pixels (0 on padding)
      segment_ids  [P] int32 - image membership (0 = pad)
      region_ids   [P] int32 - compressor region membership (0 = pad)
      pos_coords   [P, 2] float32 - posemb table coords
    Query stream (length Q, bucketed), one query per compressor region:
      q_segment_ids [Q] int32 - image membership of each query (0 = pad)
      q_region_ids  [Q] int32 - region id of each query (0 = pad)
    Bookkeeping:
      grids        per-image patch grids (h, w)
      q_grids      per-image query grids (hq, wq)
      side_factors per-image compressor side factor (1, 2, or 4)
      num_patches  real (unpadded) patch count
      num_queries  real (unpadded) query count
    """

    patches: np.ndarray
    segment_ids: np.ndarray
    region_ids: np.ndarray
    pos_coords: np.ndarray
    q_segment_ids: np.ndarray
    q_region_ids: np.ndarray
    grids: list[tuple[int, int]]
    q_grids: list[tuple[int, int]]
    side_factors: list[int]
    num_patches: int
    num_queries: int


def _pack_metadata(
    grids: list[tuple[int, int]],
    side_factors: list[int],
    base_grid: int,
    patch_dim: int,
    buckets: tuple[int, ...],
) -> tuple[PackedVisual, list[int]]:
    """All bookkeeping arrays for the given per-image patch grids, with a
    zeroed patches buffer. Returns (packed, per-image patch-row offsets)."""
    if not grids:
        # Text-only batch: a minimal all-padding buffer.
        P = buckets[0]
        return PackedVisual(
            patches=np.zeros((P, patch_dim), np.float32),
            segment_ids=np.zeros(P, np.int32),
            region_ids=np.zeros(P, np.int32),
            pos_coords=np.zeros((P, 2), np.float32),
            q_segment_ids=np.zeros(P, np.int32),
            q_region_ids=np.zeros(P, np.int32),
            grids=[], q_grids=[], side_factors=[],
            num_patches=0, num_queries=0,
        ), []

    seg_list, reg_list, coord_list = [], [], []
    qseg_list, qreg_list = [], []
    q_grids: list[tuple[int, int]] = []
    offsets: list[int] = []
    next_region = 1
    off = 0
    for i, ((h, w), s) in enumerate(zip(grids, side_factors), start=1):
        offsets.append(off)
        off += h * w
        seg_list.append(np.full(h * w, i, np.int32))
        coord_list.append(posemb_source_coords(h, w, base_grid))

        hq, wq = math.ceil(h / s), math.ceil(w / s)
        q_grids.append((hq, wq))
        rows = np.arange(h)[:, None] // s
        cols = np.arange(w)[None, :] // s
        rid = next_region + rows * wq + cols
        reg_list.append(rid.reshape(-1).astype(np.int32))
        qseg_list.append(np.full(hq * wq, i, np.int32))
        qreg_list.append(
            np.arange(next_region, next_region + hq * wq, dtype=np.int32)
        )
        next_region += hq * wq

    P = round_up_bucket(off, buckets)

    def pad_to(arr, length, fill=0):
        out = np.full((length, *arr.shape[1:]), fill, arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    q_seg = np.concatenate(qseg_list)
    Q_real = q_seg.shape[0]
    Q = round_up_bucket(Q_real, buckets)

    packed = PackedVisual(
        patches=np.zeros((P, patch_dim), np.float32),
        segment_ids=pad_to(np.concatenate(seg_list), P),
        region_ids=pad_to(np.concatenate(reg_list), P),
        pos_coords=pad_to(np.concatenate(coord_list), P),
        q_segment_ids=pad_to(q_seg, Q),
        q_region_ids=pad_to(np.concatenate(qreg_list), Q),
        grids=list(grids),
        q_grids=q_grids,
        side_factors=list(side_factors),
        num_patches=off,
        num_queries=Q_real,
    )
    return packed, offsets


def _broadcast_factors(side_factors: list[int] | int, n: int) -> list[int]:
    if isinstance(side_factors, int):
        return [side_factors] * n
    if len(side_factors) != n:
        raise ValueError(f"{len(side_factors)} side factors for {n} images")
    return list(side_factors)


def pack_images(
    images: list[np.ndarray],
    *,
    patch_size: int,
    base_grid: int,
    side_factors: list[int] | int = 1,
    buckets: tuple[int, ...] = DEFAULT_BUCKETS,
) -> PackedVisual:
    """Pack preprocessed images (dims multiples of patch_size) into one
    buffer. side_factors: compressor downsample factor per spatial side per
    image (scalar broadcast)."""
    side_factors = _broadcast_factors(side_factors, len(images))
    rows_grids = [patchify(img, patch_size) for img in images]
    grids = [g for _, g in rows_grids]
    patch_dim = (
        rows_grids[0][0].shape[1] if rows_grids else patch_size * patch_size * 3
    )
    packed, offsets = _pack_metadata(
        grids, side_factors, base_grid, patch_dim, buckets
    )
    for (rows, (h, w)), off in zip(rows_grids, offsets):
        packed.patches[off : off + h * w] = rows
    return packed


def pack_raw_images(
    images: list[np.ndarray],
    *,
    patch_size: int,
    base_grid: int,
    side_factors: list[int] | int = 1,
    max_patches: list[int] | int = 4096,
    buckets: tuple[int, ...] = DEFAULT_BUCKETS,
) -> PackedVisual:
    """Pack RAW images (uint8/float HWC, any resolution): resize, normalize
    and patchify each image straight into its slice of the packed buffer.

    The C++ thread-pool kernels (data/native_loader.py, built at first use)
    write each image's rows into its slice when the library builds; numpy
    (data/mm_utils) otherwise. The two agree to 1e-4."""
    from oryx_tpu_torch.data import mm_utils, native_loader

    n = len(images)
    side_factors = _broadcast_factors(side_factors, n)
    caps = max_patches if isinstance(max_patches, list) else [max_patches] * n
    if len(caps) != n:
        raise ValueError(f"{len(caps)} patch caps for {n} images")

    out_hws = [
        mm_utils.resize_to_patch_grid(img.shape[:2], patch_size, cap)
        for img, cap in zip(images, caps)
    ]
    grids = [(oh // patch_size, ow // patch_size) for oh, ow in out_hws]
    C = images[0].shape[2] if n else 3
    for i, img in enumerate(images):
        if img.shape[2] != C:
            raise ValueError(
                f"image {i} has {img.shape[2]} channels, expected {C}; "
                "convert inputs to RGB first"
            )
    packed, offsets = _pack_metadata(
        grids, side_factors, base_grid, patch_size * patch_size * C, buckets
    )
    slices = [
        packed.patches[off : off + h * w] for (h, w), off in zip(grids, offsets)
    ]
    if native_loader.is_available():
        native_loader.batch_preprocess(
            images, out_hws, patch_size,
            mm_utils.IMAGE_MEAN, mm_utils.IMAGE_STD, outs=slices,
        )
    else:
        for img, cap, dst in zip(images, caps, slices):
            pre = mm_utils.preprocess_image(img, patch_size, cap)
            dst[:] = patchify(pre, patch_size)[0]
    return packed
