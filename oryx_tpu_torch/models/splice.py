"""Multimodal splicing: interleave visual embeddings into the token stream
(port of `oryx_tpu.models.splice`).

The host computes an index map once per batch (numpy bookkeeping; visual
token counts are known from the packing metadata before any model runs),
and the device builds `inputs_embeds` with one select-gather:

    embeds[b, t] = is_visual[b, t] ? visual_buffer[visual_idx[b, t]]
                                   : embed_table[token_ids[b, t]]

The visual buffer is the Dynamic Compressor's packed output [Q, H_llm] for
the whole batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from oryx_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from oryx_tpu_torch.ops.packing import (
    DEFAULT_BUCKETS,
    PackedVisual,
    round_up_bucket,
)
from oryx_tpu_torch.utils.quant import embed_rows


def frame_separator_ids(tokenizer, frame_separator: str | None) -> tuple[int, ...]:
    """Tokenize OryxConfig.frame_separator into the sep_ids tuple for
    expand_video_sentinels."""
    if not frame_separator:
        return ()
    return tuple(
        int(t)
        for t in tokenizer.encode(frame_separator, add_special_tokens=False)
    )


def expand_video_sentinels(
    ids: np.ndarray,
    n_frames: int,
    *,
    labels: np.ndarray | None = None,
    sep_ids: tuple[int, ...] = (),
) -> tuple[np.ndarray, np.ndarray | None]:
    """Expand a video's single IMAGE_TOKEN_INDEX placeholder into one
    sentinel per frame, optionally followed by separator token ids after
    EACH frame. Inserted positions get IGNORE_INDEX labels."""
    ids = np.asarray(ids)
    idx = int(np.where(ids == IMAGE_TOKEN_INDEX)[0][0])
    per_frame = [IMAGE_TOKEN_INDEX, *sep_ids]
    mid = np.asarray(per_frame * n_frames, ids.dtype)
    out = np.concatenate([ids[:idx], mid, ids[idx + 1:]])
    out_labels = None
    if labels is not None:
        labels = np.asarray(labels)
        out_labels = np.concatenate(
            [labels[:idx],
             np.full(len(mid), IGNORE_INDEX, labels.dtype),
             labels[idx + 1:]]
        )
    return out, out_labels


def query_slots(packed: PackedVisual) -> list[tuple[int, int]]:
    """Per-image (start, count) slots in the packed query buffer, in pack
    order (queries are image-major, contiguous)."""
    slots = []
    start = 0
    for hq, wq in packed.q_grids:
        slots.append((start, hq * wq))
        start += hq * wq
    return slots


@dataclasses.dataclass
class MMBatch:
    """Spliced batch (host numpy).

    token_ids  [B, T] int32 - text token id per slot (0 at visual/pad slots)
    visual_idx [B, T] int32 - index into the packed visual buffer (0 if n/a)
    is_visual  [B, T] bool
    attn_mask  [B, T] int32 - 1 on real (text or visual) slots
    positions  [B, T] int32 - 0..len-1 per row (0 on pads)
    labels     [B, T] int32 - next-token targets aligned to slots
    lengths    [B] int32 - real length per row
    """

    token_ids: np.ndarray
    visual_idx: np.ndarray
    is_visual: np.ndarray
    attn_mask: np.ndarray
    positions: np.ndarray
    labels: np.ndarray
    lengths: np.ndarray


def build_mm_batch(
    input_ids: list[np.ndarray],
    image_slots: list[tuple[int, int]],
    *,
    labels: list[np.ndarray] | None = None,
    max_len: int | None = None,
    buckets: tuple[int, ...] = DEFAULT_BUCKETS,
) -> MMBatch:
    """Build the spliced index map for a batch.

    input_ids: per-sample int arrays containing IMAGE_TOKEN_INDEX sentinels,
      consumed left-to-right against `image_slots` (the global per-image
      (start, count) ranges from `query_slots`, across the whole batch).
    labels: optional per-sample arrays aligned with input_ids; visual spans
      and pads become IGNORE_INDEX.
    max_len: truncate rows to this many slots.
    """
    img_iter = iter(image_slots)
    rows = []
    for si, ids in enumerate(input_ids):
        ids = np.asarray(ids)
        lab = None if labels is None else np.asarray(labels[si])
        tok, vidx, isv, lb = [], [], [], []
        for j, t in enumerate(ids):
            if t == IMAGE_TOKEN_INDEX:
                start, count = next(img_iter)
                tok.extend([0] * count)
                vidx.extend(range(start, start + count))
                isv.extend([True] * count)
                lb.extend([IGNORE_INDEX] * count)
            else:
                tok.append(int(t))
                vidx.append(0)
                isv.append(False)
                lb.append(IGNORE_INDEX if lab is None else int(lab[j]))
        if max_len is not None:
            tok, vidx, isv, lb = (x[:max_len] for x in (tok, vidx, isv, lb))
        rows.append((tok, vidx, isv, lb))

    remaining = sum(1 for _ in img_iter)
    if remaining:
        raise ValueError(f"{remaining} image slot(s) had no sentinel consumer")

    B = len(rows)
    T = round_up_bucket(max(len(r[0]) for r in rows), buckets)
    out = MMBatch(
        token_ids=np.zeros((B, T), np.int32),
        visual_idx=np.zeros((B, T), np.int32),
        is_visual=np.zeros((B, T), bool),
        attn_mask=np.zeros((B, T), np.int32),
        positions=np.zeros((B, T), np.int32),
        labels=np.full((B, T), IGNORE_INDEX, np.int32),
        lengths=np.zeros((B,), np.int32),
    )
    for b, (tok, vidx, isv, lb) in enumerate(rows):
        n = len(tok)
        out.token_ids[b, :n] = tok
        out.visual_idx[b, :n] = vidx
        out.is_visual[b, :n] = isv
        out.attn_mask[b, :n] = 1
        out.positions[b, :n] = np.arange(n)
        out.labels[b, :n] = lb
        out.lengths[b] = n
    # Shift labels: label[t] supervises the prediction made AT slot t.
    out.labels = np.concatenate(
        [out.labels[:, 1:], np.full((B, 1), IGNORE_INDEX, np.int32)], axis=1
    )
    return out


def embed_spliced(
    embed_table: torch.Tensor,
    visual_buffer: torch.Tensor,
    token_ids: torch.Tensor,
    visual_idx: torch.Tensor,
    is_visual: torch.Tensor,
) -> torch.Tensor:
    """Build [B, T, H] inputs_embeds with one select-gather.
    embed_table: [V, H] (a tensor, or the LLM's embedding module, whose
    rows `quant.embed_rows` takes); visual_buffer: [Q, H] (compressor
    output), cast to the text rows' dtype."""
    text = embed_rows(embed_table, token_ids.long())
    vis = visual_buffer[visual_idx.long()].to(text.dtype)
    return torch.where(is_visual[..., None], vis, text)
