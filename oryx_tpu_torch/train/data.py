"""SFT data pipeline: conversation records -> packed multimodal batches
(port of `oryx_tpu.train.data`; numpy only, the arrays byte-equal to the
JAX package's).

Record schema (the LLaVA-mix JSON family):

    {"id": ..., "conversations": [{"from": "human"|"gpt", "value": ...}],
     "image": path | [paths], "video": path}

The collator emits the static-shape packed arrays (ops/packing +
models/splice) of `train.step.BATCH_FIELDS`; batches are grouped by modality
and length. Media decoding is the caller's: `SupervisedDataset` takes an
explicit `media_loader`. Text-only records can be sequence-packed, several
samples a row (`collate_packed_text`, `collate_microbatches(packed_text=)`).
"""

from __future__ import annotations

import json
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from oryx_tpu_torch.constants import (
    COMPRESSOR_RATIO,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    MODALITY_IMAGE,
    MODALITY_MULTI_IMAGE,
    MODALITY_VIDEO,
)
from oryx_tpu_torch.conversation import (
    Conversation,
    SeparatorStyle,
    conv_templates,
)
from oryx_tpu_torch.data import mm_utils
from oryx_tpu_torch.models import splice
from oryx_tpu_torch.ops import packing


def record_modality(rec: dict[str, Any]) -> str:
    if rec.get("video") is not None:
        return MODALITY_VIDEO
    img = rec.get("image")
    if isinstance(img, (list, tuple)) and len(img) > 1:
        return MODALITY_MULTI_IMAGE
    return MODALITY_IMAGE


def side_factor(modality: str) -> int:
    return int(COMPRESSOR_RATIO[modality] ** 0.5)


def preprocess_conversation(
    rec: dict[str, Any], tokenizer, conv: Conversation,
) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize one record with label masking: (input_ids with
    IMAGE_TOKEN_INDEX sentinels, labels with IGNORE_INDEX on everything but
    the assistant replies), both int64."""
    ids: list[int] = []
    labels: list[int] = []
    for text, supervised in _conversation_parts(rec, conv):
        toks = mm_utils.tokenizer_image_token(text, tokenizer)
        ids.extend(int(t) for t in toks)
        labels.extend(
            (int(t) if supervised and t >= 0 else IGNORE_INDEX) for t in toks
        )
    return np.asarray(ids, np.int64), np.asarray(labels, np.int64)


def _conversation_parts(
    rec: dict[str, Any], conv: Conversation
) -> list[tuple[str, bool]]:
    """(text, supervised) segments per the template's separator style, as
    Conversation.get_prompt formats them; assistant bodies (with the closing
    separator) are supervised."""
    role_map = {"human": conv.roles[0], "gpt": conv.roles[1]}
    msgs = [
        (role_map.get(m["from"], m["from"]), m["from"] == "gpt", m["value"])
        for m in rec["conversations"]
    ]
    parts: list[tuple[str, bool]] = []
    if conv.sep_style == SeparatorStyle.CHATML:
        if conv.system:
            parts.append((f"<|im_start|>system\n{conv.system}{conv.sep}", False))
        for role, sup, value in msgs:
            parts.append((f"<|im_start|>{role}\n", False))
            parts.append((f"{value}{conv.sep}", sup))
    elif conv.sep_style == SeparatorStyle.TWO:
        seps = [conv.sep, conv.sep2 or conv.sep]
        if conv.system:
            parts.append((conv.system + seps[0], False))
        for i, (role, sup, value) in enumerate(msgs):
            parts.append((f"{role}: ", False))
            parts.append((f"{value}{seps[i % 2]}", sup))
    elif conv.sep_style == SeparatorStyle.LLAMA_2:
        sys_block = (
            f"<<SYS>>\n{conv.system}\n<</SYS>>\n\n" if conv.system else ""
        )
        for i, (role, sup, value) in enumerate(msgs):
            if not sup:
                body = (sys_block + value) if i == 0 else value
                parts.append((f"{conv.sep}[INST] {body} [/INST]", False))
            else:
                parts.append((f" {value} {conv.sep2}", True))
    elif conv.sep_style == SeparatorStyle.PLAIN:
        # Stage-1 projector pretraining: bare concatenation; only the
        # assistant (caption) text is supervised.
        for _, sup, value in msgs:
            parts.append((f"{value}{conv.sep or ''}", sup))
    else:
        raise ValueError(f"unknown sep style {conv.sep_style}")
    return parts


@dataclass
class Example:
    """One preprocessed sample: ids with sentinels, labels, the RAW images
    (any resolution; the collator resizes and patchifies), modality and the
    per-image patch cap."""

    input_ids: np.ndarray
    labels: np.ndarray
    images: list[np.ndarray]
    modality: str
    max_patches: int = 4096


class SupervisedDataset:
    """Lazy conversation dataset over records (or a JSON file of them).

    media_loader(record) -> list of raw HWC uint8/float arrays (the images,
    or the sampled video frames). Defaults to reading an "image" record's
    paths through PIL as RGB; video records need an explicit loader.
    patch_size and video_frames are kept for the reference's signature
    (it stores them and reads neither).
    """

    def __init__(
        self,
        records: Sequence[dict[str, Any]] | str,
        tokenizer,
        *,
        template: str = "qwen",
        patch_size: int = 14,
        max_patches_per_image: int = 4096,
        video_frames: int = 64,
        media_loader: Callable[[dict[str, Any]], list[np.ndarray]] | None = None,
    ) -> None:
        if isinstance(records, str):
            with open(records) as f:
                records = json.load(f)
        self.records = list(records)
        self.tokenizer = tokenizer
        self.conv = conv_templates[template]
        self.patch_size = patch_size
        self.max_patches = max_patches_per_image
        self.video_frames = video_frames
        self.media_loader = media_loader or self._default_loader

    def __len__(self) -> int:
        return len(self.records)

    def _default_loader(self, rec: dict[str, Any]) -> list[np.ndarray]:
        paths = rec.get("image")
        if paths is None:
            raise ValueError(
                "video records need an explicit media_loader "
                f"(record id {rec.get('id')})"
            )
        if isinstance(paths, str):
            paths = [paths]
        from PIL import Image

        return [np.asarray(Image.open(p).convert("RGB")) for p in paths]

    def __getitem__(self, i: int) -> Example:
        rec = self.records[i]
        modality = record_modality(rec)
        images = self.media_loader(rec) if (
            rec.get("image") is not None or rec.get("video") is not None
        ) else []
        # Video frames share one budget; images each get the full cap.
        per_img_cap = (
            max(1, self.max_patches // max(len(images), 1))
            if modality == MODALITY_VIDEO else self.max_patches
        )
        ids, labels = preprocess_conversation(rec, self.tokenizer, self.conv)
        n_sentinels = int(np.sum(ids == IMAGE_TOKEN_INDEX))
        # A video/multi-image record may carry one placeholder for all its
        # frames (the collator expands it).
        if n_sentinels != len(images) and not (
            n_sentinels == 1 and len(images) > 1
        ):
            raise ValueError(
                f"record {rec.get('id')}: {n_sentinels} image tokens vs "
                f"{len(images)} images"
            )
        return Example(ids, labels, images, modality, per_img_cap)


def collate(
    examples: Sequence[Example],
    *,
    patch_size: int = 14,
    base_grid: int = 27,
    max_len: int | None = None,
    buckets: tuple[int, ...] = packing.DEFAULT_BUCKETS,
    frame_separator_ids: tuple[int, ...] = (),
) -> dict[str, np.ndarray]:
    """Pack Examples into one static-shape training batch (every
    BATCH_FIELDS array, numpy). frame_separator_ids: token ids spliced after
    each video frame's sentinel when a single placeholder expands."""
    all_images: list[np.ndarray] = []
    factors: list[int] = []
    caps: list[int] = []
    per_sample_ids: list[np.ndarray] = []
    per_sample_labels: list[np.ndarray] = []
    for ex in examples:
        ids, labels = ex.input_ids, ex.labels
        if int(np.sum(ids == IMAGE_TOKEN_INDEX)) == 1 and len(ex.images) > 1:
            ids, labels = splice.expand_video_sentinels(
                ids, len(ex.images), labels=labels,
                sep_ids=frame_separator_ids,
            )
        per_sample_ids.append(ids)
        per_sample_labels.append(labels)
        all_images.extend(ex.images)
        factors.extend([side_factor(ex.modality)] * len(ex.images))
        caps.extend([ex.max_patches] * len(ex.images))

    packed = packing.pack_raw_images(
        all_images, patch_size=patch_size, base_grid=base_grid,
        side_factors=factors, max_patches=caps, buckets=buckets,
    )
    batch = splice.build_mm_batch(
        per_sample_ids, splice.query_slots(packed),
        labels=per_sample_labels, max_len=max_len, buckets=buckets,
    )
    return {
        "patches": packed.patches,
        "segment_ids": packed.segment_ids,
        "pos_coords": packed.pos_coords,
        "region_ids": packed.region_ids,
        "q_region_ids": packed.q_region_ids,
        "token_ids": batch.token_ids,
        "visual_idx": batch.visual_idx,
        "is_visual": batch.is_visual,
        "attn_mask": batch.attn_mask,
        "positions": batch.positions,
        "labels": batch.labels,
    }


def collate_packed_text(
    examples: Sequence[Example],
    *,
    bucket: int,
    num_rows: int | None = None,
    patch_size: int = 14,
    base_grid: int = 27,
    buckets: tuple[int, ...] = packing.DEFAULT_BUCKETS,
    max_len: int | None = None,
    # Accepted for **collate_kw parity with `collate`; text-only batches
    # have no video placeholders.
    frame_separator_ids: tuple[int, ...] = (),
) -> dict[str, np.ndarray]:
    """Sequence-packed text-only batch: samples share `bucket`-wide rows
    (first-fit decreasing), told apart by `text_segment_ids` (1, 2, ... per
    row, 0 = pad): attention stays causal within a sample and never crosses
    samples (models/qwen2.forward segment_ids), RoPE positions restart per
    sample, and each sample's last slot predicts nothing. The visual fields
    are the empty packed buffer, so the batch feeds the standard step.

    num_rows pins the row count (all-pad rows appended: segment 0, no
    supervised token); packing that needs more rows raises."""
    if any(ex.images for ex in examples):
        raise ValueError("collate_packed_text is text-only; use collate")
    if max_len is not None and bucket > max_len:
        raise ValueError(f"bucket={bucket} exceeds max_len={max_len}")
    order = sorted(
        range(len(examples)),
        key=lambda i: len(examples[i].input_ids),
        reverse=True,
    )
    rows: list[list[int]] = []
    space: list[int] = []
    for i in order:
        n = len(examples[i].input_ids)
        if n > bucket:
            raise ValueError(
                f"sample of {n} tokens exceeds the {bucket} packing bucket"
            )
        for r in range(len(rows)):  # first fit
            if space[r] >= n:
                rows[r].append(i)
                space[r] -= n
                break
        else:
            rows.append([i])
            space.append(bucket - n)

    if num_rows is not None:
        if len(rows) > num_rows:
            raise ValueError(
                f"{len(examples)} samples packed into {len(rows)} rows "
                f"> num_rows={num_rows}; raise num_rows or the bucket"
            )
        rows += [[] for _ in range(num_rows - len(rows))]
    R = len(rows)
    token_ids = np.zeros((R, bucket), np.int32)
    labels = np.full((R, bucket), IGNORE_INDEX, np.int32)
    positions = np.zeros((R, bucket), np.int32)
    segs = np.zeros((R, bucket), np.int32)
    for r, idxs in enumerate(rows):
        off = 0
        for s, i in enumerate(idxs, start=1):
            ex = examples[i]
            n = len(ex.input_ids)
            token_ids[r, off:off + n] = ex.input_ids
            # Pre-shifted as splice.build_mm_batch: labels[t] is the target
            # predicted at t, never the next sample's first token.
            labels[r, off:off + n - 1] = ex.labels[1:]
            positions[r, off:off + n] = np.arange(n, dtype=np.int32)
            segs[r, off:off + n] = s
            off += n

    empty = packing.pack_raw_images(
        [], patch_size=patch_size, base_grid=base_grid,
        side_factors=[], max_patches=[], buckets=buckets,
    )
    return {
        "patches": empty.patches,
        "segment_ids": empty.segment_ids,
        "pos_coords": empty.pos_coords,
        "region_ids": empty.region_ids,
        "q_region_ids": empty.q_region_ids,
        "token_ids": token_ids,
        "visual_idx": np.zeros((R, bucket), np.int32),
        "is_visual": np.zeros((R, bucket), bool),
        "attn_mask": (segs > 0).astype(np.int32),
        "positions": positions,
        "labels": labels,
        "text_segment_ids": segs,
    }


def _pad_to_shape(arr: np.ndarray, shape: tuple[int, ...], fill) -> np.ndarray:
    if arr.shape == shape:
        return arr
    out = np.full(shape, fill, arr.dtype)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


def collate_microbatches(
    examples: Sequence[Example], grad_accum_steps: int, *,
    packed_text: bool = False,
    pack_bucket: int | None = None,
    pack_num_rows: int | None = None,
    **collate_kw,
) -> dict[str, np.ndarray]:
    """`grad_accum_steps` microbatches stacked on a leading [accum, ...]
    axis (the train_step layout). Each microbatch is packed on its own (its
    visual_idx/region_ids index its own visual buffer), then all are padded
    to common shapes with 0 / IGNORE_INDEX so they stack. packed_text
    collates each microbatch with `collate_packed_text` (pack_bucket wide,
    pack_num_rows rows)."""
    n = len(examples)
    if n % grad_accum_steps != 0:
        raise ValueError(f"batch of {n} not divisible by {grad_accum_steps}")
    per = n // grad_accum_steps
    if packed_text:
        if pack_bucket is None:
            raise ValueError("packed_text needs pack_bucket")
        micro = [
            collate_packed_text(
                examples[i * per : (i + 1) * per], bucket=pack_bucket,
                num_rows=pack_num_rows, **collate_kw,
            )
            for i in range(grad_accum_steps)
        ]
    else:
        micro = [
            collate(examples[i * per : (i + 1) * per], **collate_kw)
            for i in range(grad_accum_steps)
        ]
    out: dict[str, np.ndarray] = {}
    for key in micro[0]:
        fill = IGNORE_INDEX if key == "labels" else 0
        shape = tuple(
            max(m[key].shape[d] for m in micro)
            for d in range(micro[0][key].ndim)
        )
        out[key] = np.stack([_pad_to_shape(m[key], shape, fill) for m in micro])
    return out


class PrefetchIterator:
    """Collates `depth` batches ahead on one background thread while the
    device runs the step. Errors of the producer surface on the consumer
    side; `close()` stops it."""

    _DONE = object()

    def __init__(self, it: Iterator[Any], depth: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err: BaseException | None = None
        self._stop = threading.Event()

        def put_or_stop(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def run() -> None:
            try:
                for item in it:
                    if not put_or_stop(item):
                        return
            except Exception as e:  # surfaced on the consumer side
                self._err = e
            finally:
                put_or_stop(self._DONE)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> Any:
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer and drop prefetched batches (idempotent)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def length_estimate(rec: dict[str, Any]) -> int:
    """Token-length proxy without loading media: whitespace tokens plus a
    flat allowance per visual. Only the order matters (length grouping)."""
    n = sum(
        len(m.get("value", "").split()) for m in rec.get("conversations", ())
    )
    if rec.get("video") is not None:
        n += 1024
    else:
        img = rec.get("image")
        n += 729 * (len(img) if isinstance(img, (list, tuple)) else 1 if img else 0)
    return n


def grouped_batch_iterator(
    dataset: SupervisedDataset,
    batch_size: int,
    *,
    seed: int = 0,
    num_epochs: int | None = None,
    process_index: int = 0,
    process_count: int = 1,
    grad_accum_steps: int = 1,
    length_group_size: int = 8,
    **collate_kw,
) -> Iterator[dict[str, np.ndarray]]:
    """Modality- and length-grouped, shuffled, per-process batches (the JAX
    iterator's order for the same seed): indices shuffle within modality
    groups, megabatches of length_group_size * batch_size sort by
    `length_estimate`, batches shuffle across modalities and round-robin
    over processes; per-modality tails carry over to the next epoch. With
    grad_accum_steps > 1 each batch is `collate_microbatches`."""
    rng = np.random.default_rng(seed)
    by_mod: dict[str, list[int]] = {}
    for i in range(len(dataset)):
        by_mod.setdefault(record_modality(dataset.records[i]), []).append(i)
    leftover: dict[str, list[int]] = {m: [] for m in by_mod}
    lengths = (
        [length_estimate(r) for r in dataset.records]
        if length_group_size > 1
        else None
    )

    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        batches: list[list[int]] = []
        for mod, idxs in by_mod.items():
            idxs = leftover[mod] + list(idxs)
            rng.shuffle(idxs)
            if length_group_size > 1:
                mega = batch_size * length_group_size
                idxs = [
                    i
                    for j in range(0, len(idxs), mega)
                    for i in sorted(
                        idxs[j : j + mega],
                        key=lengths.__getitem__,
                        reverse=True,
                    )
                ]
            full = len(idxs) - len(idxs) % batch_size
            for j in range(0, full, batch_size):
                batches.append(idxs[j : j + batch_size])
            leftover[mod] = idxs[full:]
        rng.shuffle(batches)
        for bi, b in enumerate(batches):
            if bi % process_count != process_index:
                continue
            examples = [dataset[i] for i in b]
            if grad_accum_steps > 1:
                yield collate_microbatches(examples, grad_accum_steps,
                                           **collate_kw)
            else:
                yield collate(examples, **collate_kw)
        epoch += 1
