"""Multimodal host-side utilities: prompt tokenization with image sentinels
and native-resolution image preprocessing (numpy only; the same arithmetic
as `oryx_tpu.data.mm_utils`).

`tokenizer_image_token()` splits the prompt on "<image>" and interleaves the
IMAGE_TOKEN_INDEX sentinel; preprocessing keeps the native aspect ratio,
snapping dimensions to patch multiples and capping the total patch count.
"""

from __future__ import annotations

import math

import numpy as np

from oryx_tpu_torch.constants import DEFAULT_IMAGE_TOKEN, IMAGE_TOKEN_INDEX

# SigLIP normalization (mean/std 0.5 per channel).
IMAGE_MEAN = 0.5
IMAGE_STD = 0.5


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> np.ndarray:
    """Tokenize a prompt containing "<image>" placeholders into int32 ids
    with sentinel values at image positions. Each text chunk is tokenized
    separately (add_special_tokens off), so the sentinel never perturbs
    neighbouring tokenization."""
    chunks = prompt.split(DEFAULT_IMAGE_TOKEN)
    ids: list[int] = []
    for i, chunk in enumerate(chunks):
        if i > 0:
            ids.append(image_token_index)
        if chunk:
            ids.extend(tokenizer.encode(chunk, add_special_tokens=False))
    return np.asarray(ids, dtype=np.int32)


def resize_to_patch_grid(
    hw: tuple[int, int],
    patch_size: int,
    max_patches: int,
    min_patches: int = 1,
) -> tuple[int, int]:
    """Choose output (H, W) pixels: native aspect ratio, dims snapped to
    patch multiples, total patches capped at max_patches (downscale only)."""
    h, w = hw
    ph, pw = max(1, round(h / patch_size)), max(1, round(w / patch_size))
    if ph * pw > max_patches:
        scale = math.sqrt(max_patches / (ph * pw))
        ph = max(min_patches, int(ph * scale))
        pw = max(min_patches, int(pw * scale))
        while ph * pw > max_patches:  # int rounding guard
            if ph >= pw:
                ph -= 1
            else:
                pw -= 1
    return ph * patch_size, pw * patch_size


def preprocess_image(
    image: np.ndarray,
    patch_size: int,
    max_patches: int,
) -> np.ndarray:
    """uint8/float [H, W, 3] -> normalized float32 [H', W', 3] with H', W'
    patch multiples at native aspect ratio (bilinear resize)."""
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    H, W = img.shape[:2]
    Ht, Wt = resize_to_patch_grid((H, W), patch_size, max_patches)
    if (Ht, Wt) != (H, W):
        img = _bilinear_resize(img, Ht, Wt)
    return (img - IMAGE_MEAN) / IMAGE_STD


def _bilinear_resize(img: np.ndarray, Ht: int, Wt: int) -> np.ndarray:
    """Bilinear resize, align_corners=False semantics."""
    H, W, C = img.shape
    sy = (np.arange(Ht, dtype=np.float32) + 0.5) * (H / Ht) - 0.5
    sx = (np.arange(Wt, dtype=np.float32) + 0.5) * (W / Wt) - 0.5
    y0f, x0f = np.floor(sy), np.floor(sx)
    # y1 comes from the UNCLIPPED floor: at the low edge both taps clamp to
    # row 0 (torch bilinear align_corners=False edge semantics).
    y0 = np.clip(y0f.astype(np.int64), 0, H - 1)
    y1 = np.clip(y0f.astype(np.int64) + 1, 0, H - 1)
    x0 = np.clip(x0f.astype(np.int64), 0, W - 1)
    x1 = np.clip(x0f.astype(np.int64) + 1, 0, W - 1)
    ly = (sy - y0f)[:, None, None]
    lx = (sx - x0f)[None, :, None]
    top = img[y0][:, x0] * (1 - lx) + img[y0][:, x1] * lx
    bot = img[y1][:, x0] * (1 - lx) + img[y1][:, x1] * lx
    return (top * (1 - ly) + bot * ly).astype(np.float32)


def sample_frames(num_frames_available: int, num_frames: int) -> np.ndarray:
    """Uniform frame-index sampling for video (the decode itself stays a
    host-side dependency of the caller)."""
    if num_frames_available <= num_frames:
        return np.arange(num_frames_available)
    idx = np.linspace(0, num_frames_available - 1, num_frames)
    return np.round(idx).astype(np.int64)
