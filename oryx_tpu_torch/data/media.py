"""Host-side media loading: images, and video as a directory of frames
(port of `oryx_tpu.data.media`); `load_record_media` reads a training or
eval record's media.

Images decode through PIL where it is installed. A host without PIL
still reads PNG, with zlib and numpy (8-bit gray, gray + alpha, RGB,
RGBA; palette at 1, 2, 4 or 8 bits; the five scanline filters; no
interlace), so the server decodes `data:image/png` parts there; any other
format raises ValueError. Both refuse images above PIL's
decompression-bomb limit.
"""

from __future__ import annotations

import io
import os
import re
import struct
import zlib

import numpy as np

from oryx_tpu_torch.data import mm_utils

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PIL's decompression-bomb limit (2 x `Image.MAX_IMAGE_PIXELS`), above
# which `Image.open` raises.
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)
# Color type -> samples a pixel.
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _natural_key(name: str) -> tuple:
    """Sort key treating digit runs numerically, so frame_2 < frame_10."""
    return tuple(
        int(part) if part.isdigit() else part
        for part in re.split(r"(\d+)", name)
    )


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: [height, stride] uint8. Sub, Average
    and Paeth predict from the reconstructed left neighbour, so the rows
    are undone as a wavefront: a byte depends on its left, upper and
    upper-left bytes, which all lie on the previous two anti-diagonals of
    pixels, so one step reconstructs a whole anti-diagonal (width + height
    steps)."""
    need = height * (stride + 1)
    if len(raw) < need:
        raise ValueError("PNG image data is truncated")
    lines = np.frombuffer(raw, np.uint8, need).reshape(height, stride + 1)
    ftypes, data = lines[:, 0], lines[:, 1:]
    if int(ftypes.max()) > 4:
        raise ValueError(f"PNG scanline filter {int(ftypes.max())} is not "
                         "defined")
    width = stride // bpp
    # Skewed layout: pixel (y, x) of anti-diagonal d = x + y sits at
    # sk[y + 1, d + 2]; row 0 and the cells left of each row stay 0, which
    # is what the filters read beyond the image's top and left edges.
    sk = np.zeros((height + 1, width + height + 1, bpp), np.int16)
    coded = np.zeros((height, width + height + 1, bpp), np.uint8)
    pix = data.reshape(height, width, bpp)
    for y in range(height):
        coded[y, y + 1:y + 1 + width] = pix[y]
    # One 0/1 weight a filter and row, so a step's prediction is a sum of
    # products rather than a chain of selects.
    w_sub, w_up, w_avg, w_paeth = (
        (ftypes == f).astype(np.int16)[:, None] for f in (1, 2, 3, 4))
    for d in range(width + height - 1):
        y0, y1 = max(0, d - width + 1), min(height, d + 1)
        a = sk[y0 + 1:y1 + 1, d + 1]   # left
        b = sk[y0:y1, d + 1]           # up
        c = sk[y0:y1, d]               # up-left
        ab = a + b
        pa, pb, pc = abs(b - c), abs(a - c), abs(ab - 2 * c)
        paeth = np.where(pb <= pc, b, c)
        np.copyto(paeth, a, where=(pa <= pb) & (pa <= pc))
        val = paeth * w_paeth[y0:y1]
        val += (ab >> 1) * w_avg[y0:y1]
        val += a * w_sub[y0:y1]
        val += b * w_up[y0:y1]
        val += coded[y0:y1, d + 1]
        val &= 0xFF
        sk[y0 + 1:y1 + 1, d + 2] = val
    out = np.empty((height, width, bpp), np.uint8)
    for y in range(height):
        out[y] = sk[y + 1, y + 2:y + 2 + width]
    return out.reshape(height, stride)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> HWC uint8 RGB array, as PIL's
    `Image.open(...).convert("RGB")` gives it. Raises ValueError for what
    this reader does not cover (16-bit samples, interlace)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG stream")
    pos = len(PNG_SIGNATURE)
    ihdr = None
    palette = None
    idat = []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG stream without IHDR or IDAT")
    width, height, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _PNG_CHANNELS or comp or filt:
        raise ValueError(f"PNG color type {ctype} / method {comp},{filt} "
                         "is not defined")
    if interlace:
        raise ValueError("interlaced PNG is not covered by the built-in "
                         "reader (install PIL)")
    sub_byte = depth in (1, 2, 4) and ctype in (0, 3)
    if depth != 8 and not sub_byte:
        raise ValueError(f"{depth}-bit PNG samples are not covered by the "
                         "built-in reader (install PIL)")
    if not 0 < width * height <= MAX_PIXELS:
        raise ValueError(f"PNG image size {width}x{height} is outside "
                         f"1..{MAX_PIXELS} pixels")
    channels = _PNG_CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    try:
        # At most the bytes the header declares: a few kilobytes of
        # compressed zeros must not inflate to gigabytes.
        raw = zlib.decompressobj().decompress(
            b"".join(idat), height * (stride + 1))
    except zlib.error as e:
        raise ValueError(f"PNG image data is corrupt: {e}") from None
    rows = _unfilter(raw, height, stride, max(1, channels * depth // 8))
    if sub_byte:
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits * weights).sum(-1).astype(np.uint8)[:, :width]
        if ctype == 0:
            samples = (samples.astype(np.uint32) * 255
                       // ((1 << depth) - 1)).astype(np.uint8)
        pix = samples[..., None]
    else:
        pix = rows.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        idx = pix[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[idx]
    if ctype in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pix[..., :3])


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> HWC uint8 RGB: through PIL where it is installed, as
    the reference decodes; on a host without PIL, PNG through `decode_png`
    and any other format a ValueError."""
    try:
        from PIL import Image
    except ImportError:
        if data.startswith(PNG_SIGNATURE):
            return decode_png(data)
        raise ValueError(
            "this image format needs PIL, which is not installed (8-bit, "
            "non-interlaced PNG is read without it)"
        ) from None
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def load_image(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image(f.read())


def load_video_frames(path: str, num_frames: int) -> list[np.ndarray]:
    """Uniformly sample `num_frames` from a directory of frame images
    (natural filename order)."""
    if not os.path.isdir(path):
        raise ValueError(
            f"{path} is not a directory of frames: decoding video files "
            "needs decord, which the port does not use; pass a directory "
            "of frame images"
        )
    names = sorted(
        (n for n in os.listdir(path) if n.lower().endswith(IMAGE_EXTS)),
        key=_natural_key,
    )
    if not names:
        raise FileNotFoundError(f"no frame images under {path}")
    idx = mm_utils.sample_frames(len(names), num_frames)
    return [load_image(os.path.join(path, names[i])) for i in idx]


def load_record_media(
    rec: dict, *, media_root: str = "", num_frames: int = 64
) -> tuple[list[np.ndarray], bool]:
    """A dataset record's media -> (frames or images, is_video). The
    training records' schema (train/data.py): "image" is a path or a list
    of paths, "video" a directory of frames (a video file is refused, as
    `load_video_frames` says)."""
    def join(p):
        return os.path.join(media_root, p) if media_root else p

    if rec.get("video") is not None:
        return load_video_frames(join(rec["video"]), num_frames), True
    img = rec.get("image")
    if img is None:
        return [], False
    paths = [img] if isinstance(img, str) else list(img)
    return [load_image(join(p)) for p in paths], False
