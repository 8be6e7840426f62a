"""The port's image loading (data/media.py): its PNG reader, on zlib and
numpy, is byte-equal to PIL's decode on seeded random images in every mode
it covers (8-bit gray, gray + alpha, RGB, RGBA; palette at 1, 2, 4 and 8
bits; 1-bit gray), with each of the five scanline filters forced in turn
and with filters chosen per row as PIL and chip_smoke's `encode_png`
choose them; decoding goes through PIL where it is installed; images
above PIL's decompression-bomb limit are refused without PIL too; and
frame directories load in natural order."""

import io
import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from chip_smoke import encode_png  # noqa: E402

from oryx_tpu_torch.data import media  # noqa: E402


def _pil_png(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _want(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _image(mode, rng, h, w):
    if mode in ("P8", "P4", "P2", "P1"):
        ncol = {"P8": 200, "P4": 16, "P2": 4, "P1": 2}[mode]
        im = Image.fromarray(
            rng.integers(0, ncol, (h, w), dtype=np.uint8), "P")
        im.putpalette(rng.integers(0, 256, ncol * 3, dtype=np.uint8)
                      .tolist())
        return im
    if mode == "1":
        return Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    arr = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
    # Smooth content makes the encoder pick the predicting filters.
    arr = np.cumsum(arr // 16, axis=1).astype(np.uint8)
    return Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)


MODES = ["L", "LA", "RGB", "RGBA", "P8", "P4", "P2", "P1", "1"]


@pytest.mark.parametrize("mode", MODES)
def test_png_reader_equals_pil(mode):
    rng = np.random.default_rng(MODES.index(mode))
    for _ in range(4):
        h, w = (int(x) for x in rng.integers(1, 48, 2))
        data = _pil_png(_image(mode, rng, h, w))
        got = media.decode_png(data)
        want = _want(data)
        assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("filt", range(5))
@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_each_filter_equals_pil(filt, ctype):
    rng = np.random.default_rng(10 * filt + ctype)
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    data = encode_png(
        rng.integers(0, 256, (9, 13, bpp), dtype=np.uint8), filt)
    assert np.array_equal(media.decode_png(data), _want(data))


def _filters(data: bytes, height: int) -> set:
    """The scanline filter types of a PNG's rows."""
    rows = zlib.decompress(b"".join(
        data[i + 8:i + 8 + struct.unpack(">I", data[i:i + 4])[0]]
        for i in _chunks(data, b"IDAT")))
    return set(np.frombuffer(rows, np.uint8).reshape(height, -1)[:, 0])


def _chunks(data: bytes, kind: bytes):
    pos = len(media.PNG_SIGNATURE)
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == kind:
            yield pos
        pos += 12 + n


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_adaptive_encoder_round_trips_like_pil(channels):
    """encode_png's per-row choice mixes filters on photo-like content,
    as PIL's does, and both readers give the image back."""
    rng = np.random.default_rng(channels)
    y, x = np.mgrid[0:40, 0:52]
    img = np.stack([(x + y) * 3, x * 5, y * 7, x * y], -1)[..., :channels]
    img = (img + rng.integers(0, 6, img.shape)).astype(np.uint8)
    img = img[..., 0] if channels == 1 else img
    ours = encode_png(img)
    pils = _pil_png(Image.fromarray(img))
    assert len(_filters(ours, 40)) > 1 and len(_filters(pils, 40)) > 1
    for data in (ours, pils):
        got = media.decode_png(data)
        assert np.array_equal(got, _want(data))
        if channels == 3:
            assert np.array_equal(got, img)


def test_bombs_are_refused_and_idat_is_inflated_no_further(monkeypatch):
    import tracemalloc

    from torch_serve_common import bomb_png

    bomb = bomb_png()
    with pytest.raises(ValueError, match="outside"):
        media.decode_png(bomb)
    with pytest.raises(Image.DecompressionBombError):
        media.decode_image(bomb)
    # A small image over 64 MiB of compressed zeros: only the bytes its
    # header declares are inflated.
    small = bomb_png(64, 64, 64 << 20)
    tracemalloc.start()
    try:
        got = media.decode_png(small)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert got.shape == (64, 64, 3) and not got.any()
    assert peak < 4 << 20
    _hide_pil(monkeypatch)
    with pytest.raises(ValueError, match="outside"):
        media.decode_image(bomb)


def _hide_pil(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)


def test_other_formats_go_through_pil_or_raise(monkeypatch, tmp_path):
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    bmp = io.BytesIO()
    Image.fromarray(arr).save(bmp, format="BMP")
    assert np.array_equal(media.decode_image(bmp.getvalue()), arr)
    sixteen = _pil_png(Image.fromarray(
        rng.integers(0, 65535, (5, 6), dtype=np.uint16)))
    with pytest.raises(ValueError, match="16-bit"):
        media.decode_png(sixteen)
    assert np.array_equal(media.decode_image(sixteen), _want(sixteen))
    # Where PIL is installed it decodes PNG too, as the reference does.
    monkeypatch.setattr(media, "decode_png", None)
    png = _pil_png(Image.fromarray(arr))
    assert np.array_equal(media.decode_image(png), arr)
    monkeypatch.undo()
    _hide_pil(monkeypatch)
    with pytest.raises(ValueError, match="needs PIL"):
        media.decode_image(bmp.getvalue())
    # Without PIL, PNG still decodes.
    assert np.array_equal(media.decode_image(png), arr)
    path = tmp_path / "x.png"
    path.write_bytes(png)
    assert np.array_equal(media.load_image(str(path)), arr)


def test_frame_directory_in_natural_order(tmp_path):
    for i in (10, 2, 1):
        Image.fromarray(np.full((4, 4, 3), i, np.uint8)).save(
            tmp_path / f"frame_{i}.png")
    frames = media.load_video_frames(str(tmp_path), 3)
    assert [int(f[0, 0, 0]) for f in frames] == [1, 2, 10]
    with pytest.raises(ValueError, match="directory of frame"):
        media.load_video_frames(str(tmp_path / "frame_1.png"), 2)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        media.load_video_frames(str(tmp_path / "empty"), 2)
