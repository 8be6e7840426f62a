"""The port's native loader (oryx_tpu_torch/data/native_loader.py) against
the JAX package's (mirrors tests/test_native_loader.py): the port builds
native/loader.cpp itself into oryx_tpu_torch/_build/, and its fused
preprocess, its batch call into one shared buffer and
`pack_raw_images` (native whenever the library builds) give bytes equal to the JAX package's native
outputs on the same inputs, equal its numpy twin
(`preprocess_reference`, loader.cpp's float32 operations in order) byte
for byte, and agree with the mm_utils path to 1e-4; then the port's
prefetch iterator, the channel check and the text-only batch."""

import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from oryx_tpu.data import mm_utils as jmm  # noqa: E402
from oryx_tpu.data import native_loader as jnative  # noqa: E402
from oryx_tpu.ops import packing as jpacking  # noqa: E402
from oryx_tpu_torch.data import mm_utils  # noqa: E402
from oryx_tpu_torch.data import native_loader  # noqa: E402
from oryx_tpu_torch.ops import packing  # noqa: E402
from oryx_tpu_torch.train.data import PrefetchIterator  # noqa: E402

pytestmark = pytest.mark.skipif(
    not (native_loader.is_available() and jnative.is_available()),
    reason="native loader not built (no C++ compiler)",
)


def _numpy_reference(img, patch, max_patches):
    pre = mm_utils.preprocess_image(img, patch, max_patches)
    return packing.patchify(pre, patch)


def test_library_is_built_in_the_port_build_dir():
    path = native_loader.library_path()
    assert path.exists() and path.parent == native_loader.BUILD_DIR
    assert path.parent.name == "_build"
    assert native_loader._lib._name == str(path)
    assert "native/liboryx_loader.so" not in native_loader._lib._name


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("hw", [(28, 28), (37, 51), (100, 40)])
def test_preprocess_equals_jax_and_numpy(dtype, hw):
    rng = np.random.default_rng(0)
    if dtype == "uint8":
        img = rng.integers(0, 255, size=(*hw, 3), dtype=np.uint8)
    else:
        img = rng.standard_normal((*hw, 3)).astype(np.float32)
    patch = 14
    ref, (h, w) = _numpy_reference(img, patch, 4096)
    oh, ow = mm_utils.resize_to_patch_grid(hw, patch, 4096)
    assert (oh, ow) == jmm.resize_to_patch_grid(hw, patch, 4096)
    got = native_loader.preprocess_image(
        img, (oh, ow), patch, mm_utils.IMAGE_MEAN, mm_utils.IMAGE_STD
    )
    want = jnative.preprocess_image(
        img, (oh, ow), patch, jmm.IMAGE_MEAN, jmm.IMAGE_STD
    )
    assert got.shape == ref.shape == (h * w, patch * patch * 3)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("hw,cap", [((28, 28), 4096), ((37, 51), 4096),
                                    ((300, 200), 64), ((448, 448), 1024),
                                    ((13, 999), 4096)])
def test_preprocess_equals_its_numpy_twin_byte_for_byte(dtype, hw, cap):
    """The twin chip_smoke holds the library against on the card's
    machine: loader.cpp's float32 operations in its order."""
    rng = np.random.default_rng(5)
    if dtype == "uint8":
        img = rng.integers(0, 255, size=(*hw, 3), dtype=np.uint8)
    else:
        img = rng.standard_normal((*hw, 3)).astype(np.float32)
    out_hw = mm_utils.resize_to_patch_grid(hw, 14, cap)
    got = native_loader.preprocess_image(
        img, out_hw, 14, mm_utils.IMAGE_MEAN, mm_utils.IMAGE_STD)
    twin = native_loader.preprocess_reference(
        img, out_hw, 14, mm_utils.IMAGE_MEAN, mm_utils.IMAGE_STD)
    assert got.tobytes() == twin.tobytes()


def test_preprocess_with_downscale_cap():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, size=(300, 200, 3), dtype=np.uint8)
    patch, cap = 14, 64
    ref, grid = _numpy_reference(img, patch, cap)
    oh, ow = mm_utils.resize_to_patch_grid((300, 200), patch, cap)
    got = native_loader.preprocess_image(
        img, (oh, ow), patch, mm_utils.IMAGE_MEAN, mm_utils.IMAGE_STD
    )
    want = jnative.preprocess_image(
        img, (oh, ow), patch, jmm.IMAGE_MEAN, jmm.IMAGE_STD
    )
    assert grid[0] * grid[1] <= cap
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _shared_buffer(mod, imgs, patch, hws, rows):
    buf = np.zeros((sum(rows) + 5, patch * patch * 3), np.float32)
    offs = np.cumsum([0] + rows[:-1]).tolist()
    outs = [buf[o : o + r] for o, r in zip(offs, rows)]
    mod.batch_preprocess(imgs, hws, patch, mm_utils.IMAGE_MEAN,
                         mm_utils.IMAGE_STD, outs=outs, num_threads=3)
    return buf, offs


def test_batch_preprocess_into_shared_buffer():
    rng = np.random.default_rng(2)
    patch = 14
    imgs = [
        rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        for h, w in [(28, 28), (42, 28), (28, 56)]
    ]
    hws = [mm_utils.resize_to_patch_grid(i.shape[:2], patch, 4096)
           for i in imgs]
    rows = [(oh // patch) * (ow // patch) for oh, ow in hws]
    buf, offs = _shared_buffer(native_loader, imgs, patch, hws, rows)
    jbuf, _ = _shared_buffer(jnative, imgs, patch, hws, rows)
    assert buf.tobytes() == jbuf.tobytes()
    for img, o, r in zip(imgs, offs, rows):
        ref, _ = _numpy_reference(img, patch, 4096)
        np.testing.assert_allclose(buf[o : o + r], ref, rtol=1e-4, atol=1e-4)
    assert np.all(buf[sum(rows):] == 0)  # no overrun
    assert native_loader.batch_preprocess([], [], patch, 0.5, 0.5) == []


def test_pack_raw_images_native_equals_jax_and_fallback(monkeypatch):
    rng = np.random.default_rng(3)
    imgs = [
        rng.integers(0, 255, size=(60, 45, 3), dtype=np.uint8),
        rng.integers(0, 255, size=(28, 90, 3), dtype=np.uint8),
    ]
    kw = dict(patch_size=14, base_grid=8, side_factors=[1, 2],
              max_patches=[16, 16], buckets=(64, 256))
    native = packing.pack_raw_images(imgs, **kw)
    jax_native = jpacking.pack_raw_images(imgs, **kw)
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    fallback = packing.pack_raw_images(imgs, **kw)
    assert native.patches.tobytes() == jax_native.patches.tobytes()
    np.testing.assert_allclose(
        native.patches, fallback.patches, rtol=1e-4, atol=1e-4
    )
    for field in ("segment_ids", "region_ids", "pos_coords",
                  "q_segment_ids", "q_region_ids"):
        np.testing.assert_array_equal(
            getattr(native, field), getattr(fallback, field)
        )
        np.testing.assert_array_equal(
            getattr(native, field), getattr(jax_native, field)
        )
    assert native.grids == fallback.grids == jax_native.grids


def test_prefetch_iterator_order_and_errors():
    assert list(PrefetchIterator(iter(range(7)), depth=2)) == list(range(7))

    def boom():
        yield 1
        raise RuntimeError("decode failed")

    it = PrefetchIterator(boom(), depth=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_prefetch_close_stops_infinite_producer():
    it = PrefetchIterator(itertools.count(), depth=1)
    assert next(it) == 0
    it.close()
    assert not it._thread.is_alive()


@pytest.mark.parametrize("native", [False, True])
def test_pack_raw_images_mixed_channels_raises(native, monkeypatch):
    if not native:
        monkeypatch.setattr(native_loader, "is_available", lambda: False)
    rng = np.random.default_rng(4)
    imgs = [
        rng.integers(0, 255, size=(28, 28, 3), dtype=np.uint8),
        rng.integers(0, 255, size=(28, 28, 4), dtype=np.uint8),
    ]
    with pytest.raises(ValueError, match="channels"):
        packing.pack_raw_images(
            imgs, patch_size=14, base_grid=8, buckets=(64, 256)
        )


def test_pack_raw_images_text_only_batch():
    packed = packing.pack_raw_images(
        [], patch_size=14, base_grid=8, buckets=(64, 256)
    )
    assert packed.num_patches == 0 and packed.num_queries == 0
    assert packed.patches.shape == (64, 14 * 14 * 3)
    assert np.all(packed.segment_ids == 0)
    assert packed.grids == []
