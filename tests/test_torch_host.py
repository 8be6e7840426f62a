"""Host-side parity of the port with the JAX package: prompt tokenization,
conversation templates (and the tests/goldens file), image preprocessing,
pack_raw_images (numpy path) and build_mm_batch, all byte-equal."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from oryx_tpu import conversation as jconv  # noqa: E402
from oryx_tpu.data import mm_utils as jmm  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import splice as jsplice  # noqa: E402
from oryx_tpu.ops import packing as jpack  # noqa: E402
from oryx_tpu_torch import conversation as tconv  # noqa: E402
from oryx_tpu_torch.data import mm_utils as tmm  # noqa: E402
from oryx_tpu_torch.data import native_loader as tnative  # noqa: E402
from oryx_tpu_torch.models import splice as tsplice  # noqa: E402
from oryx_tpu_torch.ops import packing as tpack  # noqa: E402

GOLDEN_PATH = os.path.join(
    os.path.dirname(__file__), "goldens", "conversation_goldens.json"
)


class CharTokenizer:
    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


@pytest.fixture
def numpy_packing(monkeypatch):
    """Both packages on the numpy preprocessing path (pixels byte-equal)."""
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(tnative, "is_available", lambda: False)


def _images(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            for h, w in shapes]


@pytest.mark.parametrize("prompt", [
    "plain text only",
    "<image>\nwhat is this?",
    "a <image> b <image><image> c",
    "<image>",
    "",
])
def test_tokenizer_image_token_equal(prompt):
    tok = CharTokenizer()
    np.testing.assert_array_equal(
        jmm.tokenizer_image_token(prompt, tok),
        tmm.tokenizer_image_token(prompt, tok),
    )


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_conversation_prompts_equal(name):
    def prompt(mod):
        conv = mod.conv_templates[name].copy()
        conv.append_message(conv.roles[0], "<image>\nhello")
        conv.append_message(conv.roles[1], "hi there")
        conv.append_message(conv.roles[0], "and now?")
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt(), conv.stop_str

    assert prompt(jconv) == prompt(tconv)


def test_conversation_goldens_hold():
    """The port's templates reproduce the checked-in golden prompt strings
    and video sentinel expansions."""
    from test_goldens import RECORDS

    goldens = json.load(open(GOLDEN_PATH))
    for name, case in RECORDS.items():
        conv = tconv.conv_templates[case["template"]].copy()
        role = {"human": conv.roles[0], "gpt": conv.roles[1]}
        for m in case["rec"]["conversations"]:
            conv.append_message(role[m["from"]], m["value"])
        assert conv.get_prompt() == goldens[name]["prompt"], name
    vid = goldens["qwen_1_5/video"]
    for key, sep in (("expanded_plain", ()), ("expanded_sep", (2010,))):
        ids, labels = tsplice.expand_video_sentinels(
            np.asarray(vid["ids"]), 3, labels=np.asarray(vid["labels"]),
            sep_ids=sep,
        )
        want = goldens[f"qwen_1_5/video/{key}"]
        assert ids.tolist() == want["ids"]
        assert labels.tolist() == want["labels"]


@pytest.mark.parametrize("hw,cap", [
    ((40, 56), 256), ((448, 448), 4096), ((1000, 300), 512), ((13, 7), 16),
])
def test_preprocess_image_equal(hw, cap):
    img = _images(1, [hw])[0]
    assert jmm.resize_to_patch_grid(hw, 14, cap) == tmm.resize_to_patch_grid(
        hw, 14, cap
    )
    np.testing.assert_array_equal(
        jmm.preprocess_image(img, 14, cap), tmm.preprocess_image(img, 14, cap)
    )


PACK_CASES = {
    "one_image_1x": ([(40, 56)], 1, 256),
    "two_images_4x": ([(60, 30), (28, 28)], 2, 256),
    "video_16x": ([(42, 42)] * 4, 4, 64),
    "mixed": ([(40, 56), (60, 30), (28, 28)], [1, 2, 4], [256, 256, 64]),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_raw_images_byte_equal(case, numpy_packing):
    shapes, factors, caps = PACK_CASES[case]
    imgs = _images(2, shapes)
    kw = dict(patch_size=14, base_grid=8, side_factors=factors,
              max_patches=caps)
    j = jpack.pack_raw_images(imgs, **kw)
    t = tpack.pack_raw_images(imgs, **kw)
    for field in ("patches", "segment_ids", "region_ids", "pos_coords",
                  "q_segment_ids", "q_region_ids"):
        a, b = getattr(j, field), getattr(t, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    for field in ("grids", "q_grids", "side_factors", "num_patches",
                  "num_queries"):
        assert getattr(j, field) == getattr(t, field), field


def test_pack_text_only_equal():
    kw = dict(patch_size=14, base_grid=8)
    j, t = jpack.pack_raw_images([], **kw), tpack.pack_raw_images([], **kw)
    np.testing.assert_array_equal(j.patches, t.patches)
    assert j.num_patches == t.num_patches == 0


@pytest.mark.parametrize("max_len", [None, 9])
def test_build_mm_batch_equal(max_len, numpy_packing):
    imgs = _images(3, [(40, 56), (60, 30), (28, 28)])
    packed = jpack.pack_raw_images(
        imgs, patch_size=14, base_grid=8, side_factors=[1, 2, 2]
    )
    slots_j = jsplice.query_slots(packed)
    assert slots_j == tsplice.query_slots(packed)
    ids = [
        np.asarray([5, -200, 7, 8], np.int32),
        np.asarray([1, 2, 3], np.int32),
        np.asarray([-200, 4, -200, 9, 9], np.int32),
    ]
    labels = [np.arange(len(r), dtype=np.int32) + 10 for r in ids]
    j = jsplice.build_mm_batch(ids, slots_j, labels=labels, max_len=max_len)
    t = tsplice.build_mm_batch(ids, slots_j, labels=labels, max_len=max_len)
    for field in ("token_ids", "visual_idx", "is_visual", "attn_mask",
                  "positions", "labels", "lengths"):
        a, b = getattr(j, field), getattr(t, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_expand_video_sentinels_equal():
    ids = np.asarray([1, 2, -200, 3], np.int32)
    labels = np.asarray([-100, -100, -100, 3], np.int32)
    for sep in ((), (10,), (10, 11)):
        a = jsplice.expand_video_sentinels(ids, 4, labels=labels, sep_ids=sep)
        b = tsplice.expand_video_sentinels(ids, 4, labels=labels, sep_ids=sep)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_frame_separator_ids_equal():
    tok = CharTokenizer()
    for sep in (None, "", "\n", "<frame>"):
        assert jsplice.frame_separator_ids(tok, sep) == (
            tsplice.frame_separator_ids(tok, sep)
        )


def test_pack_images_byte_equal():
    imgs = [im.astype(np.float32) / 255
            for im in _images(4, [(42, 56), (28, 70), (14, 14)])]
    kw = dict(patch_size=14, base_grid=8, side_factors=[1, 2, 4])
    j, t = jpack.pack_images(imgs, **kw), tpack.pack_images(imgs, **kw)
    for field in ("patches", "segment_ids", "region_ids", "pos_coords",
                  "q_segment_ids", "q_region_ids"):
        np.testing.assert_array_equal(getattr(j, field), getattr(t, field))
    assert j.q_grids == t.q_grids
