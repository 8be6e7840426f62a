"""Seeded request mixes for the serving cells, made from a workload file's
`traffic` parameters.

Each cell's set of request sizes is drawn once from the file's `mix_seed`,
so every run does the same work; the run's `--seed` picks the pixels and
words, and orders the requests where the driver lets it (an open loop's
schedule, sizes and arrival gaps in their order, is the file's alone: its
tails follow the order). Media are views
into one random byte bank (each image or frame a slice of it at its own
offset), so making a few hundred images costs one draw."""

from __future__ import annotations

import math

import numpy as np

SYLLABLES = ("ka", "lo", "mi", "ter", "san", "vo", "ri", "pel", "du", "zen",
             "ash", "ob", "nu", "qua", "fi", "gor", "ye", "hal", "tis", "mon")
BANK_BYTES = 64 << 20
WORD_BYTES = 6  # a word and its space, on average (English)
# Tokens the chat template adds around a text question (its byte length).
TEMPLATE_TOKENS = len(
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
    "<|im_start|>user\n<|im_end|>\n<|im_start|>assistant\n".encode())


def rng(*keys: int) -> np.random.Generator:
    return np.random.default_rng([int(k) % (1 << 63) for k in keys])


def poisson_gaps(n: int, rate: float, seconds: float,
                 order: np.random.Generator) -> np.ndarray:
    """n inter-arrival gaps of an open Poisson loop: the exponential law's
    n mid-quantiles, scaled to sum to `seconds`, in a seeded order."""
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    gaps *= seconds / gaps.sum()
    return gaps[order.permutation(n)]


def arrivals(n: int, rate: float, seconds: float,
             order: np.random.Generator) -> np.ndarray:
    """Due times (s after the window opens) of n requests: the first at
    0, then the gaps."""
    gaps = poisson_gaps(n, rate, seconds, order)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def words(r: np.random.Generator, n: int) -> str:
    out = []
    for _ in range(n):
        k = int(r.integers(1, 4))
        out.append("".join(SYLLABLES[int(i)] for i in
                           r.integers(0, len(SYLLABLES), k)))
    return " ".join(out)


def text_of_bytes(r: np.random.Generator, nbytes: int) -> str:
    """ASCII text of exactly `nbytes` bytes (tokens, for a byte tokenizer):
    words and spaces."""
    s = words(r, nbytes // 3 + 2)
    return s[:nbytes]


def question(r: np.random.Generator, n_words: int) -> str:
    """A question of n_words words' worth of text: WORD_BYTES a word, so
    that its length (tokens) is the same for every seed."""
    return text_of_bytes(r, WORD_BYTES * n_words)


def log_uniform_int(r: np.random.Generator, lo: int, hi: int) -> int:
    return int(round(math.exp(r.uniform(math.log(lo), math.log(hi)))))


def _image_size(r, side, aspects):
    """(h, w) with the long side in [side] at one of the aspect ratios
    (w:h)."""
    long = int(r.integers(side[0], side[1] + 1))
    aw, ah = aspects[int(r.integers(len(aspects)))]
    if aw >= ah:
        w, h = long, max(1, round(long * ah / aw))
    else:
        h, w = long, max(1, round(long * aw / ah))
    return h, w


def visual_qa_specs(t: dict, n: int) -> list[dict]:
    """The cell's n request sizes (no pixels): kind, image sizes, question
    words, max_new. Kinds come in the file's shares exactly."""
    r = rng(t["mix_seed"], n)
    kinds = []
    for kind, share in t["shares"].items():
        kinds += [kind] * int(round(share * n))
    kinds = (kinds + ["image"] * n)[:n]
    specs = []
    for kind in kinds:
        if kind == "image":
            sizes = [_image_size(r, t["image_side"], t["aspects"])]
        elif kind == "multi_image":
            m = int(r.integers(t["multi_images"][0], t["multi_images"][1] + 1))
            sizes = [_image_size(r, t["image_side"], t["aspects"])
                     for _ in range(m)]
        elif kind == "video":
            side = int(r.integers(t["frame_side"][0], t["frame_side"][1] + 1))
            aw, ah = t["aspects"][int(r.integers(len(t["aspects"])))]
            h, w = (side, round(side * aw / ah)) if aw < ah else \
                (round(side * ah / aw), side)
            sizes = [(h, w)] * t["video_frames"]
        else:
            raise ValueError(f"unknown request kind {kind!r}")
        specs.append({
            "kind": kind, "sizes": sizes,
            "words": int(r.integers(t["question_words"][0],
                                    t["question_words"][1] + 1)),
            "max_new": int(r.integers(t["max_new"][0], t["max_new"][1] + 1)),
        })
    return specs


def text_specs(t: dict, n: int) -> list[dict]:
    """n text requests: prompt tokens (the template's included) and
    max_new, each log-uniform."""
    r = rng(t["mix_seed"], n)
    return [{
        "kind": "text", "sizes": [],
        "prompt_bytes": log_uniform_int(r, *t["prompt_tokens"]),
        "max_new": log_uniform_int(r, *t["max_new"]),
    } for _ in range(n)]


def specs(t: dict, n: int) -> list[dict]:
    """n request sizes of the file's generator ("visual_qa" or "text")."""
    return {"visual_qa": visual_qa_specs, "text": text_specs}[
        t["generator"]](t, n)


class Bank:
    """Random pixels: every image a view of one seeded byte buffer."""

    def __init__(self, seed: int) -> None:
        self.r = rng(seed, 7)
        self.buf = self.r.integers(0, 256, BANK_BYTES, dtype=np.uint8)

    def image(self, h: int, w: int) -> np.ndarray:
        n = h * w * 3
        if n > BANK_BYTES:
            raise ValueError(f"image {h}x{w} is larger than the bank")
        off = int(self.r.integers(0, BANK_BYTES - n + 1))
        return self.buf[off:off + n].reshape(h, w, 3)


def materialize(specs: list[dict], seed: int,
                order_seed: int | None = None) -> list[dict]:
    """The requests of `specs` with pixels and words from `seed`, in the
    order `order_seed` draws (the run's seed when None): [{"request":
    engine request dict, "max_new", "kind"}]."""
    order = rng(seed if order_seed is None else order_seed,
                1).permutation(len(specs))
    bank = Bank(seed)
    r = rng(seed, 2)
    out = []
    for i in order:
        s = specs[int(i)]
        if s["kind"] == "text":
            req = {"question": text_of_bytes(
                r, max(1, s["prompt_bytes"] - TEMPLATE_TOKENS))}
        else:
            req = {"question": question(r, s["words"]),
                   "images": [bank.image(h, w) for h, w in s["sizes"]],
                   "is_video": s["kind"] == "video"}
        out.append({"request": req, "max_new": s["max_new"],
                    "kind": s["kind"]})
    return out
