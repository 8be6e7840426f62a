"""Seeded SFT records for the training cell, in the LLaVA-mix conversation
schema the port's data pipeline reads (`train/data.py`).

The record sizes (modality, image sizes, question words, answer bytes) and
their order are drawn once from the file's `mix_seed`; the run's `--seed`
picks pixels and words. A record's media are views into one
seeded byte bank at offsets drawn from the seed and the record's index, so
the loader can make them again at any time: the program's loader in its
prefetch thread, and the reference after the window."""

from __future__ import annotations

import numpy as np

from benchmark.traffic import mix


def record_specs(t: dict) -> list[dict]:
    """The cell's records' sizes: kinds in the file's shares exactly."""
    n = t["records"]
    r = mix.rng(t["mix_seed"], n)
    kinds = []
    for kind, share in t["shares"].items():
        kinds += [kind] * int(round(share * n))
    kinds = (kinds + ["image"] * n)[:n]
    specs = []
    for kind in kinds:
        if kind == "image":
            sizes = [mix._image_size(r, t["image_side"], t["aspects"])]
        elif kind == "multi_image":
            m = int(r.integers(t["multi_images"][0], t["multi_images"][1] + 1))
            sizes = [mix._image_size(r, t["image_side"], t["aspects"])
                     for _ in range(m)]
        else:
            side = int(r.integers(t["frame_side"][0], t["frame_side"][1] + 1))
            sizes = [(side, side)] * t["video_frames"]
        specs.append({
            "kind": kind, "sizes": sizes,
            "words": int(r.integers(t["question_words"][0],
                                    t["question_words"][1] + 1)),
            "answer_bytes": mix.log_uniform_int(r, *t["answer_tokens"]),
        })
    return specs


class Records:
    """The run's records and their media loader."""

    def __init__(self, t: dict, seed: int) -> None:
        specs = record_specs(t)
        # The records' order is the file's: each step's batch is the same
        # for every seed (the step's work sets the rate).
        order = mix.rng(t["mix_seed"], 1).permutation(len(specs))
        self.specs = [specs[int(i)] for i in order]
        self.seed = seed
        self.bank = mix.Bank(seed)
        r = mix.rng(seed, 2)
        self.records = []
        for i, s in enumerate(self.specs):
            n_media = 1 if s["kind"] == "video" else len(s["sizes"])
            rec = {
                "id": str(i),
                "conversations": [
                    {"from": "human",
                     "value": "<image>\n" * n_media
                     + mix.question(r, s["words"])},
                    {"from": "gpt",
                     "value": mix.text_of_bytes(r, s["answer_bytes"])},
                ],
            }
            if s["kind"] == "video":
                rec["video"] = f"video-{i}"
            else:
                rec["image"] = [f"image-{i}-{j}" for j in range(n_media)]
            self.records.append(rec)
        self.loaded: list[int] = []

    def media(self, rec: dict) -> list[np.ndarray]:
        """The record's images or frames (views of the bank)."""
        i = int(rec["id"])
        r = mix.rng(self.seed, 3, i)
        out = []
        for h, w in self.specs[i]["sizes"]:
            n = h * w * 3
            off = int(r.integers(0, mix.BANK_BYTES - n + 1))
            out.append(self.bank.buf[off:off + n].reshape(h, w, 3))
        return out

    def loader(self, rec: dict) -> list[np.ndarray]:
        """The program's media loader: also logs the order records are
        read in, which is the order they enter batches."""
        self.loaded.append(int(rec["id"]))
        return self.media(rec)
