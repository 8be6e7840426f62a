"""Tiny CPU versions of the cells for the harness's tests: the drivers run
whole (set-up, window, check) on the port's plain CPU path."""

from __future__ import annotations

import json
import time

from benchmark.harness import spec


class Ctx:
    def __init__(self, workload, config, seed, seconds, trace=False,
                 control=False):
        self.workload, self.config = workload, config
        self.seed, self.seconds = seed, seconds
        self.trace, self.control, self.device = trace, control, "cpu"
        self.t_start = time.perf_counter()
        self.setup_s = None

    def mark_setup(self):
        self.setup_s = time.perf_counter() - self.t_start

    def device_record(self):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}


def tiny_oryx() -> dict:
    from oryx_tpu_torch import config

    d = json.loads(config.oryx_tiny().to_json())
    d["vision"]["max_patches_per_image"] = 256
    return d


def video_qa():
    w = spec.workload("oryx-7b.video-qa")
    w["engine"] = dict(w["engine"], num_slots=4, max_ctx=1024,
                       prefill_chunk=64)
    w["traffic"] = dict(w["traffic"], backlog=24, steady_s=0.5,
                        image_side=[56, 200], frame_side=[28, 84],
                        video_frames=8, question_words=[4, 8],
                        max_new=[4, 12])
    w["check"] = dict(w["check"], sample=3)
    w["trace_seconds"] = 1.0
    return w, {"oryx": tiny_oryx()}


def open_loop():
    """The visual mix offered on an open Poisson schedule
    (`drivers/serve_open.py`, the driver of later open-loop cells)."""
    w, c = video_qa()
    w["driver"] = "serve_open"
    w["traffic"] = dict(w["traffic"], rate_per_s=1.0)
    return w, c


def chat_backlog():
    w = spec.workload("oryx-7b.chat-backlog")
    w["engine"] = dict(w["engine"], num_slots=4, max_ctx=512,
                       prefill_chunk=64)
    w["traffic"] = dict(w["traffic"], backlog=40, prompt_tokens=[120, 200],
                        max_new=[8, 40], steady_s=0.5)
    w["check"] = dict(w["check"], sample=3)
    w["trace_seconds"] = 1.0
    return w, {"oryx": tiny_oryx()}


def sft(name: str):
    w = spec.workload(name)
    cfg = tiny_oryx()
    big = spec.config(w["config"])["oryx"]
    cfg["train"] = dict(big["train"], global_batch_size=4,
                        grad_accum_steps=2, max_seq_len=2048)
    w["traffic"] = dict(w["traffic"], records=48, image_side=[56, 200],
                        frame_side=[28, 84], video_frames=8,
                        question_words=[4, 8], answer_tokens=[16, 64])
    w["trace_seconds"] = 1.0
    # The tiny model trains in float32 (its first moment in bf16): sound
    # runs read loss ~1e-7, first gradient ~1e-3, change ~2e-2 (CPU).
    w["check"] = {"loss_rel": 1e-4, "grad_leaf": 2e-2, "change_leaf": 8e-2}
    return w, {"oryx": cfg}
