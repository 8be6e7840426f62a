#!/usr/bin/env python3
"""Replay a decision journal cold through the port's serving engine
(`oryx_tpu_torch.serve.replay`) and check that it reproduces: byte-equal
replies, decision-for-decision equal streams over the replayed kinds and
equal deterministic cost ledgers; or, with --override, replay the same
workload under altered flags and print the cost/goodput diff.

    python3 scripts/torch_replay_journal.py JOURNAL [--device cpu]
        [--model-path DIR] [--override kv_dtype=int8,prefill_chunk=16]
        [--out report.json]

The default model is the tiny config at a seeded init with the character
tokenizer; a journal captured on another model needs that model
(--model-path, a directory written by serve/builder.py). Exit codes: 0
equal, 2 diverged (the first divergence is printed).
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from oryx_tpu_torch.serve import replay

    return replay.main()


if __name__ == "__main__":
    sys.exit(main())
