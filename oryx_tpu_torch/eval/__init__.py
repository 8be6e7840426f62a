"""Benchmark evaluation: the harness and the benchmark-format adapters
(port of `oryx_tpu.eval`)."""

from oryx_tpu_torch.eval.harness import evaluate, load_task  # noqa: F401
