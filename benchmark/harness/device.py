"""The card a run uses: its presence, name, power limit and memory peak."""

from __future__ import annotations

import subprocess
import sys

import torch


def require_cards(n: int) -> None:
    """Exit non-zero, printing no result, without n CUDA cards."""
    if not torch.cuda.is_available():
        sys.stderr.write("benchmark: torch.cuda.is_available() is False\n")
        raise SystemExit(3)
    if torch.cuda.device_count() < n:
        sys.stderr.write(f"benchmark: {torch.cuda.device_count()} CUDA "
                         f"device(s), the cell needs {n}\n")
        raise SystemExit(3)


def power_limit() -> str:
    """nvidia-smi's name and power limit of card 0 (for the record)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_record(count: int) -> dict:
    """The result's `device` object: the peak is that of the fullest
    card."""
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": int(peak),
    }
