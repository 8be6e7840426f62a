"""`correct` from a driver's output: no request or step failed, and every
compared number is within its limit."""

from __future__ import annotations

import math


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def verdict(out: dict) -> bool:
    return out["failed"] == 0 and all(
        c["limit"] is None or (finite(c["value"]) and c["value"] <= c["limit"])
        for c in out["checks"].values())
