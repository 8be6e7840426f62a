"""Bounded exponential backoff with deterministic jitter (port of
`oryx_tpu.utils.retry`; stdlib only).

One retry policy for every transient-failure boundary in the stack —
checkpoint saves (utils/checkpoint.py), the HTTP clients the check /
chaos scripts point at a (possibly restarting) server — so "how many
times, how long, growing how fast" is written once and pinned by unit
test instead of re-invented per call site. The same policy and seed give
the reference's delays exactly.

Determinism contract: the full delay schedule is a pure function of
(policy, seed) — `backoff_delays` returns it up front, jitter comes
from a seeded RNG, and `retry_call` takes an injectable `sleep` so
tests assert the exact schedule with zero wall-clock sleeping.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Any, Callable

_LOG = logging.getLogger("oryx.retry")


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """`retries` attempts AFTER the first, delayed base*factor^i each,
    capped at `max_s`, then jittered by ±`jitter` fraction."""

    retries: int = 3
    base_s: float = 0.1
    factor: float = 2.0
    max_s: float = 10.0
    jitter: float = 0.1

    def __post_init__(self):
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.base_s < 0 or self.max_s < 0:
            raise ValueError("delays must be >= 0")
        if self.factor < 1.0:
            raise ValueError(f"factor must be >= 1, got {self.factor}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")


def backoff_delays(policy: BackoffPolicy, *, seed: int = 0) -> list[float]:
    """The exact sleep schedule `retry_call` will use: one delay per
    retry, exponential, capped, deterministically jittered."""
    rng = random.Random(seed)
    out = []
    for i in range(policy.retries):
        d = min(policy.base_s * policy.factor**i, policy.max_s)
        if policy.jitter:
            d *= 1.0 + policy.jitter * (2.0 * rng.random() - 1.0)
        out.append(d)
    return out


def retry_call(
    fn: Callable[[], Any],
    *,
    policy: BackoffPolicy | None = None,
    retry_on: tuple[type[BaseException], ...] = (Exception,),
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    seed: int = 0,
    describe: str = "",
) -> Any:
    """Call `fn` up to 1 + policy.retries times; re-raises the LAST
    exception when the budget is exhausted (bounded — a permanently
    broken dependency fails loudly instead of spinning forever).
    `on_retry(attempt, exc, delay_s)` fires before each sleep."""
    policy = policy or BackoffPolicy()
    delays = backoff_delays(policy, seed=seed)
    for attempt, delay in enumerate(delays + [None]):
        try:
            return fn()
        except retry_on as e:
            if delay is None:
                raise
            _LOG.warning(
                "%s failed (attempt %d/%d): %s; retrying in %.3gs",
                describe or getattr(fn, "__name__", "call"),
                attempt + 1, policy.retries + 1, e, delay,
            )
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)


def urlopen_json(
    url: str,
    *,
    timeout: float = 30.0,
    data: bytes | None = None,
    headers: dict[str, str] | None = None,
    policy: BackoffPolicy | None = None,
    sleep: Callable[[float], None] = time.sleep,
) -> tuple[int, Any, dict[str, str]]:
    """GET/POST `url` and parse the JSON body, retrying connection
    errors per `policy` — the HTTP client the check/chaos scripts use
    to ride out an engine restart window. Returns (status, body,
    headers); HTTP error statuses are returned, not raised, so callers
    can assert on 429/503 responses directly."""
    import json
    import urllib.error
    import urllib.request

    def attempt():
        req = urllib.request.Request(
            url, data=data, headers=headers or {}
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.load(r), dict(r.headers)
        except urllib.error.HTTPError as e:
            body = e.read()
            try:
                parsed = json.loads(body) if body else None
            except ValueError:
                parsed = body.decode(errors="replace")
            return e.code, parsed, dict(e.headers or {})

    return retry_call(
        attempt,
        policy=policy or BackoffPolicy(retries=4, base_s=0.2, max_s=2.0),
        retry_on=(OSError,),
        sleep=sleep,
        describe=f"fetch {url}",
    )
