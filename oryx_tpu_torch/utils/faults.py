"""Deterministic fault injection: named fault points, armed by spec (port
of `oryx_tpu.utils.faults`; the same spec gives the same firing schedule).

Chaos engineering for the serving and training stacks: production code
plants `fault_point("site")` calls at the places that fail in real
fleets (page allocation, prefill/decode dispatch, checkpoint save and
restore, data-loader next, client sockets), and a SPEC — from the
`--faults` CLI flag or the `ORYX_FAULTS` env var — arms a subset of
them to raise, delay, or request corruption on a deterministic,
seeded schedule. Everything the suite asserts about containment
(tests/test_torch_chaos.py) is therefore reproducible run-to-run:
same spec, same seed, same failures at the same hits.

Spec grammar (sites separated by `;`, options by `,`)::

    page_alloc_oom:p=0.05,seed=7;engine_crash:after=40
    decode_dispatch:delay=2.0,after=3;checkpoint_save:times=2

Per-site options:

  * trigger (pick one; default fires on every hit):
      - ``p=<float>``     Bernoulli per hit, from a `seed=`-ed RNG
      - ``after=<n>``     the n+1-th hit fires (count starts at 1:
                          ``after=0`` fires on the first hit)
      - ``every=<n>``     every n-th hit fires
  * ``times=<k>``         cap total firings (default: 1 for `after`,
                          unlimited otherwise)
  * ``seed=<int>``        RNG seed for `p=` (default 0)
  * action (default: raise :class:`FaultInjected`):
      - ``delay=<s>``     sleep `s` seconds instead of raising (hung
                          dispatch / slow I/O simulation)
      - ``corrupt=1``     `fault_point` returns True instead of
                          raising; the call site applies its own
                          corruption (e.g. a NaN batch)

Design rules: dependency-free (stdlib only), and ZERO overhead while
disarmed — `fault_point` is one module-global truthiness check. Call
sites that need a specific exception type pass a factory via ``exc=``
(e.g. the page allocator raises its own `OutOfPagesError`), so this
module never imports the code it tests.

Every firing increments `oryx_faults_injected_total{site=}` in any
registry bound via :func:`bind_registry` (raw-named, like
`oryx_anomaly_total`, so serve and train expose the same family) and
an internal per-site count (:func:`injected_count`) the chaos suite
reconciles against the metric.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time

_LOG = logging.getLogger("oryx.faults")

_ENV_VAR = "ORYX_FAULTS"


class FaultInjected(RuntimeError):
    """Default exception raised by an armed fault point."""

    def __init__(self, site: str):
        self.site = site
        super().__init__(f"injected fault at {site!r}")


class FaultSpecError(ValueError):
    """The fault spec string does not parse."""


class _Site:
    """Armed state of one fault site (guarded by the module lock)."""

    __slots__ = (
        "name", "p", "after", "every", "times", "delay", "corrupt",
        "rng", "hits", "fired",
    )

    def __init__(self, name: str, *, p: float | None, after: int | None,
                 every: int | None, times: int | None, seed: int,
                 delay: float | None, corrupt: bool):
        self.name = name
        self.p = p
        self.after = after
        self.every = every
        # `after` defaults to a single firing: "crash once at hit N,
        # then recover" is the scenario it exists for.
        self.times = times if times is not None else (
            1 if after is not None else None
        )
        self.delay = delay
        self.corrupt = corrupt
        self.rng = random.Random(seed)
        self.hits = 0
        self.fired = 0

    def should_fire(self) -> bool:
        self.hits += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.after is not None:
            if self.hits <= self.after:
                return False
        elif self.every is not None:
            if self.hits % self.every:
                return False
        elif self.p is not None:
            if self.rng.random() >= self.p:
                return False
        self.fired += 1
        return True


def parse_spec(spec: str) -> dict[str, dict[str, float]]:
    """Parse a fault spec into {site: options}; raises FaultSpecError
    with the offending fragment on malformed input (a bad --faults flag
    should fail at startup, never silently disarm a scenario)."""
    out: dict[str, dict[str, float]] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        site, _, opts = part.partition(":")
        site = site.strip()
        if not site or not site.replace("_", "").isalnum():
            raise FaultSpecError(f"bad fault site name {site!r} in {part!r}")
        kv: dict[str, float] = {}
        for opt in opts.split(","):
            opt = opt.strip()
            if not opt:
                continue
            key, eq, val = opt.partition("=")
            key = key.strip()
            if not eq or key not in (
                "p", "seed", "after", "every", "times", "delay", "corrupt"
            ):
                raise FaultSpecError(
                    f"bad fault option {opt!r} for site {site!r} "
                    "(known: p, seed, after, every, times, delay, corrupt)"
                )
            try:
                kv[key] = float(val)
            except ValueError:
                raise FaultSpecError(
                    f"non-numeric value in {opt!r} for site {site!r}"
                ) from None
        if kv.get("p") is not None and not 0.0 <= kv["p"] <= 1.0:
            raise FaultSpecError(
                f"p must be in [0, 1], got {kv['p']} for site {site!r}"
            )
        if site in out:
            raise FaultSpecError(f"site {site!r} appears twice in spec")
        out[site] = kv
    return out


# Module state: `_SITES` is None while disarmed. `_ARMED` is the single
# global the hot path reads — fault_point costs one dict-is-None check
# per call when nothing is configured.
_LOCK = threading.Lock()
_SITES: dict[str, _Site] | None = None
_ARMED = False
_REGISTRIES: list = []  # bound metric registries (weakly-owned)
# Firing observers: fn(site, fired_count) called OUTSIDE the module
# lock on every firing. The decision journal (serve/journal.py) records
# fault firings through this hook; the seeded schedule makes the stream
# of (site, count) pairs reproducible run-to-run, which is what lets
# the replay (serve/replay.py) assert fault-for-fault equality.
_OBSERVERS: list = []


def configure(spec: str | None) -> None:
    """Arm the registry from a spec string; None/'' disarms. Resets all
    hit/fired counts (each scenario starts from a clean schedule)."""
    global _SITES, _ARMED
    with _LOCK:
        if not spec:
            _SITES = None
            _ARMED = False
            return
        parsed = parse_spec(spec)
        sites: dict[str, _Site] = {}
        for name, kv in parsed.items():
            sites[name] = _Site(
                name,
                p=kv.get("p"),
                after=int(kv["after"]) if "after" in kv else None,
                every=int(kv["every"]) if "every" in kv else None,
                times=int(kv["times"]) if "times" in kv else None,
                seed=int(kv.get("seed", 0)),
                delay=kv.get("delay"),
                corrupt=bool(kv.get("corrupt", 0)),
            )
        _SITES = sites
        _ARMED = True
        _LOG.warning("fault injection ARMED: %s", spec)


def configure_from_env() -> bool:
    """Arm from $ORYX_FAULTS when set; returns whether armed. Called
    by a training entry point; the API server reads the same env var
    through its --faults fallback. Never called at import (a
    library import must not arm faults as a side effect)."""
    spec = os.environ.get(_ENV_VAR)
    if spec:
        configure(spec)
    return armed()


def reset() -> None:
    """Disarm and clear counts (test isolation)."""
    global _SITES, _ARMED
    with _LOCK:
        _SITES = None
        _ARMED = False
        _REGISTRIES.clear()
        _OBSERVERS.clear()


def armed() -> bool:
    return _ARMED


def bind_registry(registry) -> None:
    """Publish firings as `oryx_faults_injected_total{site=}` in this
    registry (raw-named: serve and train expose the same family). Safe
    to call disarmed; idempotent per registry."""
    with _LOCK:
        if registry not in _REGISTRIES:
            # Declare the family now so the ladder renders (at zero)
            # before the first firing.
            registry.counter(
                "oryx_faults_injected_total", ("site",), raw_name=True
            )
            _REGISTRIES.append(registry)


def add_observer(fn) -> None:
    """Register `fn(site, fired_count)` to run on every firing (after
    the counters, outside the module lock). Cleared by reset(); safe to
    call disarmed; idempotent per observer."""
    with _LOCK:
        if fn not in _OBSERVERS:
            _OBSERVERS.append(fn)


def remove_observer(fn) -> None:
    with _LOCK:
        if fn in _OBSERVERS:
            _OBSERVERS.remove(fn)


def injected_count(site: str | None = None) -> int:
    """Total firings (optionally one site's) since configure()."""
    with _LOCK:
        if _SITES is None:
            return 0
        if site is not None:
            s = _SITES.get(site)
            return s.fired if s is not None else 0
        return sum(s.fired for s in _SITES.values())


def fault_point(site: str, *, exc=None) -> bool:
    """One named fault site. Disarmed: returns False at the cost of a
    single global read. Armed and scheduled to fire: sleeps (`delay=`),
    returns True (`corrupt=1` — the caller applies the corruption), or
    raises `exc()` (default :class:`FaultInjected`)."""
    if not _ARMED:
        return False
    with _LOCK:
        assert _SITES is not None
        s = _SITES.get(site)
        if s is None or not s.should_fire():
            return False
        delay, corrupt = s.delay, s.corrupt
        registries = list(_REGISTRIES)
        observers = list(_OBSERVERS)
        fired = s.fired
    for reg in registries:
        reg.counter(
            "oryx_faults_injected_total", ("site",), raw_name=True
        ).labels(site=site).inc()
    for fn in observers:
        fn(site, fired)
    _LOG.warning("fault injected at %r (%s)", site,
                 "delay" if delay is not None
                 else "corrupt" if corrupt else "raise")
    if delay is not None:
        # A hung operation, not a failed one: the caller proceeds
        # normally after the stall (False = "do not corrupt").
        time.sleep(delay)
        return False
    if corrupt:
        return True
    raise (exc() if exc is not None else FaultInjected(site))
