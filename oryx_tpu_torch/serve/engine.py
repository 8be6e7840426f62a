"""The Engine interface: what the serving tier runs behind (port of
`oryx_tpu.serve.engine`).

  * `Engine` - the structural protocol. submit/cancel for the request
    path; queue_len/alive/readiness for the health surface; begin_drain/
    drain/stop for the shutdown ladder; restart/set_supervised for the
    EngineSupervisor. Anything satisfying it is drop-in behind the API
    server and the supervisor.
  * `register_engine` / `create_engine` - the factory registry keyed by
    the `--engine` flag. The server passes its metrics registry, tracer
    and anomaly monitor in, so every engine reports through the SAME
    `ServingMetrics` the server renders at /metrics.

Registered shapes:

  * `continuous` - `ContinuousScheduler` over one pipeline on one device.
  * `sharded` - the same scheduler over a tensor-parallel pipeline
    (`Pipeline(mesh=)`, parallel/): every dispatch runs on every rank's
    shard; refuses a pipe without a tp mesh.

(The window Batcher stays a special case inside api_server: it has no
admission queue, drain ladder or supervisor hooks to conform with.)
"""

from __future__ import annotations

from typing import Any, Callable, Protocol, runtime_checkable


@runtime_checkable
class Engine(Protocol):
    """Structural contract every serving engine satisfies (the continuous
    scheduler is the reference implementation).

    Request path: `submit` returns a handle whose `events` queue / `done`
    event the HTTP layer consumes; it raises AdmissionRejected
    (scheduler.py) instead of queueing when shedding. `cancel` releases a
    request wherever it lives. Health: `alive` is the loop-thread bit,
    `readiness` the (ready, reason) /readyz signal, `queue_len` the
    admission-queue depth. Shutdown: `begin_drain` stops admission now,
    `drain` waits for residents, `stop` ends the loop. Supervision:
    `restart` revives a dead loop with replay; `set_supervised` tells
    submit whether anyone will revive a dead engine. `metrics` is the
    bound ServingMetrics."""

    metrics: Any

    def submit(
        self,
        request: dict[str, Any],
        max_new: int,
        sampling: dict[str, Any] | None = None,
        *,
        streaming: bool = False,
        timeout_s: float | None = None,
        request_id: str | None = None,
        routed: bool = False,
    ) -> Any: ...

    def cancel(self, handle: Any) -> None: ...

    def queue_len(self) -> int: ...

    def alive(self) -> bool: ...

    def readiness(self) -> tuple[bool, str]: ...

    def begin_drain(self) -> None: ...

    def drain(self, timeout: float | None = 60.0) -> bool: ...

    def stop(self) -> None: ...

    def restart(self) -> None: ...

    def set_supervised(self, value: bool) -> None: ...

    def fail_inflight(self, msg: str, *, kind: str = "unavailable"
                      ) -> None: ...

    @property
    def draining(self) -> bool: ...

    @property
    def stopping(self) -> bool: ...


# name -> factory(pipe, **kwargs) -> Engine. Unknown names fail at server
# construction with the registered choices.
ENGINES: dict[str, Callable[..., Engine]] = {}


def register_engine(name: str):
    """Decorator: register a factory under an `--engine` name."""

    def deco(fn: Callable[..., Engine]):
        if name in ENGINES:
            raise ValueError(f"engine {name!r} already registered")
        ENGINES[name] = fn
        return fn

    return deco


def engine_names() -> list[str]:
    return sorted(ENGINES)


def create_engine(name: str, pipe, **kwargs) -> Engine:
    """Build the named engine around `pipe`, binding the server's metrics,
    tracer and anomaly monitor passed in kwargs."""
    factory = ENGINES.get(name)
    if factory is None:
        raise ValueError(
            f"unknown engine {name!r} (registered: {', '.join(engine_names())})"
        )
    return factory(pipe, **kwargs)


@register_engine("continuous")
def _continuous(pipe, **kwargs) -> Engine:
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    return ContinuousScheduler(pipe, **kwargs)


@register_engine("sharded")
def _sharded(pipe, **kwargs) -> Engine:
    """Tensor-parallel continuous engine: the same scheduler, with the
    mesh made a REQUIREMENT. Each rank holds its KV heads of the pool
    (scheduler._place_kv) and runs every dispatch on its shard
    (parallel/tp.py); construction fails when the pipe has no mesh, the
    mesh has no tp width, or the KV heads don't divide - a deployment
    asking for sharded serving must never silently fall back to one
    device."""
    from oryx_tpu_torch.parallel.mesh import axis_sizes
    from oryx_tpu_torch.parallel.sharding import paged_kv_spec
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    mesh = getattr(pipe, "mesh", None)
    if mesh is None:
        raise ValueError(
            "--engine sharded needs a multi-device pipeline: pass "
            "--shard tp=N (mesh absent)"
        )
    if paged_kv_spec(mesh) is None:
        raise ValueError(
            f"--engine sharded needs a tp axis > 1 on the mesh, got "
            f"axes {axis_sizes(mesh)!r} (use --shard tp=N)"
        )
    heads = pipe.cfg.llm.num_kv_heads
    tp = axis_sizes(mesh)["tp"]
    if heads % tp:
        raise ValueError(
            f"--engine sharded: {heads} KV heads do not divide over tp={tp}"
        )
    return ContinuousScheduler(pipe, **kwargs)
