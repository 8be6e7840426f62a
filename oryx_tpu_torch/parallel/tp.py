"""Tensor-parallel ranks: one process per rank, rank 0 the controller.

JAX serves a mesh from one controller and GSPMD inserts the collectives.
Here every rank is a process of its own (`torch.distributed`), so the
collectives are written out and the ranks are kept in step by hand:

  * Rank 0 owns every host decision (the scheduler, the page allocator,
    the prefix cache, the journal, the HTTP server, sampling state). Each
    call it makes into the model's device code is a DISPATCH: `World.call`
    broadcasts a descriptor (the function, its arguments) to the followers
    and then runs the function itself.
  * Ranks 1..N-1 are followers: `World.serve` receives each descriptor and
    runs the same function on the rank's own shard of the weights and of
    the paged pool, and returns nothing. A follower makes no decision.
  * Arguments cross by value (tensors as bytes, put back on the follower's
    own device; generators as their state), except rank-local objects -
    a pipeline, its model, a pool, a session's cache - which cross as
    HANDLES: an object a dispatch made with `bind=` is registered under
    the same number on every rank, and each rank resolves the number to
    its own object. A handle is dropped on the followers when rank 0's
    object is collected (or `release`d).
  * Inside a dispatch the model meets the other ranks only in
    `all_reduce`: the sum after each row-parallel product and the max of
    a quantized pool's row amax. Logits are whole on every rank and
    bitwise equal (every rank receives the same reduced bytes), so the
    followers' sampling repeats rank 0's.

After each dispatch the ranks exchange an error flag: an error every rank
raised (argument validation) is re-raised on rank 0 and the ranks go on;
ranks that disagree, or a collective that times out or loses its peer,
leave the world broken, and every later call raises.

Layouts: every rank on a card of its own (NCCL), every rank on one shared
card, or every rank on the CPU (gloo; NCCL refuses two ranks on one
card). Any other layout is refused at start. The descriptors always
travel over a gloo group of their own, whose receive waits as long as the
server idles; every other collective has the world's timeout. Ranks that
share one card do not send activations through gloo's sockets (a 117 MB
sum took 264 ms that way on an H100 host): each rank copies its partial
into an exchange buffer on the card, the ranks meet at a barrier spun on
a memory-mapped file, and each rank adds every rank's buffer, opened
through CUDA IPC, in rank order (`SHARED_CARD` counts them).
"""

from __future__ import annotations

import atexit
import hashlib
import io
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from collections import deque
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DEFAULT_TIMEOUT_S = 120.0
# The most payload bytes a rank puts through the shared card's exchange
# buffers in one turn of a training collective.
EXCHANGE_BYTES = 256 << 20
# The descriptor channel waits as long as the server idles.
_IDLE_WAIT = timedelta(days=7)

# Collectives reduced through the shared card's exchange buffers: calls,
# the bytes this rank contributed, and the host seconds from entry to
# return (the wait for the partial product and for the peers included).
SHARED_CARD = {"calls": 0, "bytes": 0, "seconds": 0.0}

# The training collectives (`World.all_gather`, `reduce_scatter`, `sum`,
# `shift`), whatever the layout: per kind, calls, the bytes this rank
# contributed and the host seconds from entry to return.
COLLECTIVES = {kind: {"calls": 0, "bytes": 0, "seconds": 0.0}
               for kind in ("all_gather", "reduce_scatter", "sum", "shift")}


def reset_collectives() -> None:
    """Zero this process's COLLECTIVES counts."""
    for row in COLLECTIVES.values():
        row.update(calls=0, bytes=0, seconds=0.0)


def _align(n: int) -> int:
    return -(-n // 16) * 16


def _pack(tensors, device) -> tuple[torch.Tensor, list]:
    """Tensors -> one uint8 payload (each at a 16-byte offset) and the
    layout (offset, dtype, shape) to read them back."""
    layout, off = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        layout.append((off, t.dtype, tuple(t.shape)))
        off += _align(n)
    buf = torch.empty(max(off, 16), dtype=torch.uint8, device=device)
    for t, (o, _, _) in zip(tensors, layout):
        n = t.numel() * t.element_size()
        if n:
            buf[o:o + n].copy_(t.contiguous().reshape(-1).view(torch.uint8))
    return buf, layout


def _unpack(raw: torch.Tensor, layout) -> list[torch.Tensor]:
    out = []
    for off, dtype, shape in layout:
        n = int(np.prod(shape, dtype=np.int64)) * torch.empty(
            (), dtype=dtype).element_size()
        out.append(raw[off:off + n].view(dtype).view(shape))
    return out

_TLS = threading.local()
_WORLD: "World | None" = None


class WorldBroken(RuntimeError):
    """A rank failed out of step, a collective timed out or a peer died:
    the ranks can no longer be trusted to be in step."""


def choose_backend(devices: list[torch.device]) -> str:
    """NCCL when every rank has a CUDA device of its own; gloo when every
    rank shares one card or runs on the CPU. A stated rule: NCCL refuses
    two ranks on one card, and this never waits to find that out. Any
    other layout (ranks on the CPU and on a card, or some ranks sharing a
    card and some not) raises ValueError naming it."""
    types = {d.type for d in devices}
    cards = {d.index for d in devices}
    if types == {"cpu"}:
        return "gloo"
    if types == {"cuda"} and len(cards) == len(devices):
        return "nccl"
    if types == {"cuda"} and len(cards) == 1:
        return "gloo"
    raise ValueError(
        f"tp ranks on {', '.join(str(d) for d in devices)}: every rank "
        "needs a card of its own, or all share one card, or all run on "
        "the CPU")


def default_devices(n: int, device) -> list[torch.device]:
    """Rank r's device for `device` ("cuda" or "cpu"): cuda:(r %
    device_count), or the CPU. "cuda" without a card raises, as
    models/params.resolve_device does."""
    from oryx_tpu_torch.models.params import resolve_device

    if resolve_device(device).type == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(n)]


def inside() -> bool:
    """True while this thread runs a dispatch (on any rank): nested calls
    run locally."""
    return getattr(_TLS, "depth", 0) > 0


class _Inside:
    def __enter__(self):
        _TLS.depth = getattr(_TLS, "depth", 0) + 1

    def __exit__(self, *exc):
        _TLS.depth -= 1


def _tensor_payload(t: torch.Tensor):
    t = t.detach()
    flat = t.to("cpu").contiguous().reshape(-1)
    raw = flat.view(torch.uint8) if flat.numel() else flat.to(torch.uint8)
    return (str(t.dtype).removeprefix("torch."), tuple(t.shape),
            raw.numpy().copy())


def _tensor_from(dtype: str, shape, raw: np.ndarray) -> torch.Tensor:
    dt = getattr(torch, dtype)
    flat = torch.from_numpy(raw.copy())
    if raw.size == 0:
        return torch.empty(shape, dtype=dt)
    return flat.view(dt).reshape(shape)


class _Pickler(pickle.Pickler):
    def __init__(self, f, world: "World"):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.world = world

    def persistent_id(self, obj):
        w = self.world
        if obj is w:
            return ("w",)
        ref = w._by_id.get(id(obj))
        if ref is not None and ref[0]() is obj:
            return ("h", ref[1], ref[2])
        if isinstance(obj, torch.Generator):
            return ("g", obj.device.type != "cpu", obj.get_state().numpy())
        if isinstance(obj, nn.Parameter):
            raise pickle.PicklingError(
                "a parameter crossed a dispatch by value: pass the "
                "registered module that owns it")
        if isinstance(obj, torch.Tensor):
            return ("t", obj.device.type != "cpu") + _tensor_payload(obj)
        if isinstance(obj, torch.device):
            return ("d", obj == w.device, str(obj))
        return None


class _Unpickler(pickle.Unpickler):
    def __init__(self, f, world: "World"):
        super().__init__(f)
        self.world = world

    def persistent_load(self, pid):
        w = self.world
        kind = pid[0]
        if kind == "w":
            return w
        if kind == "h":
            obj = w._objs[pid[1]]
            return obj.get_submodule(pid[2]) if pid[2] else obj
        if kind == "g":
            dev = w.device if pid[1] else torch.device("cpu")
            g = torch.Generator(device=dev)
            g.set_state(torch.from_numpy(pid[2].copy()))
            return g
        if kind == "t":
            t = _tensor_from(*pid[2:])
            return t.to(w.device) if pid[1] else t
        if kind == "d":
            return w.device if pid[1] else torch.device(pid[2])
        raise pickle.UnpicklingError(f"unknown persistent id {kind!r}")


def _digest_update(h, obj) -> None:
    """Fold the integer content of a dispatch's result (tokens, counts,
    replies) into `h`; float tensors and rank-local objects are skipped."""
    if isinstance(obj, (str, int, bool)) or obj is None:
        h.update(repr(obj).encode())
    elif isinstance(obj, torch.Tensor):
        if not obj.is_floating_point():
            h.update(obj.detach().to("cpu").contiguous().numpy().tobytes())
    elif isinstance(obj, np.ndarray):
        if obj.dtype.kind in "iub":
            h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _digest_update(h, x)


class _HostBarrier:
    """A barrier of the ranks on one host: each rank bumps its own
    counter in a memory-mapped file (one 64-byte line a rank) and spins
    until every counter reaches its own. `alive` is polled while it
    spins; past `timeout_s` the barrier raises."""

    def __init__(self, path: str, rank: int, size: int):
        self.rank = rank
        self.lines = np.memmap(path, dtype=np.int64, mode="r+",
                               shape=(size, 8))
        self.count = 0

    @staticmethod
    def create(path: str, size: int) -> None:
        with open(path, "wb") as f:
            f.write(bytes(64 * size))

    def wait(self, timeout_s: float, alive=None) -> None:
        self.count += 1
        self.lines[self.rank, 0] = self.count
        col = self.lines[:, 0]
        deadline = None
        spins = 0
        while (col < self.count).any():
            spins += 1
            if spins % 1024 == 0:
                now = time.monotonic()
                deadline = deadline or now + timeout_s
                if alive is not None:
                    alive()
                if now > deadline:
                    raise WorldBroken(
                        f"barrier {self.count} timed out after {timeout_s} s")
                time.sleep(0)


class World:
    """This process's place among the tensor-parallel ranks: its rank, the
    world size, its device, the collective groups and (on rank 0) the
    follower processes it started."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str, timeout_s: float, procs=None):
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.timeout_s = timeout_s
        self.group = None  # the default group
        self.ctl = self.ctl_timed = None
        self._procs = list(procs or [])
        # Rank 0: every rank's device and the rendezvous directory.
        self.devices = [device]
        self.tmpdir: str | None = None
        self._lock = threading.RLock()
        self._objs: dict[int, object] = {}
        self._by_id: dict[int, tuple] = {}
        self._next = 1
        self._drops: deque[int] = deque()
        self._digest = hashlib.sha256()
        self.broken: str | None = None
        # Ranks sharing one card: the host barrier and the exchange
        # buffers (two a rank, alternating, so one barrier a sum keeps a
        # peer from overwriting what another still reads).
        self.barrier: _HostBarrier | None = None
        self._xbufs: list[list[torch.Tensor]] = []
        self._xcap = 0
        self._xturn = 0

    @property
    def controller(self) -> bool:
        return self.rank == 0

    @property
    def index(self) -> int:
        """This rank's place in its tensor-parallel group: a serving
        world is the group."""
        return self.rank

    # ---- collectives inside a dispatch ------------------------------------

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The tp-wide sum (in fp32, returned in x's dtype) or max of a
        floating `x`: the model's only collective. Ranks that share a card
        reduce through its exchange buffers (SHARED_CARD), others through
        the world's backend on x's device. Integer tables go over
        `ctl_timed` on the host, as `_digest_table` does."""
        if self.size == 1:
            return x
        if not x.is_floating_point():
            raise TypeError(f"World.all_reduce takes floating tensors, not "
                            f"{x.dtype}")
        if self.barrier is not None:
            return self._card_reduce(x, op)
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        buf = x.to(torch.float32, copy=True)
        try:
            dist.all_reduce(buf, op=red, group=self.group)
        except Exception as e:
            self.broken = f"all_reduce failed: {type(e).__name__}: {e}"
            raise WorldBroken(self.broken) from e
        return buf.to(x.dtype)

    def _exchange(self, n: int) -> list[torch.Tensor]:
        """Every rank's exchange buffer of this turn (rank order), each
        at least n fp32 wide; grown on every rank at once (every rank
        meets the same sums in the same order), the new buffers' IPC
        handles traded over the timed gloo group."""
        from torch.multiprocessing.reductions import reduce_tensor

        if n > self._xcap:
            # This rank's reads of the old buffers are done before the
            # exchange below, which every rank enters: then they go.
            torch.cuda.current_stream(self.device).synchronize()
            cap = max(n, 2 * self._xcap)
            mine = [torch.empty(cap, dtype=torch.float32, device=self.device)
                    for _ in range(2)]
            handles: list = [None] * self.size
            dist.all_gather_object(handles, [reduce_tensor(b) for b in mine],
                                   group=self.ctl_timed)
            self._xbufs = [
                mine if r == self.rank else [fn(*a) for fn, a in h]
                for r, h in enumerate(handles)
            ]
            self._xcap = cap
        self._xturn ^= 1
        return [bufs[self._xturn] for bufs in self._xbufs]

    def _card_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        t0 = time.perf_counter()
        n = x.numel()
        try:
            bufs = self._exchange(n)
            bufs[self.rank][:n].copy_(x.reshape(-1))
            torch.cuda.current_stream(self.device).synchronize()
            self.barrier.wait(self.timeout_s, self._check_followers)
        except WorldBroken as e:
            self.broken = str(e)
            raise
        acc = bufs[0][:n].clone()
        for b in bufs[1:]:
            if op == "sum":
                acc += b[:n]
            else:
                torch.maximum(acc, b[:n], out=acc)
        SHARED_CARD["calls"] += 1
        SHARED_CARD["bytes"] += 4 * n
        SHARED_CARD["seconds"] += time.perf_counter() - t0
        return acc.view(x.shape).to(x.dtype)

    # ---- the training collectives ------------------------------------------
    #
    # Every rank of the world enters each of these at the same point of
    # the same program (SPMD), each naming its own group: the ranks it
    # meets (in rank order), a subset of the world that holds this rank.
    # Groups of one collective partition the world (the ranks of one mesh
    # axis, or of several). Every payload is as large on every rank.

    def _rounds(self, payload: torch.Tensor, ranks):
        """Exchange the uint8 [R, L] `payload` (R rows of L bytes, one
        shape on every rank): yields (a, b, views), views[k] being rank
        ranks[k]'s payload[:, a:b] ([R, b - a] uint8), column range by
        column range until L is covered. Consume each round's views
        before the next. On a shared card a round is one turn of the
        exchange buffers, at most EXCHANGE_BYTES of payload (so a
        gradient of any size moves through bounded buffers); otherwise one
        all_gather of the whole world's payloads over the backend."""
        R, L = payload.shape
        if self.size == 1:
            yield 0, L, [payload for _ in ranks]
            return
        try:
            if self.barrier is None:
                outs = [torch.empty_like(payload) for _ in range(self.size)]
                dist.all_gather(outs, payload.contiguous(), group=self.group)
                yield 0, L, [outs[r] for r in ranks]
                return
            step = max(16, EXCHANGE_BYTES // R // 16 * 16)
            for a in range(0, max(L, 1), step):
                b = min(L, a + step)
                n = R * (b - a)
                bufs = self._exchange(-(-n // 4))
                mine = bufs[self.rank].view(torch.uint8)[:n].view(R, b - a)
                mine.copy_(payload[:, a:b])
                torch.cuda.current_stream(self.device).synchronize()
                self.barrier.wait(self.timeout_s, self._check_followers)
                yield a, b, [bufs[r].view(torch.uint8)[:n].view(R, b - a)
                             for r in ranks]
        except WorldBroken as e:
            self.broken = str(e)
            raise
        except Exception as e:
            self.broken = f"collective failed: {type(e).__name__}: {e}"
            raise WorldBroken(self.broken) from e

    @staticmethod
    def _count(kind: str, nbytes: int, t0: float) -> None:
        row = COLLECTIVES[kind]
        row["calls"] += 1
        row["bytes"] += nbytes
        row["seconds"] += time.perf_counter() - t0

    def all_gather(self, x: torch.Tensor, group, dim: int = 0
                   ) -> torch.Tensor:
        """The group's tensors concatenated along `dim`, in rank order
        (every rank's `x` of one shape and dtype)."""
        t0 = time.perf_counter()
        lead = x.movedim(dim, 0).contiguous()
        raw = lead.reshape(1, -1).view(torch.uint8)
        out = torch.empty((len(group), raw.shape[1]), dtype=torch.uint8,
                          device=x.device)
        for a, b, views in self._rounds(raw, group):
            for k, v in enumerate(views):
                out[k, a:b] = v[0]
        whole = out.view(x.dtype).view((len(group) * lead.shape[0],)
                                       + tuple(lead.shape[1:]))
        self._count("all_gather", raw.numel(), t0)
        return whole.movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, group, dim: int = 0
                       ) -> torch.Tensor:
        """This rank's chunk (its index in `group`) of the group's sum of
        `x` along `dim`, summed in fp32 in rank order; returned in fp32."""
        t0 = time.perf_counter()
        parts = len(group)
        lead = x.movedim(dim, 0).to(torch.float32).contiguous()
        if lead.shape[0] % parts:
            raise ValueError(f"dim {dim} of width {lead.shape[0]} does not "
                             f"divide over {parts} ranks")
        i = list(group).index(self.rank)
        raw = lead.reshape(parts, -1).view(torch.uint8)
        acc = torch.empty(raw.shape[1] // 4, dtype=torch.float32,
                          device=x.device)
        for a, b, views in self._rounds(raw, group):
            dst = acc[a // 4:b // 4]
            dst.copy_(views[0][i].view(torch.float32))
            for v in views[1:]:
                dst += v[i].view(torch.float32)
        del raw, lead
        shape = (x.shape[dim] // parts,) + tuple(
            s for d, s in enumerate(x.shape) if d != dim)
        self._count("reduce_scatter", x.numel() * 4, t0)
        return acc.view(shape).movedim(0, dim)

    def sum(self, x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
        """The group's sum (fp32, rank order) or max of a floating `x`,
        in x's dtype."""
        t0 = time.perf_counter()
        flat = x.to(torch.float32).contiguous().reshape(1, -1)
        raw = flat.view(torch.uint8)
        acc = torch.empty(flat.shape[1], dtype=torch.float32,
                          device=x.device)
        for a, b, views in self._rounds(raw, group):
            dst = acc[a // 4:b // 4]
            dst.copy_(views[0][0].view(torch.float32))
            for v in views[1:]:
                if op == "sum":
                    dst += v[0].view(torch.float32)
                else:
                    torch.maximum(dst, v[0].view(torch.float32), out=dst)
        self._count("sum", raw.numel(), t0)
        return acc.view(x.shape).to(x.dtype)

    def shift(self, tensors, group) -> list[torch.Tensor]:
        """The ring step: the tensors of the rank before this one in
        `group` (cyclically), so rank j's go to rank j + 1: `lax.ppermute`
        with perm [(j, j + 1)]. Any dtypes."""
        t0 = time.perf_counter()
        group = list(group)
        src = group[(group.index(self.rank) - 1) % len(group)]
        raw, layout = _pack(list(tensors), self.device)
        got = torch.empty_like(raw)
        for a, b, views in self._rounds(raw.view(1, -1), [src]):
            got[a:b] = views[0][0]
        out = _unpack(got, layout)
        self._count("shift", raw.numel(), t0)
        return out

    def _check_followers(self) -> None:
        for r, p in enumerate(self._procs, 1):
            if p.poll() is not None:
                raise WorldBroken(f"rank {r} exited with code {p.returncode}")

    # ---- the descriptor channel -------------------------------------------

    def _send(self, payload: bytes) -> None:
        head = torch.tensor([len(payload)], dtype=torch.int64)
        dist.broadcast(head, src=0, group=self.ctl)
        body = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        dist.broadcast(body, src=0, group=self.ctl)

    def _recv(self) -> bytes:
        head = torch.zeros(1, dtype=torch.int64)
        dist.broadcast(head, src=0, group=self.ctl)
        body = torch.empty(int(head[0]), dtype=torch.uint8)
        dist.broadcast(body, src=0, group=self.ctl)
        return body.numpy().tobytes()

    def _agree(self, failed: bool) -> int:
        """How many ranks failed this dispatch (the error-flag exchange)."""
        flag = torch.tensor([1 if failed else 0], dtype=torch.int64)
        dist.all_reduce(flag, op=dist.ReduceOp.SUM, group=self.ctl_timed)
        return int(flag[0])

    # ---- handles ------------------------------------------------------------

    def _register(self, obj, h: int) -> None:
        """Rank 0 names `obj` by handle `h` (weakly: its collection drops
        the followers' objects); a follower holds its object under `h`."""
        if not self.controller:
            self._objs[h] = obj
            return
        try:
            ref = weakref.ref(obj)
            weakref.finalize(obj, self._collected, h)
        except TypeError:  # a dict (a pool, a page blob): `release` it
            ref = (lambda o: lambda: o)(obj)
        self._by_id[id(obj)] = (ref, h, "")
        if isinstance(obj, nn.Module):
            for path, sub in obj.named_modules():
                if path:
                    self._by_id[id(sub)] = (weakref.ref(sub), h, path)

    def _collected(self, h: int) -> None:
        for k in [k for k, v in list(self._by_id.items()) if v[1] == h]:
            self._by_id.pop(k, None)
        self._drops.append(h)

    def release(self, obj) -> None:
        """Drop rank 0's registration of `obj` and, with the next
        dispatch, the followers' objects under its handle."""
        h = self.handle_of(obj)
        if h is not None:
            self._collected(h)

    def handle_of(self, obj) -> int | None:
        ref = self._by_id.get(id(obj))
        return ref[1] if ref is not None and ref[0]() is obj else None

    # ---- dispatch -----------------------------------------------------------

    def call(self, fn, *args, bind=None, peer=None, **kwargs):
        """Run `fn(*args, **kwargs)` on every rank (rank 0 only). bind: a
        function of the result choosing the object to register (True: the
        result itself), the same on every rank. peer: rank 0 does not run
        `fn` but registers `peer` as its counterpart of the followers'
        results (a constructor rank 0 is already inside)."""
        if not self.controller:
            raise RuntimeError("World.call runs on rank 0")
        if self.size == 1 or inside():
            return fn(*args, **kwargs) if peer is None else peer
        with self._lock:
            if not self.broken:
                try:
                    self._check_followers()
                except WorldBroken as e:
                    self.broken = str(e)
            if self.broken:
                raise WorldBroken(self.broken)
            h = None
            if bind is not None or peer is not None:
                h = self._next
                self._next += 1
            drops = []
            while self._drops:
                drops.append(self._drops.popleft())
            buf = io.BytesIO()
            _Pickler(buf, self).dump((fn, args, kwargs, h, bind, drops))
            try:
                self._send(buf.getvalue())
            except Exception as e:
                self.broken = f"descriptor broadcast failed: {e}"
                raise WorldBroken(self.broken) from e
            err = None
            out = peer
            if peer is None:
                try:
                    with _Inside():
                        out = fn(*args, **kwargs)
                except WorldBroken:
                    raise
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    err = e
            try:
                failed = self._agree(err is not None)
            except Exception as e:
                self.broken = f"error-flag exchange failed: {e}"
                raise WorldBroken(self.broken) from e
            if failed not in (0, self.size):
                self.broken = (f"{failed} of {self.size} ranks failed a "
                               f"dispatch of {getattr(fn, '__name__', fn)}")
                raise WorldBroken(self.broken) from err
            if err is not None:
                raise err
            _digest_update(self._digest, out)
            if h is not None:
                obj = out if bind in (None, True) else bind(out)
                if obj is not None:
                    self._register(obj, h)
            return out

    def serve(self) -> None:
        """A follower's loop: run each descriptor until rank 0 stops."""
        while True:
            msg = _Unpickler(io.BytesIO(self._recv()), self).load()
            if msg is None:
                return
            fn, args, kwargs, h, bind, drops = msg
            for d in drops:
                self._objs.pop(d, None)
            err = None
            try:
                with _Inside():
                    out = fn(*args, **kwargs)
            except WorldBroken:
                raise
            except BaseException as e:  # noqa: BLE001 - rank 0 re-raises
                err = e
                out = None
                # Rank 0 sees only that a follower failed: say what did.
                print(f"tp rank {self.rank}: {getattr(fn, '__name__', fn)}"
                      f" raised {type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
            failed = self._agree(err is not None)
            if failed not in (0, self.size):
                raise WorldBroken(f"ranks disagree on {fn}: {err!r}")
            if err is not None:
                continue
            _digest_update(self._digest, out)
            if h is not None:
                obj = out if bind in (None, True) else bind(out)
                if obj is not None:
                    self._objs[h] = obj
            # Hold nothing past the dispatch: a dropped handle's object
            # must go when rank 0 lets go of it.
            msg = fn = args = kwargs = out = obj = None

    # ---- checks -------------------------------------------------------------

    def digests(self) -> list[str]:
        """Every rank's running digest of its dispatches' integer results
        (rank 0 only): equal digests mean the followers sampled the tokens
        rank 0 sampled."""
        table = self.call(_digest_table, self)
        return [bytes(row.tolist()).hex() for row in table]

    def peak_memory(self) -> list[int]:
        """Every rank's peak CUDA memory in bytes (0 on the CPU)."""
        return [int(x) for x in self.call(_peak_table, self).tolist()]

    # ---- shutdown -----------------------------------------------------------

    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Stop the followers and leave the process group (rank 0)."""
        global _WORLD
        if _WORLD is self:
            _WORLD = None
        # Let go of the followers' exchange buffers before they exit.
        self._xbufs = []
        if self.controller and self.size > 1 and not self.broken:
            try:
                with self._lock:
                    buf = io.BytesIO()
                    _Pickler(buf, self).dump(None)
                    self._send(buf.getvalue())
            except Exception:  # fault-boundary: the followers are killed
                pass
        deadline = time.monotonic() + timeout_s
        for p in self._procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._procs = []
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # fault-boundary: leaving a broken group
                pass
        self._objs.clear()
        self._by_id.clear()
        if self.tmpdir:
            shutil.rmtree(self.tmpdir, ignore_errors=True)

    def follow(self) -> None:
        """A follower's life in a world it joined with `adopt`: serve rank
        0's dispatches until it stops, then leave the group."""
        global _WORLD
        try:
            with torch.inference_mode():
                self.serve()
        finally:
            self._xbufs = []
            if _WORLD is self:
                _WORLD = None
            try:
                dist.destroy_process_group()
            except Exception:  # fault-boundary: rank 0 left first
                pass

    def kill_follower(self, rank: int) -> None:
        """End follower `rank`'s process (tests of a dead rank)."""
        self._procs[rank - 1].kill()
        self._procs[rank - 1].wait()


def _digest_table(world: "World") -> torch.Tensor:
    table = torch.zeros((world.size, 32), dtype=torch.int64)
    table[world.rank] = torch.tensor(list(world._digest.digest()))
    dist.all_reduce(table, group=world.ctl_timed)
    return table


def _peak_table(world: "World") -> torch.Tensor:
    table = torch.zeros((world.size,), dtype=torch.int64)
    if world.device.type == "cuda":
        table[world.rank] = torch.cuda.max_memory_allocated(world.device)
    dist.all_reduce(table, group=world.ctl_timed)
    return table


def current() -> World | None:
    """This process's world, if one was started."""
    return _WORLD


def _groups(world: World) -> None:
    """The descriptor channel (gloo, waits while the server idles) and the
    timed gloo group of the error flags; the model's collectives run on
    the default group (the world's backend and timeout)."""
    world.ctl = dist.new_group(backend="gloo", timeout=_IDLE_WAIT)
    world.ctl_timed = dist.new_group(
        backend="gloo", timeout=timedelta(seconds=world.timeout_s))


def _init(rank: int, size: int, init_method: str, backend: str,
          timeout_s: float, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank,
        world_size=size, timeout=timedelta(seconds=timeout_s),
    )


def start(size: int, devices: list[torch.device], *,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> World:
    """Make this process rank 0 of `size` ranks on one host, rank r on
    `devices[r]` (`default_devices`): start ranks 1..size-1 as processes
    of their own (`_follower_main`), rendezvous over a file store in a
    fresh temporary directory, and return the world. Printed: the backend
    and the devices. A layout `choose_backend` refuses raises before any
    process starts."""
    global _WORLD
    if _WORLD is not None:
        raise RuntimeError(
            f"a world of {_WORLD.size} ranks is already running in this "
            "process")
    devices = [torch.device(d) for d in devices]
    if len(devices) != size:
        raise ValueError(f"{len(devices)} devices for {size} ranks")
    backend = choose_backend(devices)
    tmp = tempfile.mkdtemp(prefix="oryx_tp_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    # Ranks that share one card meet at a host barrier (a file each rank
    # maps) and reduce through the card; "-" names no barrier.
    barrier = "-"
    if backend == "gloo" and devices[0].type == "cuda":
        barrier = os.path.join(tmp, "barrier")
        _HostBarrier.create(barrier, size)
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
    procs = []
    for r in range(1, size):
        args = [sys.executable, "-c", _FOLLOWER, str(r), str(size),
                init_method, backend, repr(timeout_s), str(devices[r]),
                str(os.getpid()), barrier]
        procs.append(subprocess.Popen(args, env=env,
                                      stdout=subprocess.DEVNULL))
    print(f"tp: {size} ranks over {backend} on "
          f"{', '.join(str(d) for d in devices)}"
          + ("; activations summed on the shared card" if barrier != "-"
             else ""), file=sys.stderr, flush=True)
    world = World(0, size, devices[0], backend, timeout_s, procs=procs)
    world.tmpdir = tmp
    if barrier != "-":
        world.barrier = _HostBarrier(barrier, 0, size)
    try:
        _init(0, size, init_method, backend, timeout_s, devices[0])
        _groups(world)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    world.devices = devices
    _WORLD = world
    atexit.register(world.shutdown)
    return world


def adopt(devices: list[torch.device], *, timeout_s: float =
          DEFAULT_TIMEOUT_S, tag: str = "") -> World:
    """The world of a process group this process has already joined
    (`mesh.initialize_distributed`: processes started on their own, each
    with its rank), rank r on `devices[r]`. Rank 0 returns as the
    controller; a follower then runs `World.follow`. Ranks that share a
    card meet at a host barrier in the temp directory, named by `tag`
    (the coordinator's address), which rank 0 makes before any rank maps
    it."""
    global _WORLD
    if _WORLD is not None:
        raise RuntimeError("a world is already running in this process")
    devices = [torch.device(d) for d in devices]
    rank, size = dist.get_rank(), dist.get_world_size()
    if len(devices) != size:
        raise ValueError(f"{len(devices)} devices for {size} ranks")
    backend = choose_backend(devices)
    world = World(rank, size, devices[rank], backend, timeout_s)
    world.devices = devices
    _groups(world)
    if backend == "gloo" and devices[0].type == "cuda":
        safe = "".join(c if c.isalnum() else "_" for c in tag)
        root = os.path.join(tempfile.gettempdir(), f"oryx_tp_{safe}")
        path = os.path.join(root, "barrier")
        if rank == 0:
            os.makedirs(root, exist_ok=True)
            _HostBarrier.create(path, size)
            world.tmpdir = root
        dist.barrier(group=world.ctl_timed)
        world.barrier = _HostBarrier(path, rank, size)
    _WORLD = world
    if rank == 0:
        atexit.register(world.shutdown)
    return world


# A follower's main: this module imported under its own name (run as
# __main__ it would be a second copy, with a second `_WORLD`).
_FOLLOWER = ("import sys; from oryx_tpu_torch.parallel import tp; "
             "sys.exit(tp._follower_main(sys.argv[1:]))")


def _watch_parent(pid: int) -> None:
    while True:
        time.sleep(1.0)
        try:
            os.kill(pid, 0)
        except OSError:
            os._exit(3)


def _follower_main(argv: list[str]) -> None:
    global _WORLD
    rank, size = int(argv[0]), int(argv[1])
    init_method, backend, timeout_s = argv[2], argv[3], float(argv[4])
    device = torch.device(argv[5])
    threading.Thread(target=_watch_parent, args=(int(argv[6]),),
                     daemon=True).start()
    _init(rank, size, init_method, backend, timeout_s, device)
    world = World(rank, size, device, backend, timeout_s)
    if argv[7] != "-":
        world.barrier = _HostBarrier(argv[7], rank, size)
    _groups(world)
    _WORLD = world
    try:
        with torch.inference_mode():
            world.serve()
        world._xbufs = []
    except Exception as e:  # noqa: BLE001 - the follower ends
        print(f"tp rank {rank}: {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)
        os._exit(1)
    try:
        dist.destroy_process_group()
    except Exception:  # fault-boundary: rank 0 left first
        pass
    # Skip the interpreter's teardown: it can meet the collective
    # library's threads still unwinding and abort the process.
    sys.stderr.flush()
    os._exit(0)
