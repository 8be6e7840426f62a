"""Autoregressive generation (port of `oryx_tpu.models.generate`): the
dense-KV prefill + decode loop, and the paged programs of the
continuous-batching engine (paged prefill, chunked decode, the packed
ragged step, the decode megastep, the speculative verify step with its
drafters, `generate_paged`), and the engine's pure-decode step as a CUDA
graph (`_EngineStepGraph`).

The JAX package runs the decode as one compiled `lax.while_loop`; here it
runs in chunks of steps and exits between chunks once every row has
finished (one host read of the finished flags per chunk). On the card a
chunk is one replay of a CUDA graph of its steps (`_DecodeGraph`), which
`generate_stream` replays once per yielded block; on the CPU the same
chunks run eagerly. Prefix reuse prefills only a suffix into an existing
cache at absolute positions (`kv_cache=`, `start=`). Right-padded batches
advance with per-row positions, so mixed-length multimodal prefills need no
left-padding shuffle. The paged programs' `lax.scan` over `chunk` steps is
a Python loop with no host read inside: the caller syncs once per dispatch,
at the harvest.

RNG: JAX's per-row threefry keys become one `torch.Generator` per row (None
for a greedy row, which draws nothing), so a row's draws never depend on
its neighbours. The two frameworks draw different numbers: greedy tokens
match JAX, seeded sampling is held by replaying the port against itself.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from oryx_tpu_torch.config import GenerationConfig, LLMConfig
from oryx_tpu_torch.models import qwen2
from oryx_tpu_torch.ops import paged_kv as paged_kv_lib
from oryx_tpu_torch.ops.cuda import graphs
from oryx_tpu_torch.utils import numerics as numerics_lib
from oryx_tpu_torch.utils.quant import embed_rows


def sample_token(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    *,
    temperature: float,
    top_p: float,
    top_k: int,
) -> torch.Tensor:
    """Next token ids [B] (int32) from [B, V] logits; temperature 0 is
    greedy (first maximum on ties, as jnp.argmax)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[
            :, -min(top_k, logits.shape[-1])
        ][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Smallest prefix with cumulative prob >= top_p (keeps the top token).
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    # torch.multinomial's one-sample draw, spelled out: argmax of p / q with
    # q ~ Exp(1) gives the same numbers from the same generator state, and
    # runs under CUDA graph capture (multinomial checks its input on the
    # host).
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


def truncate_logits_rows(
    logits: torch.Tensor,  # [S, V]
    *,
    temperature: torch.Tensor,  # [S] float (0 => greedy for that row)
    top_p: torch.Tensor,  # [S] float
    top_k: torch.Tensor,  # [S] int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row temperature scale + top-k + top-p truncation. Returns
    (truncated logits [S, V], -inf outside the nucleus; is_greedy [S]).
    Greedy rows pass through at t = 1."""
    V = logits.shape[-1]
    is_greedy = temperature <= 0.0
    t = torch.where(is_greedy, 1.0, temperature.float())[:, None]
    l = logits.float() / t
    tk = top_k.long().clamp(0, V)
    srt = torch.sort(l, dim=-1).values  # ascending
    kth = torch.gather(srt, 1, (V - tk).clamp(0, V - 1)[:, None])
    l = torch.where((tk > 0)[:, None] & (l < kth), -torch.inf, l)
    srt_d = torch.sort(l, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(srt_d, dim=-1), dim=-1)
    # Smallest prefix with cumulative prob >= top_p (keeps the top token);
    # an index past the end (rounding) cuts nothing, as XLA's fill does.
    cutoff_idx = torch.sum(cum < top_p.float()[:, None], dim=-1).clamp(
        max=V - 1
    )
    cutoff = torch.gather(srt_d, 1, cutoff_idx[:, None])
    l = torch.where((top_p < 1.0)[:, None] & (l < cutoff), -torch.inf, l)
    return l, is_greedy


def sample_token_rows(
    logits: torch.Tensor,  # [S, V]
    generators,  # [S] torch.Generator per sampling row, None = greedy
    *,
    temperature: torch.Tensor,  # [S]
    top_p: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S]
    draws: torch.Tensor | None = None,  # [S] bool: the rows that sample
) -> torch.Tensor:
    """Per-row sampling for continuous batching: every row carries its own
    (temperature, top_p, top_k) and generator, so a row's draw is a
    function of that row alone. Rows with no generator, or temperature 0,
    take the argmax (first maximum on ties); sampling rows draw one
    Gumbel-max sample over the truncated logits. `draws` (a device mask)
    is for a caller whose every row holds a generator (an engine-step CUDA
    graph's per-slot generators, which all draw): only the masked rows'
    draws count. Returns [S] int32."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    rows = [i for i, g in enumerate(generators) if g is not None]
    if not rows:
        return greedy
    S, V = logits.shape
    l, is_greedy = truncate_logits_rows(
        logits, temperature=temperature, top_p=top_p, top_k=top_k
    )
    u = torch.full((S, V), 0.5, dtype=torch.float32, device=logits.device)
    for i in rows:
        u[i] = torch.rand(V, generator=generators[i], device=logits.device)
    g = _gumbel(u)
    sampled = torch.argmax(l + g, dim=-1).to(torch.int32)
    drew = _drew(draws, rows, S, logits.device)
    return torch.where(drew & ~is_greedy, sampled, greedy)


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _drew(draws, rows: list[int], S: int, device) -> torch.Tensor:
    """[S] bool: `draws` when given (a graph's device mask), else the rows
    holding a generator."""
    if draws is not None:
        return draws
    drew = torch.zeros(S, dtype=torch.bool, device=device)
    drew[rows] = True
    return drew


def make_stop_sequences(stop_strs: list[str], tokenizer) -> torch.Tensor | None:
    """Encode stop strings to an [S, L] int32 tensor, left-padded with -1
    (a wildcard). S is bucketed to a power of two with filler rows of -3,
    which can never fire."""
    seqs = []
    for s in stop_strs:
        if not s:
            continue
        ids = tokenizer.encode(s, add_special_tokens=False)
        if ids:
            seqs.append(np.asarray(ids, np.int32))
    if not seqs:
        return None
    L = -(-max(len(s) for s in seqs) // 4) * 4
    S = 1 << (len(seqs) - 1).bit_length()
    out = np.full((S, L), -3, np.int32)
    for i, s in enumerate(seqs):
        out[i, : L - len(s)] = -1
        out[i, L - len(s):] = s
    return torch.from_numpy(out)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Decode steps a CUDA graph holds: `generate` reads the finished flags once
# a chunk, and `generate_stream` takes its own chunk.
DECODE_CHUNK = 8
# Idle decode graphs kept per model (each holds a dense cache of its
# cache_len); the least recently used beyond this are freed.
MAX_IDLE_GRAPHS = 8


@torch.inference_mode()
def generate(
    params: qwen2.Qwen2,
    cfg: LLMConfig,
    gen_cfg: GenerationConfig,
    *,
    inputs_embeds: torch.Tensor,  # [B, T, H] (pre-spliced; right-padded)
    lengths: torch.Tensor,  # [B] real TOTAL lengths (incl. cached prefix)
    max_new_tokens: int,
    cache_len: int,
    generator: torch.Generator | None = None,
    attn_impl: str = "xla",
    compute_dtype: torch.dtype | None = None,
    stop_sequences: torch.Tensor | None = None,  # [S, L], left-pad -1
    kv_cache: dict | None = None,
    start=None,  # int or [] / [B] tensor: first slot to write
    return_cache: bool = False,
    timings: dict | None = None,
):
    """Returns (tokens [B, max_new_tokens] int32, num_generated [B] int32,
    finished [B] bool) as tensors on the embeds' device, plus the KV cache
    when return_cache.

    Slots after a row finishes hold eos_token_id. A row finishes on EOS or
    when its trailing tokens match a stop sequence (num_generated then
    includes the stop tokens). finished=False marks a row cut off by
    max_new_tokens. cache_len must be >= T + max_new_tokens.

    kv_cache/start (prefix reuse, `Pipeline.chat_cached`): a cache of
    cache_len slots whose slots [0, start) already hold an earlier turn's
    K/V. Only the suffix embeds are prefilled, written at slot `start` at
    absolute positions, and `lengths` counts prefix + suffix; the caller
    guarantees cache_len >= lengths + max_new_tokens. kv_cache itself is
    left as it was; return_cache gives the cache after this call.

    The decode runs DECODE_CHUNK steps at a time and reads the finished
    flags once a chunk (`_decode_while`). On the card each whole chunk is
    one replay of a CUDA graph (`_DecodeGraph`, captured at its key's first
    call and reused after), and the last max_new_tokens % DECODE_CHUNK
    steps run eagerly, so no step writes past slot T + max_new_tokens.
    timings: when given, receives prefill_s, decode_s (wall seconds, the
    device synchronised at each boundary), decode_steps and capture_s (the
    graph capture this call made, 0 when it reused one).
    """
    B, T, _ = inputs_embeds.shape
    if kv_cache is None and cache_len < T + max_new_tokens:
        raise ValueError(f"{cache_len=} < {T=} + {max_new_tokens=}")
    dev = inputs_embeds.device
    stop = None if stop_sequences is None else stop_sequences.to(dev)
    with _dense_route(
        params, cfg, gen_cfg, batch=B, cache_len=cache_len, stop=stop,
        chunk=DECODE_CHUNK, attn_impl=attn_impl,
        compute_dtype=compute_dtype, generator=generator, kv_cache=kv_cache,
        device=dev,
    ) as (cache, gen, step, graph, capture_s):
        if timings is not None:
            _sync(dev)
            t0 = time.perf_counter()
        carry = _prefill_carry(
            params, cfg, gen_cfg, inputs_embeds, lengths.to(dev), gen,
            cache=cache, start=start, attn_impl=attn_impl,
            compute_dtype=compute_dtype,
            stop_L=0 if stop is None else stop.shape[1],
        )
        if timings is not None:
            _sync(dev)
            t1 = time.perf_counter()
        carry, toks, fin, steps = _decode_while(
            step, carry, max_new_tokens, gen_cfg.eos_token_id,
            chunk=DECODE_CHUNK, graph=graph,
        )
        if timings is not None:
            _sync(dev)
            timings.update(
                prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                decode_steps=steps, capture_s=capture_s,
            )
        if return_cache:
            cache = _cache_out(carry[0], graph)
    # num generated = tokens up to and including the finishing token.
    any_fin = torch.any(fin, dim=1)
    num = torch.where(
        any_fin, torch.argmax(fin.to(torch.int32), dim=1) + 1, max_new_tokens
    )
    out = (toks, num.to(torch.int32), any_fin)
    return out + (cache,) if return_cache else out


def _steps(step, carry, n: int):
    """n decode steps -> (carry, toks [B, n], fin [B, n])."""
    toks, fins = [], []
    for _ in range(n):
        carry, (tok, f) = step(carry)
        toks.append(tok)
        fins.append(f)
    return carry, torch.stack(toks, 1), torch.stack(fins, 1)


def _decode_while(step, carry, max_new_tokens: int, eos: int, *,
                  chunk: int = DECODE_CHUNK, graph=None):
    """Run the decode step until max_new_tokens OR until every row has
    finished, `chunk` steps at a time: the finished flags are read on the
    host once a chunk. A whole chunk is one replay of `graph` (a
    `_DecodeGraph` of this chunk) when given; the steps run eagerly without
    one (the CPU, and the eager witness the card checks the graphs
    against) and for a last chunk shorter than `chunk`, so the loop runs at
    most max_new_tokens steps. Steps after every row finished leave what
    the unexecuted slots hold (tokens: EOS; finished: True), so chunking
    changes no output. Returns (carry, toks [B, max_new], fin [B, max_new],
    steps run)."""
    tok0 = carry[1]
    nB = tok0.shape[0]
    toks = torch.full((nB, max_new_tokens), eos, dtype=torch.int32,
                      device=tok0.device)
    fin = torch.ones((nB, max_new_tokens), dtype=torch.bool,
                     device=tok0.device)
    i = 0
    while i < max_new_tokens and not bool(torch.all(carry[3])):
        n = min(chunk, max_new_tokens - i)
        if graph is not None and n == graph.chunk:
            carry, t, f = graph.run(carry)
        else:
            carry, t, f = _steps(step, carry, n)
        toks[:, i:i + n] = t
        fin[:, i:i + n] = f
        i += n
    return carry, toks, fin, i


class _DecodeGraph:
    """`chunk` decode steps of one model captured as one CUDA graph over
    state the graph owns: the dense cache, the rest of the decode carry,
    the stop matrix and (when sampling) a generator registered with the
    graph. A call copies its state in (`_dense_route`), replays, and copies
    out what outlives it, so a graph never replays against a cache it was
    not captured on. Capture runs one eager warm-up step first (it builds
    the kernels and their libraries' state outside the capture) and raises
    if it fails; nothing falls back to the eager loop."""

    def __init__(self, params, cfg: LLMConfig, gen_cfg: GenerationConfig,
                 key, *, batch: int, cache_len: int, dtype: torch.dtype,
                 stop_shape, attn_impl: str, compute_dtype, chunk: int,
                 device: torch.device):
        self.key, self.chunk = key, chunk
        self.cache = qwen2.init_kv_cache(cfg, batch, cache_len, dtype=dtype,
                                         device=device)

        def ints(*shape, fill=0):
            return torch.full(shape, fill, dtype=torch.int32, device=device)

        self.carry = (
            self.cache, ints(batch), ints(batch),
            torch.zeros(batch, dtype=torch.bool, device=device),
            ints(batch, 0 if stop_shape is None else stop_shape[1], fill=-2),
        )
        # Filler rows of -3 never fire (make_stop_sequences).
        self.stop = None if stop_shape is None else ints(*stop_shape, fill=-3)
        self.generator = (
            None if gen_cfg.temperature == 0.0
            else torch.Generator(device=device)
        )
        self.step = _make_decode_step(
            params, cfg, gen_cfg, self.stop, cache_len=cache_len,
            attn_impl=attn_impl, compute_dtype=compute_dtype,
            generator=self.generator,
        )
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            _steps(self.step, self.carry, 1)
        self.graph = graphs.CountedGraph()
        with self.graph.capture(
            stream, [g for g in (self.generator,) if g is not None],
            label=graphs.key_label("decode", key),
        ):
            carry, self.toks, self.fin = _steps(self.step, self.carry, chunk)
            for static, new in zip(self.carry[1:], carry[1:]):
                static.copy_(new)
        self.capture_s = time.perf_counter() - t0

    def run(self, carry):
        """One replay from `carry` (whose cache must be this graph's) ->
        (the graph's carry, toks [B, chunk], fin [B, chunk]); the outputs
        are the graph's buffers, valid until its next replay."""
        if carry[0] is not self.cache:
            raise RuntimeError("a decode graph replays only on its own cache")
        for static, x in zip(self.carry[1:], carry[1:]):
            if x is not static:
                static.copy_(x)
        self.graph.replay()
        return self.carry, self.toks, self.fin


_GRAPHS_LOCK = threading.Lock()


def _acquire_graph(params, cfg, gen_cfg, **kw) -> tuple[_DecodeGraph, float]:
    """An idle decode graph of this key (every argument that fixes its
    launches), or a new capture. Returns (graph, capture seconds of this
    call). The idle graphs live on the model itself, so they go with it."""
    key = (cfg, gen_cfg.temperature, gen_cfg.top_p, gen_cfg.top_k,
           gen_cfg.eos_token_id, *sorted(kw.items(), key=lambda x: x[0]))
    with _GRAPHS_LOCK:
        idle = params.__dict__.setdefault("_decode_graphs",
                                          collections.OrderedDict())
        pool = idle.get(key)
        if pool:
            graph = pool.pop()
            if not pool:
                del idle[key]
            return graph, 0.0
    graph = _DecodeGraph(params, cfg, gen_cfg, key, **kw)
    return graph, graph.capture_s


def _release_graph(params, graph: _DecodeGraph) -> None:
    with _GRAPHS_LOCK:
        idle = params.__dict__["_decode_graphs"]
        idle.setdefault(graph.key, []).append(graph)
        idle.move_to_end(graph.key)
        while sum(len(v) for v in idle.values()) > MAX_IDLE_GRAPHS:
            oldest = next(iter(idle))
            idle[oldest].pop(0).graph.release()
            if not idle[oldest]:
                del idle[oldest]


@contextlib.contextmanager
def _dense_route(params, cfg: LLMConfig, gen_cfg: GenerationConfig, *,
                 batch: int, cache_len: int, stop, chunk: int, attn_impl: str,
                 compute_dtype, generator, kv_cache, device: torch.device):
    """Where one dense decode runs. Yields (cache, generator, step, graph,
    capture seconds). On the card: a `_DecodeGraph` of this call's key,
    held by this call alone, whose cache starts as a copy of `kv_cache`
    (zeros without one), whose stop matrix is `stop`, and whose generator
    continues `generator`'s state (the default generator's without one);
    the prefill writes that cache and draws from that generator, and on
    leaving, the caller's generator continues from where the graph's
    stopped. On the CPU: a copy of `kv_cache` (a fresh cache without one),
    the caller's generator, its own step and no graph. Either way
    `kv_cache` itself is never written. With the graph routes off
    (utils/debug.debug_mode(disable_jit=True)) the card takes the eager
    route too, and so does a sharded rank (tp or fsdp): its collectives
    meet the other ranks through the host, which a CUDA graph cannot
    capture."""
    dtype = compute_dtype or torch.float32
    if kv_cache is not None and kv_cache["k"].shape[2] != cache_len:
        raise ValueError(
            f"kv_cache has {kv_cache['k'].shape[2]} slots, {cache_len=}"
        )
    if device.type != "cuda" or not graphs.enabled() or (
            getattr(params, "tp", None) is not None
            or getattr(params, "zero", None) is not None):
        cache = (
            qwen2.init_kv_cache(qwen2.rank_cfg(params, cfg), batch,
                                cache_len, dtype=dtype, device=device)
            if kv_cache is None
            else {name: x.clone() for name, x in kv_cache.items()}
        )
        yield cache, generator, _make_decode_step(
            params, cfg, gen_cfg, stop, cache_len=cache_len,
            attn_impl=attn_impl, compute_dtype=compute_dtype,
            generator=generator,
        ), None, 0.0
        return
    graph, capture_s = _acquire_graph(
        params, cfg, gen_cfg, batch=batch, cache_len=cache_len, dtype=dtype,
        stop_shape=None if stop is None else tuple(stop.shape),
        attn_impl=attn_impl, compute_dtype=compute_dtype, chunk=chunk,
        device=device,
    )
    try:
        for name, x in graph.cache.items():
            if kv_cache is None:
                x.zero_()
            else:
                x.copy_(kv_cache[name])
        if stop is not None:
            graph.stop.copy_(stop)
        src = generator
        if graph.generator is not None:
            if src is None:
                src = torch.cuda.default_generators[
                    device.index if device.index is not None
                    else torch.cuda.current_device()
                ]
            graph.generator.set_state(src.get_state())
        yield graph.cache, graph.generator, graph.step, graph, capture_s
        if graph.generator is not None:
            src.set_state(graph.generator.get_state())
    finally:
        _release_graph(params, graph)


def _cache_out(cache, graph, out=None):
    """The cache a caller keeps after a decode over `cache`: `cache` itself
    without a graph; with one, a copy of the graph's cache (into `out` when
    given), since that cache serves the graph's next call."""
    if graph is None:
        return cache
    if out is None:
        return {name: x.clone() for name, x in cache.items()}
    for name, x in cache.items():
        out[name].copy_(x)
    return out


def prefill(
    params, cfg: LLMConfig, inputs_embeds, lengths, *, cache_len: int,
    attn_impl: str, compute_dtype, kv_cache: dict | None = None, start=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Dense-cache prefill of right-padded embeds [B, T, H] -> (logits
    [B, V] fp32 at each row's last real position, the filled KV cache).
    With kv_cache/start the embeds are a suffix, written into kv_cache from
    slot `start` (int, [] or [B]) at absolute positions, and `lengths`
    counts prefix + suffix."""
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    start = torch.as_tensor(0 if start is None else start).to(
        device=dev, dtype=torch.long
    ).expand(B)
    positions = start[:, None] + torch.arange(T, device=dev)[None, :]
    slot_ar = torch.arange(cache_len, device=dev)[None, :]
    kv_mask = (slot_ar < lengths[:, None]).to(torch.int32)
    cache = kv_cache if kv_cache is not None else qwen2.init_kv_cache(
        qwen2.rank_cfg(params, cfg), B, cache_len,
        dtype=compute_dtype or torch.float32, device=dev,
    )
    h, cache = qwen2.forward(
        params, cfg,
        inputs_embeds=inputs_embeds, positions=positions,
        kv_cache=cache, write_slots=start,
        kv_mask=kv_mask, attn_impl=attn_impl, compute_dtype=compute_dtype,
        return_hidden=True,
    )
    # Project only each row's last real position (the same numbers as the
    # full [B, T, V] logits, without materializing them): suffix-local
    # index lengths - 1 - start.
    last_h = h[torch.arange(B, device=dev), lengths.long() - 1 - start]
    return qwen2.logits_from_hidden(params, cfg, last_h), cache


def _prefill_carry(
    params, cfg: LLMConfig, gen_cfg: GenerationConfig, inputs_embeds,
    lengths, generator, *, cache, start, attn_impl: str, compute_dtype,
    stop_L: int,
):
    """Prefill (into `cache`, from slot `start`) + first sampled token ->
    the decode carry (cache, next token, per-row lengths, finished flags,
    rolling stop-match window)."""
    B = inputs_embeds.shape[0]
    dev = inputs_embeds.device
    if start is not None and (
        int(torch.as_tensor(start).max()) + inputs_embeds.shape[1]
        > cache["k"].shape[2]
    ):
        raise ValueError(
            f"a suffix of {inputs_embeds.shape[1]} slots from {start=} "
            f"overruns the {cache['k'].shape[2]}-slot cache"
        )
    last, cache = prefill(
        params, cfg, inputs_embeds, lengths, cache_len=cache["k"].shape[2],
        attn_impl=attn_impl, compute_dtype=compute_dtype, kv_cache=cache,
        start=start,
    )
    tok0 = sample_token(
        last, generator, temperature=gen_cfg.temperature,
        top_p=gen_cfg.top_p, top_k=gen_cfg.top_k,
    )
    # Rolling last-L-token window per row for stop-sequence matching; -2
    # can match neither real ids nor the -1 stop padding.
    recent0 = torch.full((B, stop_L), -2, dtype=torch.int32, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    return cache, tok0, lengths.to(torch.int32), finished, recent0


def _make_decode_step(
    params, cfg: LLMConfig, gen_cfg: GenerationConfig, stop_sequences,
    *, cache_len: int, attn_impl: str, compute_dtype, generator,
):
    """One decode step over the `_prefill_carry` state."""

    def stop_hit(recent):
        if stop_sequences is None:
            return torch.zeros(recent.shape[0], dtype=torch.bool,
                               device=recent.device)
        # [B, S, L]: pad positions (-1) match anything.
        m = (stop_sequences[None] == -1) | (
            recent[:, None, :] == stop_sequences[None]
        )
        return torch.any(torch.all(m, dim=-1), dim=-1)

    def step(carry):
        cache, tok, cur_len, finished, recent = carry
        slot_ar = torch.arange(cache_len, device=tok.device)[None, :]
        kv_mask = (slot_ar <= cur_len[:, None]).to(torch.int32)
        # A finished row keeps feeding eos_token_id, which may lie past a
        # small vocab (test configs); XLA clamps such gather indices, so
        # the port clamps too. The row's outputs are discarded either way.
        ids = tok[:, None].long().clamp(max=cfg.vocab_size - 1)
        logits, cache = qwen2.forward(
            params, cfg,
            input_ids=ids, positions=cur_len[:, None].long(),
            kv_cache=cache, write_slots=cur_len,
            kv_mask=kv_mask, attn_impl=attn_impl,
            compute_dtype=compute_dtype,
        )
        nxt = sample_token(
            logits[:, 0], generator, temperature=gen_cfg.temperature,
            top_p=gen_cfg.top_p, top_k=gen_cfg.top_k,
        )
        if recent.shape[1]:
            recent = torch.cat([recent[:, 1:], tok[:, None]], dim=1)
        finished = (
            finished | (tok == gen_cfg.eos_token_id) | stop_hit(recent)
        )
        nxt = torch.where(finished, gen_cfg.eos_token_id, nxt)
        return (cache, nxt, cur_len + 1, finished, recent), (tok, finished)

    return step


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------


@torch.inference_mode()
def generate_stream(
    params: qwen2.Qwen2,
    cfg: LLMConfig,
    gen_cfg: GenerationConfig,
    *,
    inputs_embeds: torch.Tensor,
    lengths: torch.Tensor,
    max_new_tokens: int,
    cache_len: int,
    generator: torch.Generator | None = None,
    attn_impl: str = "xla",
    compute_dtype: torch.dtype | None = None,
    stop_sequences: torch.Tensor | None = None,
    chunk: int = 8,
    kv_cache: dict | None = None,
    start=None,
    yield_cache: bool = False,
):
    """Streaming twin of `generate` (HF TextIteratorStreamer parity):
    yields np int32 token blocks [B, <=chunk] as they decode, with the same
    semantics (EOS fill after finish, stop sequences end rows) and the same
    draws from the same generator, so sampled outputs match `generate`
    token for token at any temperature.
    The decode runs WHOLE `chunk`-step chunks (on the card, one replay of
    the chunk's CUDA graph each); overshoot tokens past max_new_tokens are
    computed and dropped, so cache_len must cover
    T + ceil(max_new/chunk)*chunk. Larger chunks amortize host round-trips,
    smaller ones lower first-token latency.

    kv_cache/start: prefix reuse as in `generate` (kv_cache is left as it
    was). With yield_cache the generator yields (block, cache) pairs: one
    cache of this stream's own holding every slot decoded so far, so a
    consumer breaking out of the loop may keep the last one.
    """
    padded_new = -(-max_new_tokens // chunk) * chunk
    B, T, _ = inputs_embeds.shape
    if kv_cache is None and cache_len < T + padded_new:
        raise ValueError(f"{cache_len=} < {T=} + {padded_new=}")
    dev = inputs_embeds.device
    stop = None if stop_sequences is None else stop_sequences.to(dev)
    with _dense_route(
        params, cfg, gen_cfg, batch=B, cache_len=cache_len, stop=stop,
        chunk=chunk, attn_impl=attn_impl, compute_dtype=compute_dtype,
        generator=generator, kv_cache=kv_cache, device=dev,
    ) as (cache, gen, step, graph, _):
        carry = _prefill_carry(
            params, cfg, gen_cfg, inputs_embeds, lengths.to(dev), gen,
            cache=cache, start=start, attn_impl=attn_impl,
            compute_dtype=compute_dtype,
            stop_L=0 if stop is None else stop.shape[1],
        )
        out = None
        done = 0
        while done < max_new_tokens:
            if graph is not None:
                carry, toks, fin = graph.run(carry)
            else:
                carry, toks, fin = _steps(step, carry, chunk)
            n = min(chunk, max_new_tokens - done)
            # The per-chunk harvest is the yield surface (and the early
            # exit below needs host booleans): the one deliberate sync.
            toks = toks[:, :n].cpu().numpy()
            fin = fin[:, :n].cpu().numpy()
            if yield_cache:
                out = _cache_out(carry[0], graph, out)
                yield toks, out
            else:
                yield toks
            done += n
            if fin[:, -1].all():
                break


# ---------------------------------------------------------------------------
# Paged chunked decode (continuous-batching serving path)
# ---------------------------------------------------------------------------


def paged_prefill(
    params,
    cfg: LLMConfig,
    inputs_embeds: torch.Tensor,  # [B, T, H] right-padded
    lengths: torch.Tensor,  # [B] real TOTAL lengths (incl. cached prefix)
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_pages: dict,  # qwen2.init_paged_kv_cache (written in place)
    start: torch.Tensor,  # [B] (or [1]) first logical slot to write
    generators,  # [B] per-row generators (None = greedy)
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B]
    *,
    attn_impl: str = "xla",
    compute_dtype=None,
):
    """Prompt prefill into a PAGED cache + first sampled token: K/V land in
    the rows' pages through their block tables. With `start` > 0 only the
    suffix is prefilled, at absolute positions. Each sampling row draws
    once from its generator. Returns (kv_pages, tok0 [B] int32)."""
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    start = start.to(device=dev, dtype=torch.long).expand(B)
    lengths = lengths.to(device=dev, dtype=torch.long)
    positions = start[:, None] + torch.arange(T, device=dev)[None, :]
    K = block_tables.shape[1] * kv_pages["k"].shape[2]
    kv_mask = (
        torch.arange(K, device=dev)[None, :] < lengths[:, None]
    ).to(torch.int32)
    h, kv_pages = qwen2.forward(
        params, cfg,
        inputs_embeds=inputs_embeds, positions=positions,
        kv_cache=kv_pages, write_slots=start, kv_mask=kv_mask,
        block_tables=block_tables, kv_lengths=lengths.to(torch.int32),
        attn_impl=attn_impl, compute_dtype=compute_dtype,
        return_hidden=True,
    )
    # Project only each row's last real position (a row whose last token
    # lies outside this window gets a discarded sample).
    last = (lengths - 1 - start).clamp(0, T - 1)
    logits = qwen2.logits_from_hidden(
        params, cfg, h[torch.arange(B, device=dev), last]
    )
    tok0 = sample_token_rows(
        logits, generators, temperature=temperature, top_p=top_p,
        top_k=top_k,
    )
    return kv_pages, tok0


def slice_embeds(embeds: torch.Tensor, start: int, *, width: int
                 ) -> torch.Tensor:
    """[B, T, H] -> the [B, width, H] window at offset `start`, clamped
    into range as XLA's dynamic_slice clamps; callers pad `embeds` so that
    no chunk start needs the clamp (`pad_embeds_for_chunks`)."""
    start = min(max(int(start), 0), embeds.shape[1] - width)
    return embeds[:, start:start + width]


def pad_embeds_for_chunks(embeds: torch.Tensor, chunk: int) -> torch.Tensor:
    """Zero-pad [B, T, H] on the token axis so every `chunk`-wide window
    starting at an offset < T stays in bounds. The padded columns prefill
    garbage KV past each row's real length, which decode overwrites
    before reading or masks out."""
    B, _, H = embeds.shape
    pad = torch.zeros((B, chunk, H), dtype=embeds.dtype, device=embeds.device)
    return torch.cat([embeds, pad], dim=1)


def paged_prefill_chunks(
    params,
    cfg: LLMConfig,
    inputs_embeds: torch.Tensor,  # [B, T, H] right-padded
    lengths: torch.Tensor,  # [B] real TOTAL lengths (incl. cached prefix)
    block_tables: torch.Tensor,  # [B, max_pages] int32
    kv_pages: dict,
    start: int,  # shared first logical slot to write
    generators,  # [B] per-row generators (None = greedy)
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    top_k: torch.Tensor,
    *,
    prefill_chunk: int,
    attn_impl: str = "xla",
    compute_dtype=None,
):
    """`paged_prefill` in bounded `prefill_chunk`-token windows. Valid-slot
    KV and the first token equal the single-shot call's: a row samples
    (and draws from its generator) only in the window that holds its last
    real token. Returns (kv_pages, tok0 [B] int32)."""
    B = inputs_embeds.shape[0]
    dev = inputs_embeds.device
    host_len = [int(x) for x in lengths.tolist()]  # once, at admission
    lengths = lengths.to(device=dev, dtype=torch.long)
    generators = list(generators)
    embeds = pad_embeds_for_chunks(inputs_embeds, prefill_chunk)
    tok0 = torch.zeros((B,), dtype=torch.int32, device=dev)
    off = start
    while off < max(host_len):
        end = off + prefill_chunk
        final = [off <= n - 1 < end for n in host_len]
        kv_pages, tok = paged_prefill(
            params, cfg,
            slice_embeds(embeds, off - start, width=prefill_chunk),
            lengths.clamp(max=end), block_tables, kv_pages,
            torch.tensor([off], device=dev),
            [g if f else None for g, f in zip(generators, final)],
            temperature, top_p, top_k,
            attn_impl=attn_impl, compute_dtype=compute_dtype,
        )
        tok0 = torch.where(torch.tensor(final, device=dev), tok, tok0)
        off = end
    return kv_pages, tok0


def _feed_ids(cfg: LLMConfig, tok: torch.Tensor) -> torch.Tensor:
    """Token ids to embed. A finished row keeps feeding eos_token_id, which
    may lie past a small vocab (test configs); XLA clamps such gathers, so
    the port clamps too. The row's outputs are discarded either way."""
    return tok.long().clamp(max=cfg.vocab_size - 1)


def paged_decode_chunk(
    params,
    cfg: LLMConfig,
    kv_pages: dict,  # written in place
    block_tables: torch.Tensor,  # [S, max_pages] int32
    tok: torch.Tensor,  # [S] next token to feed per slot
    lengths: torch.Tensor,  # [S] kv tokens held per slot (frozen on finish)
    finished: torch.Tensor,  # [S] bool (True for finished AND empty slots)
    recent: torch.Tensor,  # [S, stop_L] rolling stop window (-2 init)
    generators,  # [S] per-slot generators (None = greedy or empty)
    temperature: torch.Tensor,  # [S]
    top_p: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S]
    stop_sequences: torch.Tensor | None = None,  # [Sq, L]
    *,
    chunk: int,
    eos: int,
    attn_impl: str = "xla",
    compute_dtype=None,
    numerics: bool = False,
):
    """`chunk` decode steps over a FIXED-SLOT batch with a paged cache, the
    continuous-batching inner loop. Finished and empty slots still flow
    through the math, but their cache writes are dropped (write_mask) and
    their lengths freeze. No host read inside: the caller harvests once.
    Returns (kv_pages, tok, lengths, finished, recent, toks [S, chunk],
    fin [S, chunk]).

    numerics=True appends one more output: the [6] float32 logit-stat
    accumulator (utils/numerics.py) folded over the chunk's live rows, from
    the logits the sampler reads, so every other output is unchanged."""
    dev = tok.device
    K = block_tables.shape[1] * kv_pages["k"].shape[2]
    slot_ar = torch.arange(K, device=dev)[None, :]
    cur_len = lengths
    nstats = numerics_lib.init_logit_stats(dev) if numerics else None
    toks, fins = [], []
    for _ in range(chunk):
        logits, kv_pages = qwen2.forward(
            params, cfg,
            input_ids=_feed_ids(cfg, tok)[:, None],
            positions=cur_len.long()[:, None],
            kv_cache=kv_pages, write_slots=cur_len,
            kv_mask=(slot_ar <= cur_len[:, None]).to(torch.int32),
            block_tables=block_tables, write_mask=~finished,
            kv_lengths=cur_len + 1,
            attn_impl=attn_impl, compute_dtype=compute_dtype,
        )
        if numerics:
            nstats = numerics_lib.accumulate_logit_stats(
                nstats, logits[:, 0], ~finished
            )
        nxt = sample_token_rows(
            logits[:, 0], generators,
            temperature=temperature, top_p=top_p, top_k=top_k,
        )
        if recent.shape[1]:
            recent = torch.cat([recent[:, 1:], tok[:, None]], dim=1)
        finished = (
            finished | (tok == eos)
            | paged_kv_lib.stop_window_hit(recent, stop_sequences)
        )
        nxt = torch.where(finished, eos, nxt)
        cur_len = cur_len + (~finished).to(torch.int32)
        toks.append(tok)
        fins.append(finished)
        tok = nxt
    out = (kv_pages, tok, cur_len, finished, recent,
           torch.stack(toks, dim=1), torch.stack(fins, dim=1))
    return out + (nstats,) if numerics else out


# ---------------------------------------------------------------------------
# Ragged fused prefill+decode step (one dispatch per engine step)
# ---------------------------------------------------------------------------


def pack_prefill_window(embeds: torch.Tensor, off: int, width: int
                        ) -> torch.Tensor:
    """The [1, width, H] prefill window at logical offset `off` of a
    prompt's embeds [1, T, H], zero-padded past the prompt end, on the
    embeds' device: the dispatch operand keeps one shape for any prompt
    length."""
    T, H = embeds.shape[1], embeds.shape[2]
    out = torch.zeros((1, width, H), dtype=embeds.dtype, device=embeds.device)
    n = max(0, min(width, T - off))
    if n:
        out[0, :n] = embeds[0, off:off + n]
    return out


def unpack_ragged_rows(toks: np.ndarray, live: list[int]
                       ) -> dict[int, list[int]]:
    """Per-slot token streams from a harvest, restricted to the slots that
    were live DURING the dispatch."""
    return {s: [int(t) for t in toks[s]] for s in live}


def paged_ragged_step(
    params,
    cfg: LLMConfig,
    kv_pages: dict,  # written in place
    block_tables: torch.Tensor,  # [S, max_pages] int32
    tok: torch.Tensor,  # [S] next token to feed per slot
    lengths: torch.Tensor,  # [S] kv tokens held per slot (frozen on finish)
    finished: torch.Tensor,  # [S] bool (True for finished AND empty slots)
    recent: torch.Tensor,  # [S, stop_L] rolling stop window (-2 init)
    generators,  # [S] per-slot generators (None = greedy or empty)
    temperature: torch.Tensor,  # [S]
    top_p: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S]
    stop_sequences: torch.Tensor | None,  # [Sq, L]
    pf_embeds: torch.Tensor | None = None,  # [1, chunk*pf_width, H]
    pf_slot: int = 0,  # slot the prefill belongs to
    pf_off: int = 0,  # logical offset of the window start
    pf_len: int = 0,  # total prompt length (incl. prefix)
    pf_generator=None,  # the admitting request's generator (None = greedy)
    pf_temp: torch.Tensor | None = None,  # [1]
    pf_top_p: torch.Tensor | None = None,  # [1]
    pf_top_k: torch.Tensor | None = None,  # [1]
    *,
    chunk: int,
    pf_width: int,
    eos: int,
    attn_impl: str = "xla",
    compute_dtype=None,
    draws: torch.Tensor | None = None,
    numerics: bool = False,
):
    """ONE dispatch for a mixed prefill+decode engine step. Each of the
    `chunk` iterations runs one packed forward over R = S + pf_width rows:
    rows 0..S-1 are the decode lanes (one token per slot, the semantics of
    `paged_decode_chunk`), rows S.. are `pf_width` consecutive suffix
    tokens of the one admitting slot's prompt, so a dispatch advances the
    prefill by chunk * pf_width tokens while every resident stream decodes
    `chunk` tokens. Prefill lanes always write (window overshoot past the
    prompt writes garbage that is overwritten before it is read). The
    prompt's first token is sampled, one draw from `pf_generator`, in the
    iteration whose window holds the prompt's last token. pf_width = 0 is
    a pure packed decode step. `draws`: as in `sample_token_rows`.

    Returns (kv_pages, tok, lengths, finished, recent, toks [S, chunk],
    fin [S, chunk], pf_tok0 ([] int32, or None when no window held the
    prompt's last token)); numerics=True appends the [6] logit-stat
    accumulator of the decode lanes (as in `paged_decode_chunk`; prefill
    lanes' logits are prompt positions, not sampling inputs)."""
    S = tok.shape[0]
    W = pf_width
    dev = tok.device
    cur_len = lengths
    seg0 = torch.arange(S, dtype=torch.int32, device=dev)
    pf_seg = torch.full((W,), pf_slot, dtype=torch.int32, device=dev)
    pf_ar = torch.arange(W, dtype=torch.int32, device=dev)
    pf_wm = torch.ones((W,), dtype=torch.bool, device=dev)
    pf_tok0 = None
    nstats = numerics_lib.init_logit_stats(dev) if numerics else None
    toks, fins = [], []
    for i in range(chunk):
        emb = embed_rows(params.embed, _feed_ids(cfg, tok))  # [S, H]
        if compute_dtype is not None:
            emb = emb.to(compute_dtype)
        seg, pos, wm = seg0, cur_len, ~finished
        if W:
            win = pf_embeds[0, i * W:(i + 1) * W].to(emb.dtype)
            emb = torch.cat([emb, win], dim=0)
            pos = torch.cat([pos, pf_off + i * W + pf_ar])
            seg = torch.cat([seg, pf_seg])
            wm = torch.cat([wm, pf_wm])
        h, kv_pages = qwen2.forward(
            params, cfg,
            inputs_embeds=emb[None], positions=pos[None],
            kv_cache=kv_pages, block_tables=block_tables,
            q_segments=seg[None], write_mask=wm[None],
            attn_impl=attn_impl, compute_dtype=compute_dtype,
            return_hidden=True,
        )
        logits = qwen2.logits_from_hidden(params, cfg, h[0, :S])
        if numerics:
            nstats = numerics_lib.accumulate_logit_stats(
                nstats, logits, ~finished
            )
        nxt = sample_token_rows(
            logits, generators,
            temperature=temperature, top_p=top_p, top_k=top_k, draws=draws,
        )
        if recent.shape[1]:
            recent = torch.cat([recent[:, 1:], tok[:, None]], dim=1)
        finished = (
            finished | (tok == eos)
            | paged_kv_lib.stop_window_hit(recent, stop_sequences)
        )
        nxt = torch.where(finished, eos, nxt)
        cur_len = cur_len + (~finished).to(torch.int32)
        j = pf_len - 1 - pf_off - i * W  # the prompt's last token, if here
        if W and 0 <= j < W:
            pf_tok0 = sample_token_rows(
                qwen2.logits_from_hidden(params, cfg, h[0, S + j][None]),
                [pf_generator],
                temperature=pf_temp, top_p=pf_top_p, top_k=pf_top_k,
            )[0]
        toks.append(tok)
        fins.append(finished)
        tok = nxt
    out = (kv_pages, tok, cur_len, finished, recent,
           torch.stack(toks, dim=1), torch.stack(fins, dim=1), pf_tok0)
    return out + (nstats,) if numerics else out


def paged_fused_steps(
    params,
    cfg: LLMConfig,
    kv_pages: dict,  # written in place
    block_tables: torch.Tensor,  # [S, max_pages] int32
    tok: torch.Tensor,  # [S]
    lengths: torch.Tensor,  # [S]
    finished: torch.Tensor,  # [S] bool
    recent: torch.Tensor,  # [S, stop_L]
    generators,  # [S] per-slot generators (None = greedy or empty)
    temperature: torch.Tensor,  # [S]
    top_p: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S]
    stop_sequences: torch.Tensor | None,  # [Sq, L]
    *,
    chunk: int,
    k_steps: int,
    eos: int,
    attn_impl: str = "xla",
    compute_dtype=None,
    draws: torch.Tensor | None = None,
    numerics: bool = False,
):
    """K = `k_steps` pure-decode engine steps with one harvest, the decode
    megastep: `paged_ragged_step`'s pure-decode iteration (pf_width = 0)
    run k_steps * chunk times, so K calls of the K = 1 step and one call of
    this give the same carries and tokens. Columns [j * chunk, (j + 1) *
    chunk) of the returned toks are logical step j's; the host processes
    them as K harvests. Rows the host would have finished between steps
    (max_new, stop strings) decode on; the host discards those columns,
    and their KV stays in the row's own pages. On the card the engine runs
    this as K replays of one captured logical step (`_EngineStepGraph`).

    Returns (kv_pages, tok, lengths, finished, recent,
    toks [S, k_steps * chunk], fin [S, k_steps * chunk]); numerics=True
    appends the logit-stat accumulator (the engine arms it at K = 1
    only)."""
    out = paged_ragged_step(
        params, cfg, kv_pages, block_tables, tok, lengths, finished, recent,
        generators, temperature, top_p, top_k, stop_sequences,
        chunk=chunk * k_steps, pf_width=0, eos=eos, attn_impl=attn_impl,
        compute_dtype=compute_dtype, draws=draws, numerics=numerics,
    )
    return out[:7] + (out[8],) if numerics else out[:7]


# ---------------------------------------------------------------------------
# Speculative decoding: drafted multi-token steps verified in one packed
# forward
# ---------------------------------------------------------------------------


class Drafter:
    """Pluggable draft-token proposer for speculative decoding.

    `propose(context, k)` returns UP TO `k` token ids predicted to continue
    `context` (the request's confirmed stream: prompt ids + device-confirmed
    reply tokens + the pending fed token). Fewer, or none, are always legal:
    unproposed lanes ride the verify dispatch masked. Implementations must
    be deterministic functions of `context` (an eviction replay re-proposes
    from the same context and must re-derive the same accept pattern).

    `window` (None = unbounded) is how much context tail the drafter reads;
    the scheduler materializes only that suffix per step.

    Device contract (opt-in): a drafter that runs on the accelerator, inside
    the fused speculative megastep, returns its parameters from
    `device_params(device)` and names a module-level
    `device_apply(params, ctx, ctx_len, fed, k) -> (drafts, draft_len)`.
    device_params() returning None means host-only: such a drafter serves
    the per-step path, and the scheduler refuses fuse_steps > 1 with it."""

    window: int | None = None
    device_apply = None

    def propose(self, context, k: int) -> list[int]:
        raise NotImplementedError

    def device_params(self, device=None):
        return None


class NgramDrafter(Drafter):
    """Prompt-lookup / n-gram self-drafting: find the most recent earlier
    occurrence of the longest suffix n-gram of the context and propose the
    tokens that followed it. A host lookup in the request's own tokens; the
    verify dispatch prices each proposal at one more lane."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 window: int | None = 2048):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram=} {max_ngram=}"
            )
        if window is not None and window < max_ngram + 1:
            raise ValueError(
                f"window must cover at least one n-gram + continuation "
                f"(>= max_ngram + 1), got {window=} {max_ngram=}"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.window = window

    def propose(self, context, k: int) -> list[int]:
        a = np.asarray(context, np.int64).reshape(-1)
        if self.window is not None and a.shape[0] > self.window:
            a = a[-self.window:]
        n_ctx = int(a.shape[0])
        if k <= 0 or n_ctx < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_ctx - 1), self.min_ngram - 1,
                       -1):
            suf = a[-n:]
            w = n_ctx - n  # candidate starts 0..w-1
            m = np.ones(w, bool)
            for j in range(n):
                m &= a[j: j + w] == suf[j]
            idx = np.nonzero(m)[0]
            if idx.size:
                i = int(idx[-1])  # the most recent earlier occurrence
                cont = a[i + n: i + n + k]
                if cont.size:
                    return [int(x) for x in cont]
        return []


def spec_verify_rows(
    lg: torch.Tensor,  # [S, k + 1, V] verify-lane logits
    tok: torch.Tensor,  # [S] fed token per slot (lane 0's input)
    drafts: torch.Tensor,  # [S, k] proposals (garbage past draft_len)
    draft_len: torch.Tensor,  # [S] real proposals per slot (0..k)
    generators,  # [S] per-slot generators (None = greedy or empty)
    *,
    temperature: torch.Tensor,  # [S]
    top_p: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S]
    eos: int,
    draws: torch.Tensor | None = None,  # [S] bool, as in sample_token_rows
) -> tuple[torch.Tensor, torch.Tensor]:
    """Accept / resample core of speculative decoding over verify-lane
    logits. Returns (acc [S], cand [S]) int32.

    Lane j's logits are the model's distribution for the token after
    [tok, d_0..d_{j-1}]; drafts[s, j] is the proposal for that position.
    Acceptance is the longest matching prefix: a greedy row (temperature
    <= 0) accepts d_j iff it equals the raw argmax, so accepted tokens are
    the ones sequential greedy decode would emit; a sampling row accepts
    d_j with probability p'(d_j) of the truncated target p'
    (`truncate_logits_rows`, as `sample_token_rows` shapes it), and on a
    rejection draws the bonus token from p' with d_j masked out, so each
    emitted token is distributed exactly as p' (point-mass rejection
    sampling). `acc` counts accepted drafts, truncated at the first
    accepted EOS (inclusive) and 0 when the fed token is EOS; `cand` is the
    bonus token at lane acc, the next step's fed token.

    RNG: a sampling row draws a fixed count per step whatever its accept
    pattern, k accept uniforms then one V-wide row of uniforms (the bonus's
    Gumbel noise), from its own generator; greedy rows draw nothing. The
    eager step, the fused loop and an engine-step graph draw the same
    numbers."""
    S, k = drafts.shape
    lanes = k + 1
    V = lg.shape[-1]
    dev = lg.device
    drafts = drafts.to(torch.int32)
    tgt = torch.argmax(lg, dim=-1).to(torch.int32)  # [S, lanes]
    rows = [i for i, g in enumerate(generators) if g is not None]
    is_greedy = temperature <= 0.0
    if rows:
        l_t, _ = truncate_logits_rows(
            lg.reshape(S * lanes, V),
            temperature=_rep(temperature, lanes), top_p=_rep(top_p, lanes),
            top_k=_rep(top_k, lanes),
        )
        l_t = l_t.reshape(S, lanes, V)
        u_acc = torch.ones((S, k), dtype=torch.float32, device=dev)
        u_res = torch.full((S, V), 0.5, dtype=torch.float32, device=dev)
        for i in rows:
            if k:
                u_acc[i] = torch.rand(k, generator=generators[i], device=dev)
            u_res[i] = torch.rand(V, generator=generators[i], device=dev)
        drew = _drew(draws, rows, S, dev)
    if k:
        ok = drafts == tgt[:, :k]
        if rows:
            p = torch.softmax(l_t[:, :k], dim=-1)
            p_d = torch.gather(p, 2, drafts[..., None].long())[..., 0]
            ok = torch.where(is_greedy[:, None], ok, u_acc < p_d)
        jr = torch.arange(k, dtype=torch.int32, device=dev)[None, :]
        ok = ok & (jr < draft_len.to(torch.int32)[:, None])
        cum = torch.cumprod(ok.to(torch.int32), dim=1)  # leading accepts
        # Truncate at the first accepted EOS (inclusive).
        hit_eos = cum * (drafts == eos).to(torch.int32)
        eos_before = torch.cumsum(hit_eos, dim=1) - hit_eos
        acc = torch.sum(cum * (eos_before == 0), dim=1).to(torch.int32)
    else:
        acc = torch.zeros_like(tok, dtype=torch.int32)
    acc = torch.where(tok == eos, 0, acc)
    b = acc.long()  # the bonus lane
    cand = torch.gather(tgt, 1, b[:, None])[:, 0]
    if rows:
        l_sel = torch.gather(
            l_t, 1, b[:, None, None].expand(S, 1, V))[:, 0]
        d_pad = torch.cat(
            [drafts, torch.full((S, 1), -1, dtype=torch.int32, device=dev)],
            dim=1)
        d_b = torch.gather(d_pad, 1, b[:, None])[:, 0]
        rejected = acc < draft_len.to(torch.int32)
        vocab = torch.arange(V, dtype=torch.int32, device=dev)[None]
        l_res = torch.where(
            rejected[:, None] & (vocab == d_b[:, None]), -torch.inf, l_sel)
        sampled = torch.argmax(l_res + _gumbel(u_res), dim=-1)
        cand = torch.where(drew & ~is_greedy, sampled.to(torch.int32), cand)
    return acc, cand


def _rep(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each element of [S] repeated n times, slot-major ([S * n])."""
    return x[:, None].expand(x.shape[0], n).reshape(-1)


def paged_spec_step(
    params,
    cfg: LLMConfig,
    kv_pages: dict,  # written in place
    block_tables: torch.Tensor,  # [S, max_pages] int32
    tok: torch.Tensor,  # [S] next token to feed per slot
    lengths: torch.Tensor,  # [S] kv tokens held per slot
    finished: torch.Tensor,  # [S] bool (True for finished AND empty slots)
    generators,  # [S] per-slot generators (None = greedy or empty)
    temperature: torch.Tensor,  # [S]
    top_p: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S]
    drafts: torch.Tensor,  # [S, k] proposed tokens
    draft_len: torch.Tensor,  # [S] real proposals per slot
    pf_embeds: torch.Tensor | None = None,  # [1, pf_width, H]
    pf_slot: int = 0,
    pf_off: int = 0,
    pf_len: int = 0,
    pf_generator=None,
    pf_temp: torch.Tensor | None = None,  # [1]
    pf_top_p: torch.Tensor | None = None,  # [1]
    pf_top_k: torch.Tensor | None = None,  # [1]
    *,
    k: int,
    pf_width: int,
    eos: int,
    attn_impl: str = "xla",
    compute_dtype=None,
    draws: torch.Tensor | None = None,
):
    """ONE dispatch for a speculative engine step: a single packed forward
    in which every slot rides 1 + k verify lanes (its fed token and k
    drafts at consecutive positions, `spec_lane_metadata`) and the one
    admitting slot rides `pf_width` prefill lanes, through K4 like any
    packed row. A slot advances 1..k+1 tokens a step.

    KV discipline: lanes write at positions len..len+k of the slot's own
    pages (shared prefix pages end below the prompt; the partial boundary
    page is copied on write at admission), and only a live slot's lanes up
    to its draft_len write. Accepted drafts splice by advancing lengths
    over KV already written; rejected ones leave dead bytes past lengths
    that masking never reads and the next real token overwrites. Rollback
    frees and copies nothing.

    The prefill lanes' first token is drawn as in `paged_ragged_step`: one
    draw from `pf_generator` when the window holds the prompt's last token.

    Returns (kv_pages, nxt, lengths, finished, toks [S, k+1], n_new [S],
    acc [S], pf_tok0 ([] int32 or None)): toks[s, :n_new[s]] are the
    tokens slot s emitted this step (the fed token and its accepted
    drafts, EOS past n_new); nxt is the bonus token each slot feeds next.
    Greedy rows equal n_new steps of `paged_ragged_step`."""
    S = tok.shape[0]
    lanes = k + 1
    W = pf_width
    dev = tok.device
    drafts = drafts.to(torch.int32)
    ids = torch.cat([tok.to(torch.int32)[:, None], drafts], dim=1)
    emb = embed_rows(params.embed, _feed_ids(cfg, ids.reshape(-1)))
    if compute_dtype is not None:
        emb = emb.to(compute_dtype)
    seg, pos = paged_kv_lib.spec_lane_metadata(lengths, k)
    lane_j = torch.arange(lanes, dtype=torch.int32, device=dev).repeat(S)
    wm = _rep(~finished, lanes) & (
        lane_j <= _rep(draft_len.to(torch.int32), lanes))
    if W:
        emb = torch.cat([emb, pf_embeds[0].to(emb.dtype)], dim=0)
        pos = torch.cat(
            [pos, pf_off + torch.arange(W, dtype=torch.int32, device=dev)])
        seg = torch.cat(
            [seg, torch.full((W,), pf_slot, dtype=torch.int32, device=dev)])
        wm = torch.cat([wm, torch.ones((W,), dtype=torch.bool, device=dev)])
    h, kv_pages = qwen2.forward(
        params, cfg,
        inputs_embeds=emb[None], positions=pos[None],
        kv_cache=kv_pages, block_tables=block_tables,
        q_segments=seg[None], write_mask=wm[None],
        attn_impl=attn_impl, compute_dtype=compute_dtype,
        return_hidden=True,
    )
    lg = qwen2.logits_from_hidden(params, cfg, h[0, :S * lanes])
    acc, cand = spec_verify_rows(
        lg.reshape(S, lanes, -1), tok, drafts, draft_len, generators,
        temperature=temperature, top_p=top_p, top_k=top_k, eos=eos,
        draws=draws,
    )
    jr = torch.arange(k, dtype=torch.int32, device=dev)[None, :]
    accepted = jr < acc[:, None]
    out_toks = torch.cat(
        [tok.to(torch.int32)[:, None], torch.where(accepted, drafts, eos)],
        dim=1)
    acc_eos = torch.any(accepted & (drafts == eos), dim=1)
    fed_eos = tok == eos
    new_finished = finished | fed_eos | acc_eos
    n_new = torch.where(finished, 0, 1 + acc)
    # lengths counts confirmed non-EOS KV tokens, as the sequential step's
    # `lengths + ~finished` does.
    inc = torch.where(finished | fed_eos, 0,
                      1 + acc - acc_eos.to(torch.int32))
    nxt = torch.where(new_finished, eos, cand)
    pf_tok0 = None
    j = pf_len - 1 - pf_off  # the prompt's last token, if in this window
    if W and 0 <= j < W:
        pf_tok0 = sample_token_rows(
            qwen2.logits_from_hidden(params, cfg, h[0, S * lanes + j][None]),
            [pf_generator], temperature=pf_temp, top_p=pf_top_p,
            top_k=pf_top_k,
        )[0]
    return (kv_pages, nxt.to(torch.int32), (lengths + inc).to(torch.int32),
            new_finished, out_toks, n_new.to(torch.int32), acc, pf_tok0)


def _shift_draft_ctx(ctx: torch.Tensor, ctx_len: torch.Tensor,
                    toks: torch.Tensor, n_new: torch.Tensor):
    """The right-aligned draft context [S, CW] after a verify step: the
    first n_new[s] of toks[s] (the confirmed tokens) shifted in. A row
    with n_new 0 keeps its window. Returns (ctx, ctx_len)."""
    S, CW = ctx.shape
    ext = torch.cat([ctx, toks.to(ctx.dtype)], dim=1)
    idx = n_new.long()[:, None] + torch.arange(CW, device=ctx.device)[None]
    return (torch.gather(ext, 1, idx),
            torch.minimum(ctx_len + n_new, torch.full_like(ctx_len, CW)))


def paged_fused_spec_steps(
    params,
    cfg: LLMConfig,
    kv_pages: dict,  # written in place
    block_tables: torch.Tensor,  # [S, max_pages] int32
    tok: torch.Tensor,  # [S]
    lengths: torch.Tensor,  # [S]
    finished: torch.Tensor,  # [S] bool
    generators,  # [S] per-slot generators (None = greedy or empty)
    temperature: torch.Tensor,  # [S]
    top_p: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S]
    draft_params,  # drafter.device_params(device)
    draft_ctx: torch.Tensor,  # [S, CW] right-aligned confirmed tail (no fed)
    draft_ctx_len: torch.Tensor,  # [S] valid entries in draft_ctx
    *,
    k: int,
    k_steps: int,
    eos: int,
    attn_impl: str = "xla",
    compute_dtype=None,
    draft_apply,
    draws: torch.Tensor | None = None,
):
    """K = `k_steps` speculative pure-decode engine steps with one harvest:
    each iteration drafts k tokens on the device (`draft_apply`, the same
    math as the drafter's host `propose`), verifies them as
    `paged_spec_step` with no prefill lanes, and shifts the confirmed
    tokens into the draft context, as the host would have assembled it
    between dispatches. So K fused steps emit the bytes of K sequential
    speculative steps with the same drafter.

    Returns (kv_pages, tok, lengths, finished,
    toks [S, k_steps * (k+1)], n_new [S, k_steps], acc [S, k_steps],
    ctx, ctx_len) — logical step j owns toks[:, j * (k+1):(j+1) * (k+1)],
    of which the first n_new[:, j] are real; the shifted context is the
    graph's carry (the eager engine rebuilds it on the host)."""
    ctx, clen = draft_ctx, draft_ctx_len.to(torch.int32)
    toks, n_news, accs = [], [], []
    for _ in range(k_steps):
        drafts, dlen = draft_apply(draft_params, ctx, clen, tok, k)
        kv_pages, tok, lengths, finished, out, n_new, acc, _ = (
            paged_spec_step(
                params, cfg, kv_pages, block_tables, tok, lengths,
                finished, generators, temperature, top_p, top_k, drafts,
                dlen, k=k, pf_width=0, eos=eos, attn_impl=attn_impl,
                compute_dtype=compute_dtype, draws=draws,
            ))
        ctx, clen = _shift_draft_ctx(ctx, clen, out, n_new)
        toks.append(out)
        n_news.append(n_new)
        accs.append(acc)
    return (kv_pages, tok, lengths, finished, torch.cat(toks, dim=1),
            torch.stack(n_news, dim=1), torch.stack(accs, dim=1), ctx, clen)


# ---------------------------------------------------------------------------
# A trained draft model: a tiny proposer behind the Drafter seam whose chain
# runs on the device inside the fused speculative megastep
# ---------------------------------------------------------------------------

# Positional decay of the context-mixing weights: the token at distance d
# from the window's right edge weighs DRAFT_DECAY ** d. Part of the
# checkpoint contract (the JAX package's value).
DRAFT_DECAY = 0.9


def _draft_logits(params, buf: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Next-token logits [S, V] of the decayed-bag draft model over a
    right-aligned token window `buf` [S, W] whose last n[s] entries are
    valid: the decayed mean of the window's embeddings, projected to the
    vocabulary."""
    W = buf.shape[1]
    idx = torch.arange(W, device=buf.device)[None, :]
    valid = idx >= (W - n.long()[:, None])
    w = torch.pow(DRAFT_DECAY, (W - 1 - idx).to(torch.float32)) * valid.to(
        torch.float32)  # [S, W]
    # Out-of-range ids (EOS past a small vocabulary) clamp, as XLA's
    # gather does.
    emb = params["embed"][buf.long().clamp(0, params["embed"].shape[0] - 1)]
    h = torch.sum(w[..., None] * emb, dim=1) / torch.clamp(
        torch.sum(w, dim=1, keepdim=True), min=1e-6)
    return h @ params["proj"]


def _draft_chain(params, buf: torch.Tensor, n: torch.Tensor, *, k: int
                 ) -> torch.Tensor:
    """Greedy k-token draft chain (argmax, shift in, repeat): a
    deterministic proposer, as the Drafter contract asks. Returns [S, k]
    int32."""
    out = []
    n = n.to(torch.int32)
    for _ in range(k):
        nxt = torch.argmax(_draft_logits(params, buf, n), dim=-1).to(
            torch.int32)
        buf = torch.cat([buf[:, 1:], nxt[:, None]], dim=1)
        n = torch.clamp(n + 1, max=buf.shape[1])
        out.append(nxt)
    return torch.stack(out, dim=1)


def neural_draft_propose(draft_params, ctx: torch.Tensor,
                         ctx_len: torch.Tensor, fed: torch.Tensor, k: int):
    """`NeuralDrafter.device_apply`: shift the fed token into the
    right-aligned window ctx [S, W] (the host contract hands `propose` the
    stream including the fed token) and run the chain. Returns
    (drafts [S, k] int32, draft_len [S] int32, always k)."""
    buf = torch.cat([ctx[:, 1:].to(torch.int32),
                     fed.to(torch.int32)[:, None]], dim=1)
    n = torch.clamp(ctx_len.to(torch.int32) + 1, max=ctx.shape[1])
    drafts = _draft_chain(draft_params, buf, n, k=k)
    return drafts, torch.full(fed.shape, k, dtype=torch.int32,
                              device=fed.device)


class NeuralDrafter(Drafter):
    """A tiny trained draft model (decayed bag of embeddings -> vocabulary
    projection) with both halves of the Drafter seam: `propose` on the host
    and the device contract (`device_params(device)`, `device_apply`) that
    runs the same chain inside the fused speculative megastep. Both call
    `_draft_chain` on the same right-aligned window, so on one device they
    propose the same bits.

    Checkpoints are .npz files (embed [V, D] f32, proj [D, V] f32, window),
    the JAX package's format: an npz written by either loads in both.
    `from_spec` takes a path or "init:V:D:W:SEED" (random weights drawn
    from a torch.Generator, so they are the port's own; a random drafter
    accepts almost nothing, which is slow but correct)."""

    def __init__(self, params: dict, window: int = 16,
                 source: str | None = None):
        embed = np.asarray(params["embed"], np.float32)
        proj = np.asarray(params["proj"], np.float32)
        if embed.ndim != 2 or proj.ndim != 2 or embed.shape[1] != \
                proj.shape[0] or embed.shape[0] != proj.shape[1]:
            raise ValueError(
                f"drafter params must be embed [V, D] / proj [D, V], got "
                f"{embed.shape} / {proj.shape}"
            )
        if window < 1:
            raise ValueError(f"drafter window must be >= 1, got {window}")
        self.params = {"embed": embed, "proj": proj}
        self.window = int(window)
        self.source = source
        self._on: dict = {}

    @classmethod
    def init(cls, vocab_size: int, dim: int = 16, *, window: int = 16,
             seed: int = 0) -> "NeuralDrafter":
        g = torch.Generator().manual_seed(int(seed))
        return cls(
            {
                "embed": 0.02 * torch.randn((vocab_size, dim), generator=g),
                "proj": 0.02 * torch.randn((dim, vocab_size), generator=g),
            },
            window=window,
            source=f"init:{vocab_size}:{dim}:{window}:{seed}",
        )

    @classmethod
    def load(cls, path: str) -> "NeuralDrafter":
        with np.load(path) as z:
            return cls(
                {"embed": z["embed"], "proj": z["proj"]},
                window=int(z["window"]), source=str(path),
            )

    def save(self, path: str) -> None:
        np.savez(
            path, embed=self.params["embed"], proj=self.params["proj"],
            window=np.int64(self.window),
        )

    @classmethod
    def from_spec(cls, spec: str) -> "NeuralDrafter":
        """"init:V:D:W:SEED" -> random init; anything else -> npz path."""
        if spec.startswith("init:"):
            parts = spec.split(":")
            if len(parts) != 5:
                raise ValueError(
                    f"drafter init spec must be init:V:D:W:SEED, got "
                    f"{spec!r}"
                )
            v, d, w, s = (int(p) for p in parts[1:])
            return cls.init(v, d, window=w, seed=s)
        return cls.load(spec)

    def device_params(self, device=None) -> dict:
        """The weights as fp32 tensors on `device` (the CPU by default),
        made once per device."""
        dev = torch.device("cpu" if device is None else device)
        key = str(dev)
        if key not in self._on:
            self._on[key] = {name: torch.from_numpy(x).to(dev)
                             for name, x in self.params.items()}
        return self._on[key]

    device_apply = staticmethod(neural_draft_propose)

    def propose(self, context, k: int) -> list[int]:
        a = np.asarray(context, np.int64).reshape(-1)[-self.window:]
        if k <= 0 or a.size == 0:
            return []
        buf = np.zeros((1, self.window), np.int32)
        buf[0, self.window - a.size:] = a
        drafts = _draft_chain(
            self.device_params(), torch.from_numpy(buf),
            torch.tensor([a.size], dtype=torch.int32), k=k,
        )
        return [int(x) for x in drafts[0].tolist()]


def fit_neural_drafter(
    streams,
    vocab_size: int,
    *,
    dim: int = 16,
    window: int = 16,
    epochs: int = 30,
    lr: float = 0.5,
    seed: int = 0,
    init: NeuralDrafter | None = None,
) -> tuple[NeuralDrafter, list[float]]:
    """Train a NeuralDrafter on token streams: next-token cross-entropy,
    full-batch gradient descent through torch autograd, fp32 on the CPU.
    `init` starts from a given drafter's weights (its window wins) instead
    of `NeuralDrafter.init(vocab_size, dim, window=window, seed=seed)`.
    Returns (drafter, per-epoch losses)."""
    if init is not None:
        window = init.window
    bufs, ns, tgts = [], [], []
    for stream in streams:
        a = np.asarray(stream, np.int64).reshape(-1)
        for t in range(1, a.size):
            ctx = a[max(0, t - window): t]
            row = np.zeros((window,), np.int32)
            row[window - ctx.size:] = ctx
            bufs.append(row)
            ns.append(ctx.size)
            tgts.append(a[t])
    if not bufs:
        raise ValueError("fit_neural_drafter needs at least one 2-token "
                         "stream")
    buf = torch.from_numpy(np.stack(bufs))
    n = torch.from_numpy(np.asarray(ns, np.int32))
    tgt = torch.from_numpy(np.asarray(tgts, np.int64))
    start = init or NeuralDrafter.init(vocab_size, dim, window=window,
                                       seed=seed)
    params = {name: torch.from_numpy(x.copy())
              for name, x in start.params.items()}
    losses = []
    with torch.enable_grad(), torch.inference_mode(False):
        for _ in range(epochs):
            for p in params.values():
                p.requires_grad_(True)
            loss = torch.nn.functional.cross_entropy(
                _draft_logits(params, buf, n), tgt)
            grads = torch.autograd.grad(loss, list(params.values()))
            params = {name: (p - lr * g).detach()
                      for (name, p), g in zip(params.items(), grads)}
            losses.append(loss.item())
    out = NeuralDrafter(
        {name: p.numpy() for name, p in params.items()}, window=window,
        source=f"fit:{vocab_size}:{dim}:{window}:{seed}",
    )
    return out, losses


# ---------------------------------------------------------------------------
# The paged engine's pure-decode step as a CUDA graph
# ---------------------------------------------------------------------------


class _EngineStepGraph:
    """One logical pure-decode step of the paged engine captured as one
    CUDA graph: `chunk` packed decode iterations (`paged_fused_steps`, one
    step) or, with k drafts a slot, one verify iteration
    (`paged_fused_spec_steps`, one step, the drafter's chain in the graph)
    or `paged_spec_step` on drafts the host proposed.

    The pool is the engine's own and is captured in place: the graph
    writes it through the block tables, and a rebuilt pool needs new
    graphs. The rest of the state lives in buffers the graph owns (`state`:
    block tables, the slots' carry, their sampling knobs, `draws`, and the
    draft context or the host's drafts): the engine copies its host arrays
    in before a dispatch, replays the graph once per logical step (each
    replay leaves its carry where the next one reads it), and reads the
    carry and the outputs after. Replay j writes its tokens (and n_new and
    acc) into column block `step` of output buffers of `max_steps` blocks
    and moves `step` on, so K replays leave K logical steps for one harvest.

    A sampling graph owns one generator per slot, registered with it; the
    engine copies each sampling slot's generator state in before the
    replays and back after, and `draws` marks the slots whose draws count.
    Capture runs one eager step first, over all-finished state that writes
    nothing to the pool, and raises if it fails.

    numerics (k = 0 only): the step is `paged_fused_steps(numerics=True)`,
    a graph of its own (the engine keys it apart from the unarmed one),
    which leaves the logit-stat accumulator in `nstats`; it replays once a
    dispatch (an armed engine never fuses). `owner` (the engine's tag)
    and the key label the capture for the capture watchdog."""

    def __init__(self, params, cfg: LLMConfig, kv_pages: dict, key, *,
                 num_slots: int, max_pages: int, chunk: int, k: int,
                 stop, eos: int, attn_impl: str, compute_dtype,
                 sampling: bool, draft, max_steps: int,
                 device: torch.device, numerics: bool = False,
                 owner: str = ""):
        if numerics and k:
            raise ValueError("the numerics probe rides no speculative step")
        S, dev = num_slots, device
        self.key, self.k, self.max_steps = key, k, max_steps
        self.numerics = numerics
        self.nstats = numerics_lib.init_logit_stats(dev) if numerics else None
        self.width = k + 1 if k else chunk
        self.draft = draft  # None, or (params on dev, device_apply, window)

        def ints(*shape, fill=0):
            return torch.full(shape, fill, dtype=torch.int32, device=dev)

        stop_L = 0 if stop is None else stop.shape[1]
        st = {
            "bt": ints(S, max_pages, fill=kv_pages["k"].shape[1]),
            "tok": ints(S), "lengths": ints(S),
            "finished": torch.ones(S, dtype=torch.bool, device=dev),
            "recent": ints(S, stop_L, fill=-2),
            "temp": torch.zeros(S, device=dev),
            "top_p": torch.ones(S, device=dev), "top_k": ints(S),
            "draws": torch.zeros(S, dtype=torch.bool, device=dev),
        }
        if k and draft is None:
            st.update(drafts=ints(S, k), dlen=ints(S))
        elif k:
            st.update(ctx=ints(S, draft[2]), clen=ints(S))
        self.state = st
        self.step = torch.zeros(1, dtype=torch.long, device=dev)
        self.toks = ints(S, max_steps, self.width)
        if k:
            self.n_new = ints(S, max_steps)
            self.acc = ints(S, max_steps)
        self.gens = [torch.Generator(device=dev) if sampling else None
                     for _ in range(S)]
        common = dict(eos=eos, attn_impl=attn_impl,
                      compute_dtype=compute_dtype,
                      draws=st["draws"] if sampling else None)

        def body():
            if not k:
                out = paged_fused_steps(
                    params, cfg, kv_pages, st["bt"], st["tok"],
                    st["lengths"], st["finished"], st["recent"], self.gens,
                    st["temp"], st["top_p"], st["top_k"], stop, chunk=chunk,
                    k_steps=1, numerics=numerics, **common)
                carry = dict(tok=out[1], lengths=out[2], finished=out[3],
                             recent=out[4])
                toks = out[5]
                if numerics:
                    self.nstats.copy_(out[7])
            elif draft is None:
                out = paged_spec_step(
                    params, cfg, kv_pages, st["bt"], st["tok"],
                    st["lengths"], st["finished"], self.gens, st["temp"],
                    st["top_p"], st["top_k"], st["drafts"], st["dlen"], k=k,
                    pf_width=0, **common)
                carry = dict(tok=out[1], lengths=out[2], finished=out[3])
                toks, n_new, acc = out[4:7]
            else:
                out = paged_fused_spec_steps(
                    params, cfg, kv_pages, st["bt"], st["tok"],
                    st["lengths"], st["finished"], self.gens, st["temp"],
                    st["top_p"], st["top_k"], draft[0], st["ctx"],
                    st["clen"], k=k, k_steps=1, draft_apply=draft[1],
                    **common)
                carry = dict(tok=out[1], lengths=out[2], finished=out[3],
                             ctx=out[7], clen=out[8])
                toks, n_new, acc = out[4], out[5][:, 0], out[6][:, 0]
            for name, x in carry.items():
                st[name].copy_(x)
            self.toks.index_copy_(1, self.step, toks[:, None])
            if k:
                self.n_new.index_copy_(1, self.step, n_new[:, None])
                self.acc.index_copy_(1, self.step, acc[:, None])
            self.step.add_(1)

        self.body = body
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            body()  # builds the kernels and the libraries' state
            self.step.zero_()
        self.graph = graphs.CountedGraph()
        with self.graph.capture(
            stream, [g for g in self.gens if g is not None],
            label=graphs.key_label("engine_step", key, owner),
        ):
            body()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.capture_s = time.perf_counter() - t0

    def run(self, host: dict, gens, k_steps: int) -> dict:
        """Copy the host arrays `host` (name -> numpy) into the state, the
        sampling slots' generator states in, replay k_steps times, and copy
        the generator states back. Returns the device outputs: the carry
        (tok, lengths, finished, recent) and toks [S, k_steps * width]
        (speculating: n_new and acc [S, k_steps]; armed: nstats), valid
        until the next run."""
        most = 1 if self.numerics else self.max_steps
        if k_steps > most:
            raise ValueError(f"{k_steps=} > the graph's {most}")
        st = self.state
        for name, x in host.items():
            st[name].copy_(torch.from_numpy(np.ascontiguousarray(x)))
        self.step.zero_()
        sampling = [(s, g) for s, g in enumerate(gens)
                    if g is not None and self.gens[s] is not None]
        for s, g in sampling:
            self.gens[s].set_state(g.get_state())
        for _ in range(k_steps):
            self.graph.replay()
        for s, g in sampling:
            g.set_state(self.gens[s].get_state())
        S = self.toks.shape[0]
        out = {name: st[name] for name in ("tok", "lengths", "finished",
                                           "recent")}
        out["toks"] = self.toks[:, :k_steps].reshape(S, -1)
        if self.numerics:
            out["nstats"] = self.nstats
        if self.k:
            out["n_new"] = self.n_new[:, :k_steps]
            out["acc"] = self.acc[:, :k_steps]
        return out


# ---------------------------------------------------------------------------
# Paged generation driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedState:
    """Host half of a paged decode: the device page pool plus the block
    tables and free list that address it (owned by serve/scheduler.py for
    continuous batching)."""

    kv_pages: dict
    block_tables: np.ndarray  # [B, max_pages] int32 (sentinel-padded)
    allocator: paged_kv_lib.PageAllocator

    @property
    def page_size(self) -> int:
        return self.allocator.page_size


def _grow_block_tables(
    state: PagedState, row_tokens: list[int], max_pages: int
) -> np.ndarray:
    """Ensure each row's block table covers row_tokens[b] logical slots,
    allocating from the state's free list; widens (or narrows, freeing
    what falls off) the table to `max_pages` columns, sentinel-padded.
    Raises OutOfPagesError with nothing allocated if the pool cannot
    satisfy the TOTAL ask."""
    alloc = state.allocator
    bt = state.block_tables
    B, old = bt.shape
    out = np.full((B, max_pages), alloc.sentinel, np.int32)
    out[:, : min(old, max_pages)] = bt[:, : min(old, max_pages)]
    if old > max_pages:
        dropped = [
            int(p) for b in range(B) for p in bt[b, max_pages:]
            if p != alloc.sentinel
        ]
        if dropped:
            alloc.free(dropped)
    held = [int((out[b] != alloc.sentinel).sum()) for b in range(B)]
    need = [
        max(0, alloc.pages_for(row_tokens[b]) - held[b]) for b in range(B)
    ]
    if sum(need) > alloc.num_free:
        raise paged_kv_lib.OutOfPagesError(
            f"need {sum(need)} pages, {alloc.num_free} free"
        )
    for b in range(B):
        pages = alloc.alloc(need[b])
        out[b, held[b]: held[b] + need[b]] = pages
    state.block_tables = out
    return out


def row_generator(device: torch.device, seed: int, row: int = 0
                  ) -> torch.Generator:
    """The sampling generator of row `row` under `seed`, on `device`."""
    state = np.random.SeedSequence([int(seed), int(row)]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _returned_state(out):
    return out[-1]


@torch.inference_mode()
def generate_paged(
    params,
    cfg: LLMConfig,
    gen_cfg: GenerationConfig,
    *,
    inputs_embeds: torch.Tensor,  # [B, T, H] (suffix only when `start`)
    lengths,  # [B] real TOTAL lengths (incl. cached prefix)
    max_new_tokens: int,
    page_size: int = 64,
    chunk: int = 8,
    kv_capacity: int | None = None,
    num_pages: int | None = None,
    seed: int = 0,
    attn_impl: str = "xla",
    compute_dtype=None,
    stop_sequences: torch.Tensor | None = None,
    state: PagedState | None = None,
    start=None,
    return_state: bool = False,
    prefill_chunk: int | None = None,
    ragged: bool = False,
    kv_dtype: str | None = None,
    device="cuda",
    mesh=None,
):
    """`generate`, but over a paged KV cache in `chunk`-step dispatches: the
    reference driver of the continuous-batching path (the scheduler runs
    the same `paged_prefill` / `paged_decode_chunk` / `paged_ragged_step`
    with slots owned by different requests). Runs on `device` (the card
    unless the caller asks for the CPU); `params` must live there.

    kv_capacity: logical KV width per row (a multiple of page_size);
    defaults to the bucket of max(lengths) + the chunk-padded decode
    window. num_pages: pool size; defaults to the exact ragged need.
    state/start: prefix KV reuse (pass the previous turn's state and
    prefill only the suffix). prefill_chunk: prefill in bounded windows
    (needs one shared `start`). ragged: decode through
    `paged_ragged_step` (packed rows) instead of `paged_decode_chunk`.
    kv_dtype: None / "bf16" dense pages in the compute dtype; "int8" /
    "fp8_e4m3" a quantized pool (qwen2.init_paged_kv_cache), which the
    paged programs take unchanged. Sampling rows draw from per-row generators seeded from `seed`.

    mesh: tensor-parallel decode (parallel/mesh.py). `params` is rank 0's
    shard (`Pipeline(mesh=).params.llm`): every rank runs this call on its
    own shard (parallel/tp.py), a fresh pool holds each rank's KV heads,
    and greedy tokens equal the one-device path's. A returned `state` is
    rank-local; pass it back on the same mesh.

    Returns host tensors (tokens [B, max_new_tokens] int32, num_generated
    [B] int32, finished [B] bool)[, state]."""
    from oryx_tpu_torch.models.params import resolve_device
    from oryx_tpu_torch.ops.packing import round_up_bucket
    from oryx_tpu_torch.parallel import tp as tp_lib

    world = tp_lib.current() if mesh is not None else None
    if world is not None and world.size > 1 and not tp_lib.inside():
        return world.call(
            generate_paged, params, cfg, gen_cfg,
            inputs_embeds=inputs_embeds, lengths=lengths,
            max_new_tokens=max_new_tokens, page_size=page_size, chunk=chunk,
            kv_capacity=kv_capacity, num_pages=num_pages, seed=seed,
            attn_impl=attn_impl, compute_dtype=compute_dtype,
            stop_sequences=stop_sequences, state=state, start=start,
            return_state=return_state, prefill_chunk=prefill_chunk,
            ragged=ragged, kv_dtype=kv_dtype, device=device, mesh=mesh,
            bind=_returned_state if return_state else None,
        )
    dev = resolve_device(device)
    inputs_embeds = inputs_embeds.to(dev)
    B = inputs_embeds.shape[0]
    padded_new = -(-max_new_tokens // chunk) * chunk
    host_len = [int(x) for x in torch.as_tensor(lengths).tolist()]
    lengths = torch.tensor(host_len, dtype=torch.int32, device=dev)
    row_tokens = [n + padded_new for n in host_len]
    if kv_capacity is None:
        kv_capacity = round_up_bucket(max(row_tokens))
    if kv_capacity % page_size:
        raise ValueError(f"{kv_capacity=} not a multiple of {page_size=}")
    max_pages = kv_capacity // page_size
    if state is None:
        if num_pages is None:
            num_pages = sum(-(-n // page_size) for n in row_tokens)
        allocator = paged_kv_lib.PageAllocator(num_pages, page_size)
        state = PagedState(
            kv_pages=qwen2.init_paged_kv_cache(
                qwen2.rank_cfg(params, cfg), num_pages, page_size,
                dtype=compute_dtype or torch.float32, device=dev,
                kv_dtype=kv_dtype,
            ),
            block_tables=np.full((B, max_pages), allocator.sentinel,
                                 np.int32),
            allocator=allocator,
        )
    elif state.block_tables.shape[0] != B:
        raise ValueError(
            f"state holds {state.block_tables.shape[0]} rows, batch has {B}"
        )
    bt = torch.from_numpy(
        _grow_block_tables(state, row_tokens, max_pages)
    ).to(dev)
    starts = [0] * B if start is None else [
        int(x) for x in torch.as_tensor(start).expand(B).tolist()
    ]
    temp = torch.full((B,), gen_cfg.temperature, device=dev)
    top_p = torch.full((B,), gen_cfg.top_p, device=dev)
    top_k = torch.full((B,), gen_cfg.top_k, dtype=torch.int32, device=dev)
    gens = [
        row_generator(dev, seed, b) if gen_cfg.temperature > 0 else None
        for b in range(B)
    ]
    if prefill_chunk:
        if len(set(starts)) != 1:
            raise ValueError(
                f"prefill_chunk needs one shared start, got {sorted(set(starts))}"
            )
        state.kv_pages, tok = paged_prefill_chunks(
            params, cfg, inputs_embeds, lengths, bt, state.kv_pages,
            starts[0], gens, temp, top_p, top_k,
            prefill_chunk=prefill_chunk, attn_impl=attn_impl,
            compute_dtype=compute_dtype,
        )
    else:
        state.kv_pages, tok = paged_prefill(
            params, cfg, inputs_embeds, lengths, bt, state.kv_pages,
            torch.tensor(starts, device=dev), gens, temp, top_p, top_k,
            attn_impl=attn_impl, compute_dtype=compute_dtype,
        )
    if stop_sequences is not None:
        stop_sequences = stop_sequences.to(dev)
    stop_L = 0 if stop_sequences is None else stop_sequences.shape[1]
    recent = torch.full((B, stop_L), -2, dtype=torch.int32, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    cur_len = lengths
    eos = gen_cfg.eos_token_id
    toks_out = np.full((B, padded_new), eos, np.int32)
    fin_out = np.ones((B, padded_new), bool)
    common = dict(chunk=chunk, eos=eos, attn_impl=attn_impl,
                  compute_dtype=compute_dtype)
    done = 0
    while done < max_new_tokens:
        args = (params, cfg, state.kv_pages, bt, tok, cur_len, finished,
                recent, gens, temp, top_p, top_k, stop_sequences)
        if ragged:
            out = paged_ragged_step(*args, pf_width=0, **common)
        else:
            out = paged_decode_chunk(*args, **common)
        state.kv_pages, tok, cur_len, finished, recent, toks, fin = out[:7]
        # The once-per-dispatch harvest (the early exit needs host bools).
        toks_out[:, done:done + chunk] = toks.cpu().numpy()
        fin_out[:, done:done + chunk] = fin.cpu().numpy()
        done += chunk
        if fin_out[:, done - 1].all():
            break
    toks_out = toks_out[:, :max_new_tokens]
    fin_out = fin_out[:, :max_new_tokens]
    any_fin = fin_out.any(axis=1)
    num = np.where(
        any_fin, fin_out.argmax(axis=1) + 1, max_new_tokens
    ).astype(np.int32)
    out = (torch.from_numpy(toks_out), torch.from_numpy(num),
           torch.from_numpy(any_fin))
    return out + (state,) if return_state else out
