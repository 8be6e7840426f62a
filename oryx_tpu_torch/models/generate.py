"""Autoregressive generation (port of `oryx_tpu.models.generate`): the
dense-KV prefill + decode loop, and the paged programs of the
continuous-batching engine (paged prefill, chunked decode, the packed
ragged step, `generate_paged`).

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
) -> torch.Tensor:
    """Per-row sampling for continuous batching: every row carries its own
    (temperature, top_p, top_k) and generator, so a row's draw is a
    function of that row alone. Rows with no generator, or temperature 0,
    take the argmax (first maximum on ties); sampling rows draw one
    Gumbel-max sample over the truncated logits. Returns [S] int32."""
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
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    sampled = torch.argmax(l + g, dim=-1).to(torch.int32)
    drew = torch.zeros(S, dtype=torch.bool, device=logits.device)
    drew[rows] = True
    return torch.where(drew & ~is_greedy, sampled, greedy)


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
            stream, [g for g in (self.generator,) if g is not None]
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
            idle[oldest].pop(0)
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
    `kv_cache` itself is never written."""
    dtype = compute_dtype or torch.float32
    if kv_cache is not None and kv_cache["k"].shape[2] != cache_len:
        raise ValueError(
            f"kv_cache has {kv_cache['k'].shape[2]} slots, {cache_len=}"
        )
    if device.type != "cuda":
        cache = (
            qwen2.init_kv_cache(cfg, batch, cache_len, dtype=dtype,
                                device=device)
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
        cfg, B, cache_len, dtype=compute_dtype or torch.float32, device=dev
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
):
    """`chunk` decode steps over a FIXED-SLOT batch with a paged cache, the
    continuous-batching inner loop. Finished and empty slots still flow
    through the math, but their cache writes are dropped (write_mask) and
    their lengths freeze. No host read inside: the caller harvests once.
    Returns (kv_pages, tok, lengths, finished, recent, toks [S, chunk],
    fin [S, chunk])."""
    dev = tok.device
    K = block_tables.shape[1] * kv_pages["k"].shape[2]
    slot_ar = torch.arange(K, device=dev)[None, :]
    cur_len = lengths
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
    return (kv_pages, tok, cur_len, finished, recent,
            torch.stack(toks, dim=1), torch.stack(fins, dim=1))


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
    a pure packed decode step.

    Returns (kv_pages, tok, lengths, finished, recent, toks [S, chunk],
    fin [S, chunk], pf_tok0 ([] int32, or None when no window held the
    prompt's last token))."""
    S = tok.shape[0]
    W = pf_width
    dev = tok.device
    cur_len = lengths
    seg0 = torch.arange(S, dtype=torch.int32, device=dev)
    pf_seg = torch.full((W,), pf_slot, dtype=torch.int32, device=dev)
    pf_ar = torch.arange(W, dtype=torch.int32, device=dev)
    pf_wm = torch.ones((W,), dtype=torch.bool, device=dev)
    pf_tok0 = None
    toks, fins = [], []
    for i in range(chunk):
        emb = params.embed.weight[_feed_ids(cfg, tok)]  # [S, H]
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
        nxt = sample_token_rows(
            qwen2.logits_from_hidden(params, cfg, h[0, :S]), generators,
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
    return (kv_pages, tok, cur_len, finished, recent,
            torch.stack(toks, dim=1), torch.stack(fins, dim=1), pf_tok0)


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

    Returns host tensors (tokens [B, max_new_tokens] int32, num_generated
    [B] int32, finished [B] bool)[, state]."""
    from oryx_tpu_torch.models.params import resolve_device
    from oryx_tpu_torch.ops.packing import round_up_bucket

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
                cfg, num_pages, page_size,
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
