"""Autoregressive generation: dense-KV prefill + decode loop (port of
`oryx_tpu.models.generate`, dense path).

The JAX package runs the decode as one compiled `lax.while_loop`; here it is
a Python loop over the step, which exits as soon as every row has finished
(one host read of the finished flags per step). Right-padded batches
advance with per-row positions, so mixed-length multimodal prefills need no
left-padding shuffle.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from oryx_tpu_torch.config import GenerationConfig, LLMConfig
from oryx_tpu_torch.models import qwen2


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
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32
    )


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


@torch.inference_mode()
def generate(
    params: qwen2.Qwen2,
    cfg: LLMConfig,
    gen_cfg: GenerationConfig,
    *,
    inputs_embeds: torch.Tensor,  # [B, T, H] (pre-spliced; right-padded)
    lengths: torch.Tensor,  # [B] real lengths
    max_new_tokens: int,
    cache_len: int,
    generator: torch.Generator | None = None,
    attn_impl: str = "xla",
    compute_dtype: torch.dtype | None = None,
    stop_sequences: torch.Tensor | None = None,  # [S, L], left-pad -1
    timings: dict | None = None,
):
    """Returns (tokens [B, max_new_tokens] int32, num_generated [B] int32,
    finished [B] bool) as tensors on the embeds' device.

    Slots after a row finishes hold eos_token_id. A row finishes on EOS or
    when its trailing tokens match a stop sequence (num_generated then
    includes the stop tokens). finished=False marks a row cut off by
    max_new_tokens. cache_len must be >= T + max_new_tokens.
    timings: when given, receives prefill_s, decode_s (wall seconds, the
    device synchronised at each boundary) and decode_steps.
    """
    B, T, _ = inputs_embeds.shape
    if cache_len < T + max_new_tokens:
        raise ValueError(f"{cache_len=} < {T=} + {max_new_tokens=}")
    dev = inputs_embeds.device
    if timings is not None:
        _sync(dev)
        t0 = time.perf_counter()
    carry = _prefill_carry(
        params, cfg, gen_cfg, inputs_embeds, lengths.to(dev), generator,
        cache_len=cache_len, attn_impl=attn_impl,
        compute_dtype=compute_dtype,
        stop_L=0 if stop_sequences is None else stop_sequences.shape[1],
    )
    if timings is not None:
        _sync(dev)
        t1 = time.perf_counter()
    step = _make_decode_step(
        params, cfg, gen_cfg,
        None if stop_sequences is None else stop_sequences.to(dev),
        cache_len=cache_len, attn_impl=attn_impl,
        compute_dtype=compute_dtype, generator=generator,
    )
    carry, toks, fin, steps = _decode_while(
        step, carry, max_new_tokens, gen_cfg.eos_token_id
    )
    if timings is not None:
        _sync(dev)
        timings.update(
            prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
            decode_steps=steps,
        )
    # num generated = tokens up to and including the finishing token.
    any_fin = torch.any(fin, dim=1)
    num = torch.where(
        any_fin, torch.argmax(fin.to(torch.int32), dim=1) + 1, max_new_tokens
    )
    return toks, num.to(torch.int32), any_fin


def _decode_while(step, carry, max_new_tokens: int, eos: int):
    """Run the decode step until max_new_tokens OR until every row has
    finished. Unexecuted slots keep what a full run would have produced
    (tokens: EOS; finished: True). Returns (carry, toks [B, max_new],
    fin [B, max_new], steps run)."""
    tok0 = carry[1]
    nB = tok0.shape[0]
    toks = torch.full((nB, max_new_tokens), eos, dtype=torch.int32,
                      device=tok0.device)
    fin = torch.ones((nB, max_new_tokens), dtype=torch.bool,
                     device=tok0.device)
    i = 0
    while i < max_new_tokens and not bool(torch.all(carry[3])):
        carry, (tok, f) = step(carry)
        toks[:, i] = tok
        fin[:, i] = f
        i += 1
    return carry, toks, fin, i


def prefill(
    params, cfg: LLMConfig, inputs_embeds, lengths, *, cache_len: int,
    attn_impl: str, compute_dtype,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Dense-cache prefill of right-padded embeds [B, T, H] -> (logits
    [B, V] fp32 at each row's last real position, the filled KV cache)."""
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    positions = torch.arange(T, device=dev).expand(B, T)
    slot_ar = torch.arange(cache_len, device=dev)[None, :]
    kv_mask = (slot_ar < lengths[:, None]).to(torch.int32)
    cache = qwen2.init_kv_cache(
        cfg, B, cache_len, dtype=compute_dtype or torch.float32, device=dev
    )
    h, cache = qwen2.forward(
        params, cfg,
        inputs_embeds=inputs_embeds, positions=positions,
        kv_cache=cache,
        write_slots=torch.zeros(B, dtype=torch.long, device=dev),
        kv_mask=kv_mask, attn_impl=attn_impl, compute_dtype=compute_dtype,
        return_hidden=True,
    )
    # Project only each row's last real position (the same numbers as the
    # full [B, T, V] logits, without materializing them).
    last_h = h[torch.arange(B, device=dev), lengths.long() - 1]
    return qwen2.logits_from_hidden(params, cfg, last_h), cache


def _prefill_carry(
    params, cfg: LLMConfig, gen_cfg: GenerationConfig, inputs_embeds,
    lengths, generator, *, cache_len: int, attn_impl: str, compute_dtype,
    stop_L: int,
):
    """Prefill + first sampled token -> the decode carry (cache, next token,
    per-row lengths, finished flags, rolling stop-match window)."""
    B = inputs_embeds.shape[0]
    dev = inputs_embeds.device
    last, cache = prefill(
        params, cfg, inputs_embeds, lengths, cache_len=cache_len,
        attn_impl=attn_impl, compute_dtype=compute_dtype,
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
