"""End-to-end inference pipeline: media + question -> answer text (port of
`oryx_tpu.serve.pipeline.OryxInference`, batch path).

Host side: build the conversation prompt with `<image>` placeholders,
tokenize with sentinels, pack the raw images (resize, normalize, patchify)
and build the spliced index map. Device side: ViT -> compressor -> splice ->
dense-KV prefill -> greedy/sampled decode (CUDA graphs of the decode chunk
on the card). Also streaming (`chat_stream`), multi-turn KV prefix reuse
(`chat_cached`, `ChatSession`, the cross-session `SessionPrefixCache`),
option scoring (`score_options`) and video QA (`chat_video`).

Sharded serving (`mesh=` a mesh of parallel/mesh.py): each rank holds its
shard of the weights (parallel/sharding.py; sharding_mode "tp": heads and
MLP columns, "fsdp": each layer's leaves, gathered as the layer runs),
rank 0's pipeline is the one a caller drives, and every entry point below
runs on every rank (parallel/tp.py): the followers repeat the call on
their shards and return nothing. A session on a mesh takes the pipeline's
own shared cache (`shared=True`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import zlib
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from oryx_tpu_torch.config import OryxConfig
from oryx_tpu_torch.constants import (
    COMPRESSOR_RATIO,
    DEFAULT_IMAGE_TOKEN,
    IMAGE_TOKEN_INDEX,
    MODALITY_IMAGE,
    MODALITY_MULTI_IMAGE,
    MODALITY_VIDEO,
)
from oryx_tpu_torch.conversation import conv_templates
from oryx_tpu_torch.data import mm_utils
from oryx_tpu_torch.models import generate as generate_lib
from oryx_tpu_torch.models import oryx, qwen2, splice
from oryx_tpu_torch.models.params import resolve_device
from oryx_tpu_torch.ops import packing
from oryx_tpu_torch.parallel import sharding as sharding_lib
from oryx_tpu_torch.parallel import tp as tp_lib
from oryx_tpu_torch.parallel.mesh import axis_sizes
from oryx_tpu_torch.utils import trace as trace_lib
from oryx_tpu_torch.utils.quant import Q8Embedding, Q8Linear, embed_rows


def on_every_rank(bind=None):
    """A pipeline method that, on rank 0 of a tensor-parallel pipeline,
    every rank runs (parallel/tp.World.call; bind: what each rank keeps
    of the result under one handle). Off tp, and inside a dispatch, a
    plain call."""
    def deco(method):
        @functools.wraps(method)
        def run(self, *args, **kwargs):
            world = self.tp
            if world is None or tp_lib.inside():
                return method(self, *args, **kwargs)
            return world.call(getattr(self, method.__name__), *args,
                              bind=bind, **kwargs)
        return run
    return deco


def _second(out):
    return out[1]


def _stream_step(gen):
    """One step of a stream as a value: ("y", delta) or ("r", return)."""
    try:
        return "y", next(gen)
    except StopIteration as stop:
        return "r", stop.value


def _stream_state(out):
    """The session state a finished stream returned, if any."""
    kind, value = out
    return value[1] if kind == "r" and isinstance(value, tuple) else None


def _close_stream(gen) -> None:
    gen.close()


class _RankStream:
    """`chat_stream` on rank 0 of a tensor-parallel pipeline: each step
    of the stream is a dispatch every rank runs on its own generator."""

    def __init__(self, world, gen):
        self._world = world
        self._gen = gen
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        kind, value = self._world.call(_stream_step, self._gen,
                                       bind=_stream_state)
        if kind == "r":
            self._done = True
            raise StopIteration(value)
        return value

    def close(self) -> None:
        if not self._done:
            self._done = True
            self._world.call(_close_stream, self._gen)


def infer_modality(num_images: int, is_video: bool) -> str:
    if is_video:
        return MODALITY_VIDEO
    return MODALITY_MULTI_IMAGE if num_images > 1 else MODALITY_IMAGE


def stop_cut(text: str, stops: Sequence[str]) -> tuple[str, bool]:
    """Cut `text` at the earliest full stop-string occurrence. Returns
    (trimmed text, whether a stop fired)."""
    cut = min(
        (i for s in stops if (i := text.find(s)) >= 0),
        default=-1,
    )
    return (text[:cut], True) if cut >= 0 else (text, False)


def stop_token_count(
    tokenizer, emitted: Sequence[int], stops: Sequence[str],
    chunk_start: int,
) -> int:
    """Minimal token-prefix length of `emitted` whose decoded text contains
    a stop string (completion counts through the token completing the
    stop). The stop completed in the tokens from `chunk_start` on (earlier
    prefixes were checked clean), so only that tail is scanned."""
    for k in range(chunk_start + 1, len(emitted) + 1):
        if stop_cut(
            tokenizer.decode(list(emitted[:k]), skip_special_tokens=True),
            stops,
        )[1]:
            return k
    return len(emitted)


def stable_text_prefix(text: str, stops: Sequence[str]) -> str:
    """The prefix of `text` that can never change as more tokens decode:
    hold back an incomplete UTF-8 tail (U+FFFD), any suffix that could grow
    into a stop string, and leading/trailing whitespace (replies are
    stripped at both ends; rstripped text re-emits once non-whitespace
    follows)."""
    text = text.lstrip()
    while text.endswith("�"):
        text = text[:-1]
    held = 0
    for s in stops:
        for i in range(len(s) - 1, 0, -1):
            if text.endswith(s[:i]):
                held = max(held, i)
                break
    if held:
        text = text[: len(text) - held]
    return text.rstrip()


class Pipeline:
    """Chat interface over a loaded model on one device.

    `Pipeline(tokenizer, params, cfg).chat("what is this?", images=[img])`.
    `params` is an `oryx.OryxModel`; it is moved to `device` (CUDA by
    default, which raises on a host without a card; pass device="cpu" to
    run on the CPU).
    """

    def __init__(
        self,
        tokenizer,
        params: oryx.OryxModel,
        cfg: OryxConfig,
        *,
        template: str = "qwen",
        device="cuda",
        mesh=None,
        sharding_mode: str = "tp",
    ) -> None:
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self._frame_sep_cache = None
        self._session_cache = None
        # Ring attention is a training/prefill configuration; decode needs
        # the cached path, so ring-trained configs serve with the dense
        # kernel (the plain path on the CPU).
        if cfg.attn_impl.startswith("ring"):
            impl = "pallas" if self.device.type == "cuda" else "xla"
            cfg = dataclasses.replace(cfg, attn_impl=impl)
        self.cfg = cfg
        self.mesh = mesh
        self.sharding_mode = sharding_mode
        self.tp = None
        width = self._check_mesh(params)
        if width > 1:
            self.tp = tp_lib.current()
            if self.device.type != self.tp.device.type:
                raise ValueError(f"this rank drives {self.tp.device}, "
                                 f"not {self.device}")
            self.device = self.tp.device
            self.params = sharding_lib.rank_params(
                params, cfg, mesh, self.device, sharding_mode)
        else:
            self.params = params.to(self.device)
        self.conv = conv_templates[template]
        # In-loop stop matching: rows end as soon as the template's stop
        # string is emitted.
        self.stop_sequences = generate_lib.make_stop_sequences(
            [self.conv.stop_str] if self.conv.stop_str else [], tokenizer
        )
        if self.tp is not None and not tp_lib.inside():
            # The followers build their pipelines on their own shards.
            source = (params.state_dict() if isinstance(params, nn.Module)
                      else params)
            self.tp.call(Pipeline, tokenizer, source, cfg,
                         template=template, device=self.device, mesh=mesh,
                         sharding_mode=sharding_mode, peer=self)
            # The shard's modules cross later dispatches as handles.
            self.tp.call(getattr, self, "params", bind=True)

    def _check_mesh(self, params) -> int:
        """The number of ranks the mesh splits the weights over (tp, or
        fsdp x sp under "fsdp"), after JAX's refusals (int8 weights with a
        mesh, an unknown mode) and the port's (under tp every head count
        must divide)."""
        if self.mesh is None:
            return 1
        if self.sharding_mode not in ("tp", "fsdp"):
            raise ValueError(f"unknown serving sharding mode "
                             f"{self.sharding_mode!r}: tp|fsdp")
        if isinstance(params, nn.Module) and any(
                isinstance(m, (Q8Linear, Q8Embedding))
                for m in params.modules()):
            raise ValueError(
                "quantize='int8' is single-chip serving; drop --shard "
                "(sharded serving splits the float weights instead)")
        sizes = axis_sizes(self.mesh)
        if self.sharding_mode == "fsdp":
            return sizes["fsdp"] * sizes["sp"]
        tp = sizes["tp"]
        if tp > 1:
            sharding_lib.check_divisible(self.cfg, tp)
        return tp

    @on_every_rank(bind=True)
    def session_prefix_cache(self, capacity: int = 4):
        """Pipe-level cross-SESSION prefix cache (created at first use):
        pass it as `ChatSession(pipe, shared=pipe.session_prefix_cache())`,
        or just `shared=True`, and fresh sessions over the same media +
        system prompt seed their KV from a finished session's state instead
        of cold-prefilling it. Block-aligned token-id matching rooted at the
        media fingerprint, LRU (serve/prefix_cache.py)."""
        if self._session_cache is None:
            from oryx_tpu_torch.serve.prefix_cache import SessionPrefixCache

            self._session_cache = SessionPrefixCache(capacity=capacity)
        return self._session_cache

    # ---- host-side prompt/media prep ------------------------------------

    def build_prompt(
        self,
        question: str,
        num_media: int,
        history: Sequence[tuple[str, str]] | None = None,
    ) -> str:
        """Conversation-templated prompt with one `<image>` placeholder per
        media item prepended to the FIRST user turn."""
        conv = self.conv.copy()
        prefix = (DEFAULT_IMAGE_TOKEN + "\n") * num_media
        turns = list(history or [])
        for i, (user, assistant) in enumerate(turns):
            conv.append_message(conv.roles[0], (prefix if i == 0 else "") + user)
            conv.append_message(conv.roles[1], assistant)
        conv.append_message(
            conv.roles[0], question if turns else prefix + question
        )
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt()

    # ---- entry points ----------------------------------------------------

    def chat(
        self,
        question: str,
        *,
        images: Sequence[np.ndarray] | None = None,
        is_video: bool = False,
        history: Sequence[tuple[str, str]] | None = None,
        max_new_tokens: int | None = None,
        seed: int = 0,
        temperature: float | None = None,
        top_p: float | None = None,
        stop: Sequence[str] | None = None,
        timings: dict | None = None,
    ) -> str:
        """QA over optional images / video frames. history: prior
        (user, assistant) turns of the same conversation (media stay
        attached to the first turn). timings: as in `chat_batch`."""
        return self.chat_batch(
            [{
                "question": question,
                "images": list(images or []),
                "is_video": is_video,
                "history": list(history or []),
            }],
            max_new_tokens=max_new_tokens,
            seed=seed,
            temperature=temperature,
            top_p=top_p,
            stop=stop,
            timings=timings,
        )[0]

    def _sampling_cfg(
        self, temperature: float | None, top_p: float | None
    ) -> OryxConfig:
        """Config with per-request sampling overrides."""
        if temperature is None and top_p is None:
            return self.cfg
        gen = self.cfg.generation
        updates = {}
        if temperature is not None:
            updates["temperature"] = float(temperature)
        if top_p is not None:
            updates["top_p"] = float(top_p)
        return dataclasses.replace(
            self.cfg, generation=dataclasses.replace(gen, **updates)
        )

    def _frame_sep_ids(self) -> tuple[int, ...]:
        if self._frame_sep_cache is None:
            self._frame_sep_cache = splice.frame_separator_ids(
                self.tokenizer, self.cfg.frame_separator
            )
        return self._frame_sep_cache

    def _stop_for(self, stop: Sequence[str] | None):
        """Stop-id matrix for the template stop plus request stops."""
        if not stop:
            return self.stop_sequences
        strs = [self.conv.stop_str] if self.conv.stop_str else []
        return generate_lib.make_stop_sequences(
            strs + list(stop), self.tokenizer
        )

    def _prepare_request(
        self, req: dict[str, Any]
    ) -> tuple[np.ndarray, list[np.ndarray], list[int], list[int]]:
        """One request dict -> (token ids with per-frame sentinels, raw
        images, per-image side factors, per-image patch caps)."""
        cfgv = self.cfg.vision
        images = list(req.get("images") or [])
        is_video = bool(req.get("is_video")) and len(images) > 0
        modality = infer_modality(len(images), is_video)
        prompt = self.build_prompt(
            req["question"],
            (1 if is_video else len(images)) if images else 0,
            history=req.get("history"),
        )
        ids = mm_utils.tokenizer_image_token(prompt, self.tokenizer)
        if is_video and len(images) > 1:
            ids, _ = splice.expand_video_sentinels(
                ids, len(images), sep_ids=self._frame_sep_ids()
            )
        if not images:
            return ids, [], [], []
        per_img_cap = (
            max(1, cfgv.max_patches_per_image // len(images))
            if modality == MODALITY_VIDEO
            else cfgv.max_patches_per_image
        )
        factor = int(COMPRESSOR_RATIO[modality] ** 0.5)
        return (
            ids, images, [factor] * len(images), [per_img_cap] * len(images)
        )

    @on_every_rank()
    def _prompt_embeds(self, cfg, ids, imgs, factors, caps
                       ) -> tuple[torch.Tensor, int]:
        """One prompt row -> (decoder input embeds [1, T_bucket, H] on the
        pipeline's device, real length): the prompt prep of the serving
        engine (ViT + compressor + splice for a multimodal prompt, the
        embedding lookup of the bucketed ids for text)."""
        if imgs:
            packed = packing.pack_raw_images(
                imgs, patch_size=cfg.vision.patch_size,
                base_grid=cfg.vision.base_grid,
                side_factors=factors, max_patches=caps,
            )
            batch = splice.build_mm_batch([ids], splice.query_slots(packed))
            embeds = oryx.mm_embeds(
                self.params, cfg,
                oryx.stage_mm_arrays(packed, batch, self.device),
            )
            return embeds, int(batch.lengths[0])
        L = len(ids)
        rows = np.zeros((1, packing.round_up_bucket(L)), np.int64)
        rows[0, :L] = ids
        with torch.inference_mode():
            embeds = embed_rows(
                self.params.llm.embed, torch.from_numpy(rows).to(self.device)
            )
        return embeds, L

    def pack_requests(
        self, requests: Sequence[dict[str, Any]]
    ) -> tuple[list[np.ndarray], packing.PackedVisual | None,
               splice.MMBatch | None]:
        """Host side of `chat_batch`: per-row token ids, and for a batch
        with media the packed visual buffer and the spliced index map
        (None, None for text only)."""
        all_images: list[np.ndarray] = []
        side_factors: list[int] = []
        max_patches: list[int] = []
        ids_rows: list[np.ndarray] = []
        for req in requests:
            ids, images, factors, caps = self._prepare_request(req)
            ids_rows.append(ids)
            all_images.extend(images)
            side_factors.extend(factors)
            max_patches.extend(caps)
        if not all_images:
            return ids_rows, None, None
        packed = packing.pack_raw_images(
            all_images,
            patch_size=self.cfg.vision.patch_size,
            base_grid=self.cfg.vision.base_grid,
            side_factors=side_factors,
            max_patches=max_patches,
        )
        return ids_rows, packed, splice.build_mm_batch(
            ids_rows, splice.query_slots(packed)
        )

    @on_every_rank()
    def chat_batch(
        self,
        requests: Sequence[dict[str, Any]],
        *,
        max_new_tokens: int | None = None,
        seed: int = 0,
        return_finish_reasons: bool = False,
        return_token_counts: bool = False,
        temperature: float | None = None,
        top_p: float | None = None,
        stop: Sequence[str] | None = None,
        per_row_max: Sequence[int] | None = None,
        timings: dict | None = None,
    ) -> list[str] | tuple:
        """Batched single-turn QA: one ViT + compressor + decode for the
        whole batch. Mixed text-only / image / multi-image / video rows.

        requests: dicts with "question" (str), optional "images" (list of
        np arrays, pre-sampled for video), optional "is_video".
        return_finish_reasons: also return per-row "stop" (EOS or stop
        string) vs "length" (cut off by max_new_tokens).
        return_token_counts: also return per-row (prompt_tokens,
        completion_tokens); prompt counts the real spliced row length.
        temperature/top_p override the config for this call; stop adds
        request stop strings; per_row_max caps each row's output length.
        timings: when given, receives the device phases' wall seconds
        (visual_s, prefill_s, decode_s, and capture_s: the decode graph
        capture this call made, 0 when it reused one) and decode_steps.
        Return shape grows in flag order: replies[, reasons][, counts].
        """
        cfg = self._sampling_cfg(temperature, top_p)
        stop_seqs = self._stop_for(stop)
        max_new = max_new_tokens or cfg.generation.max_new_tokens
        if per_row_max is not None:
            if len(per_row_max) != len(requests):
                raise ValueError(
                    f"per_row_max has {len(per_row_max)} entries for "
                    f"{len(requests)} requests"
                )
            if any(m < 1 or m > max_new for m in per_row_max):
                raise ValueError(
                    f"per_row_max entries must be in [1, {max_new}]"
                )
        generator = torch.Generator(device=self.device).manual_seed(seed)
        ids_rows, packed, batch = self.pack_requests(requests)
        if packed is None:
            toks, num, fin = self._text_batch(
                ids_rows, max_new, generator, cfg=cfg, stop_seqs=stop_seqs,
                timings=timings,
            )
            prompt_lens = [len(r) for r in ids_rows]
        else:
            toks, num, fin = oryx.mm_generate(
                self.params, cfg, packed, batch,
                max_new_tokens=max_new, generator=generator,
                stop_sequences=stop_seqs, device=self.device,
                timings=timings,
            )
            prompt_lens = [int(n) for n in batch.lengths]
        toks, num, fin = (x.cpu().numpy() for x in (toks, num, fin))
        caps = per_row_max or [max_new] * len(toks)
        replies = [
            self._decode(
                toks[b], min(int(num[b]), caps[b]), extra_stops=stop
            )
            for b in range(len(toks))
        ]
        out: tuple = (replies,)
        if return_finish_reasons:
            # A row "stopped" only if its EOS/stop landed within ITS cap.
            out += ([
                "stop" if bool(f) and int(n) <= c else "length"
                for f, n, c in zip(fin, num, caps)
            ],)
        if return_token_counts:
            out += ([
                (prompt_lens[b], min(int(num[b]), caps[b]))
                for b in range(len(toks))
            ],)
        return out[0] if len(out) == 1 else out

    def _text_batch(self, ids_rows, max_new: int, generator, *, cfg=None,
                    stop_seqs=None, timings=None):
        cfg = cfg or self.cfg
        stop_seqs = stop_seqs if stop_seqs is not None else self.stop_sequences
        B = len(ids_rows)
        T = packing.round_up_bucket(max(len(r) for r in ids_rows))
        rows = np.zeros((B, T), np.int64)
        lengths = np.zeros((B,), np.int32)
        for b, ids in enumerate(ids_rows):
            rows[b, : len(ids)] = ids
            lengths[b] = len(ids)
        cache_len = packing.round_up_bucket(T + max_new)
        with torch.inference_mode():
            embeds = embed_rows(
                self.params.llm.embed, torch.from_numpy(rows).to(self.device)
            )
            return generate_lib.generate(
                self.params.llm, cfg.llm, cfg.generation,
                inputs_embeds=embeds,
                lengths=torch.from_numpy(lengths).to(self.device),
                max_new_tokens=max_new, cache_len=cache_len,
                generator=generator, attn_impl=cfg.attn_impl,
                compute_dtype=oryx.compute_dtype(cfg),
                stop_sequences=stop_seqs, timings=timings,
            )

    def chat_stream(self, question: str, **kwargs):
        """Streaming `chat`: see `_chat_stream`. On rank 0 of a
        tensor-parallel pipeline every step of the stream is a dispatch
        every rank runs."""
        if self.tp is None or tp_lib.inside():
            return self._chat_stream(question, **kwargs)
        gen = self.tp.call(self._chat_stream, question, bind=True, **kwargs)
        return _RankStream(self.tp, gen)

    def _chat_stream(
        self,
        question: str,
        *,
        images: Sequence[np.ndarray] | None = None,
        is_video: bool = False,
        history: Sequence[tuple[str, str]] | None = None,
        max_new_tokens: int | None = None,
        seed: int = 0,
        chunk: int = 8,
        temperature: float | None = None,
        top_p: float | None = None,
        stop: Sequence[str] | None = None,
        cache_state: "PrefixCacheState | None" = None,
        usage_out: dict | None = None,
        shared: "Any | None" = None,
    ):
        """Streaming `chat` (HF TextIteratorStreamer parity): yields text
        DELTAS as tokens decode; ''.join(deltas) equals chat()'s reply
        exactly (incomplete UTF-8 tails, stop-string prefixes and
        leading/trailing whitespace are held back until resolvable).
        Single request; the decode runs `chunk` tokens a block (one CUDA
        graph replay on the card). The generator's RETURN value
        (StopIteration.value) is the finish reason: "stop" (EOS/stop
        string) or "length" (max_new_tokens). temperature/top_p/stop
        override per request as in `chat_batch`.

        With cache_state (ChatSession.ask_stream), the shared token prefix
        is served from the session's KV cache (`_prefix_plan`) and the
        RETURN value becomes (reason, new PrefixCacheState): the new
        state's ids cover the PROMPT only (streamed reply tokens are
        re-prefilled next turn; the visual prefill is still one-time).

        usage_out: a dict the generator fills with prompt_tokens (the real
        spliced prompt length, visual tokens and any cached prefix
        included) and completion_tokens before returning. The finishing
        token is counted (EOS, or the token that completes a stop string),
        as chat_batch counts; tokens decoded past a host-side stop cut are
        not.

        shared: cross-session SessionPrefixCache, as in `chat_cached`: a
        COLD cache_state seeds from the index's longest stored prefix and
        the post-turn state is donated back.

        Spans (prefill, decode_chunk, emission) land on the context-active
        trace (`utils.trace.activate`, the API server's flight recorder)
        and cost nothing outside one.
        """
        cfg = self._sampling_cfg(temperature, top_p)
        stop_seqs = self._stop_for(stop)
        max_new = max_new_tokens or cfg.generation.max_new_tokens
        generator = torch.Generator(device=self.device).manual_seed(seed)
        ids, images, factors, caps = self._prepare_request({
            "question": question, "images": list(images or []),
            "is_video": is_video, "history": list(history or []),
        })
        if (
            shared is not None and cache_state is not None
            and cache_state.cache is None and not images
        ):
            cand = shared.lookup(
                np.asarray(ids, np.int64), _media_fingerprint(images)
            )
            if cand is not None:
                cache_state = cand

        # The decode runs whole chunks; overshoot tokens are dropped and
        # the cache is sized for the padded length.
        padded_new = -(-max_new // chunk) * chunk
        kv_cache = start = flat = None
        media_key = ()
        if cache_state is not None:
            with trace_lib.span("prefill", cached=True):
                flat, L, common, embeds, kv_cache, cache_len, media_key = (
                    self._prefix_plan(
                        cache_state, cfg, ids, images, factors, caps,
                        padded_new,
                    )
                )
            start = common
        else:
            with trace_lib.span("prefill"):
                embeds, L = self._prompt_embeds(
                    cfg, ids, images, factors, caps
                )
            cache_len = packing.round_up_bucket(embeds.shape[1] + padded_new)
        lengths = torch.tensor([L], dtype=torch.int32, device=self.device)
        eos = cfg.generation.eos_token_id
        stops = ([self.conv.stop_str] if self.conv.stop_str else []) + [
            s for s in (stop or []) if s  # "" would truncate everything
        ]
        emitted: list[int] = []
        text_done = ""
        finished = eos_hit = False
        stop_tok_count: int | None = None
        final_cache = None

        def result(reason):
            """Return value: bare reason, or (reason, new state) when the
            caller passed a cache_state."""
            if usage_out is not None:
                usage_out["prompt_tokens"] = L
                # A stop-string finish counts through the token that
                # completed the stop, not the whole in-flight chunk; an
                # EOS finish counts the EOS (`emitted` stops before it).
                if stop_tok_count is not None:
                    usage_out["completion_tokens"] = stop_tok_count
                elif eos_hit:
                    usage_out["completion_tokens"] = len(emitted) + 1
                else:
                    usage_out["completion_tokens"] = len(emitted)
            if cache_state is None:
                return reason
            new_state = PrefixCacheState(
                ids=flat, cache=final_cache, cache_len=cache_len,
                prompt_ids=np.asarray(ids, np.int64), prompt_flat=flat,
                media_key=media_key,
            )
            if shared is not None and final_cache is not None:
                shared.insert(new_state)
            return reason, new_state

        blocks = generate_lib.generate_stream(
            self.params.llm, cfg.llm, cfg.generation,
            inputs_embeds=embeds, lengths=lengths,
            max_new_tokens=max_new, cache_len=cache_len,
            generator=generator, attn_impl=cfg.attn_impl,
            compute_dtype=oryx.compute_dtype(cfg),
            stop_sequences=stop_seqs, chunk=chunk,
            kv_cache=kv_cache, start=start,
            yield_cache=cache_state is not None,
        )
        def traced(gen):
            """Each device chunk (the window between successive blocks) as
            a decode_chunk span on the active trace."""
            n = 0
            while True:
                t0 = trace_lib.now_ns()
                try:
                    b = next(gen)
                except StopIteration:
                    return
                trace_lib.add_complete("decode_chunk", t0, chunk=n)
                n += 1
                yield b

        with contextlib.closing(blocks):
            for block in traced(blocks):
                if cache_state is not None:
                    block, final_cache = block
                t_emit = trace_lib.now_ns()
                chunk_start = len(emitted)
                for t in block[0]:
                    if int(t) == eos:
                        finished = eos_hit = True
                        break
                    emitted.append(int(t))
                text = self.tokenizer.decode(
                    emitted, skip_special_tokens=True
                )
                text, hit = stop_cut(text, stops)
                if usage_out is not None and hit and stop_tok_count is None:
                    # The stop string completed somewhere in THIS chunk
                    # (earlier chunks were trimmed and did not hit).
                    stop_tok_count = stop_token_count(
                        self.tokenizer, emitted, stops, chunk_start
                    )
                finished = finished or hit
                safe = (
                    text.strip() if finished
                    else stable_text_prefix(text, stops)
                )
                trace_lib.add_complete("emission", t_emit, chars=len(safe))
                if len(safe) > len(text_done):
                    yield safe[len(text_done):]
                    text_done = safe
                if finished:
                    return result("stop")
        # Decode window exhausted without EOS/stop: flush the held-back
        # tail (chat() would return it) and report the truncation.
        tail = text.strip() if emitted else ""
        if len(tail) > len(text_done):
            yield tail[len(text_done):]
        return result("length")

    def _prefix_plan(
        self, state: "PrefixCacheState", cfg, ids, imgs, factors, caps,
        new_budget: int,
    ):
        """Host-side half of prefix-cached generation: match the new
        prompt's post-splice token stream against the cache, build the
        suffix embeds and a (possibly grown) cache. `new_budget` is the
        number of decode slots to reserve past the prompt (max_new, or the
        chunk-padded window for streaming).

        Returns (flat, L, common, embeds, cache, cache_len, media_key)."""
        cfgv = cfg.vision
        ids = np.asarray(ids, np.int64)

        # Visual slots match positionally, not by content: a cache built
        # over DIFFERENT media must not be matched against at all.
        media_key = _media_fingerprint(imgs)
        reusable = state.cache is not None and state.media_key == media_key

        # A turn that merely EXTENDS the previous prompt (same media,
        # appended history) reuses the stored post-splice stream: no
        # host-side image re-packing.
        packed = batch = None
        np_prev = state.prompt_ids
        extend = (
            reusable
            and 0 < len(np_prev) < len(ids)
            and np.array_equal(ids[: len(np_prev)], np_prev)
            and not np.any(ids[len(np_prev):] == IMAGE_TOKEN_INDEX)
        )
        if extend:
            flat = np.concatenate([state.prompt_flat, ids[len(np_prev):]])
            L = len(flat)
        elif imgs:
            packed = packing.pack_raw_images(
                imgs, patch_size=cfgv.patch_size, base_grid=cfgv.base_grid,
                side_factors=factors, max_patches=caps,
            )
            batch = splice.build_mm_batch([ids], splice.query_slots(packed))
            L = int(batch.lengths[0])
            row = np.asarray(batch.token_ids[0][:L], np.int64)
            isv = np.asarray(batch.is_visual[0][:L])
            flat = np.where(isv, -7, row)
        else:
            L = len(ids)
            flat = ids

        # Longest shared prefix with the cache's token stream. Keep at
        # least one token in the suffix (the prefill must produce the
        # next-token logit), and never split a visual region (-7 marks
        # visual slots in the flat stream).
        common = 0
        if reusable and len(state.ids):
            m = min(len(state.ids), L - 1)
            neq = flat[:m] != state.ids[:m]
            common = int(np.argmax(neq)) if neq.any() else m
        if np.any(flat[common:] == -7):
            if extend:  # visuals live in the prefix
                raise RuntimeError("visual slot escaped the shared prefix")
            common = 0  # visual tokens in the suffix -> full mm prefill

        suffix = flat[common:]
        s_buck = packing.round_up_bucket(len(suffix))
        # Never shrink below the live cache's capacity: generate's masks
        # are built at cache_len and must span every slot the reused cache
        # has.
        cache_len = max(
            packing.round_up_bucket(max(L + new_budget, common + s_buck)),
            state.cache_len,
        )
        if common == 0 and packed is not None:
            arrays = oryx.stage_mm_arrays(packed, batch, self.device)
            embeds = oryx.mm_embeds(self.params, cfg, arrays)
            s_buck = embeds.shape[1]
            cache_len = max(
                packing.round_up_bucket(max(L + new_budget, s_buck)),
                state.cache_len,
            )
        else:
            rows = np.zeros((1, s_buck), np.int64)
            # (-7 never reaches here: common == 0 has no cache hits.)
            rows[0, : len(suffix)] = np.where(suffix == -7, 0, suffix)
            with torch.inference_mode():
                embeds = embed_rows(
                    self.params.llm.embed,
                    torch.from_numpy(rows).to(self.device),
                )
        cache = state.cache
        if cache is None or state.cache_len < cache_len:
            fresh = qwen2.init_kv_cache(
                cfg.llm, 1, cache_len,
                dtype=oryx.compute_dtype(cfg), device=self.device,
            )
            if cache is not None:
                # Grow: carry the existing slots into the new buffer.
                for name, x in cache.items():
                    fresh[name][:, :, : x.shape[2]].copy_(x)
            cache = fresh
        return flat, L, common, embeds, cache, cache_len, media_key

    @on_every_rank(bind=_second)
    def chat_cached(
        self,
        state: "PrefixCacheState",
        question: str,
        *,
        images: Sequence[np.ndarray] | None = None,
        is_video: bool = False,
        history: Sequence[tuple[str, str]] | None = None,
        max_new_tokens: int | None = None,
        seed: int = 0,
        temperature: float | None = None,
        top_p: float | None = None,
        stop: Sequence[str] | None = None,
        shared: "Any | None" = None,
        timings: dict | None = None,
    ) -> tuple[str, "PrefixCacheState"]:
        """`chat` for one conversation with cross-turn KV prefix reuse: the
        longest token-id prefix shared with `state.ids` is NOT
        re-prefilled; only the new suffix runs through the model, at
        absolute positions, into a copy of the session's cache. Matching is
        on ids, so a tokenizer boundary merge or a template quirk just
        shortens the reuse, never changes the reply; a visual token inside
        the unshared suffix falls back to a full multimodal prefill.
        Returns (reply, new state); `state` stays valid.

        shared: a SessionPrefixCache. A COLD `state` first seeds itself
        from the cache's longest stored prefix of this prompt (cross-
        session reuse of e.g. a shared system prompt), and the new state is
        donated back after the turn. Text-only lookup (pre-splice ids ==
        the flat stream); multimodal turns still donate and reuse within a
        session. timings: when given, receives visual_s (the prefix plan,
        with any visual encode) and generate's timings."""
        cfg = self._sampling_cfg(temperature, top_p)
        stop_seqs = self._stop_for(stop)
        max_new = max_new_tokens or cfg.generation.max_new_tokens
        generator = torch.Generator(device=self.device).manual_seed(seed)
        ids, imgs, factors, caps = self._prepare_request({
            "question": question, "images": list(images or []),
            "is_video": is_video, "history": list(history or []),
        })
        if shared is not None and state.cache is None and not imgs:
            cand = shared.lookup(
                np.asarray(ids, np.int64), _media_fingerprint(imgs)
            )
            if cand is not None:
                state = cand
        if timings is not None:
            generate_lib._sync(self.device)
            t0 = time.perf_counter()
        flat, L, common, embeds, cache, cache_len, media_key = (
            self._prefix_plan(state, cfg, ids, imgs, factors, caps, max_new)
        )
        if timings is not None:
            generate_lib._sync(self.device)
            timings["visual_s"] = time.perf_counter() - t0
        toks, num, _, cache = generate_lib.generate(
            self.params.llm, cfg.llm, cfg.generation,
            inputs_embeds=embeds,
            lengths=torch.tensor([L], dtype=torch.int32, device=self.device),
            max_new_tokens=max_new, cache_len=cache_len,
            generator=generator, attn_impl=cfg.attn_impl,
            compute_dtype=oryx.compute_dtype(cfg),
            stop_sequences=stop_seqs, kv_cache=cache, start=common,
            return_cache=True, timings=timings,
        )
        toks, num = toks.cpu().numpy(), num.cpu().numpy()
        reply = self._decode(toks[0], int(num[0]), extra_stops=stop)
        new_ids = np.concatenate(
            [flat, toks[0][: int(num[0])].astype(np.int64)]
        )
        new_state = PrefixCacheState(
            ids=new_ids, cache=cache, cache_len=cache_len,
            prompt_ids=np.asarray(ids, np.int64), prompt_flat=flat,
            media_key=media_key,
        )
        if shared is not None:
            shared.insert(new_state)
        return reply, new_state

    @on_every_rank()
    @torch.inference_mode()
    def score_options(
        self,
        question: str,
        options: Sequence[str],
        *,
        images: Sequence[np.ndarray] | None = None,
        is_video: bool = False,
        history: Sequence[tuple[str, str]] | None = None,
    ) -> np.ndarray:
        """Log-likelihood of each candidate continuation given the prompt
        (lmms-eval's `loglikelihood` model API): the prompt, visual prefill
        included, runs ONCE into a KV cache, then each option's tokens are
        teacher-forced against it, summing next-token log-probs. Returns
        [len(options)] float64 sums.

        Options are tokenized STANDALONE, so a BPE tokenizer that would
        merge across the prompt/option boundary scores a token split the
        model may never emit there; include any leading space or
        punctuation in the option string itself."""
        ids, imgs, factors, caps = self._prepare_request({
            "question": question, "images": list(images or []),
            "is_video": is_video, "history": list(history or []),
        })
        cfg = self.cfg
        opt_ids = [
            np.asarray(
                self.tokenizer.encode(o, add_special_tokens=False), np.int64
            )
            for o in options
        ]
        if any(len(o) == 0 for o in opt_ids):
            raise ValueError("every option must encode to >= 1 token")
        kb = packing.round_up_bucket(max(len(o) for o in opt_ids))
        embeds, L = self._prompt_embeds(cfg, ids, imgs, factors, caps)
        cache_len = packing.round_up_bucket(L + kb)
        first_lp, cache = _ll_prefill(self.params, cfg, embeds, L, cache_len)
        first_lp = first_lp.cpu().numpy().astype(np.float64)
        scores = np.zeros(len(options), np.float64)
        for i, o in enumerate(opt_ids):
            scores[i] = first_lp[int(o[0])]
            if len(o) > 1:
                row = np.zeros((1, kb), np.int64)
                row[0, : len(o)] = o
                vec = _ll_suffix(
                    self.params, cfg, cache,
                    torch.from_numpy(row).to(self.device), L, len(o),
                    cache_len,
                )
                # vec[j] = log P(token j+1 | ... token j).
                scores[i] += float(
                    vec.cpu().numpy().astype(np.float64)[: len(o) - 1].sum()
                )
        return scores

    def chat_video(
        self,
        frames: Sequence[np.ndarray],
        question: str,
        *,
        num_frames: int | None = None,
        **kw,
    ) -> str:
        """Video QA: uniform frame sampling then 16x-compressed chat."""
        frames = list(frames)
        if num_frames is not None and len(frames) > num_frames:
            idx = mm_utils.sample_frames(len(frames), num_frames)
            frames = [frames[i] for i in idx]
        return self.chat(question, images=frames, is_video=True, **kw)

    def _decode(
        self, tokens: np.ndarray, num: int,
        extra_stops: Sequence[str] | None = None,
    ) -> str:
        ids = [int(t) for t in tokens[:num]]
        eos = self.cfg.generation.eos_token_id
        while ids and ids[-1] == eos:
            ids.pop()
        text = self.tokenizer.decode(ids, skip_special_tokens=True)
        stops = ([self.conv.stop_str] if self.conv.stop_str else []) + [
            s for s in (extra_stops or []) if s  # "" would match at 0
        ]
        return stop_cut(text, stops)[0].strip()


def _ll_prefill(params: oryx.OryxModel, cfg: OryxConfig, embeds, length: int,
                cache_len: int):
    """Prompt prefill for log-likelihood scoring -> (log-softmax [V] fp32 of
    the next-token logits at the prompt's last real position, KV cache)."""
    lengths = torch.tensor([length], dtype=torch.int32, device=embeds.device)
    logits, cache = generate_lib.prefill(
        params.llm, cfg.llm, embeds, lengths, cache_len=cache_len,
        attn_impl=cfg.attn_impl, compute_dtype=oryx.compute_dtype(cfg),
    )
    return torch.log_softmax(logits[0].float(), dim=-1), cache


def _ll_suffix(params: oryx.OryxModel, cfg: OryxConfig, cache, cont_ids,
               length: int, k: int, cache_len: int) -> torch.Tensor:
    """Teacher-force one option's tokens cont_ids [1, Kb] against the prompt
    cache (written in place from slot `length`; an option's slots are
    overwritten by the next) -> [Kb] fp32: position j's log-prob of
    continuation token j + 1, gathered on the device (the full [Kb, V]
    log-softmax never leaves it)."""
    B, Kb = cont_ids.shape
    dev = cont_ids.device
    positions = length + torch.arange(Kb, device=dev).expand(B, Kb)
    kv_mask = (
        torch.arange(cache_len, device=dev)[None, :] < length + k
    ).to(torch.int32)
    logits, _ = qwen2.forward(
        params.llm, cfg.llm,
        inputs_embeds=embed_rows(params.llm.embed, cont_ids),
        positions=positions,
        kv_cache=cache,
        write_slots=torch.full((B,), length, dtype=torch.long, device=dev),
        kv_mask=kv_mask, attn_impl=cfg.attn_impl,
        compute_dtype=oryx.compute_dtype(cfg),
    )
    lp = torch.log_softmax(logits[0].float(), dim=-1)
    nxt = torch.cat([cont_ids[0, 1:], cont_ids.new_zeros(1)])
    return torch.gather(lp, 1, nxt[:, None])[:, 0]


@dataclasses.dataclass
class PrefixCacheState:
    """Cross-turn KV prefix cache for a single conversation: `ids` is the
    token stream whose K/V occupy cache slots [0, len) (visual slots marked
    -7: they match positionally, never by id), `cache` the device K/V,
    `cache_len` its slot capacity. `prompt_ids`/`prompt_flat` record the
    previous turn's pre-splice and post-splice prompt streams so a turn that
    merely EXTENDS the prompt skips the host-side image packing."""

    ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64)
    )
    cache: dict | None = None
    cache_len: int = 0
    prompt_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64)
    )
    prompt_flat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64)
    )
    # Content fingerprint of the session's media: visual slots match
    # POSITIONALLY in the id stream, so swapped same-shape images would
    # otherwise silently reuse the old images' K/V.
    media_key: tuple = ()


def _media_fingerprint(imgs) -> tuple:
    """Cheap content key for the media list (crc32 per image + shape)."""
    return tuple(
        (im.shape, zlib.crc32(np.ascontiguousarray(im).tobytes()))
        for im in imgs
    )


class ChatSession:
    """Stateful multi-turn conversation over one media context (media
    attach to the first turn).

    With cache=True (default) the session keeps the KV cache across turns
    and each `ask` / `ask_stream` prefills only the token suffix the cache
    has not seen (longest-common-prefix matching over token ids; the
    image/video prefill happens once per session; a media-content
    fingerprint guards against positional false matches). Replies and
    streamed deltas are identical either way.

    shared routes the session through the pipe-level CROSS-session prefix
    index: True uses `pipe.session_prefix_cache()`, or pass a
    SessionPrefixCache. A fresh session then inherits the KV of the longest
    stored prefix (shared system prompt, repeated opener) instead of
    cold-prefilling it, and donates its state back after each turn."""

    def __init__(
        self,
        pipe: Pipeline,
        *,
        images: Sequence[np.ndarray] | None = None,
        is_video: bool = False,
        cache: bool = True,
        shared=None,
    ) -> None:
        self.pipe = pipe
        self.images = list(images or [])
        self.is_video = is_video and bool(self.images)
        self.history: list[tuple[str, str]] = []
        self._cache_state = PrefixCacheState() if cache else None
        if shared is True:
            shared = pipe.session_prefix_cache()
        self.shared = shared if cache else None

    def ask(self, question: str, **kw) -> str:
        if self._cache_state is not None:
            reply, self._cache_state = self.pipe.chat_cached(
                self._cache_state, question, images=self.images,
                is_video=self.is_video, history=self.history,
                shared=self.shared, **kw,
            )
        else:
            reply = self.pipe.chat(
                question, images=self.images, is_video=self.is_video,
                history=self.history, **kw,
            )
        self.history.append((question, reply))
        return reply

    def ask_stream(self, question: str, **kw):
        """Streamed `ask`: yields text deltas; records the turn in history
        once the stream is consumed. With the session cache on, the prompt
        prefix (the visual prefill included) is served from the KV cache
        like `ask`."""
        parts: list[str] = []
        gen = self.pipe.chat_stream(
            question, images=self.images, is_video=self.is_video,
            history=self.history, cache_state=self._cache_state,
            shared=self.shared, **kw,
        )
        while True:
            try:
                delta = next(gen)
            except StopIteration as s:
                if self._cache_state is not None and s.value is not None:
                    _, self._cache_state = s.value
                break
            parts.append(delta)
            yield delta
        self.history.append((question, "".join(parts).strip()))

    def reset(self) -> None:
        self.history.clear()
        if self._cache_state is not None:
            self._cache_state = PrefixCacheState()
