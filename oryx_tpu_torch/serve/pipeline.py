"""End-to-end inference pipeline: media + question -> answer text (port of
`oryx_tpu.serve.pipeline.OryxInference`, batch path).

Host side: build the conversation prompt with `<image>` placeholders,
tokenize with sentinels, pack the raw images (resize, normalize, patchify)
and build the spliced index map. Device side: ViT -> compressor -> splice ->
dense-KV prefill -> greedy/sampled decode. Streaming, multi-turn prefix reuse,
option scoring and multi-device meshes come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from oryx_tpu_torch.config import OryxConfig
from oryx_tpu_torch.constants import (
    COMPRESSOR_RATIO,
    DEFAULT_IMAGE_TOKEN,
    MODALITY_IMAGE,
    MODALITY_MULTI_IMAGE,
    MODALITY_VIDEO,
)
from oryx_tpu_torch.conversation import conv_templates
from oryx_tpu_torch.data import mm_utils
from oryx_tpu_torch.models import generate as generate_lib
from oryx_tpu_torch.models import oryx, splice
from oryx_tpu_torch.models.params import resolve_device
from oryx_tpu_torch.ops import packing


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
    ) -> None:
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self._frame_sep_cache = None
        # Ring attention is a training/prefill configuration; decode needs
        # the cached path, so ring-trained configs serve with the dense
        # kernel (the plain path on the CPU).
        if cfg.attn_impl.startswith("ring"):
            impl = "pallas" if self.device.type == "cuda" else "xla"
            cfg = dataclasses.replace(cfg, attn_impl=impl)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.conv = conv_templates[template]
        # In-loop stop matching: rows end as soon as the template's stop
        # string is emitted.
        self.stop_sequences = generate_lib.make_stop_sequences(
            [self.conv.stop_str] if self.conv.stop_str else [], tokenizer
        )

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
    ) -> str:
        """QA over optional images / video frames."""
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
        (visual_s, prefill_s, decode_s) and decode_steps.
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
            embeds = self.params.llm.embed.weight[
                torch.from_numpy(rows).to(self.device)
            ]
            return generate_lib.generate(
                self.params.llm, cfg.llm, cfg.generation,
                inputs_embeds=embeds,
                lengths=torch.from_numpy(lengths).to(self.device),
                max_new_tokens=max_new, cache_len=cache_len,
                generator=generator, attn_impl=cfg.attn_impl,
                compute_dtype=oryx.compute_dtype(cfg),
                stop_sequences=stop_seqs, timings=timings,
            )

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
