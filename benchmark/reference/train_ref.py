"""Float32 reference of the SFT step: the same records, in the same batches
and microbatches, through the plain model of `oryx_ref` (each tower and
decoder layer checkpointed so that it fits), the masked next-token loss
and AdamW with the configuration's per-group learning rates, warm-up and
clipping.

The records' tokens, labels and pixels are worked out here again from the
records (the ChatML template with the assistant turns supervised, one
sentinel a frame for a video); nothing of the program's collation is read.
`prec="fp8"` is the control (fp8 weights a row, bf16 activations,
straight-through gradients)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from benchmark.reference import oryx_ref

IGNORE = -100
GROUPS = ("llm", "projector", "vision")


def group_of(name: str) -> str:
    top = name.split(".", 1)[0]
    return {"compressor": "projector", "vit": "vision"}.get(top, "llm")


def schedule(t: dict, base: float):
    """count -> learning rate: linear warm-up from 0 over warmup_ratio of
    the steps, then cosine decay to 0."""
    warm = max(1, int(t["warmup_ratio"] * t["num_train_steps"]))
    decay = max(t["num_train_steps"], warm + 1) - warm

    def lr(c: int) -> float:
        if c < warm:
            return base * c / warm
        c = min(c - warm, decay)
        return base * 0.5 * (1 + math.cos(math.pi * c / decay))
    return lr


def sample_ids(rec: dict, n_frames: int) -> tuple[list[int], list[int]]:
    """(ids with image sentinels, labels): ChatML, only the assistant
    turns (with their closing separator) supervised."""
    parts = [(f"<|im_start|>system\n{oryx_ref.SYSTEM}<|im_end|>\n", False)]
    for m in rec["conversations"]:
        role = "assistant" if m["from"] == "gpt" else "user"
        parts.append((f"<|im_start|>{role}\n", False))
        parts.append((f"{m['value']}<|im_end|>\n", m["from"] == "gpt"))
    ids: list[int] = []
    labels: list[int] = []
    for text, sup in parts:
        for i, chunk in enumerate(text.split("<image>")):
            if i > 0:
                k = n_frames if n_frames else 1
                ids += [oryx_ref.IMAGE_TOKEN] * k
                labels += [IGNORE] * k
            b = list(chunk.encode("utf-8"))
            ids += b
            labels += b if sup else [IGNORE] * len(b)
    return ids, labels


def _kind(rec: dict, n_images: int) -> str:
    if rec.get("video") is not None:
        return "video"
    return "multi_image" if n_images > 1 else "image"


def _vit_layer(W, v, x, i):
    return ckpt.checkpoint(oryx_ref.vit_layer, W, v, x, i,
                           use_reentrant=False)


def sample_loss(W, cfg: dict, rec: dict, images) -> tuple[torch.Tensor, int]:
    """(sum of the sample's token losses, its supervised count)."""
    kind = _kind(rec, len(images))
    ids, labels = sample_ids(rec, len(images) if kind == "video" else 0)
    visual = oryx_ref.visual_tokens(W, cfg, images, kind, layer=_vit_layer)
    x = oryx_ref.embed_sequence(W, ids, visual)
    # Labels at the spliced positions: a sentinel's span is unsupervised.
    lab, vis = [], iter(visual)
    for t, lb in zip(ids, labels):
        lab += [IGNORE] * len(next(vis)) if t == oryx_ref.IMAGE_TOKEN else [lb]
    target = torch.tensor(lab[1:] + [IGNORE], device=x.device)
    llm = cfg["llm"]
    pos = torch.arange(len(x), device=x.device)
    for i in range(llm["num_layers"]):
        x = ckpt.checkpoint(oryx_ref.decoder_layer, W, llm, x, pos, i,
                            use_reentrant=False)
    rows = (target != IGNORE).nonzero()[:, 0]
    logits = oryx_ref.head_logits(W, llm, x[rows])
    return F.cross_entropy(logits, target[rows], reduction="sum"), len(rows)


def follow(params: dict, cfg: dict, batches: list[list[tuple]],
           prec: str = "fp32") -> dict:
    """Train `params` ({name: float32 leaf}, in place) over `batches` (each
    a list of microbatches, each a list of (record, images)). Returns the
    loss of each step, each leaf's norm of the first step's gradient as
    the optimizer takes it (clipped) and before clipping, and each leaf's
    norm of its change over all the steps."""
    oryx_ref.set_fp32_exact()
    t = cfg["train"]
    base = {"llm": t["learning_rate"],
            "projector": t["projector_lr"] or t["learning_rate"],
            "vision": t["vision_lr"] or t["learning_rate"]}
    lrs = {g: schedule(t, base[g]) for g in GROUPS}
    b1, b2, eps = t["adam_b1"], t["adam_b2"], t["adam_eps"]
    names = sorted(params)
    p0 = {n: params[n].detach().to("cpu", copy=True) for n in names}
    for n in names:
        params[n].requires_grad_(True)
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    W = oryx_ref.Weights(params, prec)
    out = {"loss": [], "grad_norm": {}, "raw_grad_norm": {}}
    for step, micro in enumerate(batches, start=1):
        for n in names:
            params[n].grad = None
        loss = 0.0
        for mb in micro:
            count = sum(sum(1 for x in sample_ids(
                r, len(im) if r.get("video") else 0)[1][1:] if x != IGNORE)
                for r, im in mb)
            total = 0.0
            for rec, images in mb:
                s, _ = sample_loss(W, cfg, rec, images)
                (s / count / len(micro)).backward()
                total += float(s.detach())
            loss += total / count / len(micro)
        out["loss"].append(loss)
        with torch.no_grad():
            for g in GROUPS:
                grp = [n for n in names if group_of(n) == g]
                grads = {n: params[n].grad for n in grp}
                gnorm = torch.sqrt(sum(x.double().pow(2).sum()
                                       for x in grads.values()))
                clip = float(gnorm) >= t["max_grad_norm"]
                lr = lrs[g](step - 1)
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                for n in grp:
                    gr = grads[n]
                    if step == 1:
                        out["raw_grad_norm"][n] = float(gr.norm())
                    if clip:
                        gr = gr / gnorm.float() * t["max_grad_norm"]
                    if step == 1:
                        out["grad_norm"][n] = float(gr.norm())
                    m[n].mul_(b1).add_((1 - b1) * gr)
                    v[n].mul_(b2).add_((1 - b2) * gr * gr)
                    u = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + eps)
                    if t["weight_decay"] and (params[n].dim()
                                              + (".layers." in n)) >= 2:
                        u = u + t["weight_decay"] * params[n]
                    params[n].add_(-lr * u)
    with torch.no_grad():
        out["change"] = {n: float((params[n] - p0[n].to(params[n].device))
                                  .norm()) for n in names}
    return out
