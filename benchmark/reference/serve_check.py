"""The served-token check: each sampled request's prompt and the tokens it
was served run once through the float32 reference (teacher-forced), and
every served token is judged by how far its reference logit lies below
the reference's best at that position. Greedy decoding serves the best
token, so the gap is 0 up to the program's rounding; a wrong token, a
dropped image or a misplaced row reads as a large gap.

The control puts the fp8 reference in the program's place: at each of
the same positions the token it ranks first, judged the same way."""

from __future__ import annotations

import torch

from benchmark.reference import oryx_ref


def _sequence(W, cfg, case) -> tuple[torch.Tensor, int]:
    req, kind = case["request"], case["kind"]
    images = req.get("images") or []
    n_media = 0 if not images else (1 if kind == "video" else len(images))
    ids = oryx_ref.prompt_ids(req["question"], n_media,
                              len(images) if kind == "video" else 0)
    visual = oryx_ref.visual_tokens(W, cfg, images, kind) if images else []
    prompt = oryx_ref.embed_sequence(W, ids, visual)
    served = case["served"]
    table = W.t["llm.embed.weight"]
    fed = table[torch.tensor(served[:-1], device=table.device,
                             dtype=torch.long)].float()
    return torch.cat([prompt, fed], 0), len(prompt)


@torch.no_grad()
def logits_at_served(tensors: dict, cfg: dict, cases: list[dict],
                     prec: str = "fp32", group: int = 4) -> list:
    """Per case, the reference logits [n_served, V] at the positions that
    predicted each served token (float32)."""
    oryx_ref.set_fp32_exact()
    W = oryx_ref.Weights(tensors, prec)
    out = []
    for lo in range(0, len(cases), group):
        seqs, rows = [], []
        for case in cases[lo:lo + group]:
            seq, t0 = _sequence(W, cfg, case)
            seqs.append(seq)
            rows.append(torch.arange(t0 - 1, t0 - 1 + len(case["served"]),
                                     device=seq.device))
        out += oryx_ref.decoder_logits(W, cfg["llm"], seqs, rows)
        del seqs
    return out


def gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """Best logit minus the logit of each token, a row each."""
    t = torch.as_tensor(tokens, device=logits.device, dtype=torch.long)
    return logits.max(-1).values - logits.gather(1, t[:, None])[:, 0]


@torch.no_grad()
def served_gap(tensors: dict, cfg: dict, cases: list[dict]) -> dict:
    """The program's reading: the widest gap over every served token of
    the sampled requests."""
    ref = logits_at_served(tensors, cfg, cases)
    per = [float(gaps(lg, c["served"]).max()) for lg, c in zip(ref, cases)]
    return {"max_gap": max(per), "per_request": per,
            "tokens": sum(len(c["served"]) for c in cases)}


@torch.no_grad()
def control_gap(tensors: dict, cfg: dict, cases: list[dict]) -> dict:
    """The control's reading on the same prompts and served tokens: the
    widest gap of the token the fp8 reference ranks first; the int8
    reference's beside it."""
    ref = logits_at_served(tensors, cfg, cases)
    out = {"max_gap": max(float(gaps(r, c["served"]).max())
                          for r, c in zip(ref, cases))}
    for prec in ("fp8", "int8"):
        low = logits_at_served(tensors, cfg, cases, prec=prec)
        out[f"{prec}_max_gap"] = max(float(gaps(r, lo.argmax(-1)).max())
                                     for r, lo in zip(ref, low))
        del low
    out["control_max_gap"] = out["fp8_max_gap"]
    return out
