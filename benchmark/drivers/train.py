"""SFT: the program's `Trainer.fit` over its own data pipeline
(`train/data.py`: `SupervisedDataset` and `grouped_batch_iterator`, with
`grad_accum_steps` microbatches a step), on seeded records whose media the
benchmark's loader makes.

Set-up builds one Trainer over seeded fp32 leaves and drives its first
two steps through `fit` on the window's feed (the first alone, so that
the first gradient can be read from Adam's first moment); the window then
continues the same Trainer. The batches come in the file's order, the same
for every seed (`traffic/sft.py`). `train_tokens_per_s` is the non-pad decoder
positions of the optimizer steps completed in the window over the time from
the window's start to the end of the last of them (each step ends with the
trainer's own synchronizing read of its metrics, where a hook stamps it).

The Trainer's checkpoint manager is replaced by one that writes nothing:
the configuration saves every 500 steps, so a window of a few tens of steps
holds no save, and `fit`'s closing save would write the whole state."""

from __future__ import annotations

import gc
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import count
from benchmark.harness.tokenizer import CodepointTokenizer
from benchmark.harness.trace import TracedWindow
from benchmark.harness.trace import family as kernel_family
from benchmark.harness.weights import make_weights
from benchmark.traffic.sft import Records

# Steps the reference follows: two of the three the contract names, so that
# it stays near the window's length (a step is 15-75 s in float32).
CHECK_STEPS = 2


class NoCheckpoints:
    """The Trainer's checkpoint manager, writing nothing."""

    def latest_step(self):
        return None

    def save(self, *a, **kw) -> bool:
        return False

    def wait(self) -> None:
        pass


class StepClock:
    """Stands in for the Trainer's telemetry: stamps each step as `fit`
    records it (after the step's synchronizing read), and runs `on_step`."""

    ready = False

    def __init__(self) -> None:
        self.stamps: list[float] = []
        self.on_step = None

    def mark_ready(self, ready: bool, reason: str = "") -> None:
        self.ready = ready

    def record_step(self, step, host, **kw) -> None:
        self.stamps.append(time.perf_counter())
        if self.on_step is not None:
            self.on_step()

    def record_numerics(self, *a, **kw) -> None:
        pass

    def record_restore(self, *a, **kw) -> None:
        pass

    def close(self) -> None:
        pass


class Feed:
    """The batches `fit` reads, in order, with what the benchmark needs of
    each (its records; its non-pad tokens and the attention shapes, from
    the collated masks and ids); ends when `stop_at` (host perf clock) has
    passed."""

    def __init__(self, it, records: Records, per_batch: int) -> None:
        self.it, self.records, self.per = it, records, per_batch
        self.meta: list[dict] = []
        self.stop_at = None

    def __iter__(self):
        return self

    def __next__(self):
        if self.stop_at is not None and time.perf_counter() >= self.stop_at:
            raise StopIteration
        n0 = len(self.records.loaded)
        batch = next(self.it)
        ids = self.records.loaded[n0:n0 + self.per]
        self.meta.append(batch_meta(batch, ids))
        return batch


def batch_meta(batch: dict, ids: list[int]) -> dict:
    """Per microbatch: each row's real length, each image's patches, each
    compressor region's patches, the real query count."""
    micro = []
    for j in range(batch["attn_mask"].shape[0]):
        seg = batch["segment_ids"][j]
        reg = batch["region_ids"][j]
        micro.append({
            "rows": batch["attn_mask"][j].sum(-1).astype(int).tolist(),
            "images": np.bincount(seg[seg > 0]).tolist(),
            "regions": int(np.count_nonzero(np.bincount(reg[reg > 0]))),
            "patches": int((seg > 0).sum()),
        })
    return {"records": ids, "micro": micro,
            "tokens": int(batch["attn_mask"].sum())}


def worst_leaf(prog: dict, ref: dict, names) -> float:
    """max over leaves of |program norm - reference norm| / max(reference
    norm, the median leaf's reference norm)."""
    names = list(names)
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def run(ctx) -> dict:
    from oryx_tpu_torch.config import OryxConfig
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.train import data
    from oryx_tpu_torch.train.trainer import Trainer

    w, cfgf, seed, seconds = ctx.workload, ctx.config, ctx.seed, ctx.seconds
    cfg = OryxConfig.from_dict(cfgf["oryx"])
    tc = cfg.train
    model = oryx.empty_model(cfg, dtype=torch.float32)
    layout = [(n, tuple(p.shape)) for n, p in model.state_dict().items()]
    weights = make_weights(layout, seed, torch.float32, ctx.device)
    p0 = {n: t.to("cpu", copy=True) for n, t in weights.items()}
    model.load_state_dict(weights, assign=True)
    del weights

    records = Records(w["traffic"], seed)
    ds = data.SupervisedDataset(
        records.records, CodepointTokenizer(cfg.generation.eos_token_id),
        template="qwen",
        max_patches_per_image=cfg.vision.max_patches_per_image,
        media_loader=records.loader)
    it = data.grouped_batch_iterator(
        ds, tc.global_batch_size, seed=w["traffic"]["mix_seed"],
        grad_accum_steps=tc.grad_accum_steps,
        length_group_size=tc.length_group_size,
        patch_size=cfg.vision.patch_size, base_grid=cfg.vision.base_grid,
        max_len=tc.max_seq_len)
    feed = Feed(it, records, tc.global_batch_size)
    clock = StepClock()
    trainer = Trainer(cfg, params=model, device=ctx.device, telemetry=clock)
    trainer.ckpt = NoCheckpoints()

    # The first steps of the window's call and feed; Adam's first moment
    # after step 1 is (1 - b1) times the first (clipped) gradient.
    trainer.fit(feed, num_steps=1, resume=False, prefetch=0)
    mu = trainer.state.opt_state["mu"]
    grad1 = {n: float(t.float().norm()) / (1 - tc.adam_b1)
             for n, t in mu.items()}
    trainer.fit(feed, num_steps=CHECK_STEPS - 1, resume=False, prefetch=0)
    losses = [h["loss"] for h in trainer.history[:CHECK_STEPS]]
    with torch.no_grad():
        change = {n: float((p - p0[n].to(p.device)).norm())
                  for n, p in trainer.state.params.named_parameters()}
    del p0
    win = TracedWindow() if ctx.trace else None
    ctx.mark_setup()

    t0 = time.perf_counter()
    t1 = t0 + seconds
    feed.stop_at = t1
    first = len(feed.meta)
    traced: list[int] = []
    if win is not None:
        tr_from = t0 + max(0.0, (seconds - w["trace_seconds"]) / 2)
        state = {"on": False, "done": False}

        def on_step():
            now = time.perf_counter()
            k = len(clock.stamps) - CHECK_STEPS - 1  # window step just ended
            if not state["on"] and not state["done"] and now >= tr_from:
                win.start()
                state.update(on=True, at=now, k=k + 1)
            elif state["on"] and now >= state["at"] + w["trace_seconds"]:
                win.stop()
                state.update(on=False, done=True)
                traced.extend(range(state["k"], k + 1))
        clock.on_step = on_step
    trainer.fit(feed, num_steps=1 << 30, resume=False)
    if win is not None and win.prof is not None:
        win.stop()
    device = ctx.device_record()
    # fit resets the card's peak at each step and keeps each step's.
    device["memory_peak_bytes"] = max(
        [device["memory_peak_bytes"]]
        + [int(h.get("peak_bytes", 0)) for h in trainer.history])

    stamps = clock.stamps[CHECK_STEPS:]
    done = [k for k, s in enumerate(stamps) if s <= t1]
    tokens = sum(feed.meta[first + k]["tokens"] for k in done)
    span = (stamps[done[-1]] - t0) if done else float("nan")
    sys.stderr.write(f"train: {len(done)} steps in the window "
                     f"({len(stamps)} run), {tokens} tokens over {span} s\n")
    out = {"attempted": len(done), "failed": 0, "device": device}
    if not ctx.trace:
        out["metrics"] = {"train_tokens_per_s": tokens / span}
    else:
        recs = win.in_window()
        from benchmark.drivers.serving import trace_summary
        summ = trace_summary(win, [], set())
        summ["breakdown"]["idle_gaps"] = [
            [f"before {name_after(recs, g)}", (g[1] - g[0]) / 1e9]
            for g in _gaps(recs, win)]
        metas = [feed.meta[first + k] for k in traced]
        out["trace"] = dict(
            summ,
            k5_bound_s=sum(count.train_attention_bound_s(cfgf["oryx"],
                                                         m["micro"])
                           for m in metas),
            model_flops=sum(count.train_step_flops(cfgf["oryx"], m["micro"])
                            for m in metas),
        )
        sys.stderr.write(f"trace: {len(traced)} whole steps traced\n")

    # Free the program's state; the reference starts from the same seed.
    batches = [feed.meta[k]["records"] for k in range(CHECK_STEPS)]
    del trainer, model, mu
    gc.collect()
    torch.cuda.empty_cache()
    out["checks"] = check(cfgf, layout, seed, ctx.device, records, batches,
                          tc.grad_accum_steps, losses, grad1, change,
                          w["check"], ctx.control)
    return out


def _gaps(recs, win):
    from benchmark.harness.trace import idle_gaps

    return idle_gaps(recs, win.t0_ns, win.t1_ns)[:10]


def name_after(recs, gap) -> str:
    """The family of the first device record after a gap."""
    for name, s, _ in recs:
        if s >= gap[1]:
            return kernel_family(name)
    return "the window's end"


def readings(ref: dict, losses, grad1, change) -> dict:
    """The three compared numbers of a run against the reference: the
    worst step's loss, the worst leaf's first gradient and the worst
    leaf's change (leaves whose reference gradient is under a thousandth
    of the median leaf's are left out of the change: they move by
    round-off alone)."""
    raw = ref["raw_grad_norm"]
    med = statistics.median(raw.values())
    moved = [n for n in raw if raw[n] >= med / 1000]
    return {
        "loss_rel": max(abs(p - r) / abs(r)
                        for p, r in zip(losses, ref["loss"])),
        "grad_leaf": worst_leaf(grad1, ref["grad_norm"], raw),
        "change_leaf": worst_leaf(change, ref["change"], moved),
    }


def check(cfgf, layout, seed, device, records, batches, accum, losses,
          grad1, change, limits, control: bool = False) -> dict:
    """The numbers that `limits` names; with `control` (benchmark/tools/control.py)
    the readings of the fp8 control and of a reference that leaves half
    of each batch out, each put in the program's place."""
    from benchmark.reference import train_ref

    per = len(batches[0]) // accum
    feed = [[[(records.records[i], records.media(records.records[i]))
              for i in b[j * per:(j + 1) * per]] for j in range(accum)]
            for b in batches]

    def follow(feed, prec="fp32"):
        params = make_weights(layout, seed, torch.float32, device)
        res = train_ref.follow(params, cfgf["oryx"], feed, prec)
        del params
        torch.cuda.empty_cache()
        return res

    t0 = time.perf_counter()
    ref = follow(feed)
    sys.stderr.write(f"reference: {len(feed)} steps in "
                     f"{time.perf_counter() - t0:.1f} s\n")
    for k, (p, r) in enumerate(zip(losses, ref["loss"])):
        sys.stderr.write(f"loss step {k + 1}: program {p!r} reference {r!r} "
                         f"rel {abs(p - r) / abs(r)!r}\n")
    got = readings(ref, losses, grad1, change)
    # A reading the cell gives no limit is printed and not compared: the
    # loss gap of sound runs and of the fp8 control overlap (PERF.md).
    out = {k: {"value": v, "limit": limits[k]} for k, v in got.items()
           if k in limits}
    for k in got.keys() - limits.keys():
        sys.stderr.write(f"reading {k} {got[k]!r} (not compared)\n")
    if control:
        for tag, res in (("control", follow(feed, "fp8")),
                         ("half_batch", follow([b[:accum // 2]
                                                for b in feed]))):
            r = readings(ref, res["loss"], res["grad_norm"], res["change"])
            out.update({f"{tag}_{k}": {"value": v, "limit": None}
                        for k, v in r.items()})
    return out
