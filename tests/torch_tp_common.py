"""Tensor-parallel ranks for the port's tests, without jax.

A `RankZero` is one process that makes itself rank 0 of a world of ranks
it starts (the port's own launch path, parallel/tp.py), then runs jobs
the test process sends over a pipe: the functions named `job_*` below,
each called as job(state, *args) with `state` a dict that process keeps
between jobs. The test process (which holds jax) never joins the world.
One such process serves a whole test module; every job and every wait
has a timeout.

The weights are a JAX tree converted to numpy in the test process; rank
0 builds the port's model from it (models/convert.py, numpy only) and
the tensor-parallel `Pipeline` over it on the CPU, in fp32.
"""

from __future__ import annotations

import multiprocessing as mp
import traceback

import numpy as np


class CharTokenizer:
    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


GEOM = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512)


class RankZero:
    """A process that is rank 0 of `shape` (dp, fsdp, tp, sp) ranks."""

    def __init__(self, shape=(1, 1, 2, 1), timeout: float = 180.0):
        ctx = mp.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_rank0_main, args=(child, shape),
                                daemon=True)
        self.proc.start()
        child.close()
        self.info = self._answer(timeout)

    def _answer(self, timeout: float):
        if not self.conn.poll(timeout):
            raise TimeoutError(f"rank 0 gave no answer in {timeout} s")
        ok, value = self.conn.recv()
        if not ok:
            raise RuntimeError(f"rank 0 failed:\n{value}")
        return value

    def run(self, job: str, *args, timeout: float = 300.0):
        self.conn.send((job, args))
        return self._answer(timeout)

    def close(self) -> None:
        try:
            self.conn.send(None)
            self.proc.join(60)
        except (BrokenPipeError, OSError):
            pass
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(10)


def _rank0_main(conn, shape) -> None:
    import os

    # Two compute threads a rank: the followers inherit the variable, and
    # the test run's workers share the host's cores with every rank.
    os.environ["OMP_NUM_THREADS"] = "2"
    import torch

    torch.set_num_threads(2)
    state: dict = {"pipes": {}}
    try:
        from oryx_tpu_torch.config import MeshConfig
        from oryx_tpu_torch.parallel import mesh as mesh_lib
        from oryx_tpu_torch.parallel import tp as tp_lib

        dp, fsdp, tp, sp = shape
        n = dp * fsdp * tp * sp
        tp_lib.start(n, tp_lib.default_devices(n, "cpu"))
        state["mesh"] = mesh_lib.build_mesh(MeshConfig(*shape))
        world = tp_lib.current()
        conn.send((True, {"backend": world.backend, "size": world.size,
                          "devices": [str(d) for d in world.devices]}))
    except BaseException:  # noqa: BLE001 - reported to the test
        conn.send((False, traceback.format_exc()))
        return
    while True:
        msg = conn.recv()
        if msg is None:
            break
        job, args = msg
        try:
            conn.send((True, globals()[job](state, *args)))
        except BaseException:  # noqa: BLE001 - reported to the test
            conn.send((False, traceback.format_exc()))
    world = tp_lib.current()
    if world is not None:
        world.shutdown()


# ---- jobs (run in the rank-0 process) --------------------------------------


def _cfg(cfg_dict):
    from oryx_tpu_torch.config import OryxConfig

    return OryxConfig.from_dict(cfg_dict)


def job_pipeline(state, key, tree, cfg_dict, mesh_key="mesh", mode="tp"):
    """A sharded Pipeline (`mode` tp or fsdp) over the JAX tree's weights,
    kept under `key`."""
    from oryx_tpu_torch.models.convert import from_jax_params
    from oryx_tpu_torch.serve.pipeline import Pipeline

    cfg = _cfg(cfg_dict)
    state["pipes"][key] = Pipeline(
        CharTokenizer(), from_jax_params(tree, cfg), cfg, device="cpu",
        mesh=state[mesh_key], sharding_mode=mode)
    pipe = state["pipes"][key]
    return {"tp": pipe.tp.size,
            "q_rows": int(pipe.params.llm.layers[0].q_proj.weight.shape[0]),
            "o_cols": int(pipe.params.llm.layers[0].o_proj.weight.shape[1])}


def job_pipeline_dir(state, key, model_dir, cfg_dict):
    """A tp Pipeline whose ranks each read their slices off a
    `save_pretrained` directory (sharding.CheckpointParams), under
    `key`."""
    from oryx_tpu_torch.parallel.sharding import CheckpointParams
    from oryx_tpu_torch.serve.pipeline import Pipeline

    state["pipes"][key] = Pipeline(
        CharTokenizer(), CheckpointParams(model_dir), _cfg(cfg_dict),
        device="cpu", mesh=state["mesh"])
    return job_shapes(state, key)


def job_chat_batch(state, key, requests, kw):
    return state["pipes"][key].chat_batch(requests, **kw)


def job_chat(state, key, question, kw):
    return state["pipes"][key].chat(question, **kw)


def job_stream(state, key, question, kw):
    return list(state["pipes"][key].chat_stream(question, **kw))


def prefill_logits(pipe, ids):
    """Next-token logits [V] fp32 of one text prompt (a dispatch every
    rank runs)."""
    import torch

    from oryx_tpu_torch.models import generate as generate_lib
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.utils.quant import embed_rows

    with torch.inference_mode():
        rows = torch.tensor([ids], dtype=torch.long)
        embeds = embed_rows(pipe.params.llm.embed, rows)
        logits, _ = generate_lib.prefill(
            pipe.params.llm, pipe.cfg.llm, embeds,
            torch.tensor([len(ids)], dtype=torch.int32),
            cache_len=len(ids) + 8, attn_impl=pipe.cfg.attn_impl,
            compute_dtype=oryx.compute_dtype(pipe.cfg))
    return logits[0].numpy()


def job_prefill_logits(state, key, ids):
    pipe = state["pipes"][key]
    return pipe.tp.call(prefill_logits, pipe, list(ids))


def job_engine(state, key, reqs, kw, engine="sharded"):
    """Replies of `reqs` [(question, cap)] through an engine on the tp
    pipe, everything submitted before the start; plus the dispatch
    counts by kind and each rank's KV heads."""
    from oryx_tpu_torch.serve.engine import create_engine
    from oryx_tpu_torch.utils.metrics import ServingMetrics

    pipe = state["pipes"][key]
    metrics = ServingMetrics()
    geom = dict(GEOM)
    geom.update(kw)
    if "drafter" in geom:
        from oryx_tpu_torch.models import generate as generate_lib

        geom["drafter"] = generate_lib.NeuralDrafter.from_spec(
            geom["drafter"])
    sched = create_engine(engine, pipe, autostart=False, metrics=metrics,
                          **geom)
    try:
        heads = int(sched.kv_pages["k"].shape[3])
        handles = [sched.submit({"question": q}, cap) for q, cap in reqs]
        sched.start()
        out = [h.result(timeout=300) for h in handles]
    finally:
        sched.close()
    rendered = metrics.render()
    return {"replies": [r[0] for r in out], "heads": heads,
            "dispatches": metrics.by_label("dispatches_total"),
            "host_reload": "oryx_cache_host" in rendered,
            "digests": pipe.tp.digests()}


def job_engine_refusals(state, key, bad_cfg_dict):
    """The sharded engine's refusals on a tp world: a mesh without a tp
    width and KV heads that do not divide; and the pipeline's own."""
    from types import SimpleNamespace

    from oryx_tpu_torch.config import MeshConfig
    from oryx_tpu_torch.parallel import mesh as mesh_lib
    from oryx_tpu_torch.serve.engine import create_engine

    out = {}
    fsdp = mesh_lib.build_mesh(MeshConfig(fsdp=2))
    pipe = state["pipes"][key]
    for name, stand_in in (
            ("tp_axis", SimpleNamespace(mesh=fsdp, cfg=pipe.cfg)),
            ("divide", SimpleNamespace(mesh=state["mesh"],
                                       cfg=_cfg(bad_cfg_dict)))):
        try:
            create_engine("sharded", stand_in, autostart=False, **GEOM)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def job_bad_pipeline(state, tree, cfg_dict):
    """Pipeline(mesh=) on weights whose heads do not divide: its error."""
    from oryx_tpu_torch.models.convert import from_jax_params
    from oryx_tpu_torch.serve.pipeline import Pipeline

    cfg = _cfg(cfg_dict)
    try:
        Pipeline(CharTokenizer(), from_jax_params(tree, cfg), cfg,
                 device="cpu", mesh=state["mesh"])
    except ValueError as e:
        return str(e)
    return None


def job_session(state, key, img, questions, kw):
    from oryx_tpu_torch.serve.pipeline import ChatSession

    pipe = state["pipes"][key]
    session = ChatSession(pipe, images=[img], shared=True)
    asked = [session.ask(q, **kw) for q in questions]
    streamed = ["".join(session.ask_stream(q, **kw)) for q in questions]
    return asked, streamed


def job_journal(state, key, path, reqs, kw):
    """A journaled capture on the tp pipe, then its cold replay on the
    same pipe: (first divergence, (matched, total, bad))."""
    from oryx_tpu_torch.serve import journal as journal_lib
    from oryx_tpu_torch.serve import replay as rj
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    pipe = state["pipes"][key]
    j = journal_lib.DecisionJournal(path)
    sched = ContinuousScheduler(pipe, autostart=False, journal=j, **kw)
    try:
        handles = [sched.submit({"question": q}, cap, None,
                                request_id=f"r{i}")
                   for i, (q, cap) in enumerate(reqs)]
        sched.start()
        for h in handles:
            h.result(timeout=300)
    finally:
        sched.close()
        j.close()
    header, entries = journal_lib.read_journal(path)
    res = rj.run_replay(header, entries, pipe=pipe, timeout_s=300)
    return (rj.first_divergence(entries, res["entries"]),
            rj.reply_match(entries, res["entries"]),
            [e["kind"] for e in entries])


def job_audit(state, key, reqs, kw):
    """`reqs` [(question, cap)] through a `ContinuousScheduler` on the
    sharded pipe, request ids r0.., everything submitted before the start;
    with `audit_sample_every` in `kw`, waited on until every pick has its
    verdict. `sanitize` in kw: the lock-order sanitizer and race detector
    armed (record mode) around the engine. Returns the replies, the
    auditor's `to_dict()`, the dispatch counts by kind, the ranks' digests
    and the sanitizer's violations."""
    from oryx_tpu_torch.analysis import sanitizers
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler
    from oryx_tpu_torch.utils.metrics import ServingMetrics

    kw = dict(kw)
    sanitize = kw.pop("sanitize", False)
    pipe = state["pipes"][key]
    metrics = ServingMetrics()
    if sanitize:
        sanitizers.arm_lock_sanitizer(action="record")
    violations = None
    try:
        sched = ContinuousScheduler(pipe, autostart=False, metrics=metrics,
                                    **kw)
        out = _audited_run(sched, reqs, kw)
        if sanitize:
            violations = (list(sanitizers.lock_stats().violations)
                          + sanitizers.race_violations())
    finally:
        if sanitize:
            sanitizers.disarm_lock_sanitizer()
    return dict(out, dispatches=metrics.by_label("dispatches_total"),
                digests=pipe.tp.digests(), violations=violations)


def _audited_run(sched, reqs, kw):
    """job_audit's serving and its wait for the audit backlog."""
    import time

    try:
        handles = [sched.submit({"question": q}, cap, None,
                                request_id=f"r{i}")
                   for i, (q, cap) in enumerate(reqs)]
        sched.start()
        replies = [h.result(timeout=300) for h in handles]
        want = len(reqs) // kw.get("audit_sample_every", len(reqs) + 1)
        end = time.monotonic() + 300
        while (sched.auditor.to_dict()["total"] < want
               or sched.auditor.pending()):
            if time.monotonic() > end:
                raise TimeoutError(f"audits never drained: "
                                   f"{sched.auditor.to_dict()}")
            time.sleep(0.05)
        audits = sched.auditor.to_dict()
    finally:
        sched.close()
    return {"replies": replies, "audits": audits}


def pool_rows(world, k_rows, fmt, page_size):
    """Write whole K rows [N, Hk, D] into a one-page-per-row quantized
    pool of this rank's heads, through the model's write path; return
    every rank's codes (as int32, assembled over all heads) and this
    rank's scales."""
    import torch
    import torch.distributed as dist

    from oryx_tpu_torch.ops import paged_kv

    N, Hk, D = k_rows.shape
    h = Hk // world.size
    pages = -(-N // page_size)
    plane = paged_kv.init_quant_pages(1, pages, page_size, h, D, fmt=fmt,
                                      device="cpu")[0]
    mine = k_rows[:, world.rank * h:(world.rank + 1) * h]
    paged_kv.scatter_rows(plane, torch.arange(N), mine.contiguous(), world)
    codes = plane.q.reshape(-1, h, D)[:N].view(torch.uint8).to(torch.int32)
    full = torch.zeros((N, Hk, D), dtype=torch.int32)
    full[:, world.rank * h:(world.rank + 1) * h] = codes
    dist.all_reduce(full, group=world.ctl_timed)
    return full.numpy(), plane.scale.reshape(-1)[:N].clone().numpy()


def job_pool_rows(state, k_rows, fmt, page_size=4):
    import torch

    from oryx_tpu_torch.parallel import tp as tp_lib

    world = tp_lib.current()
    return world.call(pool_rows, world, torch.from_numpy(k_rows), fmt,
                      page_size)


def job_shapes(state, key):
    """{parameter name: the shape this rank holds} of a pipe's shard."""
    return {n: tuple(p.shape)
            for n, p in state["pipes"][key].params.named_parameters()}


def job_entry_points(state, model_dir, task, media_root, image_path,
                     shard="tp=2", engine="sharded"):
    """`--shard` (tp=2 by default) through serve/cli, eval/harness,
    gradio_app and api_server's main (`--engine`, its server answering one
    request): what each printed or answered."""
    import contextlib
    import io
    import json
    import threading
    import urllib.request

    from oryx_tpu_torch.eval import harness
    from oryx_tpu_torch.serve import api_server, builder, cli, gradio_app

    builder.load_tokenizer = lambda path: CharTokenizer()
    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--model-path", model_dir, "--image", image_path,
                  "--question", "what is this?", "--max-new-tokens", "6",
                  "--shard", shard, "--device", "cpu"])
    out["cli"] = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        harness.main(["--model-path", model_dir, "--task", task,
                      "--media-root", media_root, "--num-frames", "2",
                      "--max-new-tokens", "2", "--shard", shard,
                      "--device", "cpu"])
    out["harness"] = json.loads(buf.getvalue().strip().splitlines()[-1])

    seen = {}

    class App:
        def __init__(self, pipe):
            self.pipe = pipe

        def launch(self, **kw):
            seen["gradio"] = (self.pipe.tp.size,
                              self.pipe.chat("hello there",
                                             max_new_tokens=6))

    real_app = gradio_app.build_app
    gradio_app.build_app = lambda pipe, **kw: App(pipe)
    try:
        gradio_app.main(["--model-path", model_dir, "--shard", shard,
                         "--device", "cpu"])
    finally:
        gradio_app.build_app = real_app
    out["gradio"] = seen["gradio"]

    real_build = api_server.build_server

    def build(pipe, **kw):
        kw.update(port=0, host="127.0.0.1")
        srv = real_build(pipe, **kw)
        seen["engine"] = kw["engine"]

        def serve_forever():
            t = threading.Thread(target=real_serve, daemon=True)
            t.start()
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            body = json.dumps({
                "model": "oryx", "max_tokens": 6,
                "messages": [{"role": "user", "content": "hello there"}],
            }).encode()
            req = urllib.request.Request(
                url + "/v1/chat/completions", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                seen["api"] = json.loads(r.read())["choices"][0][
                    "message"]["content"]
            srv.begin_drain()
            if srv.scheduler is not None:
                srv.scheduler.drain(timeout=60)
                srv.scheduler.close()
            if getattr(srv, "supervisor", None) is not None:
                srv.supervisor.stop()
            srv.shutdown()
            t.join(30)

        real_serve = srv.serve_forever
        srv.serve_forever = serve_forever
        return srv

    api_server.build_server = build
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            api_server.main(["--model-path", model_dir, "--shard", shard,
                             "--engine", engine, "--ragged",
                             "--prefill-chunk", "32", "--page-size", "16",
                             "--max-ctx", "512", "--num-slots", "2",
                             "--device", "cpu"])
    finally:
        api_server.build_server = real_build
    out["api"] = (seen["engine"], seen["api"])
    # The caller's device type must be the ranks': the CPU ranks refuse
    # `--device cuda`, and load_pipeline does not move a cuda request.
    try:
        cli.main(["--model-path", model_dir, "--question", "hi",
                  "--shard", "tp=2"])
    except ValueError as e:
        out["cuda_on_cpu_ranks"] = str(e)
    try:
        builder.load_pipeline(model_dir, mesh=state["mesh"], device="cuda")
    except RuntimeError as e:
        out["cuda_pipeline"] = str(e)
    return out


def job_kill_follower_then_engine(state, key, reqs):
    """Kill rank 1, then dispatch: how long the engine took to report
    dead, and whether it did."""
    import time

    from oryx_tpu_torch.parallel import tp as tp_lib
    from oryx_tpu_torch.serve.engine import create_engine

    pipe = state["pipes"][key]
    sched = create_engine("sharded", pipe, autostart=False, ragged=True,
                          prefill_chunk=32, **GEOM)
    world = tp_lib.current()
    world.kill_follower(1)
    t0 = time.monotonic()
    handles = [sched.submit({"question": q}, cap) for q, cap in reqs]
    sched.start()
    errors = []
    for h in handles:
        try:
            h.result(timeout=world.timeout_s + 60)
        except Exception as e:  # noqa: BLE001 - the expected failure
            errors.append(type(e).__name__)
    deadline = time.monotonic() + world.timeout_s + 60
    while sched.alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    dead_after = time.monotonic() - t0
    alive = sched.alive()
    sched.close()
    return {"alive": alive, "seconds": dead_after, "errors": errors,
            "broken": world.broken is not None,
            "timeout_s": world.timeout_s}


def job_mesh_checks(state):
    """The 8-rank meshes of tests/test_mesh.py: shapes, the product check,
    the hybrid layout, and a sum over each fsdp group."""
    import torch

    from oryx_tpu_torch.config import MeshConfig
    from oryx_tpu_torch.parallel import mesh as mesh_lib
    from oryx_tpu_torch.parallel import tp as tp_lib

    out = {}
    m = state["mesh"]
    out["names"] = list(m.mesh_dim_names)
    out["shape"] = mesh_lib.axis_sizes(m)
    try:
        mesh_lib.build_mesh(MeshConfig(dp=3))
    except ValueError as e:
        out["dp3"] = str(e)
    h = mesh_lib.build_hybrid_mesh(MeshConfig(dp=2, fsdp=4), num_slices=2)
    out["hybrid_shape"] = mesh_lib.axis_sizes(h)
    out["hybrid_ranks"] = h.mesh.reshape(2, 4).tolist()
    world = tp_lib.current()
    out["sums"] = world.call(fsdp_sum, h, torch.arange(16.0).reshape(8, 2))
    try:
        mesh_lib.build_hybrid_mesh(MeshConfig(dp=3), num_slices=2)
    except ValueError as e:
        out["hybrid_bad"] = str(e)
    tp8, mode = mesh_lib.parse_shard_arg("tp=8")
    out["tp8"] = (mesh_lib.axis_sizes(tp8), mode)
    fsdp8, mode = mesh_lib.parse_shard_arg("fsdp=8")
    out["fsdp8"] = (mesh_lib.axis_sizes(fsdp8), mode)
    return out


def fsdp_sum(mesh, x):
    """Each rank's row of `x`, summed over its fsdp group (a slice)."""
    import torch.distributed as dist

    from oryx_tpu_torch.parallel import tp as tp_lib

    rank = tp_lib.current().rank
    row = x[rank].clone()
    dist.all_reduce(row, group=mesh.get_group("fsdp"))
    return row.tolist()


def as_numpy_tree(tree):
    """A JAX tree as float32 numpy arrays (picklable into the rank-0 process)."""
    if isinstance(tree, dict):
        return {k: as_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def job_generate_paged(state, key, ids, lengths, kw):
    """`generate_paged(mesh=)` over the tp pipe's shard: (tokens, counts,
    finished) as numpy, the call a dispatch every rank runs."""
    import torch

    from oryx_tpu_torch.models import generate as generate_lib
    from oryx_tpu_torch.utils.quant import embed_rows

    pipe = state["pipes"][key]
    rows = torch.tensor(ids, dtype=torch.long)
    with torch.inference_mode():
        embeds = embed_rows(pipe.params.llm.embed, rows)
    out = generate_lib.generate_paged(
        pipe.params.llm, pipe.cfg.llm, pipe.cfg.generation,
        inputs_embeds=embeds, lengths=lengths, device="cpu",
        mesh=state["mesh"], **kw)
    return tuple(x.numpy() for x in out)


# ---- ring attention and the ranked trainer ------------------------------------


def ring_run(q, k, v, kw, grad):
    """Every rank: the port's global `ring_attention` over the world's
    ranks on the whole q/k/v (numpy); the output and, with `grad`, the
    gradients of sum(out ** 2), each rank's blocks summed over the ranks."""
    import torch

    from oryx_tpu_torch.ops.ring_attention import Ring, ring_attention
    from oryx_tpu_torch.parallel import tp as tp_lib

    world = tp_lib.current()
    group = tuple(range(world.size))
    with torch.inference_mode(False), torch.enable_grad():
        qkv = [torch.from_numpy(x.copy()).requires_grad_(grad)
               for x in (q, k, v)]
        kw = dict(kw)
        if kw.get("kv_mask") is not None:
            kw["kv_mask"] = torch.from_numpy(kw["kv_mask"].copy())
        out = ring_attention(*qkv, ring=Ring(world, group), **kw)
        res = {"out": out.detach().numpy()}
        if grad:
            (out ** 2).sum().backward()
            res["grads"] = [world.sum(x.grad, group).numpy() for x in qkv]
    return res


def job_ring(state, q, k, v, kw, grad=False):
    from oryx_tpu_torch.parallel import tp as tp_lib

    return tp_lib.current().call(ring_run, q, k, v, kw, grad)


def _history(trainer):
    return [{k: h[k] for k in ("loss", "grad_norm", "num_tokens")}
            for h in trainer.history]


def job_fit(state, key, tree, cfg_dict, mode, batches, steps, resume=False):
    """A `Trainer` over the world's ranks in `mode` from the JAX tree's
    weights, fit for `steps` steps on `batches` (host dicts); its metric
    history, every leaf gathered whole (numpy) and each rank's holdings.
    The trainer is kept under `key`."""
    from oryx_tpu_torch.models.convert import from_jax_params
    from oryx_tpu_torch.train.trainer import Trainer

    cfg = _cfg(cfg_dict)
    trainer = Trainer(cfg, params=from_jax_params(tree, cfg), device="cpu",
                      sharding_mode=mode)
    start = (trainer.ckpt.latest_step() or 0) if resume else 0
    trainer.fit(iter(batches[start:]), num_steps=steps, resume=resume,
                prefetch=0)
    trainer.close()
    state.setdefault("trainers", {})[key] = trainer
    reports = trainer.rank_reports()
    return {
        "start": start,
        "history": _history(trainer),
        "params": {n: t.numpy() for n, t in trainer.full_params().items()},
        "reports": [{k: r[k] for k in ("param_shapes", "mu_shapes",
                                       "param_bytes", "moment_bytes",
                                       "vit_rows")}
                    for r in reports],
        "step": trainer.state.step,
    }


def job_lora_export(state, key, out_dir):
    """The PEFT adapter directory of the LoRA trainer kept under `key`,
    written from rank 0 (`export_lora_dir` over its leaves gathered
    whole); the files' bytes by name."""
    import os

    from oryx_tpu_torch.models.import_hf import export_lora_dir
    from oryx_tpu_torch.parallel.sharding import frozen_model

    trainer = state["trainers"][key]
    model = frozen_model(trainer.cfg, trainer.full_params())
    export_lora_dir(model.llm, trainer.cfg.train.lora, out_dir)
    return {n: open(os.path.join(out_dir, n), "rb").read()
            for n in sorted(os.listdir(out_dir))}


def job_cli(state, argv):
    """The training CLI in this process, over the running world's ranks
    (the stand-in tokenizer, the numpy packing path)."""
    from oryx_tpu_torch.data import native_loader
    from oryx_tpu_torch.serve import builder
    from oryx_tpu_torch.train import cli

    builder.load_tokenizer = lambda path: CharTokenizer()
    native_loader.is_available = lambda: False
    cli.main(argv).close()
