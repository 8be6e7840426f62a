"""Shared inputs of the port's serving tests (tests/test_torch_engine.py,
test_torch_request_log.py, test_torch_api_server.py): the tiny config's
JAX init made input-sensitive, the JAX `OryxInference` on it and the port's
`Pipeline` on the same weights (`from_jax_params`, fp32, the CPU), a
character tokenizer, PNG data URIs and an HTTP client."""

import base64
import io
import json
import re
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np

import jax
import jax.numpy as jnp

from oryx_tpu import config as jcfg
from oryx_tpu.models import oryx as joryx
from oryx_tpu.serve.pipeline import OryxInference
from oryx_tpu_torch import config as tcfg
from oryx_tpu_torch.models.convert import from_jax_params
from oryx_tpu_torch.serve.pipeline import Pipeline


class CharTokenizer:
    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


def _scaled(tree):
    """x20 on kernels/tables so greedy replies depend on the inputs."""
    def f(leaf):
        a = np.asarray(leaf, np.float32)
        return a if a.ndim < 2 else a * 20
    return jax.tree_util.tree_map(f, tree)


def make_pipes():
    """(JAX OryxInference, port Pipeline on the CPU) on the same weights."""
    cfg = jcfg.oryx_tiny()
    tree = _scaled(joryx.init_params(cfg, jax.random.key(0)))
    jp = OryxInference(
        CharTokenizer(), jax.tree_util.tree_map(jnp.asarray, tree), cfg
    )
    tc = tcfg.OryxConfig.from_dict(cfg.to_dict())
    tp = Pipeline(CharTokenizer(), from_jax_params(tree, tc), tc,
                  device="cpu")
    return jp, tp


def png_uri(img: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def bomb_png(width: int = 20000, height: int = 20000,
             inflated: int = 1 << 20) -> bytes:
    """An RGB PNG whose header declares width x height pixels (by default
    above PIL's decompression-bomb limit) over an IDAT of `inflated` zero
    bytes, a few kilobytes compressed."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(inflated), 9))
            + chunk(b"IEND", b""))


def image(seed: int, h: int = 40, w: int = 56) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 255, size=(h, w, 3), dtype=np.uint8)


class Server:
    """A built server on an ephemeral port, served from a thread."""

    def __init__(self, srv):
        self.srv = srv
        self.base = f"http://127.0.0.1:{srv.server_address[1]}"
        self._thread = threading.Thread(target=srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def post(self, body, headers=None, timeout=600):
        """(status, headers, parsed JSON or SSE chunk list)."""
        req = urllib.request.Request(
            self.base + "/v1/chat/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})},
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, dict(r.headers), _body(r)
        except urllib.error.HTTPError as e:
            with e:
                return e.code, dict(e.headers), json.loads(e.read())

    def get(self, path, timeout=60):
        try:
            with urllib.request.urlopen(self.base + path,
                                        timeout=timeout) as r:
                return r.status, dict(r.headers), r.read().decode()
        except urllib.error.HTTPError as e:
            with e:
                return e.code, dict(e.headers), e.read().decode()

    def quiesce(self, timeout=120):
        """Wait until the engine has booked every dispatch it counted: a
        timeline record (and, with a journal, a step entry) for each of
        `dispatches_total`, and no audit replay pending. A reply is
        released inside the harvest, before the step's records, so a read
        or the next submit right after it can race them; tests call this
        on both servers before either."""
        sched = self.srv.scheduler
        if sched is None:
            return
        deadline = time.monotonic() + timeout
        while True:
            counted = sum(float(v) for v in re.findall(
                r"^oryx_serving_dispatches_total\{[^}]*\} (\S+)$",
                sched.metrics.render(), re.M))
            booked = [sched.timeline.total_steps]
            if sched.journal is not None:
                booked.append(sched.journal.to_dict(0)["counts_by_kind"]
                              .get("step", 0))
            if all(b == counted for b in booked) and \
                    not sched.auditor.pending():
                return
            assert time.monotonic() < deadline, (counted, booked)
            time.sleep(0.01)

    def close(self):
        if self.srv.scheduler is not None:
            self.srv.scheduler.close()
        if self.srv.supervisor is not None:
            self.srv.supervisor.stop()
        self.srv.shutdown()
        self.srv.server_close()


def _body(r):
    raw = r.read().decode()
    if r.headers.get("Content-Type") == "text/event-stream":
        return [
            line[len("data: "):] if line != "data: [DONE]" else "[DONE]"
            for line in raw.split("\n\n") if line
        ]
    return json.loads(raw)


def sse_chunks(events):
    """The SSE events parsed, the `created` stamps and ids dropped."""
    out = []
    for e in events:
        if e == "[DONE]":
            out.append(e)
            continue
        d = json.loads(e)
        d.pop("created", None)
        d.pop("id", None)
        if "oryx" in d:
            d["oryx"] = {"cost": sorted(d["oryx"]["cost"])}
        out.append(d)
    return out
