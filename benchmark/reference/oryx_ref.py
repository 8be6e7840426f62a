"""Plain PyTorch reference of Oryx: OryxViT, the Dynamic Compressor, the
splice and the Qwen2/Yi decoder, written from the published description
(arXiv 2409.12961; the Qwen2 / Llama decoder as in Hugging Face's
`Qwen2Model`), in float32 with TF32 off, one request at a time and with no
cache, batching or kernel.

It imports nothing of the program: the host steps it shares with the
serving path (the chat template, the byte tokens, the resize to the patch
grid, the patch order) are its own copies. Weights are the dict of tensors
the benchmark made (`harness/weights.py`), read by the program's leaf
names; each layer's leaves are cast to float32 as the layer runs.

`prec="fp8"` is the control: every matmul weight rounded to fp8 (e4m3)
with one scale a row (output channel), activations in bfloat16;
`prec="int8"` rounds them to int8 instead (read beside it, for the
record)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_TOKEN = -200
SYSTEM = "You are a helpful assistant."
IMAGE_MEAN = IMAGE_STD = 0.5
Q_CHUNK = 1024


def set_fp32_exact() -> None:
    """float32 matmuls and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---- host side: prompt and pixels -----------------------------------------

def prompt_ids(question: str, n_media: int, n_frames: int = 0) -> list[int]:
    """ChatML prompt ("qwen" template) with one image sentinel a medium
    (a video's one placeholder expanded to one a frame), as UTF-8 byte
    ids."""
    text = (f"<|im_start|>system\n{SYSTEM}<|im_end|>\n<|im_start|>user\n"
            + "<image>\n" * n_media + question
            + "<|im_end|>\n<|im_start|>assistant\n")
    ids: list[int] = []
    for i, chunk in enumerate(text.split("<image>")):
        if i > 0:
            ids += [IMAGE_TOKEN] * (n_frames if n_frames else 1)
        ids += list(chunk.encode("utf-8"))
    return ids


def patch_grid(hw, patch: int, cap: int) -> tuple[int, int]:
    """Native aspect, sides snapped to patch multiples, at most `cap`
    patches (downscale only): the output grid in patches."""
    h, w = hw
    ph, pw = max(1, round(h / patch)), max(1, round(w / patch))
    if ph * pw > cap:
        scale = math.sqrt(cap / (ph * pw))
        ph, pw = max(1, int(ph * scale)), max(1, int(pw * scale))
        while ph * pw > cap:
            if ph >= pw:
                ph -= 1
            else:
                pw -= 1
    return ph, pw


def resize(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Bilinear, half-pixel centres, edge-clamped (align_corners=False)."""
    h, w, _ = img.shape
    sy = (np.arange(H, dtype=np.float32) + 0.5) * (h / H) - 0.5
    sx = (np.arange(W, dtype=np.float32) + 0.5) * (w / W) - 0.5
    y0f, x0f = np.floor(sy), np.floor(sx)
    y0 = np.clip(y0f.astype(np.int64), 0, h - 1)
    y1 = np.clip(y0f.astype(np.int64) + 1, 0, h - 1)
    x0 = np.clip(x0f.astype(np.int64), 0, w - 1)
    x1 = np.clip(x0f.astype(np.int64) + 1, 0, w - 1)
    ly = (sy - y0f)[:, None, None]
    lx = (sx - x0f)[None, :, None]
    top = img[y0][:, x0] * (1 - lx) + img[y0][:, x1] * lx
    bot = img[y1][:, x0] * (1 - lx) + img[y1][:, x1] * lx
    return (top * (1 - ly) + bot * ly).astype(np.float32)


def pixels(img: np.ndarray, patch: int, cap: int):
    """uint8 [H, W, 3] -> (patch rows [h*w, patch*patch*3] float32, (h, w)):
    resized, scaled to [-1, 1], rows in (py, px, c) order."""
    x = np.asarray(img).astype(np.float32) / 255.0
    ph, pw = patch_grid(x.shape[:2], patch, cap)
    if (ph * patch, pw * patch) != x.shape[:2]:
        x = resize(x, ph * patch, pw * patch)
    x = (x - IMAGE_MEAN) / IMAGE_STD
    x = x.reshape(ph, patch, pw, patch, 3).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(x.reshape(ph * pw, -1)), (ph, pw)


# ---- weights ----------------------------------------------------------------

class Weights:
    """Leaves by name, as float32 (or, for a control, the values of fp8 or
    int8 codes times a row scale)."""

    def __init__(self, tensors: dict, prec: str = "fp32") -> None:
        if prec not in ("fp32", "int8", "fp8"):
            raise ValueError(prec)
        self.t, self.prec = tensors, prec
        self.act = torch.float32 if prec == "fp32" else torch.bfloat16

    def __call__(self, name: str) -> torch.Tensor:
        w = self.t[name].float()
        if self.prec != "fp32" and w.dim() == 2 and not name.endswith(
                ("embed.weight", "pos_embed.weight")):
            amax = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
            if self.prec == "int8":
                scale = amax / 127
                q = torch.round(w / scale).clamp(-127, 127) * scale
            else:  # fp8 e4m3, one scale a row mapping its amax to 448
                scale = amax / 448
                q = (w / scale).to(torch.float8_e4m3fn).float() * scale
            # Straight through: the training control's gradient reaches w.
            w = w + (q - w).detach()
        return w

    def opt(self, name: str):
        return self(name) if name in self.t else None

    def linear(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        w, b = self(prefix + ".weight"), self.opt(prefix + ".bias")
        y = F.linear(x.to(self.act), w.to(self.act))
        y = y.float()
        return y if b is None else y + b


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def attend(q, k, v, causal: bool, act) -> torch.Tensor:
    """q [T, Hq, D], k/v [S, Hk, D] -> [T, Hq, D], softmax in float32,
    query rows in chunks."""
    T, Hq, D = q.shape
    rep = Hq // k.shape[1]
    k = k.repeat_interleave(rep, 1).transpose(0, 1).to(act)
    v = v.repeat_interleave(rep, 1).transpose(0, 1).to(act)
    qh = q.transpose(0, 1).to(act)
    out = []
    for lo in range(0, T, Q_CHUNK):
        s = torch.matmul(qh[:, lo:lo + Q_CHUNK], k.transpose(1, 2)).float()
        s = s * D ** -0.5
        if causal:
            rows = torch.arange(lo, min(T, lo + Q_CHUNK), device=q.device)
            cols = torch.arange(k.shape[1], device=q.device)
            s = s.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        p = torch.softmax(s, -1)
        out.append(torch.matmul(p.to(act), v).float())
    return torch.cat(out, 1).transpose(0, 1)


# ---- vision tower and compressor --------------------------------------------

def posemb(table: torch.Tensor, h: int, w: int, grid: int) -> torch.Tensor:
    """The learned grid x grid table resampled bilinearly at an h x w
    grid's patch centres (half-pixel, edge-clamped)."""
    t = table.view(grid, grid, -1)
    dev = table.device
    ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) \
        * (grid / h) - 0.5
    xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) \
        * (grid / w) - 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    sy, sx = yy.reshape(-1), xx.reshape(-1)
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    ly, lx = (sy - y0f)[:, None], (sx - x0f)[:, None]
    y0 = y0f.long().clamp(0, grid - 1)
    y1 = (y0f.long() + 1).clamp(0, grid - 1)
    x0 = x0f.long().clamp(0, grid - 1)
    x1 = (x0f.long() + 1).clamp(0, grid - 1)
    return (t[y0, x0] * (1 - ly) * (1 - lx) + t[y0, x1] * (1 - ly) * lx
            + t[y1, x0] * ly * (1 - lx) + t[y1, x1] * ly * lx)


def vit_layer(W: Weights, v: dict, x: torch.Tensor, i: int) -> torch.Tensor:
    """One pre-LN block: MHA within the image, then the GELU MLP."""
    eps, hd, p = v["layer_norm_eps"], v["head_dim"], f"vit.layers.{i}"
    y = layer_norm(x, W(p + ".norm1.weight"), W(p + ".norm1.bias"), eps)
    q, k, val = (W.linear(y, f"{p}.{n}").view(len(x), -1, hd)
                 for n in ("q_proj", "k_proj", "v_proj"))
    o = attend(q, k, val, False, W.act).reshape(len(x), -1)
    x = x + W.linear(o, p + ".o_proj")
    y = layer_norm(x, W(p + ".norm2.weight"), W(p + ".norm2.bias"), eps)
    y = F.gelu(W.linear(y, p + ".fc1"), approximate="tanh")
    return x + W.linear(y, p + ".fc2")


def vit(W: Weights, v: dict, rows: torch.Tensor, h: int, w: int,
        layer=vit_layer) -> torch.Tensor:
    """One image's patch rows [h*w, p*p*3] -> features [h*w, Hv]. `layer`
    runs each block (the training reference checkpoints it)."""
    x = F.linear(rows, W("vit.patch_embed.weight"),
                 W("vit.patch_embed.bias"))
    x = x + posemb(W("vit.pos_embed.weight"), h, w, v["base_grid"])
    for i in range(v["num_layers"]):
        x = layer(W, v, x, i)
    return layer_norm(x, W("vit.post_norm.weight"), W("vit.post_norm.bias"),
                      v["layer_norm_eps"])


def compress(W: Weights, v: dict, c: dict, feats: torch.Tensor, h: int,
             w: int, s: int) -> torch.Tensor:
    """Dynamic Compressor of one image's [h*w, Hv] features at side factor
    s: each s x s region's mean is a query that cross-attends to the
    region's features; residual, then the two-layer GELU projector.
    Returns [ceil(h/s) * ceil(w/s), H_llm], queries row-major."""
    hq, wq = math.ceil(h / s), math.ceil(w / s)
    dev = feats.device
    region = ((torch.arange(h, device=dev)[:, None] // s) * wq
              + torch.arange(w, device=dev)[None, :] // s).reshape(-1)
    nq = hq * wq
    sums = torch.zeros((nq, feats.shape[1]), device=dev).index_add_(
        0, region, feats)
    counts = torch.zeros(nq, device=dev).index_add_(
        0, region, torch.ones(len(region), device=dev))
    pooled = sums / counts[:, None]
    eps = 1e-6
    qn = layer_norm(pooled, W("compressor.norm_q.weight"),
                    W("compressor.norm_q.bias"), eps)
    kn = layer_norm(feats, W("compressor.norm_kv.weight"),
                    W("compressor.norm_kv.bias"), eps)
    heads = c["num_heads"]
    hd = feats.shape[1] // heads
    q = W.linear(qn, "compressor.q_proj").view(nq, heads, hd)
    k = W.linear(kn, "compressor.k_proj").view(len(feats), heads, hd)
    val = W.linear(kn, "compressor.v_proj").view(len(feats), heads, hd)
    # Each query sees exactly its region's keys.
    s_ = torch.einsum("qhd,khd->hqk", q.to(W.act), k.to(W.act)).float()
    s_ = s_ * hd ** -0.5
    mask = region[None, :] != torch.arange(nq, device=dev)[:, None]
    p = torch.softmax(s_.masked_fill(mask[None], float("-inf")), -1)
    o = torch.einsum("hqk,khd->qhd", p.to(W.act), val.to(W.act)).float()
    x = pooled + W.linear(o.reshape(nq, -1), "compressor.o_proj")
    x = F.gelu(W.linear(x, "compressor.projector.fc1"), approximate="tanh")
    return W.linear(x, "compressor.projector.fc2")


SIDE_FACTOR = {"image": 1, "multi_image": 2, "video": 4}


def visual_tokens(W: Weights, cfg: dict, images, kind: str,
                  layer=vit_layer) -> list:
    """Per image (frame) its [Q_i, H_llm] visual tokens, in order."""
    v, c = cfg["vision"], cfg["compressor"]
    cap = v["max_patches_per_image"]
    if kind == "video":
        cap = max(1, cap // len(images))
    s = SIDE_FACTOR[kind]
    dev = W.t["vit.patch_embed.weight"].device
    out = []
    for img in images:
        rows, (h, w) = pixels(img, v["patch_size"], cap)
        feats = vit(W, v, torch.from_numpy(rows).to(dev), h, w, layer)
        out.append(compress(W, v, c, feats, h, w, s))
    return out


# ---- decoder ----------------------------------------------------------------

def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-rotation RoPE of x [T, H, D] at integer positions [T]."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = pos.float()[:, None] * inv[None]
    cos = torch.cat([ang, ang], -1).cos()[:, None]
    sin = torch.cat([ang, ang], -1).sin()[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def embed_sequence(W: Weights, ids: list[int], visual: list) -> torch.Tensor:
    """Token embeddings with each image sentinel replaced, in order, by the
    next image's visual tokens: [T, H] float32."""
    table = W.t["llm.embed.weight"]
    parts, run, vis = [], [], iter(visual)
    dev = table.device
    for t in ids:
        if t == IMAGE_TOKEN:
            if run:
                parts.append(table[torch.tensor(run, device=dev)].float())
                run = []
            parts.append(next(vis).float())
        else:
            run.append(t)
    if run:
        parts.append(table[torch.tensor(run, device=dev)].float())
    return torch.cat(parts, 0)


def decoder_layer(W: Weights, llm: dict, x: torch.Tensor,
                  pos: torch.Tensor, i: int) -> torch.Tensor:
    """One pre-RMSNorm block: causal GQA attention with RoPE, then the
    SwiGLU MLP."""
    hd, eps, p = llm["head_dim"], llm["rms_norm_eps"], f"llm.layers.{i}"
    y = rms_norm(x, W(p + ".input_norm.weight"), eps)
    q = W.linear(y, p + ".q_proj").view(len(x), -1, hd)
    k = W.linear(y, p + ".k_proj").view(len(x), -1, hd)
    v = W.linear(y, p + ".v_proj").view(len(x), -1, hd)
    q, k = rope(q, pos, llm["rope_theta"]), rope(k, pos, llm["rope_theta"])
    o = attend(q, k, v, True, W.act).reshape(len(x), -1)
    x = x + W.linear(o, p + ".o_proj")
    y = rms_norm(x, W(p + ".post_attn_norm.weight"), eps)
    g = W.linear(y, p + ".gate_proj")
    u = W.linear(y, p + ".up_proj")
    return x + W.linear(F.silu(g) * u, p + ".down_proj")


def head_logits(W: Weights, llm: dict, x: torch.Tensor) -> torch.Tensor:
    y = rms_norm(x, W("llm.final_norm.weight"), llm["rms_norm_eps"])
    head = "llm.embed" if llm.get("tie_word_embeddings") else "llm.lm_head"
    return W.linear(y, head)


def decoder_logits(W: Weights, llm: dict, seqs: list[torch.Tensor],
                   rows: list[torch.Tensor]) -> list[torch.Tensor]:
    """Causal decoder over each sequence of embeddings [T_i, H] (positions
    0..T_i-1); returns the float32 logits [len(rows_i), V] at the
    positions `rows_i`. Layer by layer over all sequences."""
    hs = [s.float() for s in seqs]
    pos = [torch.arange(len(s), device=s.device) for s in seqs]
    for i in range(llm["num_layers"]):
        hs = [decoder_layer(W, llm, x, p, i) for x, p in zip(hs, pos)]
    return [head_logits(W, llm, x[r]) for x, r in zip(hs, rows)]
