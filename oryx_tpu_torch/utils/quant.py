"""Symmetric int8 / fp8-e4m3 quantization of KV rows (port of the KV half of
`oryx_tpu.utils.quant`).

The paged pool's write-side quantizer: one fp32 scale per token row (amax
over the trailing head x dim axes), so a token's codes are a pure function
of its own K/V value and never depend on how writes were grouped, which is
what keeps cold-vs-cached, eviction replay, copy-on-write and host
spill/reload byte-identical on a quantized pool.

The encode order is the JAX package's, step for step, so the codes and
scales are byte-equal to it: fp32 `amax / qmax + finfo(f32).tiny`, then
`x / scale`, then for int8 round half to even and clip, for fp8 clip to
+-448 and cast (round to nearest even).

The weight half serves `serve/builder.load_pipeline(quantize="int8")`:
symmetric per-output-channel int8 weights. The JAX `Q8Weight` stands in for
an array at its use sites; here it is two modules with no `.weight`, so a
use site that forgets them fails loudly:
  * `Q8Linear`: codes `q` int8 [out, in] (the JAX kernel transposed), one
    fp32 `scale` [out] per output channel, and the bias, if any. Its
    product (`linear`) dequantizes in the activations' dtype,
    `q.to(dt) * scale.to(dt)` as JAX's `astype(dt)`; on the card every
    product runs a hand-written kernel (`ops/cuda/q8_linear.py`), which
    reads the codes directly, and the products of one input (q/k/v,
    gate/up: `linear_group`) run as one launch.
  * `Q8Embedding`: codes [V, H] and one fp32 scale row [H]. A row gather
    (`embed_rows`) returns fp32 rows, `q[idx].float() * scale` as JAX's
    `__getitem__`; the caller casts them. The tied head (`linear` on the
    table) dequantizes in the activations' dtype, through the same kernel
    with one scale per column.
The encode order is JAX's step for step (bf16 `amax / 127` rounds to bf16
before fp32 `tiny` promotes it), so codes and scales are byte-equal to
JAX's for fp32 and bf16 leaves. A layer (float or int8) that carries LoRA
adapters (`models/qwen2.add_lora_params`) adds their residual after the
base product and before the bias, as JAX's `_linear`.

On a tensor-parallel rank (parallel/tp.py, parallel/zero.TpGroup) the
adapters stay whole, as JAX's `param_specs` leaves them, while the base
weight holds the rank's cut. A column-parallel layer (q/k/v, gate/up)
adds ((x A) B[:, cols]) * scale, `cols` its weight's output columns; a
row-parallel one (o, down) sums x_r A[rows_r] over the group in the same
all-reduce as its base product, then adds ((sum) B) * scale once. The
gradients this leaves on a training rank: a column layer's A, B and
scale and a row layer's A are partial over the tp group, a row layer's
B and scale whole (parallel/zero.RankTrainer sums the former).
"""

from __future__ import annotations

import copy
import itertools
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from oryx_tpu_torch.ops.cuda import q8_linear
from oryx_tpu_torch.utils import remat

# name -> (storage dtype, symmetric max representable magnitude)
KV_STORAGE_DTYPES: dict[str, tuple[torch.dtype, float]] = {
    "int8": (torch.int8, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
}

_TINY = torch.finfo(torch.float32).tiny
# The LoRA leaves a linear layer may carry (models/qwen2.add_lora_params).
LORA_LEAVES = ("lora_a", "lora_b", "lora_scale")


def kv_storage_dtype(name: str) -> tuple[torch.dtype, float]:
    """(storage dtype, qmax) for a KV quantization format name; raises with
    the known names on a typo."""
    try:
        return KV_STORAGE_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown KV storage dtype {name!r} "
            f"(known: {sorted(KV_STORAGE_DTYPES)})"
        ) from None


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Invert a symmetric code + scale pair: q.to(dtype) * scale.to(dtype)."""
    return q.to(dtype) * scale.to(dtype)


def _encode(x: torch.Tensor, scale: torch.Tensor, fmt: str) -> torch.Tensor:
    """Symmetric encode of fp32 rows: int8 rounds (half to even) and clips,
    fp8 clips and relies on the cast's rounding."""
    dt, qmax = kv_storage_dtype(fmt)
    y = x / scale
    if fmt == "int8":
        return torch.clamp(torch.round(y), -qmax, qmax).to(dt)
    return torch.clamp(y, -qmax, qmax).to(dt)


def quantize_kv_rows(
    x: torch.Tensor, fmt: str = "int8", amax_reduce=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-row symmetric quantization of KV rows [..., Hk, D].
    Returns (codes [..., Hk, D] in the storage dtype, scale [...] fp32).
    amax_reduce: the max over the ranks that hold the row's other heads
    (a tensor-parallel pool keeps one scale per row over all heads)."""
    xf = x.to(torch.float32)
    _, qmax = kv_storage_dtype(fmt)
    amax = torch.amax(torch.abs(xf), dim=(-2, -1))
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    scale = amax / qmax + _TINY
    return _encode(xf, scale[..., None, None], fmt), scale


def dequantize_kv_rows(
    q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Invert `quantize_kv_rows`: codes [..., Hk, D] x scale [...]."""
    return q.to(dtype) * scale[..., None, None].to(dtype)


def roundtrip_error_stats(
    w: torch.Tensor, *, axis: int = -2, fmt: str = "int8"
) -> dict[str, float]:
    """Quantize-dequantize `w` with one scale per slice along `axis` and
    report the reconstruction error: max-abs and rms, absolute and relative
    to the tensor's own absmax."""
    _, qmax = kv_storage_dtype(fmt)
    w = torch.as_tensor(w).to(torch.float32)
    amax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    scale = amax / qmax + _TINY
    err = torch.abs(dequantize(_encode(w, scale, fmt), scale) - w)
    overall = float(torch.abs(w).max())
    max_abs = float(err.max())
    rms = float(torch.sqrt(torch.mean(err * err)))
    return {
        "max_abs_err": max_abs,
        "rms_err": rms,
        "rel_max_abs_err": max_abs / overall if overall else 0.0,
        "rel_rms_err": rms / overall if overall else 0.0,
    }


def page_roundtrip_error(
    pages: torch.Tensor,  # [P, page, Hk, D] one layer's K or V pool
    *, fmt: str = "int8",
) -> dict[str, torch.Tensor]:
    """Per-page symmetric round-trip error of a pool layer in format `fmt`,
    one scale per page: {"max_abs_err": [P], "rms_err": [P], "scale": [P]},
    so the pages quantization would hurt most can be ranked."""
    _, qmax = kv_storage_dtype(fmt)
    x = torch.as_tensor(pages).to(torch.float32)
    flat = x.reshape(x.shape[0], -1)
    scale = torch.amax(torch.abs(flat), dim=1) / qmax + _TINY
    q = _encode(flat, scale[:, None], fmt)
    err = torch.abs(q.to(torch.float32) * scale[:, None] - flat)
    return {
        "max_abs_err": torch.amax(err, dim=1),
        "rms_err": torch.sqrt(torch.mean(err * err, dim=1)),
        "scale": scale,
    }


# ---------------------------------------------------------------------------
# Weight-only int8 (serving)
# ---------------------------------------------------------------------------

# Leaves smaller than this stay in float (biases, norms, pos embeds): no
# bandwidth win, and tiny tensors are precision-sensitive. Stacked decoder
# and encoder leaves count all their layers, as in the JAX tree.
MIN_QUANT_SIZE = 1 << 16


def quantize_array(
    w: torch.Tensor, dim: int = -2
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over `dim` (-2: the input axis of a JAX [.., in, out]
    kernel; -1 for a [out, in] weight), on w's device. Returns (codes int8
    like w, fp32 scale with `dim` kept as 1)."""
    amax = torch.amax(torch.abs(w), dim=dim, keepdim=True)
    # amax / 127 rounds in w's dtype; then fp32 tiny promotes the sum.
    scale = (amax / 127.0).to(torch.float32) + _TINY
    q = torch.clamp(torch.round(w.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def _should_quantize(path: tuple[str, ...], shape: tuple[int, ...]) -> bool:
    """JAX's leaf rule over the JAX tree's path and shape: linear kernels
    and the LLM's embedding table of at least MIN_QUANT_SIZE elements."""
    name = path[-1] if path else ""
    size = 1
    for d in shape:
        size *= d
    if len(shape) < 2 or size < MIN_QUANT_SIZE:
        return False
    if name == "kernel":
        return True
    return name == "weight" and len(path) >= 2 and path[-2] == "embed"


class Q8Linear(nn.Module):
    """A linear layer with int8 codes: y = x . deq(q, scale)^T (+ bias)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor | None = None) -> None:
        super().__init__()
        self.out_features, self.in_features = q.shape
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @classmethod
    def empty(cls, out_features: int, in_features: int, bias: bool,
              bias_dtype: torch.dtype, device="meta") -> "Q8Linear":
        return cls(
            torch.empty(out_features, in_features, dtype=torch.int8,
                        device=device),
            torch.empty(out_features, dtype=torch.float32, device=device),
            torch.empty(out_features, dtype=bias_dtype, device=device)
            if bias else None,
        )

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"bias={self.bias is not None}")


class Q8Embedding(nn.Module):
    """An embedding table with int8 codes [V, H] and one fp32 scale per
    column [H]."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        super().__init__()
        self.num_embeddings, self.embedding_dim = q.shape
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @classmethod
    def empty(cls, num: int, dim: int, device="meta") -> "Q8Embedding":
        return cls(torch.empty(num, dim, dtype=torch.int8, device=device),
                   torch.empty(dim, dtype=torch.float32, device=device))

    def dequantize(self, dtype: torch.dtype) -> torch.Tensor:
        return self.q.to(dtype) * self.scale.to(dtype)

    def extra_repr(self) -> str:
        return f"{self.num_embeddings}, {self.embedding_dim}"


def q8_shells(model: nn.Module, state) -> nn.Module:
    """Swap, in place, each linear layer or embedding of `model` (on the
    meta device) that `state` ({name: tensor}) holds as `<name>.q` codes
    for an empty Q8Linear / Q8Embedding of the same shape, so that the
    state then loads into it."""
    for key in [k for k in state if k.endswith(".q")]:
        name = key[: -len(".q")]
        parent, _, child = name.rpartition(".")
        owner = model.get_submodule(parent)
        mod = getattr(owner, child)
        if isinstance(mod, nn.Linear):
            bias = state.get(f"{name}.bias")
            shell = Q8Linear.empty(
                mod.out_features, mod.in_features, bias is not None,
                mod.weight.dtype if bias is None else bias.dtype)
        elif isinstance(mod, nn.Embedding):
            shell = Q8Embedding.empty(*mod.weight.shape)
        else:
            raise ValueError(f"{key}: {type(mod).__name__} takes no codes")
        setattr(owner, child, shell)
    return model


def _leaf(mod: nn.Module, name: str):
    """A module's tensor `name` (a parameter, or the compute-dtype copy
    `train.step.compute_params` puts in its place), or None; dict lookups
    only, no attribute search (host time every product)."""
    t = mod.__dict__.get(name)
    return mod._parameters.get(name) if t is None else t


def lora_of(mod: nn.Module):
    """(lora_a [in, r], lora_b [r, out], lora_scale [1, 1]) of a layer that
    carries LoRA adapters (`models/qwen2.add_lora_params`), else None."""
    a = _leaf(mod, "lora_a")
    if a is None:
        return None
    return a, _leaf(mod, "lora_b"), _leaf(mod, "lora_scale")


def _lora_residual(x: torch.Tensor, y: torch.Tensor, lora,
                   bias: torch.Tensor | None, tp=None) -> torch.Tensor:
    """JAX `_linear`'s order after the base product y = x . W: the low-rank
    residual ((x A) B) * scale, then the bias, each in x's dtype. tp: the
    group of a column-parallel rank, whose y holds its cut of the output
    columns: the residual takes the same columns of B."""
    a, b, s = lora
    dt = x.dtype
    if tp is not None and tp.size > 1:
        n = y.shape[-1]
        b = b.narrow(1, tp.index * n, n)
    y = y + torch.matmul(torch.matmul(x, a.to(dt)), b.to(dt)) * s.to(dt)
    return y if bias is None else y + bias.to(dt)


def _base(x: torch.Tensor, mod: nn.Module, with_bias: bool) -> torch.Tensor:
    if isinstance(mod, Q8Linear):
        b = mod._buffers  # not attribute lookups: host time every step
        return q8_linear.q8_linear(x, b["q"], b["scale"],
                                   b["bias"] if with_bias else None)
    if isinstance(mod, Q8Embedding):  # the tied head: a scale per column
        b = mod._buffers
        return q8_linear.q8_linear(x, b["q"], b["scale"], column_scale=True)
    bias = getattr(mod, "bias", None) if with_bias else None
    return F.linear(x, mod.weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def _bias(mod: nn.Module):
    if isinstance(mod, (Q8Linear, Q8Embedding)):
        return mod._buffers.get("bias")
    return getattr(mod, "bias", None)


def linear(x: torch.Tensor, mod: nn.Module,
           name: str | None = None, tp=None) -> torch.Tensor:
    """x . W^T (+ b) in x's dtype, for every weight a model multiplies by:
    an nn.Linear, a Q8Linear, or an embedding table (the tied head). A
    layer with LoRA adapters adds ((x A) B) * scale after the base product
    and before the bias, as JAX's `_linear`. `name`: under a remat policy
    that saves it (utils/remat.py), the base product is computed as that
    name's. tp: the group of a column-parallel rank (its weight holds its
    output columns; the residual takes the same columns of B)."""
    lora = lora_of(mod)
    if name is not None and remat.naming():
        with remat.named(name):
            y = _base(x, mod, lora is None)
    else:
        y = _base(x, mod, lora is None)
    return y if lora is None else _lora_residual(x, y, lora, _bias(mod), tp)


def row_linear(x: torch.Tensor, mod: nn.Module, tp,
               name: str | None = None) -> torch.Tensor:
    """`linear` of a product whose input rows are split over
    tensor-parallel ranks (parallel/tp.py): each rank's partial product,
    summed over the ranks, then the bias once. With LoRA adapters the
    rank's x_r A[rows_r] joins its partial product in the one sum, and
    ((x A) B) * scale is added after it, before the bias. tp None:
    `linear`."""
    if tp is None or tp.size == 1:
        return linear(x, mod, name)
    y = _base(x, mod, False)
    lora = lora_of(mod)
    if lora is None:
        y = tp.all_reduce(y)
    else:
        a, b, s = lora
        dt = x.dtype
        n = x.shape[-1]
        xa = torch.matmul(x, a.narrow(0, tp.index * n, n).to(dt))
        y, xa = tp.all_reduce(torch.cat([y, xa], -1)).split(
            [y.shape[-1], xa.shape[-1]], -1)
        y = y + torch.matmul(xa, b.to(dt)) * s.to(dt)
    bias = _bias(mod)
    return y if bias is None else y + bias.to(y.dtype)


def column_input(x: torch.Tensor, tp) -> torch.Tensor:
    """The input of a product whose output columns are split over
    tensor-parallel ranks: x itself in the forward; in a training rank's
    backward its gradient summed over the tp group
    (parallel/zero.TpGroup.enter). Serving (a World, no backward) and
    tp None: x."""
    enter = getattr(tp, "enter", None)
    return x if enter is None or tp.size == 1 else enter(x)


def linear_group(x: torch.Tensor, mods, names=None,
                 tp=None) -> list[torch.Tensor]:
    """[linear(x, m, name, tp) for m, name in zip(mods, names)]: Q8Linears
    of one input width take one grouped q8 product (one launch on the
    card, each output with the bits of its own product; a member's LoRA
    residual and bias are added after it); other layers take `linear` one
    by one. tp: as `linear`'s (the members are column-parallel)."""
    names = names or (None,) * len(mods)
    if len(mods) > 1 and all(isinstance(m, Q8Linear) for m in mods) and len(
            {m.in_features for m in mods}) == 1:
        loras = [lora_of(m) for m in mods]
        ys = q8_linear.q8_linear_group(x, [
            (m._buffers["q"], m._buffers["scale"],
             m._buffers["bias"] if lora is None else None)
            for m, lora in zip(mods, loras)])
        return [y if lora is None else
                _lora_residual(x, y, lora, m._buffers["bias"], tp)
                for y, m, lora in zip(ys, mods, loras)]
    return [linear(x, m, n, tp) for m, n in zip(mods, names)]


def embed_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """Rows `ids` of an embedding table: an nn.Embedding's in its dtype, a
    Q8Embedding's in fp32 (the scale's dtype; the caller casts), or a plain
    tensor's."""
    if isinstance(table, Q8Embedding):
        return table.q[ids].to(torch.float32) * table.scale
    if isinstance(table, nn.Embedding):
        return table.weight[ids]
    return table[ids]


@torch.no_grad()
def quantize_params(
    model: nn.Module,
    cast: Callable[[torch.Tensor], torch.Tensor] | None = None,
    device=None,
) -> nn.Module:
    """A copy of `model` whose large linear weights and LLM embedding table
    are Q8Linear / Q8Embedding (JAX's `_should_quantize` on the JAX tree's
    paths and layer-stacked shapes); every other leaf passes through `cast`
    (identity by default: the copy then shares those tensors with `model`).
    A weight is moved to `device` (default: where it lies) in its own dtype
    before it is quantized, one leaf at a time, so a model held on the host
    (a memory-mapped checkpoint) quantizes onto the card without its full
    float tree ever landing there. Modules already quantized pass through,
    their codes and scales moved to `device`."""
    return _walk(model, cast or (lambda t: t), device, True, (), ())


@torch.no_grad()
def cast_params(model: nn.Module,
                cast: Callable[[torch.Tensor], torch.Tensor],
                device=None) -> nn.Module:
    """A copy of `model` with every parameter and buffer passed through
    `cast`; quantized modules keep their codes and fp32 scales (moved to
    `device`), their biases cast."""
    return _walk(model, cast, device, False, (), ())


# The attributes nn.Module itself keeps. A copy keeps these and the public
# ones (widths, eps); other private attributes are state derived from the
# weights (the decode graphs kept on a model), which a copy must not share.
_MODULE_STATE = frozenset(nn.Module().__dict__)


def _copy(mod: nn.Module) -> nn.Module:
    out = copy.copy(mod)
    for k in [k for k in out.__dict__
              if k.startswith("_") and k not in _MODULE_STATE]:
        del out.__dict__[k]
    out._non_persistent_buffers_set = set(mod._non_persistent_buffers_set)
    return out


def _cast_parameters(mod: nn.Module, cast) -> dict:
    out = {}
    for k, p in mod._parameters.items():
        t = None if p is None else cast(p)
        if t is not None and not isinstance(t, nn.Parameter):
            t = nn.Parameter(t, requires_grad=False)
        out[k] = t
    return out


def _walk(mod: nn.Module, cast, device, quantize: bool,
          path: tuple[str, ...], lead: tuple[int, ...]) -> nn.Module:
    def move(t):
        return t if device is None else t.to(device)

    if isinstance(mod, (Q8Linear, Q8Embedding)):
        out = _copy(mod)
        out._buffers = {
            k: None if t is None else (cast(t) if k == "bias" else move(t))
            for k, t in mod._buffers.items()
        }
        out._parameters = _cast_parameters(mod, cast)
        return out
    if quantize and isinstance(mod, nn.Linear) and _should_quantize(
        path + ("kernel",), lead + (mod.in_features, mod.out_features)
    ):
        q, scale = quantize_array(move(mod.weight.detach()), dim=-1)
        bias = None if mod.bias is None else cast(mod.bias.detach())
        out = Q8Linear(q, scale[:, 0], bias)
        # LoRA adapters are not kernels (JAX's rule): they pass through.
        for k, p in _cast_parameters(mod, cast).items():
            if k in LORA_LEAVES:
                out.register_parameter(k, p)
        return out
    if quantize and isinstance(mod, nn.Embedding) and _should_quantize(
        path + ("weight",), lead + tuple(mod.weight.shape)
    ):
        q, scale = quantize_array(move(mod.weight.detach()), dim=-2)
        return Q8Embedding(q, scale[0])
    out = _copy(mod)
    out._parameters = _cast_parameters(mod, cast)
    out._buffers = {k: None if t is None else cast(t)
                    for k, t in mod._buffers.items()}
    stacked = isinstance(mod, nn.ModuleList)
    out._modules = {
        k: None if c is None else _walk(
            c, cast, device, quantize,
            path if stacked else path + (k,),
            lead + (len(mod),) if stacked else lead,
        )
        for k, c in mod._modules.items()
    }
    return out


def quantized_bytes(model: nn.Module) -> int:
    """Total serving bytes of a (possibly quantized) model: every parameter
    and buffer, each counted once."""
    seen: set[int] = set()
    total = 0
    for t in itertools.chain(model.parameters(), model.buffers()):
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total
