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

The weight-only half (`Q8Weight`, `quantize_array`, `quantize_params`)
serves `serve/builder.load_pipeline(quantize="int8")`, which is not ported.
"""

from __future__ import annotations

import torch

# name -> (storage dtype, symmetric max representable magnitude)
KV_STORAGE_DTYPES: dict[str, tuple[torch.dtype, float]] = {
    "int8": (torch.int8, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
}

_TINY = torch.finfo(torch.float32).tiny


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
    x: torch.Tensor, fmt: str = "int8"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token-row symmetric quantization of KV rows [..., Hk, D].
    Returns (codes [..., Hk, D] in the storage dtype, scale [...] fp32)."""
    xf = x.to(torch.float32)
    _, qmax = kv_storage_dtype(fmt)
    amax = torch.amax(torch.abs(xf), dim=(-2, -1))
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
