"""Flash-attention forward: the hand-written Hopper kernel and its plain twin.

Port of the Pallas TPU kernel `oryx_tpu.ops.pallas.flash_attention`
(forward only). The CUDA source is `oryx_tpu_torch/csrc/flash_attention.cu`;
see its header for what bounds it and how it is laid out.

`flash_attention` has the JAX wrapper's signature and masking model. Its
layout step (`_prepare`: [B, T, H, D] -> [B, H, T, D] views, the int32
[B, T] position/segment/validity arrays) is shared by both devices; only
the innermost call differs:
  * CUDA tensors -> `_mha_forward`, which launches the kernel (bf16 or
    fp32) or raises;
  * CPU tensors  -> `_mha_forward_reference`, a plain PyTorch function with
    the kernel's argument list and arithmetic.

Rows past the sequence ends need no padding in memory: the kernel treats kv
rows past Tk as invalid (the Pallas pad convention: kv segment -2, invalid)
and never stores q rows past Tq.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from oryx_tpu_torch.ops.cuda import build

NEG = -0.7 * torch.finfo(torch.float32).max

# Kernel launches, keyed by call shape (causal, has_segments, B, Hq, Hk, Tq,
# Tk, D). Only `_mha_forward` adds to it, once per launch.
LAUNCHES: collections.Counter = collections.Counter()

_ENTRY = {
    torch.bfloat16: "oryx_flash_fwd_bf16",
    torch.float32: "oryx_flash_fwd_f32",
}
_fns: dict[torch.dtype, object] = {}


def _kernel_fn(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(build.load("flash_attention"), _ENTRY[dtype])
        fn.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int] * 6
            + [ctypes.c_float]
            + [ctypes.c_int] * 4
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check_ints(name: str, x: torch.Tensor, B: int, T: int, device) -> None:
    if (
        x.dtype != torch.int32 or tuple(x.shape) != (B, T)
        or not x.is_contiguous() or x.device != device
    ):
        raise ValueError(
            f"{name}: need contiguous int32 [{B}, {T}] on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )


def _mha_forward(
    q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid,
    *,
    causal: bool,
    has_segments: bool,
    kv_arange: bool,
    scale: float,
) -> torch.Tensor:
    """Launch the kernel. q [B, Hq, Tq, D]; k/v [B, Hk, Tk, D] (any strides
    with a contiguous feature dim); int arrays contiguous int32 [B, T*].
    Returns o [B, Hq, Tq, D] in q's dtype (a view of a [B, Tq, Hq, D]
    buffer). Raises on anything the kernel does not take."""
    B, Hq, Tq, D = q.shape
    _, Hk, Tk, _ = k.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"_mha_forward needs CUDA tensors, got {dev}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need all bf16 or "
            "all fp32"
        )
    if (
        tuple(k.shape) != (B, Hk, Tk, D) or tuple(v.shape) != (B, Hk, Tk, D)
        or Hq % Hk or D > 128
    ):
        raise ValueError(
            f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)}: need Hq % Hk == 0 and D <= 128"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, q on {dev}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: feature dim must be contiguous")
    _check_ints("q_pos", q_pos, B, Tq, dev)
    _check_ints("q_seg", q_seg, B, Tq, dev)
    for name, x in (("kv_pos", kv_pos), ("kv_seg", kv_seg),
                    ("kv_valid", kv_valid)):
        _check_ints(name, x, B, Tk, dev)

    o = torch.empty((B, Tq, Hq, D), dtype=q.dtype, device=dev).transpose(1, 2)
    views = (q, k, v, o)
    strides = [s for x in views for s in x.stride()[:3]]
    # 16-byte vector loads need 16-byte aligned rows.
    per16 = 16 // q.element_size()
    vec = int(
        D % per16 == 0
        and all(s % per16 == 0 for s in strides)
        and all(x.data_ptr() % 16 == 0 for x in views)
    )
    stride_arr = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            ctypes.addressof(stride_arr),
            q_pos.data_ptr(), kv_pos.data_ptr(), q_seg.data_ptr(),
            kv_seg.data_ptr(), kv_valid.data_ptr(),
            B, Hq, Hk, Tq, Tk, D, float(scale),
            int(causal), int(has_segments), int(kv_arange), vec, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} "
            f"(q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)})"
        )
    LAUNCHES[(causal, has_segments, B, Hq, Hk, Tq, Tk, D)] += 1
    return o


def _mha_forward_reference(
    q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid,
    *,
    causal: bool,
    has_segments: bool,
    kv_arange: bool,
    scale: float,
) -> torch.Tensor:
    """Plain PyTorch twin of `_mha_forward` (same arguments, same result):
    fp32 logits from the input operands, masked entries set to NEG,
    unnormalized p = exp(s - rowmax) rounded to v's dtype for p.V with an
    fp32 sum, then divided by l (1 where l == 0). Rows are processed one
    (batch, kv head) group at a time to bound memory. `kv_arange` only
    selects tile skipping in the kernel, which changes no valid row."""
    del kv_arange
    B, Hq, Tq, D = q.shape
    _, Hk, Tk, _ = k.shape
    G = Hq // Hk
    out = torch.empty((B, Hq, Tq, D), dtype=q.dtype, device=q.device)
    for b in range(B):
        mask = kv_valid[b][None, :] > 0  # [1, Tk]
        if causal:
            mask = mask & (q_pos[b][:, None] >= kv_pos[b][None, :])
        if has_segments:
            mask = mask & (q_seg[b][:, None] == kv_seg[b][None, :])
        for hk in range(Hk):
            qh = q[b, hk * G : (hk + 1) * G].float()  # [G, Tq, D]
            kh = k[b, hk].float()  # [Tk, D]
            s = torch.matmul(qh, kh.T) * scale  # [G, Tq, Tk]
            s = torch.where(mask, s, NEG)
            p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
            l = torch.sum(p, dim=-1, keepdim=True)
            acc = torch.matmul(p.to(v.dtype).float(), v[b, hk].float())
            out[b, hk * G : (hk + 1) * G] = (
                acc / torch.where(l == 0.0, 1.0, l)
            ).to(q.dtype)
    return out


def _prepare(q, k, v, q_positions, kv_positions, q_segment_ids,
             kv_segment_ids, kv_mask, causal, scale, slot_positions=False):
    """Kernel layouts for both devices: [B, H, T, D] views of q/k/v and
    contiguous int32 [B, T] arrays, plus the static flags."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hk, _ = k.shape
    dev = q.device

    def ints(x, T, default):
        if x is None:
            return default(T)
        return x.to(device=dev, dtype=torch.int32).expand(B, T).contiguous()

    def arange(T):
        return torch.arange(T, dtype=torch.int32, device=dev).expand(
            B, T
        ).contiguous()

    def zeros(T):
        return torch.zeros((B, T), dtype=torch.int32, device=dev)

    def ones(T):
        return torch.ones((B, T), dtype=torch.int32, device=dev)

    has_segments = q_segment_ids is not None
    if has_segments and kv_segment_ids is None:
        raise ValueError("q_segment_ids given without kv_segment_ids")
    args = (
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        ints(q_positions, Tq, arange),
        ints(kv_positions, Tk, arange),
        ints(q_segment_ids, Tq, zeros),
        ints(kv_segment_ids if has_segments else None, Tk, zeros),
        ints(kv_mask, Tk, ones),
    )
    flags = dict(
        causal=bool(causal), has_segments=has_segments,
        kv_arange=kv_positions is None or bool(slot_positions),
        scale=float(D**-0.5 if scale is None else scale),
    )
    return args, flags


def flash_attention(
    q, k, v,
    *,
    causal: bool = True,
    q_positions=None,
    kv_positions=None,
    q_segment_ids=None,
    kv_segment_ids=None,
    kv_mask=None,
    scale: float | None = None,
    slot_positions: bool = False,
):
    """Drop-in for ops.attention.attention with the same masking model.

    q: [B, Tq, Hq, D]; k/v: [B, Tk, Hk, D]. Returns [B, Tq, Hq, D].

    slot_positions: caller promise that every VALID token's position equals
    its slot index (right-padded prefill), which lets the kernel end its kv
    loop at the largest q position of a tile.
    """
    args, flags = _prepare(
        q, k, v, q_positions, kv_positions, q_segment_ids, kv_segment_ids,
        kv_mask, causal, scale, slot_positions,
    )
    if q.device.type == "cuda":
        out = _mha_forward(*args, **flags)
    elif q.device.type == "cpu":
        out = _mha_forward_reference(*args, **flags)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return out.transpose(1, 2)
