"""The int8-weight product: the hand-written Hopper kernel and its plain twin.

`q8_linear(x, q, scale, bias)` computes x . deq(q, scale)^T (+ bias) in x's
dtype, with deq = q.to(dt) * scale.to(dt): the JAX package's
`x @ Q8Weight.astype(x.dtype)` (`oryx_tpu/utils/quant.py:68`), which XLA
fuses into the matmul's operand read. The scale is one per output channel
([N], a linear layer) or, with `column_scale=True`, one per input column
([K]: the tied head, whose weight is the int8 embedding table). No Pallas
kernel computes it; the CUDA source is `oryx_tpu_torch/csrc/q8_linear.cu`
(see its header for what bounds it and how it is laid out). Routes:
  * CPU tensors -> `q8_linear_reference` (dequantize, then `F.linear`);
  * CUDA tensors with at most MAX_ROWS rows (decode, verify, megasteps,
    the ragged engine's 4 decode rows beside 64 prefill lanes) -> the
    kernel, which reads the int8 codes directly, in launches of at most
    KERNEL_ROWS rows, or a raise;
  * CUDA tensors with more rows (prefill, the ViT, the compressor, 512
    prefill lanes) -> the twin: a plain large product, which the JAX
    package too computes outside any Pallas kernel.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from oryx_tpu_torch.ops.cuda import build
from oryx_tpu_torch.ops.cuda.flash_attention import _call, _sm_count

# Kernel launches, keyed by (M, N, K, dtype name). Only `q8_linear_kernel`
# adds to it, once per launch.
LAUNCHES: collections.Counter = collections.Counter()

KERNEL_ROWS = 64  # rows one launch takes (csrc/q8_linear.cu)
# Rows the kernel serves; more go to the dequantized product. On an H100
# every oryx_7b decoder shape is faster through the kernel up to 128 rows
# (two launches) and about even at 192 (`scripts/torch_q8_check.py --time`).
MAX_ROWS = 128
KB = 64  # columns of a k block of the bf16 kernel (csrc/q8_linear.cu)
WARPS_PER_SM = 16  # live warps per SM the bf16 plan aims for
MIN_KB_PER_SPLIT = 4  # k blocks a split takes at least

_DT = {torch.bfloat16: "bf16", torch.float32: "f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("q8_linear").oryx_q8_linear
        # x q scale bias y part; M N K bf16 nt splits kps vec col; stream
        fn.argtypes = [_P] * 6 + [_I] * 9 + [_P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype,
                      column_scale: bool = False) -> torch.Tensor:
    """deq(q [N, K], scale [N], or [K] with column_scale) in `dtype`:
    q.to(dtype) * scale.to(dtype)."""
    s = scale.to(dtype)
    return q.to(dtype) * (s[None, :] if column_scale else s[:, None])


def q8_linear_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor | None = None, *,
                        column_scale: bool = False) -> torch.Tensor:
    """The plain twin: dequantize in x's dtype, then F.linear."""
    return F.linear(x, dequantize_weight(q, scale, x.dtype, column_scale),
                    None if bias is None else bias.to(x.dtype))


def _plan(N: int, K: int, sm_count: int) -> tuple[int, int, int]:
    """(16-channel tiles a warp owns, splits, k blocks a split) of the bf16
    kernel, from N, K and the SM count only (never M, so a row's bits do not
    depend on how many rows a call has): two tiles a warp when the channels
    alone give WARPS_PER_SM warps an SM, else one; then enough contiguous
    k ranges to reach that many warps, each at least MIN_KB_PER_SPLIT
    blocks."""
    nkb = -(-K // KB)
    want = WARPS_PER_SM * sm_count
    nt = 2 if -(-N // 32) >= want else 1
    warps = -(-N // (16 * nt))
    splits = max(1, min(-(-want // warps), nkb // MIN_KB_PER_SPLIT))
    kps = -(-nkb // splits)
    return nt, -(-nkb // kps), kps


def q8_linear_kernel(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor | None = None,
                     column_scale: bool = False) -> torch.Tensor:
    """The kernel alone over CUDA x2 [M, K], any M, KERNEL_ROWS rows a
    launch (a row's bits do not depend on the launch it is in); raises on
    operands it does not take or a failed launch."""
    M, K = x2.shape
    N = q.shape[0]
    dev = x2.device
    if x2.dtype not in _DT:
        raise ValueError(f"q8_linear: x must be bf16 or fp32, got {x2.dtype}")
    if (q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != K
            or not q.is_contiguous() or q.device != dev):
        raise ValueError(
            f"q8_linear: q must be contiguous int8 [N, {K}] on {dev}, got "
            f"{q.dtype} {tuple(q.shape)} on {q.device}")
    S = K if column_scale else N
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (S,)
            or not scale.is_contiguous() or scale.device != dev):
        raise ValueError(
            f"q8_linear: scale must be contiguous fp32 [{S}] on {dev}, got "
            f"{scale.dtype} {tuple(scale.shape)} on {scale.device}")
    if bias is not None:
        bias = bias.to(x2.dtype).contiguous()
        if tuple(bias.shape) != (N,) or bias.device != dev:
            raise ValueError(f"q8_linear: bias must be [{N}] on {dev}")
    y = torch.empty((M, N), dtype=x2.dtype, device=dev)
    # On the vector path K % 16 == 0, so every launch's rows of x start
    # 16-byte aligned.
    vec = int(K % 16 == 0 and x2.data_ptr() % 16 == 0
              and q.data_ptr() % 16 == 0
              and (not column_scale or scale.data_ptr() % 16 == 0))
    bf16 = x2.dtype == torch.bfloat16
    nt, splits, kps = _plan(N, K, _sm_count(dev)) if bf16 else (1, 1, 1)
    part = (torch.empty((splits, min(M, KERNEL_ROWS), N), dtype=torch.float32,
                        device=dev)
            if splits > 1 else None)
    fn = _kernel_fn()
    for m0 in range(0, M, KERNEL_ROWS):
        m = min(KERNEL_ROWS, M - m0)
        err = _call(
            fn, dev, x2[m0:].data_ptr(), q.data_ptr(), scale.data_ptr(),
            0 if bias is None else bias.data_ptr(), y[m0:].data_ptr(),
            0 if part is None else part.data_ptr(), m, N, K, int(bf16), nt,
            splits, kps, vec, int(column_scale),
        )
        if err != 0:
            raise RuntimeError(
                f"q8_linear launch failed: CUDA error {err} (M={m}, N={N}, "
                f"K={K}, plan {nt, splits, kps}, column_scale={column_scale})")
        LAUNCHES[(m, N, K, _DT[x2.dtype])] += 1
    return y


def q8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor | None = None, *,
              column_scale: bool = False) -> torch.Tensor:
    """x [..., K] . deq(q [N, K], scale [N] or, with column_scale, [K])^T
    (+ bias [N]) -> [..., N] in x's dtype (see the module docstring for the
    routes)."""
    K = q.shape[1]
    M = x.numel() // K if K else 0
    if x.device.type != "cuda" or M > MAX_ROWS or M == 0:
        return q8_linear_reference(x, q, scale, bias,
                                   column_scale=column_scale)
    y = q8_linear_kernel(x.reshape(M, K).contiguous(), q, scale, bias,
                         column_scale)
    return y.reshape(*x.shape[:-1], q.shape[0])
