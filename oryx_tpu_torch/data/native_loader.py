"""ctypes binding for the native host-pipeline kernels (native/loader.cpp).

The C++ library fuses resize + normalize + patchify in one pass and fans a
batch out over a std::thread pool, writing each image's patch rows into its
slice of the packed buffer (`ops/packing.pack_raw_images`, whenever the
library builds).

The port builds the library itself, at first use, from the checkout's
`native/loader.cpp` with the flags of `native/Makefile` (portable: no
-march), into `oryx_tpu_torch/_build/` (listed in .gitignore), named after
a hash of the source and the flags so an edited source is rebuilt. An
exclusive file lock serializes concurrent builders across processes, and
the compiler writes a process-unique temporary file that is renamed into
place, so a concurrent dlopen never maps a truncated library. A library
file that sits in `native/` is never loaded. Callers gate on
`is_available()`, which builds on its first call; with no compiler it is
False and packing keeps its numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "loader.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared",
             "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"liboryx_loader-{digest}.so"


def build() -> Path | None:
    """Compile native/loader.cpp unless the library for this exact source
    exists. Returns the library path, or None when there is no source or
    no compiler or the compile failed."""
    import fcntl

    if not SOURCE.exists():
        return None
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    try:
        with open(BUILD_DIR / ".native_loader.lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            if out.exists():  # another process built it while we waited
                return out
            tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
            r = subprocess.run(
                [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                capture_output=True, text=True, timeout=120,
            )
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                return None
            os.replace(tmp, out)
            return out
    except (OSError, subprocess.TimeoutExpired):
        return None


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = build()
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _lib_failed = True
            return None
        lib.oryx_preprocess_image.restype = ctypes.c_int
        lib.oryx_preprocess_image.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.oryx_batch_preprocess.restype = ctypes.c_int
        lib.oryx_batch_preprocess.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native loader unavailable (no C++ compiler, or the build of "
            "native/loader.cpp failed); gate on is_available()"
        )
    return lib


def _img_meta(img: np.ndarray) -> tuple[np.ndarray, int]:
    """Contiguous array + dtype code (0 = uint8, 1 = float32)."""
    if img.dtype == np.uint8:
        return np.ascontiguousarray(img), 0
    return np.ascontiguousarray(img, dtype=np.float32), 1


def preprocess_image(
    img: np.ndarray,
    out_hw: tuple[int, int],
    patch: int,
    mean: float,
    std: float,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Fused resize (align_corners=False) + normalize + patchify.

    Returns float32 [gh * gw, patch * patch * C] patch rows (written into
    `out` when given, e.g. a row slice of the packed patches buffer)."""
    lib = _need()
    img, dtype = _img_meta(img)
    H, W, C = img.shape
    oh, ow = out_hw
    rows = (oh // patch) * (ow // patch)
    if out is None:
        out = np.empty((rows, patch * patch * C), np.float32)
    if out.dtype != np.float32 or not out.flags.c_contiguous or \
            out.shape != (rows, patch * patch * C):
        raise ValueError(
            f"out must be C-contiguous float32 {(rows, patch * patch * C)}, "
            f"got {out.dtype} {out.shape}"
        )
    rc = lib.oryx_preprocess_image(
        img.ctypes.data_as(ctypes.c_void_p), dtype, H, W, C, oh, ow, patch,
        mean, std, out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise RuntimeError(f"oryx_preprocess_image failed: {rc}")
    return out


def _taps(dst: int, src: int):
    """(lo, hi, frac) source taps along one axis, float32 op for op as
    loader.cpp's make_taps."""
    f32 = np.float32
    scale = f32(src) / f32(dst)
    s = (np.arange(dst, dtype=f32) + f32(0.5)) * scale - f32(0.5)
    f = np.floor(s)
    lo = f.astype(np.int64)
    return (np.clip(lo, 0, src - 1), np.clip(lo + 1, 0, src - 1),
            (s - f).astype(f32))


def preprocess_reference(
    img: np.ndarray,
    out_hw: tuple[int, int],
    patch: int,
    mean: float,
    std: float,
) -> np.ndarray:
    """The plain numpy twin of `preprocess_image`: loader.cpp's float32
    operations in its order (horizontal taps then the vertical blend, the
    normalization folded into v * a + b), so its bytes equal the library's
    on a build without fused multiply-add (the Makefile's portable flags).
    data/mm_utils' path agrees with both to 1e-4 only."""
    f32 = np.float32
    img, dtype = _img_meta(img)
    H, W, C = img.shape
    oh, ow = out_hw
    inv_std = f32(1.0) / f32(std)
    a = (f32(1.0) / f32(255.0) if dtype == 0 else f32(1.0)) * inv_std
    b = -f32(mean) * inv_std
    ylo, yhi, fy = _taps(oh, H)
    xlo, xhi, fx = _taps(ow, W)
    src = img.astype(f32)
    v0, v1 = src[:, xlo], src[:, xhi]
    rows = (v0 + (v1 - v0) * fx[None, :, None]) * a + b
    r0, r1 = rows[ylo], rows[yhi]
    out = r0 + (r1 - r0) * fy[:, None, None]
    gh, gw = oh // patch, ow // patch
    return np.ascontiguousarray(
        out.reshape(gh, patch, gw, patch, C).transpose(0, 2, 1, 3, 4)
    ).reshape(gh * gw, patch * patch * C)


def batch_preprocess(
    images: list[np.ndarray],
    out_hws: list[tuple[int, int]],
    patch: int,
    mean: float,
    std: float,
    outs: list[np.ndarray] | None = None,
    num_threads: int = 0,
) -> list[np.ndarray]:
    """Thread-pool batch version of `preprocess_image`. `outs` may alias
    disjoint row slices of one packed buffer, so the pool writes the final
    layout directly."""
    lib = _need()
    n = len(images)
    if n == 0:
        return []
    metas = [_img_meta(img) for img in images]
    C = metas[0][0].shape[2]
    if outs is None:
        outs = [
            np.empty(((oh // patch) * (ow // patch), patch * patch * C),
                     np.float32)
            for oh, ow in out_hws
        ]

    def ints(vals):
        return (ctypes.c_int * n)(*vals)

    img_ptrs = (ctypes.c_void_p * n)(
        *[m[0].ctypes.data_as(ctypes.c_void_p).value for m in metas]
    )
    out_ptrs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for o in outs]
    )
    rc = lib.oryx_batch_preprocess(
        n, img_ptrs, ints([m[1] for m in metas]),
        ints([m[0].shape[0] for m in metas]),
        ints([m[0].shape[1] for m in metas]),
        ints([m[0].shape[2] for m in metas]),
        ints([hw[0] for hw in out_hws]), ints([hw[1] for hw in out_hws]),
        patch, mean, std, out_ptrs, num_threads,
    )
    if rc != 0:
        raise RuntimeError(f"oryx_batch_preprocess failed: {rc}")
    return outs
