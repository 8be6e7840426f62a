"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` (with the shared headers `csrc/*.cuh`) is compiled
with nvcc into a shared library with a plain C interface, at first use,
into `oryx_tpu_torch/_build/` (listed in .gitignore), and loaded with
ctypes. No driver library is linked: kernels that need a driver call
(the TMA tensor-map encoder) reach it through the runtime's
`cudaGetDriverEntryPoint`. The library file is named after a hash of its
source, the headers and the flags, so an edited kernel is rebuilt and a
stale one is never loaded. An exclusive file lock per source serializes
concurrent builds of it across processes (different sources build in
parallel). A failed compile or load raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's stderr of each build this process ran (ptxas register/spill lines).
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    # The shared headers are hashed too: an edited header rebuilds every
    # library.
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this exact source
    exists. Returns the library path; raises with nvcc's stderr on
    failure."""
    import fcntl

    out = library_path(name)
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_logs[name] = res.stderr
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {name}.cu:\n"
                f"{res.stderr}"
            )
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load {path}: {e}") from e
            _libs[name] = lib
        return lib
