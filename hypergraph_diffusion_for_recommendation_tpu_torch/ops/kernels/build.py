"""Build a CUDA source of `csrc/` into a shared library at first use.

Each source has a plain C interface and is compiled on its own by `nvcc`
for Hopper (`sm_90a`), then loaded with ctypes; `build_libraries` starts
the compilers of several sources together. Nothing here runs when a
module is imported: the CPU tests import every module, and the CPU has
no `nvcc`.

The library lands in `build/torch_kernels/` at the repository root (a
directory `.gitignore` lists), named by a hash of the source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ptxas register / shared-memory report of each build, by source name
BUILD_LOGS: dict[str, str] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the source, the headers of
    `csrc/` it may include, and the flags."""
    parts = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    data = b"".join(p.read_bytes() for p in parts) + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(data).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_library(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists.
    A file lock serialises processes that build the same source."""
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu ({proc.returncode}):\n{proc.stderr}"
                )
            BUILD_LOGS[name] = proc.stderr
            os.replace(tmp, out)
    return out


def build_libraries(names) -> None:
    """Compile several sources at once: one `nvcc` each, all started
    together (the builds wait on processes, not on Python)."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        list(pool.map(build_library, names))


def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name)))
