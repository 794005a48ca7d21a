"""The port's native host data plane (`fastload.cpp`), bound with ctypes:
file parsing (`load_columns`, behind `data/io.py`), first-appearance id
factorisation (`factorize`, behind `data/dataset.py`) and the (major,
minor) edge sort of adjacency construction (`sort_pairs`, behind
`data/device.py` and `core/types.py`).

The library is compiled with `g++` at first use into `build/native/` at the
repository root (a directory `.gitignore` lists), named by a hash of the
source and the flags, as the CUDA kernels are (`ops/kernels/build.py`);
nothing is built when the module is imported. A failed build raises. Each
entry point also has its plain numpy version, which the tests hold the
library against; it runs only when the caller passes `plain=True`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "fastload.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfastload-{digest}.so"


def build_library() -> Path:
    """Compile `fastload.cpp` unless an up-to-date library exists; a file
    lock serialises processes that build it at once."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "fastload.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for fastload.cpp ({proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.hd_load_columns.restype = ctypes.c_int64
        lib.hd_load_columns.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.POINTER(_I64P)]
        lib.hd_factorize.restype = ctypes.c_int64
        lib.hd_factorize.argtypes = [_I64P, ctypes.c_int64, _I32P, _I64P]
        lib.hd_sort_pairs.restype = ctypes.c_int64
        lib.hd_sort_pairs.argtypes = [_I64P, _I64P, ctypes.c_int64, _I64P]
        lib.hd_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def load_columns(path: str, ncols: int, plain: bool = False) -> np.ndarray:
    """The first `ncols` integer columns of a file with one header line ->
    int64 [n, ncols]. Columns are separated by tabs or commas (the plain
    version reads the separator off the header: a tab if it has one)."""
    if plain:
        with open(path) as f:
            sep = "\t" if "\t" in f.readline() else ","
            rows = [[int(x) for x in line.split(sep)[:ncols]] for line in f if line.strip()]
        return np.asarray(rows, np.int64).reshape(-1, ncols)
    out = _I64P()
    n = library().hd_load_columns(os.fsencode(path), ncols, ctypes.byref(out))
    if n < 0:
        raise OSError(f"fastload: cannot read {path}")
    if n == 0:
        return np.zeros((0, ncols), np.int64)
    try:
        return np.ctypeslib.as_array(out, shape=(n, ncols)).copy()
    finally:
        library().hd_free(out)


def sort_pairs(major: np.ndarray, minor: np.ndarray, plain: bool = False) -> np.ndarray:
    """Stable argsort by (major, minor), `np.lexsort((minor, major))`:
    the library's LSD radix sort (non-negative keys), or with `plain`
    `np.lexsort` itself."""
    if plain:
        return np.lexsort((minor, major))
    major = np.ascontiguousarray(major, np.int64)
    minor = np.ascontiguousarray(minor, np.int64)
    n = major.shape[0]
    perm = np.empty(n, np.int64)
    rc = library().hd_sort_pairs(major.ctypes.data_as(_I64P), minor.ctypes.data_as(_I64P), n,
                                 perm.ctypes.data_as(_I64P))
    if rc != 0:
        raise ValueError("sort_pairs: negative keys" if rc == -2 else "sort_pairs: out of memory")
    return perm


def factorize(vals: np.ndarray, plain: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """First-appearance factorisation (`pandas.factorize`): (codes int32
    [n], uniques int64 [n_unique]), uniques in order of first appearance."""
    vals = np.ascontiguousarray(vals, np.int64)
    if plain:
        uniq, first, inverse = np.unique(vals, return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(order.shape[0], np.int64)
        rank[order] = np.arange(order.shape[0])
        return rank[inverse.reshape(-1)].astype(np.int32), uniq[order]
    n = vals.shape[0]
    codes = np.empty(n, np.int32)
    uniques = np.empty(max(n, 1), np.int64)
    n_unique = library().hd_factorize(vals.ctypes.data_as(_I64P), n, codes.ctypes.data_as(_I32P),
                                      uniques.ctypes.data_as(_I64P))
    if n_unique < 0:
        raise MemoryError("factorize: out of memory")
    return codes, uniques[:n_unique].copy()
