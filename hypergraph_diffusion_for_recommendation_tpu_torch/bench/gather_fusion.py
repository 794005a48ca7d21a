"""Gather-fusion probe: can a gather from a table that stays in fast
memory beat the row gather outside the SpMM kernel?

The port of the JAX package's microbenchmark `scripts/bench_gather_fusion.py`
at its shapes (N = 19712 rows, d = 128, nnz = 262144, gather blocks of
EB = 1024 edges) and on its data (`numpy.random.default_rng(0)`: random
columns, sorted random rows, a standard-normal X, unit values). Run on the
card:

    python -m hypergraph_diffusion_for_recommendation_tpu_torch.bench.gather_fusion

Probes, each timed by its device time per call (torch.profiler):
  1. the row gather x[cols] as `torch.index_select`, f32 and bf16;
  2. gather + `index_add_` SpMM;
  3. `resident_row_gather` (the port of `gather_kernel`), f32 and bf16,
     and its plain version;
  4. `fused_window_spmm` (the port of `fused_kernel`) on the `pack_blocked`
     layout, f32 and bf16, and its plain version;
  5. the port's `blocked_spmm` (`segment_spmm_rows`) on the same layout;
  6. `torch.sparse.mm` on the same matrix in CSR.
Each kernel's result is first held against its plain version; a mismatch
raises. The last line printed is one JSON object with every time, the
card's name and the kernels' errors.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kernels import gather_fusion as G
from ..ops.kernels import segment_spmm as S

N, D, NNZ, EB = 19712, 128, 262144, 1024
# a kernel against its plain version, relative to the output's scale: the
# fused kernel sums each row in a fixed order of its own (in f32 with
# fused multiply-adds, its teams' partial sums added by a shuffle tree),
# the plain version rounds each product and sums them by `index_add_`:
# the same products summed in another f32 order. Two calls of the kernel
# give the same bits.
KERNEL_RTOL = 1e-5


@dataclass
class Probe:
    x: torch.Tensor  # [n, d] f32
    rows: torch.Tensor  # [nnz] int32, sorted
    cols: torch.Tensor  # [nnz] int32
    vals: torch.Tensor  # [nnz] f32
    idx: torch.Tensor  # the gather's indices: cols as [nnz // eb, eb] blocks
    blocked: S.BlockedCOO  # pack_blocked of the matrix, f32 mode
    shape: tuple[int, int]


def make_probe(device, n: int = N, d: int = D, nnz: int = NNZ, eb: int = EB,
               seed: int = 0) -> Probe:
    """The probe's data, drawn as the JAX script draws it, on `device`."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    rows = np.sort(rng.integers(0, n, nnz)).astype(np.int32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    vals = np.ones(nnz, np.float32)
    blocked = S.pack_blocked(rows, cols, vals, (n, n), device=device)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    idx = t(cols.reshape(nnz // eb, eb) if nnz % eb == 0 else cols)
    return Probe(x=t(x), rows=t(rows), cols=t(cols), vals=t(vals), idx=idx, blocked=blocked,
                 shape=(n, n))


def csr_matrix(p: Probe):
    """The probe's matrix as scipy CSR on the host (duplicate edges summed)."""
    import scipy.sparse as sps

    return sps.csr_matrix((p.vals.cpu().numpy(), (p.rows.cpu().numpy(), p.cols.cpu().numpy())),
                          shape=p.shape)


def check_kernels(p: Probe) -> dict[str, float]:
    """Each kernel in f32 and bf16 against its plain version: the gather
    exactly, the fused product within KERNEL_RTOL of the output's scale.
    Returns the largest absolute error of each; raises on a mismatch."""
    errs = {}
    for mode, table in (("f32", p.x), ("bf16", p.x.to(torch.bfloat16))):
        got = G.resident_row_gather(table, p.idx)
        want = G.resident_row_gather_reference(table, p.idx)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"resident_row_gather {mode} differs from its plain version")
        errs[f"resident_row_gather {mode}"] = 0.0
        blk = p.blocked.replace(bf16=mode == "bf16")
        got = G.fused_window_spmm(blk, p.x)
        want = G.fused_window_spmm_reference(blk, p.x)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if got.shape != want.shape or not err <= KERNEL_RTOL * max(scale, 1.0):
            raise AssertionError(f"fused_window_spmm {mode} differs from its plain version by "
                                 f"{err:.3e} (scale {scale:.3f})")
        errs[f"fused_window_spmm {mode}"] = err
    return errs


def run_probes(p: Probe, log=print, iters: int = 20) -> dict:
    """Check both kernels, then time every probe on the card. Returns
    {"errors": {...}, "ms": {probe: device ms per call}}."""
    from .timing import device_ms

    if p.x.device.type != "cuda":
        raise RuntimeError("the gather-fusion probe measures the card: give it CUDA tensors")
    errs = check_kernels(p)
    x, xb = p.x, p.x.to(torch.bfloat16)
    cols_l, rows_l = p.cols.long(), p.rows.long()
    csr = csr_matrix(p)
    a_csr = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr.astype(np.int64)), torch.as_tensor(csr.indices.astype(np.int64)),
        torch.as_tensor(csr.data.astype(np.float32)), csr.shape, check_invariants=False,
    ).to(x.device)
    blk, blk_b = p.blocked, p.blocked.replace(bf16=True)

    def gather_spmm():
        g = x[cols_l] * p.vals[:, None]
        return torch.zeros_like(x).index_add_(0, rows_l, g)

    probes = {
        "1. index_select f32": lambda: torch.index_select(x, 0, cols_l),
        "1b. index_select bf16": lambda: torch.index_select(xb, 0, cols_l),
        "2. gather + index_add_ spmm": gather_spmm,
        "3. resident_row_gather f32": lambda: G.resident_row_gather(x, p.idx),
        "3b. resident_row_gather bf16": lambda: G.resident_row_gather(xb, p.idx),
        "3p. resident_row_gather plain f32": lambda: G.resident_row_gather_reference(x, p.idx),
        "3pb. resident_row_gather plain bf16": lambda: G.resident_row_gather_reference(xb, p.idx),
        "4. fused_window_spmm f32": lambda: G.fused_window_spmm(blk, x),
        "4b. fused_window_spmm bf16": lambda: G.fused_window_spmm(blk_b, x),
        "4p. fused_window_spmm plain f32": lambda: G.fused_window_spmm_reference(blk, x),
        "4pb. fused_window_spmm plain bf16": lambda: G.fused_window_spmm_reference(blk_b, x),
        "5. blocked_spmm f32": lambda: S.blocked_spmm(blk, x),
        "5b. blocked_spmm bf16": lambda: S.blocked_spmm(blk_b, x),
        "6. torch.sparse.mm": lambda: torch.sparse.mm(a_csr, x),
    }
    ms = {}
    for name, fn in probes.items():
        ms[name] = device_ms(fn, iters=iters, log=log)[0]
        log(f"{name:38s} {ms[name]:9.4f} ms")
    return {"errors": errs, "ms": ms}


def main() -> int:
    import warnings

    if not torch.cuda.is_available():
        print("gather_fusion: no CUDA device; the probe measures the card", file=sys.stderr)
        return 2
    warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
    print(f"device: {torch.cuda.get_device_name(0)}  N={N} d={D} nnz={NNZ} EB={EB}", flush=True)
    out = run_probes(make_probe("cuda"), log=lambda *a: print(*a, flush=True))
    print(json.dumps(dict(out, device=torch.cuda.get_device_name(0),
                          shape=dict(n=N, d=D, nnz=NNZ, eb=EB))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
