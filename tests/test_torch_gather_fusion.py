"""The gather-fusion probe kernels' plain versions against the JAX probe.

`scripts/bench_gather_fusion.py` keeps its Pallas kernels inside `main()`,
so they are held here through what that script checks them against: the
row gather `x[cols]` (its check of `gather_kernel`, :105) and its
segment-sum SpMM (:76-78) and the JAX `_blocked_spmm_fwd_only` on the same
`pack_blocked` layout in Pallas interpret mode (its `fused_kernel`'s
contract and yardstick). f32: within 1e-6 of the output's scale (the same
products summed in another order); bf16 mode rounds each product to bf16,
as the Pallas fused kernel does, where the JAX SpMM kernel keeps it f32:
within 1e-2 of scale. The CUDA kernels themselves are held against these
plain versions on the card (`chip_smoke.py`, `test_torch_kernels_gpu.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu.ops.pallas import segment_spmm as jsp
from hypergraph_diffusion_for_recommendation_tpu_torch.bench import gather_fusion as B
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import gather_fusion as G
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as tsp

SMALL = dict(n=1000, d=32, nnz=8192, eb=1024)


@pytest.fixture(scope="module")
def probe():
    return B.make_probe("cpu", **SMALL)


def test_probe_data_is_the_jax_scripts(probe):
    # bench_gather_fusion.py:60-66, at a small size
    rng = np.random.default_rng(0)
    cols = rng.integers(0, SMALL["n"], SMALL["nnz"]).astype(np.int32)
    rows = np.sort(rng.integers(0, SMALL["n"], SMALL["nnz"])).astype(np.int32)
    x0 = np.asarray(jnp.asarray(rng.standard_normal((SMALL["n"], SMALL["d"])), jnp.float32))
    np.testing.assert_array_equal(probe.cols.numpy(), cols)
    np.testing.assert_array_equal(probe.rows.numpy(), rows)
    np.testing.assert_array_equal(probe.x.numpy(), x0)
    assert probe.idx.shape == (SMALL["nnz"] // SMALL["eb"], SMALL["eb"])
    # the port's layout is the JAX packer's, bit for bit
    jb = jsp.pack_blocked(rows, cols, np.ones(SMALL["nnz"], np.float32), (SMALL["n"],) * 2)
    for f in ("cols", "vals", "local_rows", "wmap"):
        np.testing.assert_array_equal(getattr(probe.blocked, f).numpy(), np.asarray(getattr(jb, f)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_row_gather_plain_matches_jax(probe, dtype):
    x = probe.x if dtype == "f32" else probe.x.to(torch.bfloat16)
    jx = jnp.asarray(probe.x.numpy())
    if dtype == "bf16":
        jx = jx.astype(jnp.bfloat16)
    want = np.asarray(jx[jnp.asarray(probe.idx.numpy())].astype(jnp.float32))
    got = G.resident_row_gather(x, probe.idx)  # a CPU tensor: the plain version
    assert got.dtype == x.dtype and got.shape == probe.idx.shape + (SMALL["d"],)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_row_gather_plain_clamps():
    x = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([[-2, 0], [3, 9]], dtype=torch.int32)
    np.testing.assert_array_equal(G.resident_row_gather(x, idx).numpy(),
                                  x.numpy()[[[0, 0], [3, 3]]])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_window_spmm_plain_matches_jax(probe, bf16):
    rows, cols, x = probe.rows.numpy(), probe.cols.numpy(), probe.x.numpy()
    vals = probe.vals.numpy()
    n = SMALL["n"]
    seg = np.asarray(jax.ops.segment_sum(jnp.asarray(x)[cols] * vals[:, None], rows,
                                         num_segments=n, indices_are_sorted=True))
    jb = jsp.pack_blocked(rows, cols, vals, (n, n), bf16=bf16)
    pallas = np.asarray(jsp._blocked_spmm_fwd_only(jb, jnp.asarray(x), interpret=True))
    got = G.fused_window_spmm(probe.blocked.replace(bf16=bf16), probe.x).numpy()
    assert got.shape == (n, SMALL["d"]) and got.dtype == np.float32
    scale = float(np.abs(seg).max())
    tol = (1e-2 if bf16 else 1e-6) * scale
    assert float(np.abs(got - seg).max()) <= tol
    assert float(np.abs(got - pallas).max()) <= tol


def test_fused_window_spmm_plain_empty_windows_and_ragged_nnz():
    # rows only in the first and last windows (the middle ones get one
    # all-pad block each), an nnz that is not a multiple of the edge block,
    # a last window shorter than rb, and values other than one
    rng = np.random.default_rng(3)
    n, d, nnz = 1100, 32, 1000
    rows = np.sort(np.concatenate([rng.integers(0, 200, 700), rng.integers(1030, n, nnz - 700)]))
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    x = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32))
    blocked = tsp.pack_blocked(rows, cols, vals, (n, n), device="cpu")
    assert blocked.n_windows == 5 and blocked.nrows % blocked.rb != 0
    got = G.fused_window_spmm(blocked, x)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (rows, cols), vals)
    np.testing.assert_allclose(got.numpy(), dense @ x.numpy(), rtol=1e-5, atol=1e-5)
    assert float(got[200:1030].abs().max()) == 0.0


def test_check_kernels_on_the_cpu(probe):
    # the probe's own kernel-vs-plain check (on the card it holds the CUDA
    # kernels); its timing needs the card
    errs = B.check_kernels(probe)
    assert set(errs) == {"resident_row_gather f32", "resident_row_gather bf16",
                         "fused_window_spmm f32", "fused_window_spmm bf16"}
    with pytest.raises(RuntimeError, match="CUDA"):
        B.run_probes(probe)
