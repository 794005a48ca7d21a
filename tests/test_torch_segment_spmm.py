"""The port's row-window segment SpMM against the JAX package's.

The packers must give the JAX packers' layouts bit for bit, and the
plain PyTorch version must compute what the Pallas kernels compute (run
here in interpret mode), in f32, bf16 and int8 mode; the int8 table must
be JAX's bit for bit, and `blocked_spmm`'s gradients must be the JAX
custom VJP's. The CUDA kernels themselves are held against the plain
version on the card (`chip_smoke.py` and `test_torch_kernels_gpu.py`).
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sps
import jax.numpy as jnp
import torch

from hypergraph_diffusion_for_recommendation_tpu.ops.pallas import segment_spmm as jsp
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as tsp


def _random(rng):
    n, m = 700, 900
    mat = sps.random(n, m, density=0.02, random_state=np.random.RandomState(7), format="coo")
    return n, m, mat.row, mat.col, rng.standard_normal(mat.nnz).astype(np.float32)


def _empty_windows(rng):
    # every edge in row 0: all other windows must come out zero
    return 1000, 64, np.zeros(50, np.int64), np.arange(50), np.ones(50, np.float32)


def _hub(rng):
    # power law: one hub row with thousands of edges next to sparse rows
    n, m = 600, 400
    rows = np.concatenate([np.zeros(3000, np.int64), rng.integers(1, n, 2000)])
    cols = np.concatenate([rng.integers(0, m, 3000), rng.integers(0, m, 2000)])
    return n, m, rows, cols, rng.standard_normal(rows.shape[0]).astype(np.float32)


def _dense_windows(rng):
    # ML-1M-like column multiplicity inside each row window
    n, m = 300, 120
    mat = sps.random(n, m, density=0.3, random_state=np.random.RandomState(3), format="coo")
    return n, m, mat.row, mat.col, rng.uniform(0.1, 1.0, mat.nnz).astype(np.float32)


# (graph, tiles): the default tiles, and small ones so that windows span
# several blocks and dedup blocks close on the distinct-column budget
CASES = {
    "random": (_random, {}),
    "empty_windows": (_empty_windows, {}),
    "hub": (_hub, {}),
    "dense_windows": (_dense_windows, {}),
    "random_small_tiles": (_random, dict(edge_block=64, row_block=32, unique_block=16)),
    "hub_small_tiles": (_hub, dict(edge_block=64, row_block=32, unique_block=16)),
}


def _coo(case, seed=0):
    make, tiles = CASES[case]
    n, m, rows, cols, vals = make(np.random.default_rng(seed))
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    # trailing pad entries (row == n, col 0, val 0), as the padded COO has
    rows = np.concatenate([rows, np.full(5, n)]).astype(np.int32)
    cols = np.concatenate([cols, np.zeros(5, np.int64)]).astype(np.int32)
    vals = np.concatenate([vals, np.zeros(5, np.float32)])
    return (n, m), rows, cols, vals, tiles


def _pack_both(case, dedup, bf16=False, canon=False):
    shape, rows, cols, vals, tiles = _coo(case)
    if not dedup:
        tiles = {k: v for k, v in tiles.items() if k != "unique_block"}
    canon_map = np.random.default_rng(1).permutation(rows.shape[0]) if canon else None
    jpack = jsp.pack_blocked_dedup if dedup else jsp.pack_blocked
    tpack = tsp.pack_blocked_dedup if dedup else tsp.pack_blocked
    jb = jpack(rows, cols, vals, shape, bf16=bf16, canon_map=canon_map, **tiles)
    tb = tpack(rows, cols, vals, shape, bf16=bf16, canon_map=canon_map, device="cpu", **tiles)
    return shape, jb, tb


@pytest.mark.parametrize("dedup", [False, True], ids=["base", "dedup"])
@pytest.mark.parametrize("case", list(CASES))
def test_packers_bit_for_bit(case, dedup):
    _, jb, tb = _pack_both(case, dedup, canon=True)
    fields = ["cols", "local_rows", "wmap", "src", "canon"]
    fields += ["ucols", "local_cols"] if dedup else []
    for f in fields:
        j, t = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert j.dtype == t.dtype == np.int32, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    np.testing.assert_array_equal(tb.vals.numpy(), np.asarray(jb.vals))
    for f in ("nrows", "ncols", "n_blocks", "n_windows", "eb", "rb", "ub"):
        assert getattr(tb, f) == getattr(jb, f), f
    assert tb.dedup == dedup


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("dedup", [False, True], ids=["base", "dedup"])
@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_pallas_interpret(case, dedup, bf16):
    shape, jb, tb = _pack_both(case, dedup, bf16=bf16)
    x = np.random.default_rng(2).standard_normal((shape[1], 32)).astype(np.float32)
    want = np.asarray(jsp._blocked_spmm_fwd_only(jb, jnp.asarray(x), None, interpret=True))
    got = tsp.blocked_spmm(tb, torch.as_tensor(x)).numpy()  # CPU tensor -> plain version
    assert got.shape == want.shape == (shape[0], 32)
    if bf16:
        # both round X, the edge values and the dedup weights to bf16 and
        # sum in f32; only the order of the f32 sums differs
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dedup", [False, True], ids=["base", "dedup"])
def test_reference_matches_scipy(dedup):
    shape, rows, cols, vals, _ = _coo("hub")
    pack = tsp.pack_blocked_dedup if dedup else tsp.pack_blocked
    tb = pack(rows, cols, vals, shape, device="cpu")
    x = np.random.default_rng(4).standard_normal((shape[1], 16)).astype(np.float32)
    live = rows < shape[0]
    want = sps.coo_matrix((vals[live], (rows[live], cols[live])), shape=shape) @ x
    got = tsp.blocked_spmm(tb, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def _base_work(tb):
    """Decode the base kernel's work list as the kernel reads it: the rows
    each warp (or hub CTA) writes, and the owner row of each flat slot."""
    wr, rs, re_ = tb.warp_rows.numpy(), tb.row_start.numpy(), tb.row_end.numpy()
    per = tsp.WARPS_PER_CTA
    assert wr.shape[1] == per + 1 and (np.diff(wr, axis=1) >= 0).all()
    writes = np.zeros(tb.nrows, np.int64)
    owner = np.full(tb.n_blocks * tb.eb, -1)
    hubs = []
    for w in wr:
        if w[1] == w[0] + 1 and re_[w[0]] - rs[w[0]] > tsp.ROW_SLOTS:
            assert (w[1:] == w[0] + 1).all()  # the other warps hold no rows
            rows = [w[0]]
            hubs.append(w[0])
        else:
            rows = range(w[0], w[-1])
            for k in range(per):
                assert w[k + 1] - w[k] <= tsp.ROWS_PER_WARP
                assert (re_[w[k]:w[k + 1]] - rs[w[k]:w[k + 1]]).sum() <= tsp.ROW_SLOTS
        for r in rows:
            writes[r] += 1
            assert (owner[rs[r]:re_[r]] == -1).all()
            owner[rs[r]:re_[r]] = r
    return writes, owner, hubs


def test_base_row_chunks_cover_each_live_slot_once():
    # the base kernel reads the flat slot ranges [row_start, row_end) of the
    # rows its work list gives each warp: every live slot must lie in
    # exactly one range, of its own row, and the hub row takes a CTA
    shape, rows, cols, vals, tiles = _coo("hub_small_tiles")
    tiles.pop("unique_block")
    tb = tsp.pack_blocked(rows, cols, vals, shape, device="cpu", **tiles)
    lrows = tb.local_rows.reshape(-1).numpy()
    grow = np.repeat(tb.wmap.numpy(), tb.eb) * tb.rb + lrows
    writes, owner, hubs = _base_work(tb)
    live = lrows < tb.rb
    np.testing.assert_array_equal(owner[live], grow[live])
    assert (owner[~live] == -1).all()
    np.testing.assert_array_equal(writes, 1)
    assert hubs[0] == 0 and tb.row_end[0] - tb.row_start[0] == 3000  # the hub row
    assert tb.n_live == int(live.sum())


@pytest.mark.parametrize("case", list(CASES))
def test_base_work_list_writes_every_row_once(case):
    # every output row, empty ones and those of empty windows included, has
    # exactly one writer; live slots are covered once, pads never
    shape, rows, cols, vals, tiles = _coo(case)
    tiles.pop("unique_block", None)
    tb = tsp.pack_blocked(rows, cols, vals, shape, device="cpu", **tiles)
    writes, owner, hubs = _base_work(tb)
    np.testing.assert_array_equal(writes, 1)
    lrows = tb.local_rows.reshape(-1).numpy()
    grow = np.repeat(tb.wmap.numpy(), tb.eb) * tb.rb + lrows
    live = lrows < tb.rb
    np.testing.assert_array_equal(owner[live], grow[live])
    assert (owner[~live] == -1).all()
    counts = np.bincount(rows[rows < shape[0]], minlength=shape[0])
    np.testing.assert_array_equal(sorted(hubs), np.nonzero(counts > tsp.ROW_SLOTS)[0])


def _emulate_dedup(tb, x, target):
    """The f32 dedup kernel's walk in numpy: per part its blocks; per
    block, group k of the ordered slots is row (k % 16) * 16 + k // 16, W
    is summed per (row, column) run and W * X added into the row's sum;
    a window's parts added in part order."""
    rc, slot, meta = tb.order_rc.numpy(), tb.order_slot.numpy(), tb.block_meta.numpy()
    vals, ucols = tb.vals.numpy().reshape(-1), tb.ucols.numpy()
    n_groups = tsp.DEDUP_WARPS * tsp.DEDUP_ROWS_PER_WARP
    part_window, part_blocks, _ = tsp.dedup_parts(tb.window_blocks, target,
                                                  tsp.dedup_block_cost(meta))
    out = np.zeros((tb.n_windows * tb.rb, x.shape[1]), np.float32)
    for p, w in enumerate(part_window):
        sums = np.zeros((n_groups, x.shape[1]), np.float32)
        for b in range(part_blocks[p], part_blocks[p + 1]):
            xs = x[ucols[b, : meta[b, n_groups + 1]]]
            for k in range(n_groups):
                row = (k % tsp.DEDUP_ROWS_PER_WARP) * tsp.DEDUP_WARPS + k // tsp.DEDUP_ROWS_PER_WARP
                run = np.float32(0)
                for t in range(meta[b, k], meta[b, k + 1]):
                    assert rc[b, t] >> 16 == row
                    run += vals[slot[b, t]]
                    if t + 1 == meta[b, n_groups] or rc[b, t + 1] != rc[b, t]:
                        sums[row] += run * xs[rc[b, t] & 0xFFFF]
                        run = np.float32(0)
        out[w * tb.rb:(w + 1) * tb.rb] += sums[: tb.rb]
    return out[: tb.nrows]


@pytest.mark.parametrize("target", [1, 3, 1000])
@pytest.mark.parametrize("case", list(CASES))
def test_dedup_work_lists_cover_each_live_slot_once(case, target):
    # each block's ordered list holds each live slot once, grouped by row in
    # the order (row % 16, row, slot) with its (row, column); the parts of a
    # window take each of its blocks once; and the kernel's walk over them
    # computes A @ X
    shape, rows, cols, vals, tiles = _coo(case)
    tb = tsp.pack_blocked_dedup(rows, cols, vals, shape, device="cpu", **tiles)
    lrows, lcols = tb.local_rows.numpy(), tb.local_cols.numpy()
    rc, slot, meta = tb.order_rc.numpy(), tb.order_slot.numpy(), tb.block_meta.numpy()
    n_groups = tsp.DEDUP_WARPS * tsp.DEDUP_ROWS_PER_WARP
    assert meta.shape == (tb.n_blocks, n_groups + 2)
    for b in range(tb.n_blocks):
        live = np.nonzero(lrows[b] < tb.rb)[0]
        n = meta[b, n_groups]
        assert meta[b, 0] == 0 and (np.diff(meta[b, : n_groups + 1]) >= 0).all()
        np.testing.assert_array_equal(live, np.arange(n))  # the live slots lead the block
        pos = slot[b, :n] - b * tb.eb
        np.testing.assert_array_equal(np.sort(pos), live)
        np.testing.assert_array_equal(rc[b, :n], (lrows[b, pos] << 16) | lcols[b, pos])
        key = np.stack([lrows[b, pos] % tsp.DEDUP_WARPS, lrows[b, pos], pos])
        assert (np.lexsort(key[::-1]) == np.arange(n)).all()
        assert meta[b, -1] == (lcols[b, live].max() + 1 if n else 0)
        assert (np.diff(lcols[b, live]) >= 0).all()  # a W chunk's slots are consecutive
    wmap = tb.wmap.numpy()
    assert tb.window_blocks[0] == 0 and tb.window_blocks[-1] == tb.n_blocks
    for w in range(tb.n_windows):
        lo, hi = tb.window_blocks[w], tb.window_blocks[w + 1]
        assert hi > lo and (wmap[lo:hi] == w).all()  # an empty window has its pad block
    part_window, part_blocks, window_parts = tsp.dedup_parts(tb.window_blocks, target,
                                                             tsp.dedup_block_cost(meta))
    assert part_blocks[0] == 0 and part_blocks[-1] == tb.n_blocks
    assert (np.diff(part_blocks) >= 1).all()  # each block in exactly one part
    for w in range(tb.n_windows):  # a window's parts: consecutive, its blocks exactly
        p0, p1 = window_parts[w], window_parts[w + 1]
        assert p1 > p0 and (part_window[p0:p1] == w).all()
        assert part_blocks[p0] == tb.window_blocks[w] and part_blocks[p1] == tb.window_blocks[w + 1]
    if target >= tb.n_blocks:  # parts as small as the costs allow
        cost = tsp.dedup_block_cost(meta)
        assert np.add.reduceat(cost, part_blocks[:-1]).max() <= 2 * cost.max()
    x = np.random.default_rng(5).standard_normal((shape[1], 16)).astype(np.float32)
    want = tsp.blocked_spmm_reference(tb, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(_emulate_dedup(tb, x, target), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_dedup_parts_fill_the_card():
    # at ML-1M density (10 windows of 256 rows) a CTA a window would leave
    # most of 132 SMs idle: the parts fill them in one wave, and a window
    # with more blocks gets more parts
    shape, rows, cols, vals, _ = _coo("dense_windows")
    tb = tsp.pack_blocked_dedup(rows, cols, vals, shape, device="cpu", edge_block=64,
                                row_block=32, unique_block=16)
    target = tsp.dedup_target(tb, 128, 2, 132)
    assert target == 132 * min(tsp._SM_SMEM // tsp._dedup_smem(tb, 2), 4)
    per_sm_f32 = min(tsp._SM_SMEM // tsp._dedup_smem(tb, 4), 4)
    assert tsp.dedup_target(tb, 256, 4, 132) == 132 * per_sm_f32 // 4  # f32: 64-feature slices
    for t in (7, 40, 1000):
        part_window, part_blocks, window_parts = tsp.dedup_parts(tb.window_blocks, t)
        assert tb.n_windows <= part_window.shape[0] <= max(t, tb.n_windows)
    per_window = np.diff(tsp.dedup_parts(tb.window_blocks, 40)[2])
    nb = np.diff(tb.window_blocks)
    assert per_window[np.argmax(nb)] == per_window.max() > 1
    assert tsp.dedup_parts(tb.window_blocks, 1)[0].shape[0] == tb.n_windows
    # with costs, a window holding a costly block is cut at that block, and
    # no part of a window costs more than its even share plus one block
    nb = int(np.diff(tb.window_blocks)[0])
    cost = np.ones(tb.n_blocks)
    cost[nb // 2] = nb
    part_window, part_blocks, window_parts = tsp.dedup_parts(tb.window_blocks,
                                                             4 * tb.n_windows, cost)
    assert nb // 2 in part_blocks and window_parts[1] >= 2
    part_cost = np.add.reduceat(cost, part_blocks[:-1])
    w_cost = np.add.reduceat(cost, np.asarray(tb.window_blocks[:-1]))
    share = w_cost[part_window] / np.diff(window_parts)[part_window]
    assert (part_cost <= share + cost.max()).all()
    with pytest.raises(ValueError, match="row_block <= 256"):
        tsp.pack_blocked_dedup(rows, cols, vals, shape, device="cpu", row_block=512)


@pytest.mark.parametrize("target", [1, 66, 1000])
@pytest.mark.parametrize("tiles", [{}, dict(edge_block=64, row_block=32, unique_block=16)],
                         ids=["default", "small"])
def test_dedup_int8_parts_cover_each_block_once(tiles, target):
    # the int8 kernel's parts (dedup_parts with its own block cost) on the
    # ML-1M-density stand-in: every block in exactly one part, the parts in
    # block order, each window's parts consecutive and covering its blocks
    shape, rows, cols, vals, _ = _coo("dense_windows")
    tb = tsp.pack_blocked_dedup(rows, cols, vals, shape, device="cpu", **tiles)
    meta = tb.block_meta.numpy()
    cost = tsp.dedup_int8_block_cost(meta)
    n_live = meta[:, tsp.DEDUP_WARPS * tsp.DEDUP_ROWS_PER_WARP]
    np.testing.assert_array_equal(cost, 2 + -(-n_live // 128))  # staging, then per 128 slots
    part_window, part_blocks, window_parts = tsp.dedup_parts(tb.window_blocks, target, cost)
    assert part_blocks[0] == 0 and part_blocks[-1] == tb.n_blocks
    assert (np.diff(part_blocks) >= 1).all()
    assert window_parts[0] == 0 and window_parts[-1] == part_window.shape[0]
    assert (np.diff(part_window) >= 0).all()
    for w in range(tb.n_windows):
        p0, p1 = window_parts[w], window_parts[w + 1]
        assert p1 > p0 and (part_window[p0:p1] == w).all()
        assert part_blocks[p0] == tb.window_blocks[w] and part_blocks[p1] == tb.window_blocks[w + 1]
    assert part_window.shape[0] <= max(target, tb.n_windows)
    if target >= tb.n_blocks:  # parts as small as the costs allow
        assert np.add.reduceat(cost, part_blocks[:-1]).max() <= 2 * cost.max()


def _bf16(v):
    return torch.as_tensor(np.float32(v)).bfloat16().float().item()


def _emulate_dedup_int8(tb, x, target):
    """The int8 dedup kernel's walk in numpy: per part its blocks; per
    block, W of each (row, column) run = bf16(f32 sum of its bf16-rounded
    values), added as W * q[u] into the row's f64 sum; a window of one
    part dequantised straight away, a split window's f64 tiles added in
    part order first."""
    q, s = tsp.quantize_int8(torch.as_tensor(x))
    q, s = q.numpy().astype(np.float64), s.numpy()
    rc, slot, meta = tb.order_rc.numpy(), tb.order_slot.numpy(), tb.block_meta.numpy()
    vals, ucols = tb.vals.numpy().reshape(-1), tb.ucols.numpy()
    n_groups = tsp.DEDUP_WARPS * tsp.DEDUP_ROWS_PER_WARP
    part_window, part_blocks, window_parts = tsp.dedup_parts(
        tb.window_blocks, target, tsp.dedup_int8_block_cost(meta))
    tiles = np.zeros((part_window.shape[0], tb.rb, x.shape[1]), np.float64)
    for p in range(part_window.shape[0]):
        for b in range(part_blocks[p], part_blocks[p + 1]):
            xs = q[ucols[b, : meta[b, n_groups + 1]]]
            for k in range(n_groups):
                row = (k % tsp.DEDUP_ROWS_PER_WARP) * tsp.DEDUP_WARPS + k // tsp.DEDUP_ROWS_PER_WARP
                run = np.float32(0)
                for t in range(meta[b, k], meta[b, k + 1]):
                    run = np.float32(run + np.float32(_bf16(vals[slot[b, t]])))
                    if t + 1 == meta[b, n_groups] or rc[b, t + 1] != rc[b, t]:
                        tiles[p, row] += _bf16(run) * xs[rc[b, t] & 0xFFFF]
                        run = np.float32(0)
    out = np.zeros((tb.n_windows * tb.rb, x.shape[1]), np.float32)
    for w in range(tb.n_windows):
        total = tiles[window_parts[w]].copy()
        for p in range(window_parts[w] + 1, window_parts[w + 1]):
            total += tiles[p]
        out[w * tb.rb:(w + 1) * tb.rb] = total.astype(np.float32) * s
    return out[: tb.nrows]


@pytest.mark.parametrize("target", [1, 1000], ids=["whole_windows", "split_windows"])
@pytest.mark.parametrize("case", ["random", "empty_windows", "hub_small_tiles", "dense_windows"])
def test_dedup_int8_walk_matches_plain_bit_for_bit(case, target):
    # the int8 kernel's walk over its parts, with its f64 sums, equals the
    # plain version bit for bit whether a window is one part or several
    shape, rows, cols, vals, tiles = _coo(case)
    tb = tsp.pack_blocked_dedup(rows, cols, vals, shape, device="cpu", **tiles)
    tb = tb.replace(int8=True)
    x = np.random.default_rng(7).standard_normal((shape[1], 32)).astype(np.float32)
    want = tsp.blocked_spmm_reference(tb, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(_emulate_dedup_int8(tb, x, target), want)


def test_wrapper_refuses_other_devices():
    shape, rows, cols, vals, _ = _coo("random")
    tb = tsp.pack_blocked(rows, cols, vals, shape, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tsp.blocked_spmm(tb, torch.zeros(shape[1], 8, device="meta"))


@pytest.mark.parametrize("dedup", [False, True], ids=["int8", "dedup_int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_int8_reference_matches_pallas_interpret(case, dedup):
    shape, jb, tb = _pack_both(case, dedup)
    jb, tb = jb.replace(int8=True), tb.replace(int8=True)
    x = np.random.default_rng(2).standard_normal((shape[1], 32)).astype(np.float32)
    want = np.asarray(jsp._blocked_spmm_fwd_only(jb, jnp.asarray(x), None, interpret=True))
    got = tsp.blocked_spmm(tb, torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (shape[0], 32)
    # the same int8 table, bf16 edge values and bf16 W, f32 sums: only the
    # order of the f32 sums differs (and the dequantisation multiply, which
    # both apply to the finished sum)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_int8_table_bit_for_bit():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((500, 48)).astype(np.float32)
    x[:, 3] = 0.0  # an all-zero column takes the 1e-12 floor
    x[7, 5] = 127.0 * 0.5  # exact .5 quotients round half to even
    x[:, 6] = np.arange(500, dtype=np.float32) - 250.0
    s = np.maximum(np.abs(x).max(0) / 127.0, 1e-12)
    jq = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / jnp.asarray(s)[None, :]), -127, 127)
                    .astype(jnp.int8))
    jscale = np.asarray(jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x)), axis=0) / 127.0, 1e-12))
    q, scale = tsp.quantize_int8(torch.as_tensor(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(scale.numpy(), jscale)
    np.testing.assert_array_equal(q.numpy(), jq)
    assert np.abs(q.numpy()).max() == 127
    # against the JAX int8 branch itself (segment_spmm.py:569-571): a zero
    # column and columns of exact half-way quotients (s = 1 and s = 0.5:
    # round half to even); the wrapper takes the plain version on the CPU
    x2 = rng.standard_normal((256, 32)).astype(np.float32)
    x2[:, 0] = 0.0
    x2[:, 1] = np.concatenate([[127.0], np.arange(255) * 0.5 - 63.5])
    x2[:, 2] = x2[:, 1] * 0.5
    jx = jnp.asarray(x2)
    js = jnp.maximum(jnp.max(jnp.abs(jx), axis=0) / 127.0, 1e-12)
    jq2 = jnp.clip(jnp.round(jx / js[None, :]), -127, 127).astype(jnp.int8)
    for q2, s2 in (tsp.quantize_int8(torch.as_tensor(x2)),
                   tsp.quantize_int8_fused(torch.as_tensor(x2))):
        np.testing.assert_array_equal(s2.numpy(), np.asarray(js))
        np.testing.assert_array_equal(q2.numpy(), np.asarray(jq2))
    assert float(s2[0]) == np.float32(1e-12) and (q2[:, 0] == 0).all()
    assert float(s2[1]) == 1.0 and float(s2[2]) == 0.5
    np.testing.assert_array_equal(q2[:, 1].numpy(), np.round(x2[:, 1]))  # half to even
    assert (np.abs(x2[1:, 1] % 1) == 0.5).sum() > 100  # ties, both parities


@pytest.mark.parametrize("with_vals", [False, True], ids=["x", "x_and_vals"])
@pytest.mark.parametrize("dedup", [False, True], ids=["base", "dedup"])
def test_blocked_spmm_grads_match_jax(dedup, with_vals):
    shape, jb, tb = _pack_both("random_small_tiles", dedup)
    _, rows, _, vals, _ = _coo("random_small_tiles")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((shape[1], 16)).astype(np.float32)
    w = rng.standard_normal((shape[0], 16)).astype(np.float32)
    v = (vals * rng.uniform(0.5, 1.5, vals.shape[0])).astype(np.float32)  # runtime values

    def jloss(xx, vv):
        out = jsp.blocked_spmm(jb, xx, vv if with_vals else None, True)
        return jnp.sum(out * jnp.asarray(w))

    jl, (jgx, jgv) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(v))
    tx = torch.tensor(x, requires_grad=True)
    tv = torch.tensor(v, requires_grad=True)
    out = tsp.blocked_spmm(tb, tx, tv if with_vals else None)
    tl = torch.sum(out * torch.as_tensor(w))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    if with_vals:
        np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgv), rtol=1e-5, atol=1e-5)
        assert np.all(tv.grad.numpy()[rows >= shape[0]] == 0)  # pads get no gradient
    else:
        assert tv.grad is None


def test_one_sided_spmm_grads_on_a_dropped_adjacency_match_jax():
    # HCCF's path: A_drop @ X, one-sided (no transposed layout), its VJP's
    # dx and dvals against jax.vjp of the JAX blocked_spmm in interpret mode
    from hypergraph_diffusion_for_recommendation_tpu.ops import dropout as jdrop
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops import dropout as tdrop

    shape, jb, tb = _pack_both("hub_small_tiles", False, canon=False)
    _, rows, _, vals, _ = _coo("hub_small_tiles")
    key = (2**31 + 17, 991)
    ids = np.arange(vals.shape[0])
    jkeep = np.asarray(jdrop.hash_keep_mask(jnp.asarray(np.array(key, np.uint32)),
                                            jnp.asarray(ids.astype(np.uint32)), 0.5))
    tkeep = tdrop.hash_keep_mask(key, torch.as_tensor(ids), 0.5).numpy()
    np.testing.assert_array_equal(tkeep, jkeep)
    assert 0 < jkeep.sum() < jkeep.size
    v = np.where(jkeep, vals / np.float32(0.5), 0.0).astype(np.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((shape[1], 16)).astype(np.float32)
    g = rng.standard_normal((shape[0], 16)).astype(np.float32)
    jout, vjp = jax.vjp(lambda xx, vv: jsp.blocked_spmm(jb, xx, vv, True), jnp.asarray(x),
                        jnp.asarray(v))
    jdx, jdv = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    tv = torch.tensor(v, requires_grad=True)
    out = tsp.blocked_spmm(tb, tx, tv)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jdv), rtol=1e-5, atol=1e-5)
    assert np.all(tv.grad.numpy()[rows >= shape[0]] == 0)  # pads get no gradient
