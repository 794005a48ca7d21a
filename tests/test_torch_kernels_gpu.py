"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests need a CUDA GPU (marker `gpu`) and skip without one.
The file imports no JAX, so that it also runs where JAX is missing:

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest -o addopts="" -m gpu
"""

import numpy as np
import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as tsp
from hypergraph_diffusion_for_recommendation_tpu_torch.ops import topk as tt
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import topk_select as tsel
from _int8_walk import SPAN_F64_ROWS, int8_row_scales, span_graph


def _hub_graph():
    # a hub row with thousands of edges beside sparse rows, padded COO
    rng = np.random.default_rng(0)
    n, m = 600, 400
    rows = np.concatenate([np.zeros(3000, np.int64), rng.integers(1, n, 2000)])
    cols = np.concatenate([rng.integers(0, m, 3000), rng.integers(0, m, 2000)])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    order = np.lexsort((cols, rows))
    rows = np.concatenate([rows[order], np.full(5, n)]).astype(np.int32)
    cols = np.concatenate([cols[order], np.zeros(5, np.int64)]).astype(np.int32)
    vals = np.concatenate([vals[order], np.zeros(5, np.float32)])
    return (n, m), rows, cols, vals


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", [{}, dict(edge_block=64, row_block=32)], ids=["default", "small"])
@pytest.mark.parametrize("dedup", [False, True], ids=["base", "dedup"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_cuda_kernels_match_plain(cuda, tiles, dedup, mode):
    shape, rows, cols, vals = _hub_graph()
    pack = tsp.pack_blocked_dedup if dedup else tsp.pack_blocked
    extra = dict(unique_block=16) if dedup and tiles else {}
    tb = pack(rows, cols, vals, shape, bf16=mode == "bf16", device=cuda, **tiles, **extra)
    tb = tb.replace(int8=mode == "int8")
    x = torch.randn(shape[1], 128, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    before = dict(tsp.LAUNCHES)
    got = tsp.blocked_spmm(tb, x)
    torch.cuda.synchronize()
    name = ("segment_spmm_dedup" if dedup else "segment_spmm_rows") + (
        "_int8" if mode == "int8" else "")
    assert tsp.LAUNCHES[name] == before[name] + 1
    want = tsp.blocked_spmm_reference(tb, x)
    # the same products summed in another f32 order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    # empty rows come out zero
    empty = np.setdiff1d(np.arange(shape[0]), rows[rows < shape[0]])
    assert empty.size and float(got[torch.as_tensor(empty, device=cuda)].abs().max()) == 0.0


def _one_block_graph():
    # 300 edges on 100 rows: one window whose edges fill one block of either
    # layout (the packers add seven all-pad blocks to reach a multiple of 8)
    rng = np.random.default_rng(3)
    n, m = 100, 80
    rows, cols = rng.integers(0, n, 300), rng.integers(0, m, 300)
    order = np.lexsort((cols, rows))
    vals = rng.standard_normal(300).astype(np.float32)
    rows = np.concatenate([rows[order], np.full(3, n)]).astype(np.int32)
    cols = np.concatenate([cols[order], np.zeros(3, np.int64)]).astype(np.int32)
    return (n, m), rows, cols, np.concatenate([vals[order], np.zeros(3, np.float32)])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 256])
@pytest.mark.parametrize("graph", ["hub", "one_block"])
@pytest.mark.parametrize("kernel", ["rows", "dedup_whole_windows", "dedup_split_windows"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_redesigned_kernels_match_plain_and_repeat(cuda, mode, kernel, graph, d):
    # kernels 1 and 3 on a hub row far longer than one CTA's warps' share
    # (3000 slots) and on a window of one block; kernels 2 and 4 with each
    # window in one part and with a part per block (the second pass sums the
    # parts' tiles); the narrowest and a wide d (int8 takes d % 32 == 0: 32
    # for the narrowest). All write every row once in a fixed order: two
    # calls give the same bits; the int8 kernels' f64 sums are exact, so they
    # equal the plain version bit for bit
    shape, rows, cols, vals = _hub_graph() if graph == "hub" else _one_block_graph()
    dedup = kernel.startswith("dedup")
    pack = tsp.pack_blocked_dedup if dedup else tsp.pack_blocked
    tb = pack(rows, cols, vals, shape, bf16=mode == "bf16", device=cuda)
    tb = tb.replace(int8=mode == "int8")
    if mode == "int8":
        d = max(d, 32)
    if graph == "one_block":
        live_blocks = (tb.local_rows < tb.rb).any(dim=1)
        assert tb.n_windows == 1 and int(live_blocks.sum()) == 1
    else:
        assert int((rows == 0).sum()) > tsp.WARPS_PER_CTA * tsp.ROW_SLOTS  # the hub row
    x = torch.randn(shape[1], d, device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    target = {"dedup_whole_windows": 1, "dedup_split_windows": 10**6}.get(kernel)
    name = ("segment_spmm_dedup" if dedup else "segment_spmm_rows") + (
        "_int8" if mode == "int8" else "")
    before = tsp.LAUNCHES[name]
    got = tsp._launch(tb, x, target)
    again = tsp._launch(tb, x, target)
    torch.cuda.synchronize()
    assert tsp.LAUNCHES[name] == before + 2
    assert torch.equal(got, again)
    want = tsp.blocked_spmm_reference(tb, x)
    if mode == "int8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    empty = np.setdiff1d(np.arange(shape[0]), rows[rows < shape[0]])
    if empty.size:
        assert float(got[torch.as_tensor(empty, device=cuda)].abs().max()) == 0.0


def _int8_x(m, d, device, seed):
    # an all-zero column (s = 1e-12, q = 0), columns whose maxima give q = +-127 and one of q =
    # 127 throughout (where one int32 sum of a long hub share would overflow)
    x = torch.randn(m, d, device=device, generator=torch.Generator(device).manual_seed(seed))
    x[:, 2] = 1.0
    x[:, 3] = 0.0
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 128, 256, 544])
@pytest.mark.parametrize("graph", ["hub", "span"])
def test_rows_int8_bit_for_bit_and_repeats(cuda, graph, d):
    # kernel 3 equals its plain version bit for bit on both its paths (the
    # integer sums and the f64 sums), hub rows and rows whose least exponent
    # takes the f64 conversion included, at widths of 1 to 32 lanes a team
    # and of two feature passes (544); two calls give the same bits
    shape, rows, cols, vals = _hub_graph() if graph == "hub" else span_graph()
    tb = tsp.pack_blocked(rows, cols, vals, shape, device=cuda).replace(int8=True)
    t, fast = int8_row_scales(tb)
    if graph == "span":
        assert sorted(np.nonzero(~fast)[0]) == SPAN_F64_ROWS
        assert t[7] == -133 and t[11] == 97 and t[12] == -7
    x = _int8_x(shape[1], d, cuda, 6)
    before = dict(tsp.LAUNCHES)
    got = tsp.blocked_spmm(tb, x)
    again = tsp.blocked_spmm(tb, x)
    torch.cuda.synchronize()
    assert tsp.LAUNCHES["segment_spmm_rows_int8"] == before["segment_spmm_rows_int8"] + 2
    assert tsp.LAUNCHES["quantize_int8"] == before["quantize_int8"] + 2
    assert torch.equal(got, again)
    assert torch.equal(got, tsp.blocked_spmm_reference(tb, x))


@pytest.mark.gpu
@pytest.mark.parametrize("dedup", [False, True], ids=["int8", "dedup_int8"])
def test_int8_kernels_replay_in_a_cuda_graph(cuda, dedup):
    # the quantisation and the int8 kernel captured in a CUDA graph: a replay
    # on new X equals the eager call bit for bit, and kernel 3's the plain
    # version (kernel 4's plain W sums a run's values with atomics on the
    # card, whose order can change a bf16 rounding of the hub row's runs)
    shape, rows, cols, vals = span_graph()
    pack = tsp.pack_blocked_dedup if dedup else tsp.pack_blocked
    tb = pack(rows, cols, vals, shape, device=cuda).replace(int8=True)
    x = _int8_x(shape[1], 128, cuda, 7)
    tsp.blocked_spmm(tb, x)  # the eager first call (the dedup parts are cut on the host)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tsp.blocked_spmm(tb, x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tsp.blocked_spmm(tb, x)
    x.copy_(_int8_x(shape[1], 128, cuda, 8))
    graph.replay()
    eager = tsp.blocked_spmm(tb, x)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    if not dedup:
        assert torch.equal(out, tsp.blocked_spmm_reference(tb, x))


@pytest.mark.gpu
def test_rows_int8_runs_one_kernel_after_the_quantisation(cuda):
    # a call of kernel 3 is three launches on the card: the quantisation's two
    # and the SpMM, which writes the dequantised output itself (no f64
    # scratch, no dequantisation pass); the wrappers count one launch each.
    # The profiler now and then loses a kernel event, never adds one, so a
    # short trace is taken again
    shape, rows, cols, vals = span_graph()
    tb = tsp.pack_blocked(rows, cols, vals, shape, device=cuda).replace(int8=True)
    x = _int8_x(shape[1], 128, cuda, 9)
    tsp.blocked_spmm(tb, x)
    torch.cuda.synchronize()
    before = dict(tsp.LAUNCHES)
    for tries in range(1, 6):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            tsp.blocked_spmm(tb, x)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(names) >= 3:
            break
    assert len(names) == 3, names
    assert sum("segment_spmm_rows_int8_kernel" in n for n in names) == 1, names
    assert sum("column_amax_kernel" in n for n in names) == 1, names
    assert sum("quantise_kernel" in n and "dequantise" not in n for n in names) == 1, names
    assert not any("dequantise" in n for n in names), names
    calls = {k: v - before[k] for k, v in tsp.LAUNCHES.items() if v != before[k]}
    assert calls == {"segment_spmm_rows_int8": tries, "quantize_int8": tries}


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("dedup", [False, True], ids=["int8", "dedup_int8"])
def test_int8_kernels_keep_their_bits_with_the_shared_quantisation(cuda, dedup, d):
    # both int8 kernels on the quantisation kernel's table: one quantisation
    # launch a call, the result bit for bit the plain version's (which
    # quantises with the torch passes)
    shape, rows, cols, vals = _hub_graph()
    pack = tsp.pack_blocked_dedup if dedup else tsp.pack_blocked
    tb = pack(rows, cols, vals, shape, device=cuda).replace(int8=True)
    x = _int8_x(shape[1], d, cuda, 10)
    before = tsp.LAUNCHES["quantize_int8"]
    got = tsp.blocked_spmm(tb, x)
    torch.cuda.synchronize()
    assert tsp.LAUNCHES["quantize_int8"] == before + 1
    assert torch.equal(got, tsp.blocked_spmm_reference(tb, x))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 256])
def test_quantize_kernel_matches_plain_bit_for_bit(cuda, d):
    # the two-launch quantisation against the plain torch passes on the card:
    # a zero column (the 1e-12 floor), a column of exact half-way quotients
    # (round half to even) and rows enough for several chunks of each launch
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2500, d)).astype(np.float32)
    x[:, 3] = 0.0
    x[:, 5] = np.concatenate([[127.0], (np.arange(2499) % 499 - 249) * 0.5])  # s = 1
    x = torch.as_tensor(x, device=cuda)
    before = tsp.LAUNCHES["quantize_int8"]
    q, s = tsp.quantize_int8_fused(x)
    torch.cuda.synchronize()
    assert tsp.LAUNCHES["quantize_int8"] == before + 1
    q_p, s_p = tsp.quantize_int8(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert torch.equal(s, s_p) and torch.equal(q, q_p)
    assert float(s[3]) == np.float32(1e-12) and int(q[:, 3].abs().max()) == 0
    assert float(s[5]) == 1.0  # q = x rounded half to even, as numpy rounds
    np.testing.assert_array_equal(q[:, 5].cpu().numpy(), np.round(x[:, 5].cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("nnz", [0, 40], ids=["empty", "small"])
def test_every_cuda_matrix_gets_a_kernel_layout(cuda, nnz):
    # matrices far smaller than the serving path's still get the packed
    # layout on the card, and `spmm` runs the kernel on them
    from hypergraph_diffusion_for_recommendation_tpu_torch.data.device import make_adj_pair
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.sparse import spmm

    rng = np.random.default_rng(1)
    n, m = 30, 20
    rows, cols = rng.integers(0, n, nnz), rng.integers(0, m, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    pair = make_adj_pair(rows, cols, vals, (n, m), cuda)
    assert pair.fwd.blocked is not None and pair.bwd.blocked is not None
    x = torch.randn(m, 128, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    before = sum(tsp.LAUNCHES.values())
    got = spmm(pair.fwd, x)
    torch.cuda.synchronize()
    assert sum(tsp.LAUNCHES.values()) == before + (1 if nnz else 0)  # no edges: nothing to launch
    dense = np.zeros((n, m), np.float32)
    np.add.at(dense, (rows, cols), vals)
    want = torch.as_tensor(dense) @ x.cpu()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cuda_wrapper_checks_its_input(cuda):
    shape, rows, cols, vals = _hub_graph()
    tb = tsp.pack_blocked(rows, cols, vals, shape, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        tsp.blocked_spmm(tb, torch.zeros(shape[1], 128, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="rows"):
        tsp.blocked_spmm(tb, torch.zeros(shape[1] + 1, 128, device=cuda))
    with pytest.raises(ValueError, match="int32"):
        tsp.blocked_spmm(tb.replace(cols=tb.cols.long()), torch.zeros(shape[1], 128, device=cuda))
    # a width the kernel does not take is padded with zero columns, not refused
    # (the int8 kernels take d % 32 == 0): the kernel runs on d 32, sliced to 24
    x = torch.randn(shape[1], 24, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    padded, launches = tsp.PADDED["calls"], tsp.LAUNCHES["segment_spmm_rows_int8"]
    got = tsp.blocked_spmm(tb.replace(int8=True), x)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], 24) and got.is_contiguous()
    assert tsp.PADDED["calls"] == padded + 1
    assert tsp.LAUNCHES["segment_spmm_rows_int8"] == launches + 1
    assert torch.equal(got, tsp.blocked_spmm_reference(tb.replace(int8=True), x))


@pytest.mark.gpu
@pytest.mark.parametrize("with_vals", [False, True], ids=["x", "x_and_vals"])
def test_blocked_spmm_gradient_reaches_x(cuda, with_vals):
    # a kernel launch on a tensor that needs a gradient goes through the
    # autograd Function: the result has a grad_fn and X (and the runtime
    # values) get the VJP's gradient, as on the CPU
    shape, rows, cols, vals = _hub_graph()
    tb = tsp.pack_blocked(rows, cols, vals, shape, device=cuda)
    gen = torch.Generator(cuda).manual_seed(2)
    x = torch.randn(shape[1], 128, device=cuda, generator=gen, requires_grad=True)
    v = torch.as_tensor(vals, device=cuda).requires_grad_(with_vals)
    w = torch.randn(shape[0], 128, device=cuda, generator=gen)
    out = tsp.blocked_spmm(tb, x, v if with_vals else None)
    assert out.grad_fn is not None
    (out * w).sum().backward()
    xc = x.detach().cpu().requires_grad_(True)
    vc = torch.as_tensor(vals).requires_grad_(with_vals)
    tc = tsp.pack_blocked(rows, cols, vals, shape, device="cpu")
    (tsp.blocked_spmm(tc, xc, vc if with_vals else None) * w.cpu()).sum().backward()
    torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=1e-5, atol=1e-4)
    if with_vals:
        torch.testing.assert_close(v.grad.cpu(), vc.grad, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dedup", [False, True], ids=["base", "dedup"])
def test_blocked_spmm_backward_repeats_bit_for_bit(cuda, dedup):
    # the VJP's dx and dvals sum in a fixed order on the card (no atomics),
    # so that two backward calls, and a replayed step and its eager step,
    # give the same bits
    shape, rows, cols, vals = _hub_graph()
    pack = tsp.pack_blocked_dedup if dedup else tsp.pack_blocked
    tb = pack(rows, cols, vals, shape, device=cuda)
    gen = torch.Generator(cuda).manual_seed(3)
    x = torch.randn(shape[1], 128, device=cuda, generator=gen)
    w = torch.randn(shape[0], 128, device=cuda, generator=gen)
    grads = []
    for _ in range(2):
        xx = x.clone().requires_grad_(True)
        vv = torch.as_tensor(vals, device=cuda).requires_grad_(True)
        (tsp.blocked_spmm(tb, xx, vv) * w).sum().backward()
        grads.append((xx.grad, vv.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


@pytest.mark.gpu
@pytest.mark.parametrize("gather_layout", ["base", "dedup", "int8", "dedup_int8"])
def test_spmm_pair_backward_launches_the_kernel(cuda, gather_layout):
    # the backward of A @ X is A^T @ g on the transposed layout: one more
    # launch of the same kernel, and the gradient the plain version gives
    from hypergraph_diffusion_for_recommendation_tpu_torch.data.device import make_adj_pair
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.sparse import spmm_pair

    shape, rows, cols, vals = _hub_graph()
    live = rows < shape[0]
    pair = make_adj_pair(rows[live], cols[live], vals[live], shape, cuda,
                         gather_layout=gather_layout)
    name = ("segment_spmm_dedup" if gather_layout.startswith("dedup") else "segment_spmm_rows"
            ) + ("_int8" if gather_layout.endswith("int8") else "")
    gen = torch.Generator(cuda).manual_seed(3)
    x = torch.randn(shape[1], 128, device=cuda, generator=gen, requires_grad=True)
    w = torch.randn(shape[0], 128, device=cuda, generator=gen)
    before = tsp.LAUNCHES[name]
    (spmm_pair(pair.fwd, pair.bwd, x) * w).sum().backward()
    torch.cuda.synchronize()
    assert tsp.LAUNCHES[name] == before + 2
    want = tsp.blocked_spmm_reference(pair.bwd.blocked, w)
    scale = float(want.abs().max())
    torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-5 * scale)


def _probe_case(case: str, device):
    """(layout, X, gather indices): the probe's data at a small size; an
    nnz that is not a multiple of the edge blocks; or rows in the first and
    last windows only, so the windows between have one all-pad block."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.bench.gather_fusion import make_probe

    if case != "empty_windows":
        nnz = 8192 if case == "probe" else 8192 - 333
        p = make_probe(device, n=3000, d=128, nnz=nnz, eb=1024)
        return p.blocked, p.x, p.idx
    rng = np.random.default_rng(4)
    n, nnz = 1100, 1500
    rows = np.sort(np.concatenate([rng.integers(0, 200, 1000), rng.integers(1030, n, nnz - 1000)]))
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(np.float32)
    blocked = tsp.pack_blocked(rows, cols, vals, (n, n), device=device)
    x = torch.randn(n, 128, device=device, generator=torch.Generator(device).manual_seed(5))
    return blocked, x, torch.as_tensor(cols.astype(np.int32), device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["probe", "ragged_nnz", "empty_windows"])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_probe_kernels_match_plain(cuda, case, mode):
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import gather_fusion as G

    blocked, x, idx = _probe_case(case, cuda)
    blocked = blocked.replace(bf16=mode == "bf16")
    table = x if mode == "f32" else x.to(torch.bfloat16)
    before = dict(G.LAUNCHES)
    got_g = G.resident_row_gather(table, idx)
    got_f = G.fused_window_spmm(blocked, x)
    again = G.fused_window_spmm(blocked, x)
    torch.cuda.synchronize()
    assert G.LAUNCHES["resident_row_gather"] == before["resident_row_gather"] + 1
    assert G.LAUNCHES["fused_window_spmm"] == before["fused_window_spmm"] + 2
    # each row summed by one warp in a fixed order, no atomics: the same bits
    assert torch.equal(got_f, again)
    # the gather copies rows: exactly the plain version's
    assert torch.equal(got_g, G.resident_row_gather_reference(table, idx))
    want = G.fused_window_spmm_reference(blocked, x)
    assert got_f.shape == want.shape == (blocked.nrows, 128)
    # the same products summed in another f32 order
    torch.testing.assert_close(got_f, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    if case == "empty_windows":
        assert float(got_f[200:1030].abs().max()) == 0.0


@pytest.mark.gpu
def test_probe_wrappers_check_their_input(cuda):
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import gather_fusion as G

    blocked, x, idx = _probe_case("probe", cuda)
    with pytest.raises(ValueError, match="int32"):
        G.resident_row_gather(x, idx.long())
    with pytest.raises(ValueError, match="16 B"):
        G.resident_row_gather(torch.zeros(10, 3, device=cuda), idx)
    with pytest.raises(ValueError, match="d % 32"):
        G.fused_window_spmm(blocked, torch.zeros(x.shape[0], 48, device=cuda))
    with pytest.raises(ValueError, match="base layout"):
        G.fused_window_spmm(blocked.replace(int8=True), x)


@pytest.mark.gpu
def test_hd_forward_and_backward_launch_on_b_hyper(cuda):
    # HGNN_HD3's encode runs 8 products on the square CF adjacency and 16 on
    # the rectangular b_hyper incidence (the group view's HWNN layers); a
    # training step runs each again backward. Through the kernels and through
    # the plain versions the loss and gradients agree.
    from unittest import mock

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import (
        build_cf_device_data,
        build_interaction,
        synthetic_dataset,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse

    train, test, _ = synthetic_dataset(n_users=300, n_items=500, mean_degree=12.0, seed=2)
    cf = build_cf_device_data(build_interaction(train, test), cuda, needs={"adj", "b_hyper"})
    n_u, n_i = cf.n_users, cf.n_items
    b = cf.b_hyper.fwd.blocked
    assert b is not None and (b.nrows, b.ncols) == (n_u, n_i) and n_u != n_i
    bundle = build_model(make_config("HGNN_HD3", hyper_dim=32, batch_size=256), cf)
    bundle.init(torch.Generator().manual_seed(0))
    calls = []
    real = tsp.blocked_spmm

    def counted(blocked, x, vals=None):
        calls.append((blocked.nrows, blocked.ncols))
        return real(blocked, x, vals)

    with mock.patch.object(sparse, "blocked_spmm", counted):
        u, i = bundle.encode_eval({})
    assert u.shape == (n_u, 32) and i.shape == (n_i, 32) and torch.isfinite(u).all()
    square = sum(1 for s in calls if s == (n_u + n_i,) * 2)
    assert (square, len(calls) - square) == (8, 16)

    gen = torch.Generator(cuda)
    batch = tuple(torch.as_tensor(a[:256], device=cuda).int() for a in
                  (cf.edge_u, cf.edge_i, torch.roll(cf.edge_i, 7)))
    params = list(bundle.module.parameters())

    def step(fn):
        with mock.patch.object(sparse, "blocked_spmm", fn):
            loss, _ = bundle.batch_loss({}, batch, ((11, 12),), gen.manual_seed(3))
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            return float(loss.detach()), grads

    before = sum(tsp.LAUNCHES.values())
    loss_k, grads_k = step(real)
    torch.cuda.synchronize()
    assert sum(tsp.LAUNCHES.values()) == before + 48
    loss_p, grads_p = step(tsp.blocked_spmm_reference)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for gk, gp in zip(grads_k, grads_p):
        assert gk is not None and gp is not None
        torch.testing.assert_close(gk, gp, rtol=1e-4, atol=1e-4 * float(gp.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("gather_layout", ["base", "dedup"])
@pytest.mark.parametrize("d", [1, 5])
def test_narrow_operand_runs_the_kernel_padded(cuda, gather_layout, d):
    # AutoCF's [n, 1] operands: the wrapper pads X to width 8, launches the
    # same kernel, and slices; the backward of spmm_pair pads its [m, d]
    # gradient likewise. Both equal the plain version on the narrow X.
    from hypergraph_diffusion_for_recommendation_tpu_torch.data.device import make_adj_pair
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.sparse import spmm_pair

    shape, rows, cols, vals = _hub_graph()
    live = rows < shape[0]
    pair = make_adj_pair(rows[live], cols[live], vals[live], shape, cuda,
                         gather_layout=gather_layout)
    name = "segment_spmm_dedup" if gather_layout == "dedup" else "segment_spmm_rows"
    gen = torch.Generator(cuda).manual_seed(4)
    x = torch.randn(shape[1], d, device=cuda, generator=gen, requires_grad=True)
    w = torch.randn(shape[0], d, device=cuda, generator=gen)
    before, padded = tsp.LAUNCHES[name], tsp.PADDED["calls"]
    y = spmm_pair(pair.fwd, pair.bwd, x)
    (y * w).sum().backward()
    torch.cuda.synchronize()
    assert tsp.LAUNCHES[name] == before + 2 and tsp.PADDED["calls"] == padded + 2
    assert y.shape == (shape[0], d) and x.grad.shape == (shape[1], d)
    want = tsp.blocked_spmm_reference(pair.fwd.blocked, x.detach())
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    want_dx = tsp.blocked_spmm_reference(pair.bwd.blocked, w)
    torch.testing.assert_close(x.grad, want_dx, rtol=1e-5,
                               atol=1e-5 * float(want_dx.abs().max()))


@pytest.mark.gpu
def test_autocf_refresh_and_keep_graphs_replay_their_eager_steps(cuda):
    # AutoCF's two step graphs on the card: the refresh branch draws its
    # subgraphs from the trainer's generator inside its graph (width-1
    # products included); 12 replayed steps equal 12 eager steps bit for bit
    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import (
        build_cf_device_data,
        build_interaction,
        synthetic_dataset,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer

    train, test, _ = synthetic_dataset(n_users=300, n_items=500, mean_degree=12.0, seed=2)
    cf = build_cf_device_data(build_interaction(train, test), cuda, needs={"adj", "raw_adj"})
    bundle = build_model(make_config("AutoCF", embedding_size=32, batch_size=256), cf)
    runs = []
    for graphs in (None, False):
        tr = Trainer(bundle, seed=0, graphs=graphs)
        batches = tr.sample_epoch()
        losses = [tr.train_step(tuple(t[s % batches[0].shape[0]] for t in batches), ())[0]
                  .clone() for s in range(12)]
        torch.cuda.synchronize()
        runs.append((torch.stack(losses), {k: v.detach().clone() for k, v in
                                           bundle.module.state_dict().items()},
                     {k: v for k, v in tr.extras.items()}))
        if graphs is None:
            assert sorted(tr._step_graphs) == ["keep", "refresh"]
    (lg, pg, eg), (le, pe, ee) = runs
    assert torch.isfinite(lg).all() and torch.equal(lg, le)
    assert all(torch.equal(pg[k], pe[k]) for k in pg)
    assert eg["step"] == ee["step"] == 12
    assert all(torch.equal(eg[k], ee[k]) for k in eg if k != "step")


@pytest.mark.gpu
def test_hub_safe_sum_matches_and_repeats_on_the_card(cuda):
    # AutoCF's decoder sums: one id repeated 200,000 times among others. The
    # two-level fixed-order sum repeats bit for bit and is at least as close
    # to the f64 sum as the plain fixed-order sum, which adds the 200,000
    # terms one after another (its f32 error grows with the run); so is the
    # gather's backward
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse

    gen = torch.Generator(cuda).manual_seed(6)
    n = 5000
    ids = torch.cat([torch.randint(0, n, (100_000,), device=cuda, generator=gen),
                     torch.full((200_000,), 17, device=cuda)])
    ids = ids[torch.randperm(ids.shape[0], device=cuda, generator=gen)]
    values = torch.randn(ids.shape[0], 64, device=cuda, generator=gen)
    exact = torch.zeros(n, 64, dtype=torch.float64, device=cuda).index_add_(0, ids,
                                                                             values.double())
    scale = float(exact.abs().max())

    def err(t):
        return float((t.double() - exact).abs().max()) / scale

    got = sparse.scatter_sum_hubs(values, ids, n)
    assert torch.equal(got, sparse.scatter_sum_hubs(values, ids, n))
    assert err(got) <= max(err(sparse.scatter_sum(values, ids, n)), 1e-6) and err(got) <= 1e-5
    x = torch.randn(n, 64, device=cuda, generator=gen, requires_grad=True)
    grads = []
    for _ in range(2):
        (g,) = torch.autograd.grad((sparse.gather_rows_hubs(x, ids) * values).sum(), x)
        grads.append(g)
    assert torch.equal(grads[0], grads[1]) and err(grads[0]) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["LightGCN", "KHGRec"])
def test_replayed_launches_come_from_the_capture(cuda, model):
    # a replay makes no Python call, so `LAUNCHES` stays still; each step
    # graph carries the wrappers' launches of its capture, which equal an
    # eager step's, and the trainer counts its replays: the replayed steps'
    # launches without the profiler
    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import synthetic_dataset
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer
    from hypergraph_diffusion_for_recommendation_tpu_torch.train.trainer import (
        GRAPH_WARMUP_STEPS,
    )

    kw = dict(hyper_dim=32, relation_dim=16, n_layers=2, batch_size_kg=512,
              compute_dtype="bfloat16") if model == "KHGRec" else dict(embedding_size=32)
    rec = Recommender(make_config(model, batch_size=256, eval_user_batch=128, **kw), cuda)
    rec.build(synthetic_dataset(n_users=300, n_items=500, mean_degree=20.0, seed=3,
                                with_kg=model == "KHGRec"))
    rec.init_weights(0)
    te = Trainer(rec.bundle, seed=0, extras=rec.extras, graphs=False)
    tg = Trainer(rec.bundle, seed=0, extras=rec.extras)
    batches = te.sample_epoch()
    before = dict(tsp.LAUNCHES)
    te.train_step(tuple(t[0] for t in batches), te.epoch_keys(1)[0])
    torch.cuda.synchronize()
    eager = {k: n - before[k] for k, n in tsp.LAUNCHES.items() if n != before[k]}
    assert eager.get("segment_spmm_rows", 0) + eager.get("segment_spmm_dedup", 0) > 0
    tg.run_epoch(0)
    before = dict(tsp.LAUNCHES)
    tg.run_epoch(1)
    torch.cuda.synchronize()
    assert tsp.LAUNCHES == before  # every step of the second epoch a replay
    assert sorted(tg._step_graphs) == ["full"]
    assert tg._step_graphs["full"][0].launches == eager
    replays = 2 * tg.n_batches - GRAPH_WARMUP_STEPS
    assert tg.replays == {"full": replays}
    assert tg.replayed_launches() == {k: replays * n for k, n in eager.items()}
    tg.encode()
    tg.encode()  # cached: no second replay
    assert tg.replays["encode"] == 1
    enc = tg._encode_graph.graph.launches
    assert sum(enc.values()) > 0
    assert tg.replayed_launches() == {k: replays * eager.get(k, 0) + enc.get(k, 0)
                                      for k in set(eager) | set(enc)}


# --- the masked top-k select (csrc/topk_select.cu): ids and values bit for bit
# the mask and stable sort's on the card

def _topk_scores(cuda, b: int, width: int, seed: int, kind: str) -> torch.Tensor:
    g = torch.Generator(cuda).manual_seed(seed)
    if kind == "ties":  # few distinct values, +-0.0, NaN of both signs, +-inf, a raw -1e9
        s = torch.randint(-6, 6, (b, width), device=cuda, generator=g).float() / 4
        for v, j in ((0.0, 3), (-0.0, 5), (float("nan"), 7), (float("inf"), 11),
                     (float("-inf"), 13), (tt.NEG_INF, 1), (-0.0, 17), (float("nan"), 19),
                     (-float("nan"), 23)):
            s[2:, j % width] = v
        return s
    s = torch.randn(b, width, device=cuda, generator=g)
    if kind == "rising":  # scores that grow along the row: the threshold keeps moving
        s += torch.linspace(0, 8, width, device=cuda)
    return s


def _topk_rated(cuda, b: int, width: int, deg: int, seed: int) -> torch.Tensor:
    """[b, deg + 4] int32 rated lists, pad -1: where deg >= width, row 0 every
    item and row 1 all but three; the others up to deg ids, with repeats, and
    ids >= width."""
    g = torch.Generator(cuda).manual_seed(seed + 1)
    rated = torch.randint(0, width, (b, deg + 4), device=cuda, generator=g, dtype=torch.int32)
    lens = torch.randint(0, deg + 1, (b,), device=cuda, generator=g)
    rated[torch.arange(deg + 4, device=cuda)[None, :] >= lens[:, None]] = -1
    rated[:, -4:] = torch.tensor([width, width + 9, -1, 0], device=cuda, dtype=torch.int32)
    if b > 2 and width <= deg:
        rated[0, :width] = torch.randperm(width, device=cuda, generator=g).int()
        rest = torch.randperm(width, device=cuda, generator=g)[3:].int()
        rated[1, : rest.numel()] = rest
    return rated


def _same_topk(got, want) -> None:
    (gv, gi), (wv, wi) = got, want
    assert gi.dtype == wi.dtype == torch.int64 and gv.dtype == torch.float32
    assert gi.shape == wi.shape
    assert torch.equal(gi, wi)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["normal", "rising"])
@pytest.mark.parametrize("k", [1, 10, 40, 256])
def test_topk_select_matches_the_sort_at_the_eval_block(cuda, k, kind):
    # the LightGCN Amazon-Book cell's block: 512 users x 91,599 items, rated
    # lists up to its widest user's 492 training items
    scores = _topk_scores(cuda, 512, 91599, seed=k, kind=kind)
    rated = _topk_rated(cuda, 512, 91599, 492, seed=k)
    before = dict(tsel.LAUNCHES)
    got = tsel.topk_select(scores, rated, k)
    again = tsel.topk_select(scores, rated, k)
    torch.cuda.synchronize()
    assert tsel.LAUNCHES == {"topk_select": before["topk_select"] + 2}
    _same_topk(got, tsel.topk_select_reference(scores, rated, k))
    _same_topk(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("rated_form", ["int32", "int64", "none"])
@pytest.mark.parametrize("k", [1, 10, 40, 256])
@pytest.mark.parametrize("width", [1, 31, 4097, 91599])
def test_topk_select_ties_zeros_nan_and_masked_rows(cuda, width, k, rated_form):
    # odd widths: rows start misaligned; row 0 fully masked and row 1 all but
    # three where the rated lists can hold every item
    b = 6
    scores = _topk_scores(cuda, b, width, seed=width + k, kind="ties")
    rated = _topk_rated(cuda, b, width, width, seed=width)
    rated = {"int32": rated, "int64": rated.long(), "none": None}[rated_form]
    got = tsel.topk_select(scores, rated, k)
    assert tuple(got[1].shape) == (b, min(k, width))
    _same_topk(got, tsel.topk_select_reference(scores, rated, k))
    # a view whose rows start one float later and whose row stride is not the width
    view = torch.nn.functional.pad(scores, (1, 0))[:, 1:]
    _same_topk(tsel.topk_select(view, rated, k), got)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [200, 91599])
def test_topk_select_places_nan_and_zeros_as_the_card_sort(cuda, width):
    # the card's sort: +NaN first, -0.0 and +0.0 tied in index order, a NaN
    # with the sign bit set after -inf (the CPU's sort puts it first)
    x = torch.full((1, width), -5.0, device=cuda)
    for j, v in {2: -0.0, 3: 0.0, 5: float("nan"), 6: -float("nan"), 8: float("inf"),
                 9: 0.0, 10: -0.0, 12: float("-inf")}.items():
        x[0, j] = v
    k = min(width, tsel.KMAX)
    got = tsel.topk_select(x, None, k)
    _same_topk(got, tsel.topk_select_reference(x, None, k))
    assert got[1][0, :6].tolist() == [5, 8, 2, 3, 9, 10]
    if width <= tsel.KMAX:
        assert got[1][0, -2:].tolist() == [12, 6]


@pytest.mark.gpu
@pytest.mark.parametrize("width,k", [(5000, 257), (5000, 3 * 256 + 7), (5000, 5000),
                                     (91599, 600)])
def test_topk_select_serves_k_above_kmax_in_rounds(cuda, width, k):
    # past KMAX the kernel reads the row again a round of KMAX columns, each
    # below the last key of the one before; one launch whatever k is
    scores = _topk_scores(cuda, 8, width, seed=k, kind="ties")
    rated = _topk_rated(cuda, 8, width, 300, seed=k)
    before = dict(tsel.LAUNCHES)
    got = tsel.topk_select(scores, rated, k)
    assert tsel.LAUNCHES == {"topk_select": before["topk_select"] + 1}
    _same_topk(got, tsel.topk_select_reference(scores, rated, k))
    _same_topk(tsel.topk_select(scores, None, k), tsel.topk_select_reference(scores, None, k))
    # and the public functions reach the kernel
    tt.masked_topk(scores, rated, k)
    tt.topk_ids(scores, 1)
    assert tsel.LAUNCHES["topk_select"] == before["topk_select"] + 4


@pytest.mark.gpu
@pytest.mark.parametrize("rated_form", ["int32", "none"])
@pytest.mark.parametrize("k", [1, 40, 300])
def test_topk_select_past_one_window_of_the_mask(cuda, k, rated_form):
    # 262,147 items: three windows of the kernel's 131,072-item bitmap, the
    # last of 3 items; rated ids in every window, row 0 every item rated and
    # row 1 all but three; rows start misaligned in a view
    width, b = 2 * 131072 + 3, 6
    scores = _topk_scores(cuda, b, width, seed=k, kind="ties")
    rated = _topk_rated(cuda, b, width, width, seed=k)
    rated[2:, :3] = torch.tensor([131071, 131072, 262146], device=cuda, dtype=torch.int32)
    rated = rated if rated_form == "int32" else None
    got = tsel.topk_select(scores, rated, k)
    _same_topk(got, tsel.topk_select_reference(scores, rated, k))
    view = torch.nn.functional.pad(scores, (3, 0))[:, 3:]
    _same_topk(tsel.topk_select(view, rated, k), got)
    if rated is not None:  # the fully masked row: NEG_INF in index order
        assert got[1][0].tolist() == list(range(min(k, width)))
        assert bool((got[0][0] == tt.NEG_INF).all())


@pytest.mark.gpu
def test_topk_select_writes_no_score_sized_tensor(cuda):
    # peak memory of the call: its [B, k] outputs (f32 values, int64 ids) and
    # nothing else (the mask's bitmap lives in shared memory); the sort path
    # copies the [B, I] scores several times
    b, n, k = 512, 91599, 40
    scores = _topk_scores(cuda, b, n, seed=3, kind="normal")
    rated = _topk_rated(cuda, b, n, 492, seed=3)
    tsel.topk_select(scores, rated, k)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = tsel.topk_select(scores, rated, k)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= b * k * (4 + 8)
    del out
    torch.cuda.reset_peak_memory_stats()
    ref = tsel.topk_select_reference(scores, rated, k)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base > b * n * 4
    del ref


# --- the fused ranking (csrc/score_topk.cu): the scoring product and the masked
# top-k in one kernel, against its plain version (cuBLAS and the stable sort)

from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import score_topk as fsk


def _ranking_case(cuda, n_users: int, n_items: int, d: int, deg: int, seed: int,
                  kind: str = "dyadic"):
    """User and item tables, the users to rank (every row once, shuffled, and
    some twice) and [n_users, deg + 4] int32 rated lists in no order (pad -1,
    repeats, ids outside [0, I)). "dyadic": multiples of 1/16 in [-1/2, 1/2],
    whose sums are exact in any order (many exact ties); "normal": N(0, 1)."""
    g = torch.Generator(cuda).manual_seed(seed)
    if kind == "dyadic":
        u = torch.randint(-8, 9, (n_users, d), device=cuda, generator=g).float() / 16
        i = torch.randint(-8, 9, (n_items, d), device=cuda, generator=g).float() / 16
    else:
        u = torch.randn(n_users, d, device=cuda, generator=g)
        i = torch.randn(n_items, d, device=cuda, generator=g)
    users = torch.cat([torch.randperm(n_users, device=cuda, generator=g),
                       torch.randint(0, n_users, (n_users // 7,), device=cuda, generator=g)])
    rated = _topk_rated(cuda, n_users, n_items, deg, seed)
    return u, users.int(), i, rated


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 40, 256])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_score_topk_matches_the_plain_version_bit_for_bit(cuda, d, k):
    # user and item counts that are not multiples of the kernel's tiles
    u, users, i, rated = _ranking_case(cuda, 1000, 5003, d, 300, seed=d + k)
    before = dict(fsk.LAUNCHES)
    got = fsk.score_topk(u, users, i, rated, k)
    torch.cuda.synchronize()
    assert fsk.LAUNCHES == {"score_topk": before["score_topk"] + 1}
    _same_topk(got, fsk.score_topk_reference(u, users, i, rated, k))
    _same_topk(fsk.score_topk(u, users.long(), i, None, k),
               fsk.score_topk_reference(u, users, i, None, k))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 50])
def test_score_topk_at_widths_that_are_not_multiples_of_four(cuda, d):
    # rows that a 16-byte load cannot read, a width below one staged chunk
    u, users, i, rated = _ranking_case(cuda, 300, 777, d, 100, seed=d)
    _same_topk(fsk.score_topk(u, users, i, rated, 40),
               fsk.score_topk_reference(u, users, i, rated, 40))
    # a row stride past the width
    wide = torch.nn.functional.pad(i, (0, 3))[:, :d]
    _same_topk(fsk.score_topk(u, users, wide, rated, 40),
               fsk.score_topk_reference(u, users, i, rated, 40))


@pytest.mark.gpu
def test_score_topk_at_the_eval_cell(cuda):
    # the LightGCN Amazon-Book cell: 52,736 padded test users x 91,599 items at
    # width 64, k 40, rated lists up to its widest user's 492 items
    u, users, i, rated = _ranking_case(cuda, 52736, 91599, 64, 492, seed=7)
    users = users[:52736]
    got = fsk.score_topk(u, users, i, rated, 40)
    _same_topk(got, fsk.score_topk_reference(u, users, i, rated, 40))


@pytest.mark.gpu
def test_score_topk_masking_cases(cuda):
    # duplicated item rows (exact ties across items), users who rated all but
    # two of the items (fewer than k unmasked: masked ids at -1e9 in index
    # order), rated ids outside [0, I), a zero row against negative items
    # (signed zero products) and NaN scores of both signs
    n_users, n_items, d, k = 40, 300, 32, 256
    u, users, i, rated = _ranking_case(cuda, n_users, n_items, d, n_items, seed=5)
    i[100:150] = i[10:60]
    u[3] = 0.0
    i[7] = -0.5
    i[20, 5] = float("nan")
    i[21, 0] = -float("nan")
    rated[1] = -1
    rated[1, : n_items - 2] = torch.arange(2, n_items, device=cuda, dtype=torch.int32)
    rated[2, :4] = torch.tensor([-1, n_items, n_items + 100, 0], device=cuda, dtype=torch.int32)
    got = fsk.score_topk(u, users, i, rated, k)
    _same_topk(got, fsk.score_topk_reference(u, users, i, rated, k))
    row = int((users == 1).nonzero()[0, 0])
    assert sorted(got[1][row, :2].tolist()) == [0, 1]
    assert got[1][row, 2:].tolist() == list(range(2, k))
    assert bool((got[0][row, 2:] == tt.NEG_INF).all())


@pytest.mark.gpu
def test_score_topk_on_random_inputs_within_the_sum_order(cuda):
    # N(0, 1) tables: the kernel sums over the width in another order than
    # cuBLAS, so a value may differ by a few ulp of the row's scale, and an id
    # only where two scores lie that close (a near tie)
    # only where two scores lie that close (a near tie). The stated tolerance is
    # the f32 dot product's error bound for either order, d eps sum_k |u_k i_k|,
    # twice: values ~30 at width 64 differ by a few ulp, far inside it
    d = 64
    u, users, i, rated = _ranking_case(cuda, 4096, 20011, d, 300, seed=3, kind="normal")
    (gv, gi), (wv, wi) = (fsk.score_topk(u, users, i, rated, 40),
                          fsk.score_topk_reference(u, users, i, rated, 40))
    rows = u[users.long()].abs()
    bound = 2 * d * torch.finfo(torch.float32).eps * torch.einsum(
        "nd,nkd->nk", rows, i[wi].abs())
    same = gi == wi
    assert bool(((gv - wv).abs() <= bound)[same].all())
    # a differing position holds two near-tied scores of the plain version
    assert bool(((gv - wv).abs() <= 2 * bound)[~same].all())
    assert float((~same).float().mean()) < 1e-3


@pytest.mark.gpu
def test_score_topk_launches_once_for_an_evaluation(cuda):
    # ranking_metrics: one score_topk step, no topk_select launch, no [B, I]
    from hypergraph_diffusion_for_recommendation_tpu_torch.data.device import EvalData
    from hypergraph_diffusion_for_recommendation_tpu_torch.eval.metrics import ranking_metrics

    n_users, n_items, d = 2048, 30011, 64
    u, _, i, rated = _ranking_case(cuda, n_users, n_items, d, 200, seed=11)
    g = torch.Generator(cuda).manual_seed(12)
    test = torch.randint(0, n_items, (n_users, 8), device=cuda, generator=g, dtype=torch.int32)
    ed = EvalData(test_users=torch.arange(n_users, device=cuda, dtype=torch.int32),
                  user_valid=torch.ones(n_users, dtype=torch.bool, device=cuda),
                  test_pos_pad=test, test_counts=torch.full((n_users,), 8, device=cuda,
                                                           dtype=torch.int32),
                  n_test_users=n_users, total_test_interactions=8 * n_users)
    ranking_metrics(u, i, rated, ed, (10, 20, 40), block=512)
    torch.cuda.synchronize()
    before, sel = dict(fsk.LAUNCHES), dict(tsel.LAUNCHES)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = ranking_metrics(u, i, rated, ed, (10, 20, 40), block=512)
    torch.cuda.synchronize()
    assert fsk.LAUNCHES == {"score_topk": before["score_topk"] + 1}
    assert tsel.LAUNCHES == sel
    # the scores of one block of the blocked path alone would be 512 x I x 4 bytes
    assert torch.cuda.max_memory_allocated() - base < 512 * n_items * 4 // 2
    # and the metrics are the blocked path's
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.topk import exact_scores, masked_topk
    ids = torch.cat([masked_topk(exact_scores(u[s:s + 512], i), rated[s:s + 512], 40)[1]
                     for s in range(0, n_users, 512)])
    from hypergraph_diffusion_for_recommendation_tpu_torch.eval.metrics import metrics_from_topk
    want = metrics_from_topk(ids, ed, (10, 20, 40), block=512)
    for name in got:  # sums exact in any order: the same ids
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


@pytest.mark.gpu
def test_serving_and_the_facade_rank_with_score_topk(cuda, tmp_path, monkeypatch):
    # Retriever.topk (with and without the rated items), Recommender.recommend
    # and the dump on covered tables: one score_topk step each, no topk_select
    # launch, and score_topk's own values and ids
    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import synthetic_dataset
    from hypergraph_diffusion_for_recommendation_tpu_torch.eval.serving import Retriever
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender
    from hypergraph_diffusion_for_recommendation_tpu_torch.utils import logging as tlog

    rec = Recommender(make_config("LightGCN", embedding_size=64, eval_user_batch=64,
                                  item_ranking=(10, 20), output_dir=str(tmp_path / "out")),
                      device=cuda)
    rec.build(synthetic_dataset(n_users=600, n_items=3001, mean_degree=20.0, seed=5))
    g = torch.Generator(cuda).manual_seed(9)
    rec.user_emb = torch.randn(rec.inter.n_users, 64, device=cuda, generator=g)
    rec.item_emb = torch.randn(rec.inter.n_items, 64, device=cuda, generator=g)
    rated, ed = rec.cf_dev.rated_pad, rec.cf_dev.eval_data
    retr = Retriever.load(rec.export_embeddings(str(tmp_path / "emb.npz")), device=cuda)
    raw = [int(u) for u in rec.inter.id2user[::5]]
    dense = torch.tensor([rec.inter.user[u] for u in raw], device=cuda)

    def one_step(fn):
        torch.cuda.synchronize()
        before, sel = fsk.LAUNCHES["score_topk"], tsel.LAUNCHES["topk_select"]
        out = fn()
        torch.cuda.synchronize()
        assert fsk.LAUNCHES["score_topk"] == before + 1 and tsel.LAUNCHES["topk_select"] == sel
        return out

    def host(t):
        return t.cpu().numpy()

    for exclude in (True, False):
        ids, scores = one_step(lambda: retr.topk(raw, k=20, exclude_rated=exclude,
                                                 raw_ids=False))
        vals, want = fsk.score_topk(rec.user_emb, dense, rec.item_emb,
                                    rated if exclude else None, 20)
        np.testing.assert_array_equal(ids, host(want))
        np.testing.assert_array_equal(scores.view(np.int32), host(vals).view(np.int32))
    got = one_step(lambda: rec.recommend(raw[0], k=20))
    vals, want = fsk.score_topk(rec.user_emb, dense[:1], rec.item_emb, rated, 20)
    assert got == [(int(rec.inter.id2item[i]), v) for i, v in zip(host(want)[0].tolist(),
                                                                   host(vals)[0].tolist())]
    written = {}
    real = tlog.dump_recommendations

    def keep(path, users, id2item, top_ids, top_scores, hits):
        written.update(ids=top_ids, scores=top_scores)
        return real(path, users, id2item, top_ids, top_scores, hits)

    monkeypatch.setattr(tlog, "dump_recommendations", keep)
    one_step(lambda: rec.dump_recommendations(str(tmp_path / "dump.txt"), k=20))
    vals, want = fsk.score_topk(rec.user_emb, ed.test_users[: ed.n_test_users], rec.item_emb,
                                rated, 20)
    np.testing.assert_array_equal(written["ids"], host(want))
    np.testing.assert_array_equal(written["scores"].view(np.int32), host(vals).view(np.int32))


@pytest.mark.gpu
def test_score_topk_writes_no_score_sized_tensor(cuda):
    # peak memory of the call: its [n, k] outputs and the merge's workspace of
    # [grid, 2, users a tile, k] keys, each large one perhaps in a cached block
    # up to 1 MB longer (the caching allocator splits a free block only past
    # 1 MB of remainder); a [B, I] f32 score matrix is 1.5 GB here
    n, n_items, d, k = 4096, 91599, 64, 40
    u, users, i, rated = _ranking_case(cuda, n, n_items, d, 492, seed=13, kind="normal")
    users = users[:n]
    fsk.score_topk(u, users, i, rated, k)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fsk.score_topk(u, users, i, rated, k)
    torch.cuda.synchronize()
    import ctypes

    work = ctypes.c_int64(0)
    assert fsk._library().hd_score_topk_workspace(n, n_items, d, k, ctypes.byref(work)) == 0
    assert 0 < work.value <= 132 * 2 * 128 * k * 8  # [grid, 2, users a tile, k] keys
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= n * k * (4 + 8) + work.value + 3 * 2**20, (peak, n * k * (4 + 8), work.value)
    assert peak < n * n_items * 4 // 100
    del out
