"""HGNN_HD3's cell at the small size on the CPU: the sparse products a step
multiplies against its counts, the incidence against the program's, the
feature-dropout stream that the reference must follow, and the reader of
the SpMM kernels' share of the device's busy time."""

import numpy as np
import pytest
import torch

from harness import program
from harness.small import run_small, small_cell
from harness.spec import model_module, reader
from harness.trace import Trace

CELL = "hgnn_hd3-ml1m.train"


def _built():
    """(the program's bundle, the reference's graph, its sizes) of the small cell."""
    from generators.synthetic_recipe import generate

    cfg = small_cell(CELL).config
    ref = model_module("reference", cfg)
    train, test, kg, _ = generate(cfg["data"], 2147483999)
    bundle, _, _ = program.build(cfg, train, test, kg, "cpu", lambda msg: None)
    graph = ref.derive(train, test, kg)
    ref.attach(graph, "cpu")
    return bundle, graph, ref.sizes(graph, cfg["settings"])


def test_a_training_forward_runs_the_counted_products(monkeypatch):
    """`spmm_pair`'s calls in one training forward, by the adjacency and
    direction of the matrix multiplied (a dropped pair keeps its index
    arrays), equal `counts/hgnn_hd3.products`, rows and columns included."""
    import hypergraph_diffusion_for_recommendation_tpu_torch.ops.sparse as sparse_mod

    bundle, graph, s = _built()
    counts = model_module("counts", small_cell(CELL).config)
    names = {}
    for adj, (part, field) in counts.ADJACENCIES.items():
        pair = getattr(getattr(bundle, part), field)
        for side in ("fwd", "bwd"):
            names[id(getattr(pair, side).rows)] = (adj, side)
    seen = {}
    spmm_pair = sparse_mod.spmm_pair

    def counted(a, a_t, x):
        key = names[id(a.rows)] + (a.nrows, a.ncols, a.nnz)
        seen[key] = seen.get(key, 0) + 1
        return spmm_pair(a, a_t, x)

    monkeypatch.setattr(sparse_mod, "spmm_pair", counted)
    bundle.init(torch.Generator().manual_seed(1))
    batch = tuple(torch.as_tensor(t[:64], dtype=torch.int32)
                  for t in (graph.cf.train_u, graph.cf.train_i, graph.cf.train_i[::-1].copy()))
    keys = torch.tensor([[123, 456]], dtype=torch.int64)
    bundle.batch_loss({}, batch, keys, torch.Generator().manual_seed(2))
    want = {(adj, side, r, c, nnz): times for adj, side, r, c, nnz, times in counts.products(s)}
    assert seen == want
    assert sum(want.values()) == 24
    assert want[("b_hyper", "bwd", s["n_items"], s["n_users"], s["b_hyper_nnz"])] == 8


def test_the_incidence_is_the_programs():
    bundle, graph, _ = _built()
    b = bundle.cf.b_hyper.fwd
    n = b.nnz
    assert (b.nrows, b.ncols) == graph.b.shape and n == graph.b.vals.shape[0]
    assert torch.equal(b.rows[:n].long(), graph.b.rows) and torch.equal(b.cols[:n].long(), graph.b.cols)
    np.testing.assert_allclose(b.vals[:n].numpy(), graph.b.vals.numpy(), rtol=2e-7, atol=0)


def test_the_cell_follows_the_programs_dropout_stream(monkeypatch):
    """Correct with the trainer's dropout stream handed to the reference, and
    not correct with a generator seeded otherwise: the step's three feature
    masks decide its numbers."""
    torch.set_num_threads(1)
    handed = run_small(CELL)
    assert handed["correct"] is True, handed["checks"]
    monkeypatch.setattr(program, "dropout_state",
                        lambda trainer: torch.Generator().manual_seed(12345).get_state())
    withheld = run_small(CELL)
    assert withheld["correct"] is False, withheld["checks"]
    gap = withheld["checks"]["loss_gap"]
    assert gap["value"] > gap["limit"]


def _trace():
    """A 1 s window: the device busy 0.1-0.5 and 0.6-0.8 (0.6 s). The SpMM
    kernels run 0.1-0.2 and 0.15-0.3 (overlapping: 0.2 s) and 0.6-0.65;
    a GEMM 0.3-0.5 and a LayerNorm 0.65-0.8 are not theirs."""
    device = [("void segment_spmm_dedup_mma_kernel<128>(int const*)", 0.1, 0.2, 0.05),
              ("segment_spmm_dedup_sum_parts_kernel", 0.15, 0.3, 0.06),
              ("sm90_xmma_gemm_f32f32_f32f32_f32_tn", 0.3, 0.5, 0.07),
              ("void segment_spmm_rows_kernel<__nv_bfloat16>(int const*)", 0.6, 0.65, 0.55),
              ("vectorized_layer_norm_kernel", 0.65, 0.8, 0.56)]
    return Trace(window_s=1.0, device=device, host=[("train_step:cf", 0.0, 0.6, "user_annotation")])


def test_the_spmm_share_of_the_busy_time():
    read = reader("spmm.device_share.train")
    t = _trace()
    assert read({"trace": t, "kind": "train"}) == pytest.approx(100.0 * 0.25 / 0.6)
    without = Trace(t.window_s, [op for op in t.device if "segment_spmm" not in op[0]], t.host)
    assert read({"trace": without, "kind": "train"}) is None
    assert read({"trace": Trace(1.0, [], t.host), "kind": "train"}) is None
    assert read({"trace": t, "kind": "eval"}) is None


@pytest.mark.gpu
def test_the_int8_program_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("the int8 kernels run on a CUDA card only")
    assert run_small(CELL, device="cuda")["correct"] is True
    r = run_small(CELL, device="cuda", control="program_env")
    assert r["correct"] is False, r["checks"]
