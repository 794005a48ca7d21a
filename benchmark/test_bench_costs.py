"""The work counts of the yardstick, worked out by hand."""

import pytest

from harness import costs
from harness.spec import model_module

H100 = costs.PEAKS["NVIDIA H100 80GB HBM3"]


def test_one_product():
    # [1000, 500] with 4000 entries, width 64, a bf16 operand
    flops, nbytes = costs.spmm_cost(1000, 500, 4000, 64, 2)
    assert flops == 2 * 4000 * 64
    assert nbytes == 500 * 64 * 2 + 4000 * 8 + 1000 * 64 * 4
    # 352,000 bytes over 3.35 TB/s beats 512,000 FLOPs over 67 TFLOP/s
    assert costs.bound_s(flops, nbytes, H100) == pytest.approx(352000 / 3.35e12)


def test_products_with_their_backward():
    prods = [("cf", "fwd", 1000, 500, 4000, 2)]
    f, b = costs.products_cost(prods, 64, 4, backward=True)
    f1, b1 = costs.spmm_cost(1000, 500, 4000, 64, 4)
    f2, b2 = costs.spmm_cost(500, 1000, 4000, 64, 4)
    assert (f, b) == (2 * (f1 + f2), 2 * (b1 + b2))
    bound = costs.products_bound_s(prods, 64, 4, True, H100)
    assert bound == pytest.approx(2 * (b1 + b2) / 3.35e12)


def test_model_counts():
    cfg = {"reference": "khgrec"}
    s = dict(n_users=10, n_items=20, n_entities=64, cf_nnz=100, kg_nnz=200, n_layers=2,
             hyper_dim=128, batch_size_kg=8)
    k = model_module("counts", cfg)
    assert [p[:2] for p in k.products(s)] == [("cf", "bwd"), ("cf", "fwd"), ("kg", "bwd"),
                                                ("kg", "fwd")]
    assert k.products(s)[0][2:] == (30, 30, 100, 2)
    assert k.other_sparse_flops(s, backward=False) == 2 * 2 * 2 * 8 * 128
    lg = model_module("counts", {"reference": "lightgcn"})
    s = dict(n_users=10, n_items=20, cf_nnz=100, n_layers=3, embedding_size=64)
    assert lg.products(s) == [("cf", "fwd", 30, 30, 100, 3)]
