#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from `csrc/` with nvcc (sm_90a);
  3. kernels: each of the four segment-SpMM kernels (base and dedup, in
     f32 and bf16 mode; their int8 forms) on the layouts packed from the
     four matrices of the serving and training path (the CF and KG
     adjacencies of the LastFM-shape and ML-1M-density graphs, both
     directions), held against its plain PyTorch version on the card;
     profiler device times beside the plain version's, one
     `torch.sparse.mm` call's on the same CSR matrix (for the int8
     kernels on the dequantised table: it does not quantise), and the
     bound;
  4. the serving slice at the LastFM shape, full width: KHGRec encode
     through the kernels (8 launches), the same encode through the plain
     version, ranking metrics over every test user, export, and top-k
     requests through `Retriever`;
  5. the same at ML-1M density, where the dedup layout and kernel run;
  6. training at full width (bench.py's configuration), one phase per
     layout: the LastFM shape with gather_layout "auto" (base, kernel 1),
     ML-1M density with "auto" (dedup, kernel 2), the LastFM shape with
     "int8" (kernel 3), ML-1M density with "dedup_int8" (kernel 4). Each
     holds one training step through the kernels against the same step
     through the plain versions (loss and every parameter's gradient),
     counts exactly 16 launches of its kernel per step (8 forward, 8
     backward), then trains: a whole `Recommender.train()` epoch with its
     evaluation in the first phase (Recall@20 beside the untrained
     state's), 5 `Trainer` steps in the others; it reports the loss and
     the step's wall time, device time and idle share;
  7. the gather-fusion probe path (`bench/gather_fusion.py`, the port of
     scripts/bench_gather_fusion.py) at its shapes, launches counted:
     kernels 5 and 6 (`resident_row_gather`, `fused_window_spmm`) in f32
     and bf16 against their plain versions (the gather exactly, the fused
     product within KERNEL_RTOL, and in f32 also against scipy's product),
     with the device times of each kernel, its plain version, its library
     call and kernel 1 on the same layout;
  8. HGNN_HD3 at full width at the LastFM shape (its MODEL_DEFAULTS, mode
     full, bf16 operand): the encode through the kernels against the plain
     versions, one training step likewise (loss and every gradient), 24
     SpMM launches an encode and 48 a step (8 and 16 forward products on
     the CF adjacency and the rectangular b_hyper incidence, as many
     backward), then 5 `Trainer` steps with the step's wall, device time
     and idle share, and the layout `dedup_auto` picked for b_hyper;
  9. every other HD variant and HGNN_HD3's local_only and group_only modes:
     one encode and one `Trainer` step each, finite, launches asserted;
 10. cached propagation (prop_cache_steps 8) for 16 `Trainer` steps in
     KHGRec (LastFM, auto) and HGNN_HD3: only steps 0 and 8 launch a
     kernel; the mean cached step's time beside the full step's.

The line before the last is the card's name and power limit; before it,
one JSON line with a row per kernel (kernels 1-4: times per training step
at the kernel's main-path shape, launches per step; kernels 5-6: times per
call at the probe's shapes, launches on the probe path). The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Weights are random, drawn from a seeded generator. It imports nothing of
JAX or of the JAX package, and exits non-zero without a CUDA card or
without the port's package beside it.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "build" / "chip_smoke"

# published H100 SXM peaks: HBM3 bytes/s, and float32 FLOP/s outside the
# tensor cores (the kernels' multiply-adds are f32 FMAs in both modes)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

DEVICE = "cuda"
D = 128  # hyper_dim of the serving path
SEED = 0
TIMED_ITERS = 20

# kernel vs plain version: the same products summed in another f32 order
# (the dedup kernel's float atomics in an order that changes run to run)
KERNEL_RTOL = 1e-5
# encode through the kernels vs through the plain version: that f32 order
# can flip a bf16 rounding of the next layer's table (2^-8 relative on
# the flipped elements), so the bf16-mode tables agree to 1e-2 of their scale
ENCODE_RTOL = 1e-2
# a training step through the kernels vs through the plain versions, per
# gradient, of that gradient's scale (max |g|): in bf16 mode the same
# rounding flips as the encode, in the forward and the backward, summed by
# the reductions into the LayerNorm and table gradients; in int8 mode the
# kernels' f64 sums are exact and equal the plain version's bit for bit
TRAIN_RTOL = 1e-2
LOSS_RTOL = 1e-3
# one training step runs each (matrix, direction) four times: the two
# layers' forward products and their two backward products
CALLS_PER_STEP = 4

SHAPES = {
    "lastfm": dict(n_users=1890, n_items=17632, mean_degree=49.0, seed=7),
    "ml1m": dict(n_users=1500, n_items=1000, mean_degree=120.0, seed=9),
}
_TPU_SRC = "hypergraph_diffusion_for_recommendation_tpu/ops/pallas/segment_spmm.py"
KERNELS = {
    # name: (layout, modes, main-path shape, main-path mode, the TPU kernel)
    "segment_spmm_rows": ("base", ("f32", "bf16"), "lastfm", "bf16", f"{_TPU_SRC}:356"),
    "segment_spmm_dedup": ("dedup", ("f32", "bf16"), "ml1m", "bf16", f"{_TPU_SRC}:429"),
    "segment_spmm_rows_int8": ("base", ("int8",), "lastfm", "int8", f"{_TPU_SRC}:397"),
    "segment_spmm_dedup_int8": ("dedup", ("int8",), "ml1m", "int8", f"{_TPU_SRC}:475"),
}
# training phases: (shape, gather_layout, the kernel it must launch)
TRAIN_PHASES = (
    ("lastfm", "auto", "segment_spmm_rows"),
    ("ml1m", "auto", "segment_spmm_dedup"),
    ("lastfm", "int8", "segment_spmm_rows_int8"),
    ("ml1m", "dedup_int8", "segment_spmm_dedup_int8"),
)
TRAIN_STEPS = 5  # Trainer steps in the phases without a whole epoch
# bench.py's KHGRec training configuration (bench.py:181-196), bf16 gathered operand
KHGREC_TRAIN = dict(hyper_dim=D, relation_dim=32, n_layers=2, batch_size=2048,
                    batch_size_kg=8192, mode="full", drop_rate=0.2, p=0.3, temp=1.0,
                    cl_rate=0.01, lrate=0.001, compute_dtype="bfloat16", eval_user_batch=512)
SOURCES = ("segment_spmm", "gather_fusion")  # csrc/<name>.cu

_PROBE_SRC = "scripts/bench_gather_fusion.py"
PROBE_KERNELS = {
    # name: (the TPU kernel, the probes (bench/gather_fusion.py) of the kernel
    # in f32 and bf16, its plain version in f32, and the library call)
    "resident_row_gather": (f"{_PROBE_SRC}:86", "3. resident_row_gather f32",
                            "3b. resident_row_gather bf16", "3p. resident_row_gather plain f32",
                            "1. index_select f32"),
    "fused_window_spmm": (f"{_PROBE_SRC}:125", "4. fused_window_spmm f32",
                          "4b. fused_window_spmm bf16", "4p. fused_window_spmm plain f32",
                          "6. torch.sparse.mm"),
}
# HGNN_HD3's SpMM launches: 6 products on the CF adjacency in the local view
# (the ED-HNN layer's two two-hop convs, the cap's one), 2 on it and 16 on
# b_hyper in the group view (two HWNN layers of 4 two-hops each, the cap's
# one), forward; a training step runs each again backward
HD3_ENCODE_LAUNCHES = 24
# the other variants (model, mode): SpMM launches of an encode, as the code
# gives them; a step launches twice as many (each product again backward).
# The scatter-form ED-HNN of HD and HGNN_HD2 launches none
HD_VARIANTS = {
    ("HD", "full"): 0, ("HGNN_HD", "full"): 8, ("HGNN_HD2", "full"): 2,
    ("HGNN_HD4", "full"): 26, ("WaveletHD", "full"): 32, ("WaveletHD2", "full"): 18,
    ("LocalEncoder", "full"): 6, ("HGNN_HD3", "local_only"): 6, ("HGNN_HD3", "group_only"): 18,
}
PROP_CACHE_STEPS, PROP_CACHE_RUN = 8, 16  # K, and the Trainer steps run with it


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, iters: int = TIMED_ITERS, warmup: int = 3) -> float:
    """Median time of one call of `fn` in ms between two CUDA events
    (`bench/timing.py`). The L2 stays warm, as in the encode, where X has
    just been written."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.bench.timing import cuda_ms as timed

    return timed(fn, iters, warmup)


def device_ms(fn, iters: int = TIMED_ITERS, attempts: int = 10) -> tuple[float, dict[str, float]]:
    """Device time per call of `fn` in ms and its split by kernel name, from
    torch.profiler's trace (`bench/timing.py`); an empty trace is taken
    again, up to `attempts` times, and then the phase fails."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.bench.timing import device_ms as timed

    return timed(fn, iters, attempts, log=log)


def kernel_only_ms(by_name: dict[str, float]) -> float:
    return sum(t for k, t in by_name.items() if "segment_spmm" in k)


def bound_ms(mat, d: int) -> tuple[float, str]:
    """Least time for A @ X at this matrix: the CSR matrix (8 B per edge,
    4 B per row pointer), the X rows it references and the output, each
    moved once, against 2 * nnz * d f32 operations."""
    import numpy as np

    nnz = mat.nnz
    used_cols = np.unique(mat.indices).shape[0]
    nbytes = 8 * nnz + 4 * (mat.shape[0] + 1) + 4 * d * used_cols + 4 * d * mat.shape[0]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * nnz * d / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    if not card:
        raise RuntimeError(f"nvidia-smi gave no card: rc={smi.returncode} {smi.stderr.strip()}")
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import (
        build,
        gather_fusion,
        segment_spmm,
    )

    t0 = time.time()
    build.build_libraries(SOURCES)  # one nvcc per source, started together
    segment_spmm._library()
    gather_fusion._library()
    log(f"[build] {', '.join(f'{n}.cu' for n in SOURCES)} built and loaded in "
        f"{time.time() - t0:.2f} s")
    for name in SOURCES:
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")


def make_graphs():
    """Host data for both shapes: the split, the interaction and KG data,
    and the two adjacencies the encode multiplies by."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import (
        build_interaction,
        build_knowledge,
        synthetic_dataset,
    )

    graphs = {}
    for name, kw in SHAPES.items():
        t0 = time.time()
        data = synthetic_dataset(with_kg=True, **kw)
        inter = build_interaction(data[0], data[1])
        kg = build_knowledge(data[2], inter)
        graphs[name] = dict(data=data, mats={"cf": inter.norm_adj.tocsr(),
                                             "kg": kg.norm_kg_adj.tocsr()})
        log(f"[data] {name}: {inter.n_users} users, {inter.n_items} items, "
            f"cf {inter.norm_adj.shape[0]}^2 nnz {inter.norm_adj.nnz}, "
            f"kg {kg.norm_kg_adj.shape[0]}^2 nnz {kg.norm_kg_adj.nnz} ({time.time() - t0:.1f} s)")
    return graphs


def phase_kernels(graphs) -> list[dict]:
    """Every kernel in each of its modes on every (matrix, direction) of
    the main path; a JSON row per kernel, its times per training step at
    its main-path shape and mode."""
    import numpy as np
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S

    gen = torch.Generator(DEVICE).manual_seed(SEED)
    rows = []
    for kname, (layout, modes, main_shape, main_mode, replaces) in KERNELS.items():
        pack = S.pack_blocked_dedup if layout == "dedup" else S.pack_blocked
        worst = 0.0
        main = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
        bound_by = set()
        for gname, g in graphs.items():
            for mname, mat in g["mats"].items():
                for direction, m in (("fwd", mat), ("bwd", mat.T.tocsr())):
                    m.sort_indices()
                    coo = m.tocoo()
                    layout_f32 = pack(coo.row, coo.col, coo.data, m.shape, device=DEVICE)
                    x = torch.randn(m.shape[1], D, device=DEVICE, generator=gen)
                    a_csr = torch.sparse_csr_tensor(
                        torch.as_tensor(m.indptr.astype(np.int64)),
                        torch.as_tensor(m.indices.astype(np.int64)),
                        torch.as_tensor(m.data.astype(np.float32)), m.shape,
                        check_invariants=False,
                    ).to(DEVICE)
                    exact = torch.as_tensor(m @ x.cpu().numpy(), device=DEVICE)
                    b_ms, b_by = bound_ms(m, D)
                    for mode in modes:
                        blk = layout_f32.replace(bf16=mode == "bf16", int8=mode == "int8")
                        if mode == "int8":
                            # the nearest library call: torch.sparse.mm on the
                            # dequantised table (it does not quantise)
                            q, sc = S.quantize_int8(x)
                            x_lib = q.float() * sc
                        else:
                            x_lib = x
                        lib_ms = device_ms(lambda: torch.sparse.mm(a_csr, x_lib))[0]
                        got = S.blocked_spmm(blk, x)
                        torch.cuda.synchronize()
                        ref = S.blocked_spmm_reference(blk, x)
                        scale = float(ref.abs().max())
                        err = float((got - ref).abs().max())
                        err_exact = float((got - exact).abs().max())
                        ok = err <= KERNEL_RTOL * max(scale, 1.0)
                        if mode == "f32":  # f32 mode also agrees with scipy's f32 product
                            ok = ok and err_exact <= KERNEL_RTOL * max(scale, 1.0)
                        k_ms, k_split = device_ms(lambda: S.blocked_spmm(blk, x))
                        k_call = cuda_ms(lambda: S.blocked_spmm(blk, x))
                        p_ms = device_ms(lambda: S.blocked_spmm_reference(blk, x), iters=5)[0]
                        lib_label = "torch.sparse.mm" + (" (dequantised)" if mode == "int8"
                                                         else "")
                        log(f"[kernel] {kname} {gname}.{mname}.{direction} {mode} "
                            f"{m.shape[0]}x{m.shape[1]} nnz {m.nnz} blocks {blk.n_blocks}: "
                            f"max_abs_err {err:.3e} rel {err / max(scale, 1e-30):.3e} "
                            f"(vs scipy f32 {err_exact:.3e}) | device ms: wrapper {k_ms:.4f} "
                            f"(kernel alone {kernel_only_ms(k_split):.4f}) plain {p_ms:.4f} "
                            f"{lib_label} {lib_ms:.4f} bound {b_ms:.4f} ({b_by}) | "
                            f"one call between events {k_call:.4f} ms {'OK' if ok else 'FAIL'}")
                        if not ok:
                            raise AssertionError(f"{kname} disagrees with its plain version "
                                                 f"on {gname}.{mname}.{direction} {mode}")
                        worst = max(worst, err)
                        if gname == main_shape and mode == main_mode:
                            main["ms"] += CALLS_PER_STEP * k_ms
                            main["plain_ms"] += CALLS_PER_STEP * p_ms
                            main["library_ms"] += CALLS_PER_STEP * lib_ms
                            main["bound_ms"] += CALLS_PER_STEP * b_ms
                            bound_by.add(b_by)
        rows.append(dict(
            name=kname, route="cuda",
            source="hypergraph_diffusion_for_recommendation_tpu_torch/csrc/segment_spmm.cu",
            replaces=replaces, launches=0, max_abs_err=worst,
            bound_by="bytes" if bound_by == {"bytes"} else "operations", **main,
        ))
    return rows


def phase_slice(shape: str, data, layout: str, card: str) -> tuple[dict, dict]:
    """The serving slice at one graph: build, encode through the kernels
    (launches counted), encode through the plain version, metrics,
    export and top-k requests. Returns (launch counts, summary)."""
    from unittest import mock

    import numpy as np
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.eval.serving import Retriever
    from hypergraph_diffusion_for_recommendation_tpu_torch.models.khgrec import attention_extras
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender

    cfg = make_config(
        "KHGRec", hyper_dim=D, relation_dim=32, n_layers=2, batch_size_kg=8192,
        eval_user_batch=512, item_ranking=(10, 20, 40), compute_dtype="bfloat16",
    )
    t0 = time.time()
    rec = Recommender(cfg, DEVICE)
    rec.build(data)
    build_s = time.time() - t0
    bundle = rec.bundle
    for adj in (bundle.cf.adj, bundle.kg.kg_adj):
        for side in (adj.fwd, adj.bwd):
            b = side.blocked
            if b is None or b.dedup != (layout == "dedup") or not b.bf16:
                raise AssertionError(f"{shape}: expected a bf16 {layout} layout on every "
                                     f"adjacency, got {b and (b.dedup, b.bf16)}")

    rec.init_weights(SEED)
    # the attention a training step leaves: scored from a KG forward over
    # the first batch_size_kg KG triples
    with torch.no_grad():
        ent_kg = bundle.module(bundle.cf, bundle.kg, (
            rec.extras["att_h"], rec.extras["att_t"], rec.extras["att_v"]))[2]
    trip = [torch.as_tensor(a[: cfg.batch_size_kg].astype(np.int32), device=DEVICE)
            for a in (rec.kg.h, rec.kg.r, rec.kg.t)]
    rec.extras = attention_extras(bundle.module, ent_kg, *trip)
    torch.cuda.synchronize()

    # --- the main path, counted ---
    for k in S.LAUNCHES:
        S.LAUNCHES[k] = 0
    t0 = time.time()
    u_emb, i_emb = rec.encode()
    torch.cuda.synchronize()
    encode_s = time.time() - t0
    launches = dict(S.LAUNCHES)
    t0 = time.time()
    metrics = rec.evaluate()
    eval_s = time.time() - t0
    out = OUT_DIR / f"embeddings_{shape}.npz"
    rec.export_embeddings(str(out))
    retr = Retriever.load(str(out), device=DEVICE)
    users = [int(u) for u in rec.inter.id2user[:: max(len(rec.inter.id2user) // 8, 1)][:8]]
    t0 = time.time()
    ids_ex, sc_ex = retr.topk(users, k=20, exclude_rated=True)
    serve_s = time.time() - t0
    ids_all, sc_all = retr.topk(users, k=20, exclude_rated=False)
    counted = dict(S.LAUNCHES)
    if counted != launches:
        raise AssertionError(f"{shape}: kernels launched after the encode: {counted}")

    # --- checks ---
    enc_ms = cuda_ms(lambda: bundle.encode_eval(rec.extras), iters=5, warmup=1)
    enc_dev, enc_split = device_ms(lambda: bundle.encode_eval(rec.extras), iters=5)
    with mock.patch.object(sparse, "blocked_spmm", S.blocked_spmm_reference):
        pu, pi = bundle.encode_eval(rec.extras)
        plain_enc_ms = cuda_ms(lambda: bundle.encode_eval(rec.extras), iters=3, warmup=1)
    top = sorted(enc_split.items(), key=lambda kv: -kv[1])[:8]
    log(f"[slice] {shape} encode device time by kernel (ms per encode, of {enc_dev:.4f}):")
    for name, t in top:
        log(f"[slice]   {t:.4f}  {name[:110]}")
    enc_err = max(float((u_emb - pu).abs().max()), float((i_emb - pi).abs().max()))
    scale = max(float(pu.abs().max()), float(pi.abs().max()))
    if not enc_err <= ENCODE_RTOL * max(scale, 1.0):
        raise AssertionError(f"{shape}: encode through the kernels differs from the plain "
                             f"version by {enc_err:.3e} (table scale {scale:.3f})")
    n_users, n_items = rec.inter.n_users, rec.inter.n_items
    if u_emb.shape != (n_users, D) or i_emb.shape != (n_items, D):
        raise AssertionError(f"{shape}: table shapes {tuple(u_emb.shape)} {tuple(i_emb.shape)}")
    if not (torch.isfinite(u_emb).all() and torch.isfinite(i_emb).all()):
        raise AssertionError(f"{shape}: non-finite tables")
    for n, m in metrics.items():
        if not all(0.0 <= v <= 1.0 for v in m.values()):
            raise AssertionError(f"{shape}: metrics out of range at {n}: {m}")
    rated = rec.cf_dev.rated_pad.cpu().numpy()
    for row, u in enumerate(users):
        uid = rec.inter.user[u]
        seen = {int(rec.inter.id2item[i]) for i in rated[uid] if i >= 0}
        if seen & set(ids_ex[row].tolist()):
            raise AssertionError(f"{shape}: rated items served to user {u}")
        if np.any(np.diff(sc_ex[row]) > 0) or np.any(np.diff(sc_all[row]) > 0):
            raise AssertionError(f"{shape}: scores not in descending order")
        if [i for i, _ in rec.recommend(u, k=20)] != ids_ex[row].tolist():
            raise AssertionError(f"{shape}: Retriever and Recommender.recommend disagree")
    if not np.all(sc_all[:, 0] >= sc_ex[:, 0]):
        raise AssertionError(f"{shape}: excluding rated items raised a top score")

    summary = dict(
        shape=shape, card=card, layout=layout, test_users=int(rec.cf_dev.eval_data.n_test_users),
        build_s=round(build_s, 3), first_encode_s=round(encode_s, 4),
        encode_ms=round(enc_ms, 4), encode_device_ms=round(enc_dev, 4),
        encode_idle_share=round(max(0.0, 1.0 - enc_dev / enc_ms), 4),
        encode_spmm_kernel_ms=round(kernel_only_ms(enc_split), 4),
        plain_encode_ms=round(plain_enc_ms, 4),
        encode_max_abs_err=enc_err, table_scale=round(scale, 4),
        eval_s=round(eval_s, 4), serve_s_8_users=round(serve_s, 4), launches=launches,
        metrics={str(n): m for n, m in metrics.items()},
    )
    log(f"[slice] {json.dumps(summary)}")
    log(f"[slice] {shape} top-5 for raw user {users[0]}: {ids_ex[0][:5].tolist()} "
        f"scores {[round(float(s), 4) for s in sc_ex[0][:5]]}")
    return launches, summary


def phase_train(shape: str, data, gather_layout: str, kname: str, card: str,
                fit: bool) -> dict:
    """Training at full width under one gather layout: one step through
    the kernels against the same step through the plain versions (same
    state, batch and dropout keys), the launch count, then the main path
    (a whole epoch through `Recommender.train`, or `TRAIN_STEPS` Trainer
    steps) with its launches counted, and the step's timing."""
    from unittest import mock

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer

    tag = f"{shape}/{gather_layout}"
    cfg = make_config("KHGRec", **KHGREC_TRAIN, gather_layout=gather_layout,
                      item_ranking=(10, 20, 40), max_epoch=1, early_stopping_steps=100)
    t0 = time.time()
    rec = Recommender(cfg, DEVICE)
    rec.build(data)
    build_s = time.time() - t0
    bundle = rec.bundle
    dedup, int8 = KERNELS[kname][0] == "dedup", kname.endswith("_int8")
    for adj in (bundle.cf.adj, bundle.kg.kg_adj):
        for side in (adj.fwd, adj.bwd):
            b = side.blocked
            if b is None or (b.dedup, b.int8, b.bf16) != (dedup, int8, True):
                raise AssertionError(f"{tag}: expected (dedup, int8, bf16) = {(dedup, int8, True)} "
                                     f"on every adjacency, got {b and (b.dedup, b.int8, b.bf16)}")
    rec.init_weights(SEED)
    trainer = Trainer(bundle, seed=SEED, extras=rec.extras)
    batches = trainer.sample_epoch()
    batch = tuple(t[0] for t in batches)
    keys = trainer.edge_keys()
    names, params = zip(*bundle.module.named_parameters())

    def loss_and_grads():
        loss, _ = bundle.batch_loss(rec.extras, batch, keys)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return float(loss.detach()), grads

    # --- one step through the kernels (counted) and through the plain versions
    for k in S.LAUNCHES:
        S.LAUNCHES[k] = 0
    loss_k, grads_k = loss_and_grads()
    step_launches = dict(S.LAUNCHES)
    want = {k: (16 if k == kname else 0) for k in S.LAUNCHES}
    if step_launches != want:
        raise AssertionError(f"{tag}: one training step launched {step_launches}, expected {want}")
    with mock.patch.object(sparse, "blocked_spmm", S.blocked_spmm_reference):
        loss_p, grads_p = loss_and_grads()
    if dict(S.LAUNCHES) != step_launches:
        raise AssertionError(f"{tag}: the plain versions launched a kernel")
    loss_rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)
    grad_rel = {}
    for name, gk, gp in zip(names, grads_k, grads_p):
        if not torch.isfinite(gk).all():
            raise AssertionError(f"{tag}: non-finite gradient of {name}")
        grad_rel[name] = float((gk - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
    worst = max(grad_rel, key=grad_rel.get)
    log(f"[train] {tag}: loss kernels {loss_k:.6f} plain {loss_p:.6f} (rel {loss_rel:.2e}); "
        f"worst gradient {worst} rel {grad_rel[worst]:.2e} (tolerance "
        f"{TRAIN_RTOL:g}); {step_launches[kname]} launches of {kname} per step")
    if not loss_rel <= LOSS_RTOL or grad_rel[worst] > TRAIN_RTOL:
        raise AssertionError(f"{tag}: the step through the kernels differs from the plain one")

    # --- the main path, counted
    untrained = None
    if fit:
        rec.encode()
        untrained = rec.evaluate()
    for k in S.LAUNCHES:
        S.LAUNCHES[k] = 0
    t0 = time.time()
    if fit:
        result = rec.train(quiet=False)
        n_steps, n_encodes = rec.trainer.n_batches, 2  # the epoch's eval, the best state's
        loss = result.history[-1].losses["train_loss"]
    else:
        for s in range(TRAIN_STEPS):
            i = s % batches[0].shape[0]
            loss_t, _ = trainer.train_step(tuple(t[i] for t in batches), trainer.edge_keys())
        n_steps, n_encodes = TRAIN_STEPS, 0
        loss = float(loss_t)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = dict(S.LAUNCHES)
    want = {k: (16 * n_steps + 8 * n_encodes if k == kname else 0) for k in S.LAUNCHES}
    if launches != want:
        raise AssertionError(f"{tag}: {n_steps} steps and {n_encodes} encodes launched "
                             f"{launches}, expected {want}")
    if not math.isfinite(loss):
        raise AssertionError(f"{tag}: non-finite training loss {loss}")

    # --- one step's time: wall (CUDA events) and device (profiler)
    step = lambda: trainer.train_step(batch, keys)  # noqa: E731
    wall = cuda_ms(step, iters=5, warmup=1)
    dev, split = device_ms(step, iters=5)
    top = sorted(split.items(), key=lambda kv: -kv[1])[:8]
    log(f"[train] {tag} step device time by kernel (ms per step, of {dev:.4f}):")
    for name, t in top:
        log(f"[train]   {t:.4f}  {name[:110]}")
    summary = dict(
        shape=shape, gather_layout=gather_layout, kernel=kname, card=card,
        build_s=round(build_s, 3), n_train=int(bundle.cf.n_train), steps=n_steps,
        run_s=round(run_s, 3), launches=launches[kname], launches_per_step=step_launches[kname],
        loss=loss, loss_kernels=loss_k, loss_plain=loss_p, loss_rel_err=loss_rel,
        worst_grad=worst, worst_grad_rel_err=grad_rel[worst],
        step_wall_ms=round(wall, 4), step_device_ms=round(dev, 4),
        step_idle_share=round(max(0.0, 1.0 - dev / wall), 4),
        step_spmm_kernel_ms=round(kernel_only_ms(split), 4),
    )
    if fit:
        summary.update(recall20_untrained=untrained[20]["recall"],
                       recall20_after_epoch=result.final_metrics[20]["recall"],
                       examples_per_sec=round(result.examples_per_sec, 1))
    log(f"[train] {json.dumps(summary)}")
    return summary


def phase_probe() -> list[dict]:
    """The gather-fusion probe path with its launches counted, then kernels
    5 and 6 held against their plain versions and (the fused product, f32)
    scipy's product; a JSON row per kernel, times per call in f32 mode."""
    import numpy as np
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.bench import gather_fusion as P
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import gather_fusion as G

    probe = P.make_probe(DEVICE)
    # --- the probe path (its entry point's body), counted
    for k in G.LAUNCHES:
        G.LAUNCHES[k] = 0
    res = P.run_probes(probe, log=lambda line: log(f"[probe] {line}"))
    torch.cuda.synchronize()
    launches = dict(G.LAUNCHES)
    if not all(launches.values()):
        raise AssertionError(f"the probe path launched {launches}: a kernel never ran")
    ms = res["ms"]

    # --- checks: both modes against the plain versions, the fused f32 product
    # against scipy's f32 product
    worst = dict.fromkeys(G.LAUNCHES, 0.0)
    exact = torch.as_tensor(P.csr_matrix(probe) @ probe.x.cpu().numpy(), device=DEVICE)
    for mode, table in (("f32", probe.x), ("bf16", probe.x.to(torch.bfloat16))):
        got = G.resident_row_gather(table, probe.idx)
        if not torch.equal(got, G.resident_row_gather_reference(table, probe.idx)):
            raise AssertionError(f"resident_row_gather {mode} differs from its plain version")
        blk = probe.blocked.replace(bf16=mode == "bf16")
        got = G.fused_window_spmm(blk, probe.x)
        torch.cuda.synchronize()
        ref = G.fused_window_spmm_reference(blk, probe.x)
        scale = max(float(ref.abs().max()), 1.0)
        err = float((got - ref).abs().max())
        ok = err <= KERNEL_RTOL * scale
        err_exact = float((got - exact).abs().max())
        if mode == "f32":
            ok = ok and err_exact <= KERNEL_RTOL * scale
        log(f"[probe] fused_window_spmm {mode}: max_abs_err {err:.3e} vs plain, {err_exact:.3e} "
            f"vs scipy f32 (scale {scale:.3f}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused_window_spmm {mode} disagrees")
        worst["fused_window_spmm"] = max(worst["fused_window_spmm"], err)

    # --- bounds from this run's inputs: each input read once, each output
    # written once (X: the rows the indices reference), f32
    n, d = probe.x.shape
    nnz = probe.cols.numel()
    x_bytes = 4 * d * np.unique(probe.cols.cpu().numpy()).shape[0]
    gather_bytes = x_bytes + 4 * nnz + 4 * nnz * d
    fused_bytes = x_bytes + 12 * nnz + 4 * probe.blocked.nrows * d
    fused_ops = 2 * nnz * d / F32_FLOPS * 1e3
    bounds = {"resident_row_gather": (gather_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
              "fused_window_spmm": max((fused_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                                       (fused_ops, "operations"))}
    rows = []
    for kname, (replaces, k_probe, kb_probe, p_probe, lib_probe) in PROBE_KERNELS.items():
        b_ms, b_by = bounds[kname]
        rows.append(dict(
            name=kname, route="cuda",
            source="hypergraph_diffusion_for_recommendation_tpu_torch/csrc/gather_fusion.cu",
            replaces=replaces, launches=launches[kname], max_abs_err=worst[kname],
            ms=ms[k_probe], plain_ms=ms[p_probe], bound_ms=b_ms, bound_by=b_by,
            library_ms=ms[lib_probe],
        ))
        log(f"[probe] {kname}: {launches[kname]} launches on the probe path; device ms per call "
            f"f32 {ms[k_probe]:.4f} (bf16 {ms[kb_probe]:.4f}), plain "
            f"{ms[p_probe]:.4f}, {lib_probe[3:]} {ms[lib_probe]:.4f}, bound {b_ms:.4f} ({b_by})")
    log(f"[probe] kernel 1 (segment_spmm_rows) on the same layout: f32 "
        f"{ms['5. blocked_spmm f32']:.4f} ms, bf16 {ms['5b. blocked_spmm bf16']:.4f} ms")
    return rows


def _zero_spmm_launches() -> None:
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S

    for k in S.LAUNCHES:
        S.LAUNCHES[k] = 0


def _spmm_launches() -> dict[str, int]:
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S

    return {k: v for k, v in S.LAUNCHES.items() if v}


def _layout_name(b) -> str:
    return ("dedup" if b.dedup else "base") + ("_int8" if b.int8 else "") + (
        "_bf16" if b.bf16 and not b.int8 else "")


def phase_hd(shape: str, data, card: str):
    """HGNN_HD3 at full width: the encode and one training step through the
    kernels against the plain versions, the launch counts, then
    `TRAIN_STEPS` Trainer steps and the step's timing. Returns (summary,
    the Recommender, whose device data the variant phase reuses)."""
    from unittest import mock

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer

    tag = f"HGNN_HD3/{shape}"
    # MODEL_DEFAULTS["HGNN_HD3"]: hyper_dim 128, n_layers 2, batch 2048,
    # drop_rate 0.2, cl_rate 1e-5, temp 0.2; mode full; bf16 gathered operand
    cfg = make_config("HGNN_HD3", compute_dtype="bfloat16", eval_user_batch=512,
                      item_ranking=(10, 20, 40))
    t0 = time.time()
    rec = Recommender(cfg, DEVICE)
    rec.build(data)
    build_s = time.time() - t0
    bundle, cf = rec.bundle, rec.cf_dev
    layouts = {}
    for field in ("adj", "b_hyper"):
        pair = getattr(cf, field)
        for side in ("fwd", "bwd"):
            b = getattr(pair, side).blocked
            if b is None or not b.bf16:
                raise AssertionError(f"{tag}: {field}.{side} has no bf16 kernel layout")
            layouts[f"{field}.{side}"] = f"{_layout_name(b)} {b.nrows}x{b.ncols}"
    rec.init_weights(SEED)

    # --- the encode through the kernels (counted) and through the plain versions
    _zero_spmm_launches()
    u_emb, i_emb = rec.encode()
    torch.cuda.synchronize()
    enc_launches = _spmm_launches()
    if sum(enc_launches.values()) != HD3_ENCODE_LAUNCHES:
        raise AssertionError(f"{tag}: one encode launched {enc_launches}, expected "
                             f"{HD3_ENCODE_LAUNCHES} in all")
    with mock.patch.object(sparse, "blocked_spmm", S.blocked_spmm_reference):
        pu, pi = bundle.encode_eval(rec.extras)
    enc_err = max(float((u_emb - pu).abs().max()), float((i_emb - pi).abs().max()))
    scale = max(float(pu.abs().max()), float(pi.abs().max()))
    if not (torch.isfinite(u_emb).all() and torch.isfinite(i_emb).all()):
        raise AssertionError(f"{tag}: non-finite tables")
    if not enc_err <= ENCODE_RTOL * max(scale, 1.0):
        raise AssertionError(f"{tag}: encode through the kernels differs from the plain version "
                             f"by {enc_err:.3e} (table scale {scale:.3f})")

    # --- one step through the kernels (counted) and through the plain versions:
    # the same batch, edge key and feature-dropout generator seed
    trainer = Trainer(bundle, seed=SEED, extras=rec.extras)
    batches = trainer.sample_epoch()
    batch = tuple(t[0] for t in batches)
    keys = trainer.edge_keys()
    names, params = zip(*bundle.module.named_parameters())

    def loss_and_grads():
        gen = torch.Generator(DEVICE).manual_seed(SEED)
        loss, _ = bundle.batch_loss(rec.extras, batch, keys, gen)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return float(loss.detach()), grads

    _zero_spmm_launches()
    loss_k, grads_k = loss_and_grads()
    step_launches = _spmm_launches()
    if sum(step_launches.values()) != 2 * HD3_ENCODE_LAUNCHES:
        raise AssertionError(f"{tag}: one training step launched {step_launches}, expected "
                             f"{2 * HD3_ENCODE_LAUNCHES} in all")
    with mock.patch.object(sparse, "blocked_spmm", S.blocked_spmm_reference):
        loss_p, grads_p = loss_and_grads()
    if _spmm_launches() != step_launches:
        raise AssertionError(f"{tag}: the plain versions launched a kernel")
    loss_rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)
    grad_rel = {}
    for name, gk, gp in zip(names, grads_k, grads_p):
        if not torch.isfinite(gk).all():
            raise AssertionError(f"{tag}: non-finite gradient of {name}")
        grad_rel[name] = float((gk - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
    worst = max(grad_rel, key=grad_rel.get)
    log(f"[hd] {tag}: encode max_abs_err {enc_err:.3e} (scale {scale:.3f}); loss kernels "
        f"{loss_k:.6f} plain {loss_p:.6f} (rel {loss_rel:.2e}); worst gradient {worst} rel "
        f"{grad_rel[worst]:.2e}; launches an encode {enc_launches}, a step {step_launches}")
    if not loss_rel <= LOSS_RTOL or grad_rel[worst] > TRAIN_RTOL:
        raise AssertionError(f"{tag}: the step through the kernels differs from the plain one")

    # --- the main path: Trainer steps, counted
    _zero_spmm_launches()
    t0 = time.time()
    for s in range(TRAIN_STEPS):
        i = s % batches[0].shape[0]
        loss_t, _ = trainer.train_step(tuple(t[i] for t in batches), trainer.edge_keys())
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = _spmm_launches()
    if sum(launches.values()) != TRAIN_STEPS * 2 * HD3_ENCODE_LAUNCHES:
        raise AssertionError(f"{tag}: {TRAIN_STEPS} steps launched {launches}")
    loss = float(loss_t)
    if not math.isfinite(loss):
        raise AssertionError(f"{tag}: non-finite training loss {loss}")

    step = lambda: trainer.train_step(batch, keys)  # noqa: E731
    wall = cuda_ms(step, iters=5, warmup=1)
    dev, split = device_ms(step, iters=5)
    top = sorted(split.items(), key=lambda kv: -kv[1])[:8]
    log(f"[hd] {tag} step device time by kernel (ms per step, of {dev:.4f}):")
    for name, t in top:
        log(f"[hd]   {t:.4f}  {name[:110]}")
    summary = dict(
        model="HGNN_HD3", shape=shape, card=card, layouts=layouts, build_s=round(build_s, 3),
        n_train=int(cf.n_train), steps=TRAIN_STEPS, run_s=round(run_s, 3),
        launches_per_encode=enc_launches, launches_per_step=step_launches, loss=loss,
        encode_max_abs_err=enc_err, loss_kernels=loss_k, loss_plain=loss_p,
        loss_rel_err=loss_rel, worst_grad=worst, worst_grad_rel_err=grad_rel[worst],
        step_wall_ms=round(wall, 4), step_device_ms=round(dev, 4),
        step_idle_share=round(max(0.0, 1.0 - dev / wall), 4),
        step_spmm_kernel_ms=round(kernel_only_ms(split), 4),
    )
    log(f"[hd] {json.dumps(summary)}")
    return summary, rec


def phase_hd_variants(rec, card: str) -> list[dict]:
    """Each other HD variant (and HGNN_HD3's single-view modes) on the same
    device data: one encode and one Trainer step on the card, finite
    tables and loss, the launches as counted in HD_VARIANTS."""
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer

    out = []
    for (name, mode), want in HD_VARIANTS.items():
        tag = f"{name}/{mode}"
        # the variant's own MODEL_DEFAULTS, at full width (hyper_dim 128)
        bundle = build_model(make_config(name, mode=mode, eval_user_batch=512), rec.cf_dev)
        trainer = Trainer(bundle, seed=SEED)
        batch = tuple(t[0] for t in trainer.sample_epoch())
        _zero_spmm_launches()
        u, i = trainer.encode()
        torch.cuda.synchronize()
        enc = sum(_spmm_launches().values())
        _zero_spmm_launches()
        loss, _ = trainer.train_step(batch, trainer.edge_keys())
        loss = float(loss)
        step = sum(_spmm_launches().values())
        finite = bool(torch.isfinite(u).all() and torch.isfinite(i).all()) and math.isfinite(loss)
        log(f"[variant] {tag}: loss {loss:.6f}, tables {tuple(u.shape)} {tuple(i.shape)}, "
            f"launches an encode {enc}, a step {step} (expected {want} and {2 * want})")
        if not finite or (enc, step) != (want, 2 * want):
            raise AssertionError(f"{tag}: finite={finite}, launches ({enc}, {step}), expected "
                                 f"({want}, {2 * want})")
        out.append(dict(model=name, mode=mode, loss=loss, launches_encode=enc,
                        launches_step=step, card=card))
    return out


def phase_prop_cache(name: str, data, card: str) -> dict:
    """`PROP_CACHE_RUN` Trainer steps with prop_cache_steps K: only every
    K-th step launches a kernel; each step's time between CUDA events, the
    mean of the cached steps beside the full steps'. Counts the host syncs
    of the cached steps (torch's sync debug mode)."""
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer

    k = PROP_CACHE_STEPS
    if name == "KHGRec":  # phase 6's configuration
        cfg = make_config("KHGRec", **KHGREC_TRAIN, prop_cache_steps=k)
        per_full = 16
    else:
        cfg = make_config(name, compute_dtype="bfloat16", eval_user_batch=512,
                          prop_cache_steps=k)
        per_full = 2 * HD3_ENCODE_LAUNCHES
    rec = Recommender(cfg, DEVICE)
    rec.build(data)
    rec.init_weights(SEED)
    trainer = Trainer(rec.bundle, seed=SEED, extras=rec.extras)
    batches = trainer.sample_epoch()
    n_b = batches[0].shape[0]
    per_step, events = [], []
    syncs = []  # where each host sync of a cached step was called from
    for s in range(PROP_CACHE_RUN):
        batch, keys = tuple(t[s % n_b] for t in batches), trainer.edge_keys()
        cached = s % k != 0
        _zero_spmm_launches()
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if cached:
                torch.cuda.set_sync_debug_mode("warn")
            ev[0].record()
            trainer.train_step(batch, keys)
            ev[1].record()
            torch.cuda.set_sync_debug_mode("default")
        syncs += [f"{'/'.join(Path(w.filename).parts[-3:])}:{w.lineno}" for w in caught
                  if "synchroniz" in str(w.message)]
        torch.cuda.synchronize()
        per_step.append(sum(_spmm_launches().values()))
        events.append(ev)
    want = [0 if s % k else per_full for s in range(PROP_CACHE_RUN)]
    if per_step != want:
        raise AssertionError(f"{name}: launches per step {per_step}, expected {want}")
    if trainer.extras["prop_age"] != PROP_CACHE_RUN:
        raise AssertionError(f"{name}: prop_age {trainer.extras['prop_age']}")
    times = [a.elapsed_time(b) for a, b in events]
    full_ms = statistics.mean(t for s, t in enumerate(times) if s % k == 0)
    cached_ms = statistics.mean(t for s, t in enumerate(times) if s % k)
    summary = dict(model=name, card=card, k=k, steps=PROP_CACHE_RUN, launches_per_step=per_step,
                   full_step_ms=round(full_ms, 4), cached_step_ms=round(cached_ms, 4),
                   cached_step_host_syncs=len(syncs), sync_sites=sorted(set(syncs)))
    log(f"[prop_cache] {json.dumps(summary)}")
    return summary


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        import hypergraph_diffusion_for_recommendation_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: {e}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 scoring, as on the reference
    torch.backends.cudnn.allow_tf32 = False
    warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t_start = time.time()

    card = phase_device()
    phase_build()
    graphs = make_graphs()
    rows = phase_kernels(graphs)
    summaries = []
    for shape, kname in (("lastfm", "segment_spmm_rows"), ("ml1m", "segment_spmm_dedup")):
        layout = KERNELS[kname][0]
        launches, summary = phase_slice(shape, graphs[shape]["data"], layout, card)
        want = {k: (8 if k == kname else 0) for k in launches}
        if launches != want:
            raise AssertionError(f"{shape}: one encode launched {launches}, expected {want}")
        summaries.append(summary)
    trains = []
    for i, (shape, gather_layout, kname) in enumerate(TRAIN_PHASES):
        t = phase_train(shape, graphs[shape]["data"], gather_layout, kname, card, fit=i == 0)
        # per training step, as the row's times
        next(r for r in rows if r["name"] == kname)["launches"] = t["launches_per_step"]
        trains.append(t)
    rows += phase_probe()
    lastfm = graphs["lastfm"]["data"]
    hd, hd_rec = phase_hd("lastfm", lastfm, card)
    variants = phase_hd_variants(hd_rec, card)
    del hd_rec
    caches = [phase_prop_cache(name, lastfm, card) for name in ("KHGRec", "HGNN_HD3")]
    (OUT_DIR / "summary.json").write_text(json.dumps(dict(
        kernels=rows, slices=summaries, training=trains, hd=hd, hd_variants=variants,
        prop_cache=caches), indent=1))
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
