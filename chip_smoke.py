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
     bound (kernel 3's from its own bytes: X read once by the quantisation,
     q written, the used q rows gathered at 1 B, the indices and values, the
     f32 output); the wrapper time of kernels 1-2's earlier code beside
     each of their rows and of kernel 3's f64 design (the base kernel
     on an int8 table, f64 sums and a dequantisation pass) beside its rows,
     and kernel 3's wrapper with the torch quantisation; each wrapper's
     device time per step split by kernel name, kernel 3's beside its f64
     design's split and kernel 1's body, with its two targets (wrapper at
     or below torch.sparse.mm, body at or below kernel 1's) held or
     missed; the rows on kernel 3's f64 path, and kernel 3 on the LastFM
     CF layout with every other value scaled by 2^12 (its rows on the f64
     path: bit for bit, timed beside the f64 design's call); two calls
     compared bit for bit (kernel 1 and the int8 kernels must repeat
     exactly, and the int8 kernels, whose sums are exact, equal their plain
     version exactly; the others report); the int8 quantisation kernel (`quantize_int8_fused`)
     on each X, bit for bit with `quantize_int8`, and its device time;
     kernel 2 beside kernel 1 on the same ML-1M-density layouts, which says
     whether `dedup_auto` picks the faster kernel on this card;
  4. the serving slice at the LastFM shape, full width: KHGRec encode
     through the kernels, as a replayed CUDA graph (8 launches a replay,
     counted in the profiler's trace; bit for bit the eager encode, whose
     wall, device time and idle share it reports beside its own), the same
     encode through the plain version, ranking metrics over every test user,
     export, and top-k requests through `Retriever`;
  5. the same at ML-1M density, where the dedup layout and kernel run;
  6. training at full width (bench.py's configuration), one phase per
     layout: the LastFM shape with gather_layout "auto" (base, kernel 1),
     ML-1M density with "auto" (dedup, kernel 2), the LastFM shape with
     "int8" (kernel 3), ML-1M density with "dedup_int8" (kernel 4). Each
     holds one training step through the kernels against the same step
     through the plain versions (loss and every parameter's gradient),
     counts exactly 16 launches of its kernel per step (8 forward, 8
     backward; the int8 phases also 16 of the quantisation kernel, and
     their step through the kernels equals the plain one exactly), then
     trains through the replayed CUDA graphs of the step and the encode: a
     whole `Recommender.train()` epoch with its evaluation in the first
     phase (Recall@20 beside the untrained state's; its time and examples/s
     beside the same epoch run eagerly, and a second epoch of each), 5
     `Trainer` steps in the others; then the graph check (`graph_check`):
     the replayed step against the eager step from one full state, after 1
     and 8 steps (bit for bit where two eager runs agree bit for bit, else
     within GRAPH_RTOL), the SpMM launches inside one replayed step and one
     eager step counted by kernel name in the profiler's trace (16 each),
     and both steps' wall, device time and idle share;
  7. the gather-fusion probe path (`bench/gather_fusion.py`, the port of
     scripts/bench_gather_fusion.py) at its shapes, launches counted:
     kernels 5 and 6 (`resident_row_gather`, `fused_window_spmm`) in f32
     and bf16 against their plain versions (the gather exactly, the fused
     product within KERNEL_RTOL, and in f32 also against scipy's product;
     two calls of the fused product bit for bit), with the device times of
     each kernel beside PR 4's, its plain version, its library call and
     kernel 1 on the same layout;
  8. HGNN_HD3 at full width at the LastFM shape (its MODEL_DEFAULTS, mode
     full, bf16 operand): the encode through the kernels against the plain
     versions, one training step likewise (loss and every gradient), 24
     SpMM launches an encode and 48 a step (8 and 16 forward products on
     the CF adjacency and the rectangular b_hyper incidence, as many
     backward), then 5 `Trainer` steps and the graph check (48 launches a
     replayed step), and the layout `dedup_auto` picked for b_hyper;
  9. every other HD variant and HGNN_HD3's local_only and group_only modes:
     one encode and one `Trainer` step each, finite, launches asserted;
 10. cached propagation (prop_cache_steps 8) for 16 `Trainer` steps in
     KHGRec (LastFM, auto) and HGNN_HD3, as graphs: the SpMM wrappers run
     from Python at steps 0 (eager) and 8 (its capture) only, no cached
     step synchronises with the host; then the graph check per branch (a
     full replay 16 or 48 launches, a cached one 0), the cached step's
     time beside the full step's;
 11. HGNN, HD2 and HGNNAblation (mode wohyper) at full width at the LastFM
     shape: one encode and one step through the kernels against the plain
     versions, their launches, then 5 replayed steps (a replay's launches
     counted in the trace) and the replayed step's times;
 12. LightGCN at full width (width 64, 2 layers, reg 0.1, batch 2048, bf16
     operand) at the LastFM shape (kernel 1) and at ML-1M density (kernel
     2): one step through the kernels against the plain versions (loss and
     every gradient), 4 launches a step and 2 an encode, then the main path
     (a whole `Recommender.train()` epoch at the LastFM shape, its
     examples/s and Recall@20 beside the untrained state's; 5 `Trainer`
     steps at ML-1M density), top-20 for 8 users through `Retriever`, and
     the replayed step bit for bit the eager step after 1 and 8 steps;
 13. the other twelve models that read only the CF adjacency (MF, HCCF,
     HGCN, SHT, DirectAU, SimGCL, XSimGCL, NCL, MixGCF, SSL4Rec, BUIR,
     SelfCF) at the LastFM shape with their MODEL_DEFAULTS, width 64 and
     the bf16 operand: the encode and one step through the kernels against
     the plain versions with the launches of `ZOO`, NCL's k-means
     `epoch_setup` on the card, the replayed step bit for bit the eager
     step (BUIR's `update_extras` inside the graph) and its times;
 14. KHGRec's joint encode (HGDR_JOINT) in phase 6's configuration: 4
     launches an encode and 8 a step, against the plain versions, equal to
     the unfused encode, the replayed step bit for bit the eager step, and
     its wall and device time beside the unfused step's (16 launches) on the
     same device data.
 15. SGL at full width (LightGCN's width 64 and batch 2048, SGL's
     MODEL_DEFAULTS: 2 layers, reg 0.1, drop_rate 0.1, edge dropout; bf16
     operand) at the LastFM shape (kernel 1) and at ML-1M density (kernel 2),
     as phase 12: the epoch's augmented views drawn by `epoch_setup` on the
     card, one step (6 launches) and the encode (2) against the plain
     versions, a whole `Recommender.train()` epoch at the LastFM shape (its
     Recall@20 beside the untrained state's; at reg 0.1 SGL's un-normalised
     L2 term collapses the first epochs, so the learning check is the same
     epoch at reg 0, which must beat its untrained state), at ML-1M density
     5 steps, new views, 5 more steps through the same graph, serving, and
     the replayed step bit for bit the eager step;
 16. the other adjacency forms (DHCF and DHCF_diffusion at hyper_dim 64,
     HCCF_diffusion, KGIN, KGCL, AutoCF, LRMRec) at the LastFM shape on one
     CF device data with `raw_adj`, `raw_int` and `int_norm` and the KG
     device data, MODEL_DEFAULTS, width 64, bf16 operand: a width-1 product
     on raw_adj and its backward through kernel 1 (padded to width 8)
     against the plain version; each model's encode and one step against
     the plain versions with the launches of `ADJACENCY`; AutoCF's and
     LRMRec's subgraph refresh against the plain one (5 launches, the same
     decoder lists), their refresh and keep step graphs each replayed bit for
     bit its eager step (7 and 2 launches a replayed step), and every
     model's replayed step's wall, device time and idle share.
 17. KGAT at full width (the KGAT paper's embedding 64, relation_dim 64,
     conv_dim_list (64, 32, 16), bi-interaction; MODEL_DEFAULTS' reg,
     reg_kg and lrate 1e-4; batch 2048, KG batch 8192; bf16 operand) at the
     LastFM shape and at ML-1M density, through the alternating trainer: one
     CF step and one KG step against the plain versions (0 SpMM launches:
     KGAT reaches no segment-SpMM kernel), the KG step's relation gather
     three ways (one-hot matmul, the code's; hub-safe gather; plain
     indexing) with their device times, the attention refresh against f64
     with its time and transient memory, the encode against the plain
     version; at the LastFM shape one `Recommender.train()` epoch whose
     Recall@20 must beat the untrained state's (at KGAT_LEARN_LRATE if the
     paper's rate does not), at ML-1M density TRAIN_STEPS steps of each
     phase and the refresh; serving; each phase's step graph replayed bit
     for bit its eager step, with its times;
 18. KTUP, HKGRippleNet, MHCN and SEPT at the LastFM shape and MHCN at ML-1M
     density, width 64, bf16 operand, each built by `Recommender.build`
     (the social models given `synthetic_social(inter, 5)`): the build times
     (ripple sets, user-user matrices), each social matrix's shape, nnz and
     kernel, the encode and one step against the plain versions with their
     SpMM launches by kernel name (`REST`), serving, and the replayed step
     bit for bit its eager step with its times.
 19. SASRec and CL4SRec in the SASRec paper's configuration (`SEQ_TRAIN`: d
     50, 2 blocks, 1 head, max length 50, batch 128, lr 0.001; dropout 0.5 at
     the LastFM shape, 0.2 at ML-1M density; CL4SRec's cl_rate 0.1, temp 1):
     the encode graph bit for bit the eager encode, SEQ_EPOCHS epochs through
     `Recommender.train()` (0 SpMM launches; examples/s; Recall@20 above the
     untrained state's), serving, and the replayed step bit for bit the eager
     step after 1 and 8 steps, with its wall, device time and idle share.
 20. the CLI from files: the LastFM-shape split written in the reference
     layout and parsed by the native library (against its plain parser);
     `cli.main` for KHGRec in bench.py's configuration (`--experiment=missing
     --missing_pct=20 --export_embeddings`, 2 epochs: kernel 1 launches, the
     JAX package's artifact headers) and SASRec (`--experiment=cold_start
     --group_id=1`: no SpMM); `serving_cli` over the export; and resume on the
     card: a fresh Trainer restores the checkpoint of a 2-epoch
     `fit(ckpt_every=1)` and its next epoch equals an uninterrupted run's third
     bit for bit (loss, parameters, Adam states, extras), for KHGRec and for
     KGAT (two Adam instances, two step graphs). The layout variables through
     the CLI: a LightGCN epoch with HGDR_DEDUP=0 at ML-1M density launches
     kernel 1 and not kernel 2, one with HGDR_DEDUP=1 at the LastFM shape
     kernel 2 and not kernel 1; MHCN without social data is refused
     (`python -m ...cli`, non-zero exit code).
 21. the KG-embedding trainer (`train/kg_embedding.py`): TransE, DistMult and
     RealE at KGEConfig's defaults (dim 64, batch 2048, lr 0.001, 10
     negatives, window 2, arity 6, sigmoid) on the KG CLI's default KG
     (`generate_kg(2000, 16, seed=1)`: 3,985 triples, 2,128 entities) and on
     the LastFM-shape KG (`generate_kg(17632, 16, seed=1)`: 34,829, 17,760):
     the replayed step bit for bit the eager step after 1 and 8 steps, with
     its wall, device time and idle share; KGE_EPOCHS epochs with finite
     losses, triples a second; the evaluation's wall time and filtered
     Measure, each of its ranks within its near ties of the CPU plain
     evaluation's of the same tables (the entities whose float64 score lies
     within KGE_TIE_RTOL of the row's scale of the true entity's); no SpMM
     launched. Then the JAX slow tier's learning checks (RealE's full-entity
     CE branch on `generate_kg(400, 8, 4, seed=2, max_triples_per_item=8)`,
     RealE on arity-3 tuples: filtered Hit@10 above 0.15), and `python -m
     ...kg_embedding_cli --model RealE --max_epoch 3 --test_by_arity` in a
     process of its own (exit code 0).
 22. profile: `Trainer.profile_epoch` of KHGRec in bench.py's configuration at the
     LastFM shape (kernel 1) and at ML-1M density (kernel 2), its steps replayed
     graphs: the profiled epoch's loss and aux terms bit for bit those of the same
     epoch unprofiled from the same restored state; the trace read by
     `utils/trace_analysis.py` (one execution of the step annotation a step, 16
     SpMM launches a step at most, traced again while fewer: the profiler loses
     events); `trace_roofline` with the kernels' bytes (`spmm_bytes`, as
     `bound_ms` reckons them, times the launches) and `cost_analysis` of one
     step; the trace's device time a step within PROFILE_RTOL of phase 6's
     replayed step; every share at most 1; the step's FLOPs.
 23. parallel: the collective layer (`parallel/`) on 4 ranks (a 2 x 2 mesh) that
     share the card through gloo, started by `utils.platform.run_ranks`, with
     LastFM-shape tables (1890 x 17632, width 64, batch 2048): the sharded and
     all-to-all lookups' rows and gradients bit for bit the single-device
     gather's (no overflow at capacity factor 2), `sharded_user_topk` at k 40
     giving the single-device `masked_topk`'s ids but at counted near ties, 5
     `ShardedMF` steps within 1e-6 of the dense steps; each rank's backend and
     device, each call's time.
 24. supervisor: `utils.supervisor.run_supervised` around `python -m ...cli` for
     KHGRec (bench.py's configuration, 11 epochs, checkpoints): the child's
     process group is SIGKILLed once its first checkpoint (epoch 10) exists; the
     restart carries --resume once, and its epochs and final metrics equal an
     uninterrupted run's bit for bit.

Each phase's seconds are printed as it ends (`[time]`), and all of them
with the total before the result lines.

The wrappers' launch counts (`LAUNCHES`) count Python calls: in graph mode
a branch's eager first step and its capture, never a replay. A replayed
step's launches are those its graph's capture counted
(`Trainer.replayed_launches`); the profiler's trace, which can lose an
event, gives times.

The line before the last is the card's name and power limit; before it,
one JSON line with a row per kernel (kernels 1-4: times per training step
at the kernel's main-path shape, launches in one replayed step; kernels 5-6: times per
call at the probe's shapes, launches on the probe path; the int8
quantisation: per training step at ML-1M density, the dedup_int8 phase's
launches). The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Weights are random, drawn from a seeded generator. It imports nothing of
JAX or of the JAX package, and exits non-zero without a CUDA card or
without the port's package beside it.
"""

from __future__ import annotations

import json
import math
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
INT8_OPS = 1979e12  # int8 operations a second (the table's dense int8 rate)

DEVICE = "cuda"
D = 128  # hyper_dim of the serving path
SEED = 0
TIMED_ITERS = 20

# kernel vs plain version: the same products summed in another f32 order
# (each kernel's fixed order, the plain version's `index_add_`); the int8
# kernels' f64 sums are exact and must equal the plain version's bits
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
# figures of earlier designs, printed beside this run's (this script on an NVIDIA H100 80GB HBM3
# at 700 W): kernels 1, 2 and 4 in the code before the int8 and probe kernels were redesigned,
# kernel 3 in its f64 design (the base kernel on an int8 table with f64 sums, a dequantisation
# pass and two quantisation launches).
# Each phase-3 row's wrapper device ms per call, by (kernel, graph.matrix.direction, mode), and
# each kernel's per-step ms at its main-path shape
BEFORE_WRAPPER_MS = {  # (kernel, graph.matrix.direction): {mode: ms}
    ("segment_spmm_rows", "lastfm.cf.fwd"): {"f32": 0.0148, "bf16": 0.0157},
    ("segment_spmm_rows", "lastfm.cf.bwd"): {"f32": 0.0149, "bf16": 0.0158},
    ("segment_spmm_rows", "lastfm.kg.fwd"): {"f32": 0.0201, "bf16": 0.0219},
    ("segment_spmm_rows", "lastfm.kg.bwd"): {"f32": 0.0207, "bf16": 0.0230},
    ("segment_spmm_rows", "ml1m.cf.fwd"): {"f32": 0.0196, "bf16": 0.0183},
    ("segment_spmm_rows", "ml1m.cf.bwd"): {"f32": 0.0196, "bf16": 0.0182},
    ("segment_spmm_rows", "ml1m.kg.fwd"): {"f32": 0.0204, "bf16": 0.0189},
    ("segment_spmm_rows", "ml1m.kg.bwd"): {"f32": 0.0204, "bf16": 0.0189},
    ("segment_spmm_dedup", "lastfm.cf.fwd"): {"f32": 0.0719, "bf16": 0.0497},
    ("segment_spmm_dedup", "lastfm.cf.bwd"): {"f32": 0.0718, "bf16": 0.0489},
    ("segment_spmm_dedup", "lastfm.kg.fwd"): {"f32": 0.3291, "bf16": 0.0607},
    ("segment_spmm_dedup", "lastfm.kg.bwd"): {"f32": 0.3291, "bf16": 0.0612},
    ("segment_spmm_dedup", "ml1m.cf.fwd"): {"f32": 0.0575, "bf16": 0.0249},
    ("segment_spmm_dedup", "ml1m.cf.bwd"): {"f32": 0.0573, "bf16": 0.0256},
    ("segment_spmm_dedup", "ml1m.kg.fwd"): {"f32": 0.0529, "bf16": 0.0242},
    ("segment_spmm_dedup", "ml1m.kg.bwd"): {"f32": 0.0534, "bf16": 0.0240},
    ("segment_spmm_rows_int8", "lastfm.cf.fwd"): {"int8": 0.0366},
    ("segment_spmm_rows_int8", "lastfm.cf.bwd"): {"int8": 0.0368},
    ("segment_spmm_rows_int8", "lastfm.kg.fwd"): {"int8": 0.0508},
    ("segment_spmm_rows_int8", "lastfm.kg.bwd"): {"int8": 0.0510},
    ("segment_spmm_rows_int8", "ml1m.cf.fwd"): {"int8": 0.0283},
    ("segment_spmm_rows_int8", "ml1m.cf.bwd"): {"int8": 0.0283},
    ("segment_spmm_rows_int8", "ml1m.kg.fwd"): {"int8": 0.0293},
    ("segment_spmm_rows_int8", "ml1m.kg.bwd"): {"int8": 0.0293},
}
BEFORE_STEP_MS = {"segment_spmm_rows": 0.3051, "segment_spmm_dedup": 0.3906,
                  "segment_spmm_rows_int8": 0.7008, "segment_spmm_dedup_int8": 3.5692}
# the design BEFORE_* holds for each kernel
BEFORE_OF = {"segment_spmm_rows": "the earlier code", "segment_spmm_dedup": "the earlier code",
             "segment_spmm_rows_int8": "the f64 design", "segment_spmm_dedup_int8": "the earlier code"}
# kernel 3's f64 design per step at the LastFM shape, by launch
BEFORE_INT8_SPLIT = {"segment_spmm_rows_kernel<signed char>": 0.3601, "column_amax_kernel": 0.1312,
                     "dequantise_kernel": 0.1108, "quantise_kernel": 0.0987}
# kernel 3's f64 path is timed on this layout, beside the f64 design's call there (its SpMM
# launch alone, ms; its time does not depend on the values)
F64_PATH_AT, F64_DESIGN_BODY_MS = ("lastfm", "cf", "fwd"), 0.0187
# the int8 quantisation kernel's row: per training step at the dedup_int8 phase's shape
QUANT_SHAPE = "ml1m"

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
# PR 4's kernel-6 design (a CTA per row window, shared float atomics), ms per call (f32, bf16)
BEFORE_PROBE_MS = {"fused_window_spmm": (0.3851, 0.4779)}
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
# a replayed step against eager steps from one state: after 1 step and after 8; where two eager
# runs differ (float atomics in the index additions), within GRAPH_RTOL of each tensor's scale
GRAPH_COMPARE_STEPS = (1, 8)
GRAPH_RTOL = 1e-5
TRACE_ATTEMPTS = 8  # traces taken before a launch count is held wrong
# the KHGRec family's other members at full width: (model, mode): SpMM launches of an encode (a
# step has twice as many); HGNNAblation's wohyper conv is one hop, 6 products
FAMILY = {("HGNN", "full"): 8, ("HD2", "full"): 8, ("HGNNAblation", "wohyper"): 6}
FAMILY_REPLAYS = 5
FAMILY_GRAD_FLOOR = 1e-2
# LightGCN at full width: the LightGCN paper's and SELFRec's LightGCN.conf width 64,
# MODEL_DEFAULTS' 2 layers and reg 0.1, batch 2048, the bf16 gathered operand
LIGHTGCN_TRAIN = dict(embedding_size=64, n_layers=2, reg=0.1, batch_size=2048,
                      compute_dtype="bfloat16", eval_user_batch=512)
# (shape, the kernel its layout runs, whether a whole Recommender.train() epoch runs)
LIGHTGCN_PHASES = (("lastfm", "segment_spmm_rows", True), ("ml1m", "segment_spmm_dedup", False))
# the adjacency-only zoo at the LastFM shape, each with its MODEL_DEFAULTS, width 64 and the
# bf16 gathered operand: name: (SpMM launches of a training step, of an encode), as the code
# gives them with 2 layers (a LightGCN pass: 2 forward, 2 backward; SimGCL 3 passes, XSimGCL 2;
# SelfCF's target pass has no backward; HGCN's conv is two-hop; HCCF's one-sided product has a
# torch-ops backward)
ZOO = {"LightGCN": (4, 2), "MF": (0, 0), "HCCF": (2, 2), "HGCN": (8, 4), "SHT": (4, 2),
       "DirectAU": (0, 0), "SimGCL": (12, 2), "XSimGCL": (8, 2), "NCL": (4, 2),
       "MixGCF": (4, 2), "SSL4Rec": (0, 0), "BUIR": (0, 0), "SelfCF": (6, 2)}
ZOO_WIDTH = dict(embedding_size=64, compute_dtype="bfloat16", eval_user_batch=512)  # on LightGCN's data
# KHGRec's joint encode (HGDR_JOINT): SpMM launches of a step and of an encode, joint and unfused
JOINT_LAUNCHES, UNFUSED_LAUNCHES = (8, 4), (16, 8)
# SGL at full width: LightGCN's width 64 and batch, SGL's MODEL_DEFAULTS (2 layers, reg 0.1,
# drop_rate 0.1, edge dropout), the bf16 gathered operand; its phases as LIGHTGCN_PHASES
SGL_TRAIN = dict(embedding_size=64, batch_size=2048, compute_dtype="bfloat16",
                 eval_user_batch=512)
# the other adjacency forms at the LastFM shape with their MODEL_DEFAULTS, width 64 and the
# bf16 gathered operand: name: (SpMM launches of a training step, of an encode), as the code
# gives them with 2 layers (SGL: three one-sided LightGCN passes, a kernel forward each layer;
# DHCF: two two-hop convs a layer over raw_int, forward and backward; DHCF_diffusion: scatter
# form; HCCF_diffusion: HCCF's one-sided product; KGIN: one spmm_pair on int_norm; KGCL: three
# LightGCN passes; AutoCF and LRMRec: {branch: launches a step}, the encoder's two one-sided
# products, five more in a refresh: four for the seed scores, one for the mask ball)
ADJACENCY = {"SGL": (6, 2), "DHCF": (16, 8), "DHCF_diffusion": (0, 0), "HCCF_diffusion": (2, 2),
             "KGIN": (2, 1), "KGCL": (12, 2), "AutoCF": ({"refresh": 7, "keep": 2}, 2),
             "LRMRec": ({"refresh": 7, "keep": 2}, 2)}
ADJACENCY_WIDTH = dict(embedding_size=64, hyper_dim=64, compute_dtype="bfloat16",
                       eval_user_batch=512)
# SpMM launches of AutoCF's subgraph refresh (`update_extras`), two of them on X of width 1
REFRESH_LAUNCHES = 5
# KGAT at full width: the KGAT paper's configuration (Wang et al., KDD 2019, §4.1.3: embedding
# 64, relation_dim 64, conv_dim_list (64, 32, 16), bi-interaction), MODEL_DEFAULTS' reg, reg_kg
# and lrate 1e-4, the bench batches (2048 CF, 8192 KG), the bf16 operand
KGAT_TRAIN = dict(embedding_size=64, relation_dim=64, conv_dim_list=(64, 32, 16),
                  aggregation_type="bi-interaction", batch_size=2048, batch_size_kg=8192,
                  compute_dtype="bfloat16", eval_user_batch=512)
# the rate of the JAX package's own KGAT learning test (tests/test_models_kg.py), for the
# learning check when one epoch at the paper's 1e-4 leaves Recall@20 where it was
KGAT_LEARN_LRATE = 0.01
# the refresh against its f64 form: softmax weights of f32 logits of magnitude up to about 10,
# exponentiated, so an f32 logit's rounding (about 1e-6 of it) is a relative error of ~1e-5
REFRESH_RTOL = 1e-4
# the other KG recommenders and the social models: name: (SpMM launches of a training step, of
# an encode) with 2 layers (MHCN: 3 channels x 2 layers and inv_int_norm, forward and backward;
# SEPT: adj, friend and sharing x 2 layers forward and backward, its encode the main view only)
REST = {"KTUP": (0, 0), "HKGRippleNet": (0, 0), "MHCN": (14, 7), "SEPT": (12, 2)}
REST_WIDTH = dict(embedding_size=64, batch_size=2048, batch_size_kg=8192,
                  compute_dtype="bfloat16", eval_user_batch=512)
# SASRec at full width: the SASRec paper's configuration (Kang & McAuley, ICDM 2018, §IV: d 50,
# 2 blocks, 1 head, max length 50, batch 128, lr 0.001; dropout 0.5 on the sparse data, 0.2 on
# ML-1M); CL4SRec on the same encoder with the JAX package's test values (cl_rate 0.1, temp 1)
SEQ_TRAIN = dict(embedding_size=50, n_layers=2, batch_size=128, lrate=0.001, cl_rate=0.1,
                 temp=1.0, eval_user_batch=512)
SEQ_DROPOUT = {"lastfm": 0.5, "ml1m": 0.2}
SEQ_EPOCHS = 3
# the CLI phase: KHGRec in bench.py's configuration as flags (the CLI has no compute_dtype
# flag: the f32 operand), then SASRec in the paper's; both for 2 epochs
CLI_KHGREC = ["--model=KHGRec", "--hyper_dim=128", "--relation_dim=32", "--n_layers=2",
              "--batch_size=2048", "--batch_size_kg=8192", "--mode=full", "--drop_rate=0.2",
              "--p=0.3", "--temp=1.0", "--cl_rate=0.01", "--lrate=0.001", "--max_epoch=2",
              "--experiment=missing", "--missing_pct=20", "--export_embeddings"]
CLI_SASREC = ["--model=SASRec", "--embedding_size=50", "--n_layers=2", "--batch_size=128",
              "--drop_rate=0.5", "--lrate=0.001", "--max_epoch=2", "--experiment=cold_start",
              "--group_id=1", "--export_embeddings"]
# phase 20's layout variables: (dataset, HGDR_DEDUP, the kernel that must launch, the one
# that must not), each through one LightGCN epoch of the CLI
CLI_LAYOUTS = (("ml1m", "0", "segment_spmm_rows", "segment_spmm_dedup"),
               ("lastfm", "1", "segment_spmm_dedup", "segment_spmm_rows"))
CLI_LIGHTGCN = ["--model=LightGCN", "--embedding_size=64", "--batch_size=2048", "--max_epoch=1"]
# the KG-embedding phase: the KG CLI's default KG and the LastFM-shape KG
# (`generate_kg` arguments), each model at KGEConfig's defaults, KGE_EPOCHS epochs
KGE_KGS = {"cli": dict(n_items=2000, n_clusters=16, seed=1),
           "lastfm": dict(n_items=17632, n_clusters=16, seed=1)}
KGE_MODELS = ("TransE", "DistMult", "RealE")
KGE_EPOCHS = 3
# an entity whose float64 score lies within this share of the row's scale of the true
# entity's is a near tie: a rank may differ between the card and the CPU by as many
KGE_TIE_RTOL = 1e-6
# the JAX package's artifact headers (utils/logging.py), at the CLI's top-N 10, 20, 40
PERF_HEADER = "epoch,train_time,test_time,hit@40,precision@40,recall@40,ndcg@40"
FINAL_HEADER = "topN,hit_ratio,precision,recall,ndcg"
# phase 22: `Trainer.profile_epoch` of KHGRec (KHGREC_TRAIN) at each shape, the kernel its
# "auto" layout launches; the trace's device time a step against the replayed step's
# `device_ms` (phase 6), within PROFILE_RTOL
PROFILE_SHAPES = (("lastfm", "segment_spmm_rows"), ("ml1m", "segment_spmm_dedup"))
PROFILE_RTOL = 0.10
# phase 23: the collective layer on PARALLEL_MESH ranks sharing the card, LastFM-shape tables
# (1890 users x 17632 items) at width 64, batch 2048; sharded_user_topk at k 40 over every
# user; PARALLEL_MF_STEPS ShardedMF steps within PARALLEL_MF_ATOL of the dense steps; each
# call timed PARALLEL_REPS times on every rank
PARALLEL_MESH = (2, 2)
PARALLEL_DIM, PARALLEL_BATCH, PARALLEL_K = 64, 2048, 40
PARALLEL_MF_STEPS, PARALLEL_MF_LRATE, PARALLEL_MF_ATOL = 5, 0.05, 1e-6
PARALLEL_REPS = 5
# a sharded top-k id may differ from the dense one where the two scores lie within this share
# of the row's largest |score| (the local products may sum in another order than the full one)
TOPK_TIE_RTOL = 1e-6
# phase 24: KHGRec in bench.py's configuration through the CLI under the supervisor; the CLI
# saves a checkpoint every 10 epochs (as the JAX CLI), so the run takes 11: the child is
# killed once epoch 10's checkpoint exists, and the restart resumes for epoch 11
SUPERVISED_EPOCHS = 11
CLI_MODULE = "hypergraph_diffusion_for_recommendation_tpu_torch.cli"
CLI_SUPERVISED = ["--model=KHGRec", "--hyper_dim=128", "--relation_dim=32", "--n_layers=2",
                  "--batch_size=2048", "--batch_size_kg=8192", "--mode=full", "--drop_rate=0.2",
                  "--p=0.3", "--temp=1.0", "--cl_rate=0.01", "--lrate=0.001",
                  "--dataset=synthetic", "--early_stopping_steps=100", "--save_checkpoints",
                  f"--max_epoch={SUPERVISED_EPOCHS}"]


# phase 25: the sharded runtime on ranks that share the card (gloo). Products on a (1, 4)
# mesh: (shape, matrix, modes) with a bf16 operand at width SHARDED_WIDTH; KHGRec (bench.py's
# configuration), MF's checkpoints and ShardedLightGCN on a (2, 2) mesh; every product and
# its X-gradient within SHARDED_SPMM_RTOL of the unsharded kernel, the first step's loss and a
# resumed epoch's within SHARDED_STEP_RTOL, an epoch's and the CLI's metrics within
# SHARDED_EPOCH_RTOL, evaluate() within SHARDED_EVAL_ATOL of the single-device evaluation of
# the same embeddings, SHARDED_KHGREC_LAUNCHES SpMM launches a KHGRec step on every rank
SHARDED_SPMM_MESH = (1, 4)
SHARDED_TRAIN_MESH = (2, 2)
SHARDED_WIDTH = 128
SHARDED_PRODUCTS = (("lastfm", "cf", ("window", "balanced"), False),
                    ("lastfm", "kg", ("window", "balanced"), False),
                    ("ml1m", "cf", ("window",), False),
                    ("lastfm", "cf", ("window",), True),  # HGDR_INT8=1: kernel 3
                    ("ml1m", "cf", ("window",), True))  # kernel 4
SHARDED_DEDUP_SHAPES = ("ml1m",)  # where the pooled decision must pick the dedup layout
SHARDED_SPMM_RTOL = 1e-6
SHARDED_STEP_RTOL = 1e-5
SHARDED_EPOCH_RTOL = 1e-3
SHARDED_EVAL_ATOL = 1e-6
SHARDED_KHGREC_LAUNCHES = 16
SHARDED_KHGREC_KERNEL = "segment_spmm_rows"  # the pooled decision at the LastFM shape
SHARDED_REPS = 5
SHARDED_MF = dict(embedding_size=64, batch_size=2048, lrate=0.05, eval_user_batch=512)
SHARDED_GCN = dict(dim=64, batch=2048, steps=5, lrate=0.05, n_layers=2)
SHARDED_GCN_ATOL = 1e-5
SHARDED_CLI_FLAGS = ["--mesh_data=2", "--mesh_model=2", "--shard_graph=on"]
# phase 25's data split: on the (2, 2) mesh each data rank computes its share of every step's
# batch (`ModelBundle.data_split`). These models at the full widths of the earlier phases, at
# the LastFM shape, adjacencies replicated (the propagation runs whole on every rank, as in the
# JAX mesh): the first SPLIT_STEPS steps of each phase within SPLIT_STEP_RTOL (the CPU test's
# loss tolerance: tests/test_torch_sharded.py holds HGNN_HD3, whose bf16 operand rounds each data
# rank's share of the cotangent on its own, at 1e-3) of one device's eager steps (the last
# step's wall is the step time reported), the data ranks' shares of the first step's loss
# differing and adding up to it within SPLIT_SHARE_RTOL, each rank's SpMM launches equal to one
# device's, and a data rank's step FLOPs (`utils.profiling.cost_analysis`) at most
# SPLIT_FLOPS_BOUND of one device's where the step is per-example work
SPLIT_MODELS = {"SASRec": dict(SEQ_TRAIN, drop_rate=SEQ_DROPOUT["lastfm"]),
                "CL4SRec": dict(SEQ_TRAIN, drop_rate=SEQ_DROPOUT["lastfm"]),
                "KGAT": dict(KGAT_TRAIN), "SGL": dict(SGL_TRAIN),
                # phase 8's: MODEL_DEFAULTS["HGNN_HD3"], the bf16 gathered operand
                "HGNN_HD3": dict(compute_dtype="bfloat16", eval_user_batch=512)}
SPLIT_STEPS = 3
SPLIT_STEP_RTOL = {"HGNN_HD3": 1e-3}  # else 1e-4
SPLIT_SHARE_RTOL = 1e-6
SPLIT_FLOPS_BOUND = {("SASRec", "cf"): 0.6, ("CL4SRec", "cf"): 0.6, ("KGAT", "kg"): 0.6}


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


def counted_profile(tag: str, fn, want: float, iters: int = 5):
    """`device_profile` of `fn` (device ms, split by kernel, launches by
    kernel). The profiler now and then loses kernel events (seen: 18 of 20
    launches of 5 eager steps, 26 of 40 of 5 replayed encodes, 34 of 35 of
    5 eager steps in each of three traces in a row) but never adds one, so
    a trace's SpMM count is a lower bound on the launches: `fn` is traced
    again while the count is below `want`, up to TRACE_ATTEMPTS traces, and
    the trace with the most launches is returned (at once if it holds
    `want` or more). The caller holds its count to `want`."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.bench.timing import device_profile

    best = None
    for _ in range(TRACE_ATTEMPTS):
        traced = device_profile(fn, iters=iters, log=log)
        n = spmm_launches(traced[2])
        if best is None or n > spmm_launches(best[2]):
            best = traced
        if n >= want:
            return traced
        log(f"[timer] {tag}: the trace holds {n:g} SpMM launches a call, "
            f"expected {want:g}: traced again")
    return best


def kernel_only_ms(by_name: dict[str, float]) -> float:
    return sum(t for k, t in by_name.items() if "segment_spmm" in k)


def spmm_bytes(mat, d: int) -> int:
    """The bytes A @ X must move at this matrix: the CSR matrix (8 B per
    edge, 4 B per row pointer), the X rows it references and the output,
    each moved once."""
    import numpy as np

    used_cols = np.unique(mat.indices).shape[0]
    return 8 * mat.nnz + 4 * (mat.shape[0] + 1) + 4 * d * used_cols + 4 * d * mat.shape[0]


def int8_rows_bytes(mat, d: int) -> int:
    """The bytes kernel 3's wrapper must move at this matrix: f32 X read once
    by the quantisation, q and the scales written, the q rows in use
    gathered at 1 B a feature, the CSR indices and values (8 B an edge, 4 B
    a row pointer) and the f32 output."""
    import numpy as np

    used_cols = np.unique(mat.indices).shape[0]
    m = mat.shape[1]
    return (4 * m * d + m * d + 4 * d + d * used_cols + 8 * mat.nnz + 4 * (mat.shape[0] + 1)
            + 4 * d * mat.shape[0])


def bound_ms(mat, d: int, int8_rows: bool = False) -> tuple[float, str]:
    """Least time for A @ X at this matrix: `spmm_bytes` against 2 * nnz * d
    operations at the f32 rate; for kernel 3 its own bytes
    (`int8_rows_bytes`) against its int8 products at the int8 rate."""
    moved = int8_rows_bytes(mat, d) if int8_rows else spmm_bytes(mat, d)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * mat.nnz * d / (INT8_OPS if int8_rows else F32_FLOPS) * 1e3
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


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled symbol (`_ZN<len><id>...` or
    `_Z<len><id>...`): the last name, with an integer template argument."""
    i = 3 if mangled.startswith("_ZN") else 2
    parts = []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    if not parts:
        return mangled[:64]
    arg = mangled[i:].split("EE")[0] if mangled[i:].startswith("ILi") else ""
    return parts[-1] + (f"<{arg[3:]}>" if arg[3:].isdigit() else "")


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
        entry = ""  # the kernel each ptxas line is about
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            if "Compiling entry function" in line and "'" in line:
                entry = kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                log(f"[build]   {name}: {entry}: {line.strip()}")


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
    its main-path shape and mode (the int8 quantisation's at QUANT_SHAPE)."""
    from unittest import mock

    import numpy as np
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from _int8_walk import int8_row_scales  # kernel 3's path decisions, written again in numpy

    gen = torch.Generator(DEVICE).manual_seed(SEED)
    rows = []
    per_step = {}  # (kernel, graph, mode): kernel-alone ms per training step
    bodies = {}  # kernel: its SpMM launches' device ms per step at its main-path shape
    quant = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)  # per step at QUANT_SHAPE
    quantised = set()

    def check_quantize(gname, tag, x, q_plain, s_plain):
        """The quantisation kernel on one X: bit for bit with the torch
        passes, its device time (and theirs) beside its bound."""
        before = S.LAUNCHES["quantize_int8"]
        q, sc = S.quantize_int8_fused(x)
        torch.cuda.synchronize()
        if S.LAUNCHES["quantize_int8"] != before + 1:
            raise AssertionError("quantize_int8_fused launched no kernel")
        if not (torch.equal(q, q_plain) and torch.equal(sc, s_plain)):
            raise AssertionError(f"quantize_int8 kernel differs from the torch passes on {tag}")
        k_ms, k_split = device_ms(lambda: S.quantize_int8_fused(x))
        p_ms = device_ms(lambda: S.quantize_int8(x))[0]
        m, d = x.shape
        b_ms = (4 * m * d + m * d + 4 * d) / HBM_BYTES_PER_S * 1e3  # X read, q and s written
        log(f"[quantize] {tag} X {m}x{d}: bit for bit with the torch passes | device ms: kernel "
            f"{k_ms:.4f} ({', '.join(f'{n[:24]} {t:.4f}' for n, t in k_split.items())}) "
            f"torch passes {p_ms:.4f} bound {b_ms:.4f} (bytes)")
        if gname == QUANT_SHAPE:
            quant["ms"] += CALLS_PER_STEP * k_ms
            quant["plain_ms"] += CALLS_PER_STEP * p_ms
            quant["bound_ms"] += CALLS_PER_STEP * b_ms
    def check_f64_path(tag, blk, x, int_body):
        """Kernel 3 with every other slot's value times 2^12, so that each
        warp with two nonzero values spans more than 7 binades and sums in
        f64 (its fallback): bit for bit with the plain version, two calls
        equal, its device time beside the f64 design's and the integer
        path's on the same layout."""
        odd = torch.arange(blk.vals.numel(), device=blk.vals.device).reshape(blk.vals.shape) % 2
        wide = blk.replace(vals=blk.vals * torch.where(odd == 1, 4096.0, 1.0))
        n_f64 = int((~int8_row_scales(wide)[1]).sum())
        got = S.blocked_spmm(wide, x)
        again = S.blocked_spmm(wide, x)
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and torch.equal(got, S.blocked_spmm_reference(wide, x))):
            raise AssertionError(f"segment_spmm_rows_int8's f64 path on {tag}: two calls differ "
                                 f"or the bits differ from the plain version's")
        k_ms, k_split = device_ms(lambda: S.blocked_spmm(wide, x))
        body = kernel_only_ms(k_split)
        before = BEFORE_WRAPPER_MS[("segment_spmm_rows_int8", tag)]["int8"]
        log(f"[kernel] segment_spmm_rows_int8 {tag} int8, every other value x 2^12: rows on the "
            f"f64 path {n_f64} of {wide.nrows}, bit for bit with the plain version, two calls "
            f"bitwise equal | device ms a call: wrapper {k_ms:.4f} (the f64 design's {before:.4f})"
            f", kernel alone {body:.4f} (the f64 design's {F64_DESIGN_BODY_MS:.4f}; the integer "
            f"path's on the layout's own values {int_body:.4f})")

    for kname, (layout, modes, main_shape, main_mode, replaces) in KERNELS.items():
        pack = S.pack_blocked_dedup if layout == "dedup" else S.pack_blocked
        worst = 0.0
        main = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
        main_split = {}  # the wrapper's device time per step at the main shape, by kernel name
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
                    b_ms, b_by = bound_ms(m, D, int8_rows=kname == "segment_spmm_rows_int8")
                    for mode in modes:
                        blk = layout_f32.replace(bf16=mode == "bf16", int8=mode == "int8")
                        if mode == "int8":
                            # the nearest library call: torch.sparse.mm on the
                            # dequantised table (it does not quantise)
                            q, sc = S.quantize_int8(x)
                            x_lib = q.float() * sc
                            if (gname, mname, direction) not in quantised:
                                quantised.add((gname, mname, direction))
                                check_quantize(gname, f"{gname}.{mname}.{direction}", x, q, sc)
                        else:
                            x_lib = x
                        lib_ms = device_ms(lambda: torch.sparse.mm(a_csr, x_lib))[0]
                        got = S.blocked_spmm(blk, x)
                        again = S.blocked_spmm(blk, x)
                        torch.cuda.synchronize()
                        repeats = torch.equal(got, again)
                        ref = S.blocked_spmm_reference(blk, x)
                        scale = float(ref.abs().max())
                        err = float((got - ref).abs().max())
                        err_exact = float((got - exact).abs().max())
                        ok = err <= KERNEL_RTOL * max(scale, 1.0)
                        if mode == "f32":  # f32 mode also agrees with scipy's f32 product
                            ok = ok and err_exact <= KERNEL_RTOL * max(scale, 1.0)
                        k_ms, k_split = device_ms(lambda: S.blocked_spmm(blk, x))
                        k_call = cuda_ms(lambda: S.blocked_spmm(blk, x))
                        old_quant = ""
                        if kname == "segment_spmm_rows_int8":  # the torch passes quantising
                            with mock.patch.object(S, "quantize_int8_fused", S.quantize_int8):
                                t_old = device_ms(lambda: S.blocked_spmm(blk, x))[0]
                            n_f64 = int((~int8_row_scales(blk)[1]).sum())
                            old_quant = (f"; with the torch quantisation {t_old:.4f}; rows on "
                                         f"the f64 path {n_f64} of {m.shape[0]}")
                        p_ms = device_ms(lambda: S.blocked_spmm_reference(blk, x), iters=5)[0]
                        lib_label = "torch.sparse.mm" + (" (dequantised)" if mode == "int8"
                                                         else "")
                        k_alone = kernel_only_ms(k_split)
                        key = (kname, gname, mode)
                        per_step[key] = per_step.get(key, 0.0) + CALLS_PER_STEP * k_alone
                        before = BEFORE_WRAPPER_MS.get(
                            (kname, f"{gname}.{mname}.{direction}"), {}).get(mode)
                        log(f"[kernel] {kname} {gname}.{mname}.{direction} {mode} "
                            f"{m.shape[0]}x{m.shape[1]} nnz {m.nnz} blocks {blk.n_blocks}: "
                            f"max_abs_err {err:.3e} rel {err / max(scale, 1e-30):.3e} "
                            f"(vs scipy f32 {err_exact:.3e}) | device ms: wrapper {k_ms:.4f} "
                            f"(kernel alone {k_alone:.4f}; {BEFORE_OF[kname]}'s wrapper "
                            f"{'-' if before is None else f'{before:.4f}'}{old_quant}) "
                            f"plain {p_ms:.4f} "
                            f"{lib_label} {lib_ms:.4f} bound {b_ms:.4f} ({b_by}) | "
                            f"one call between events {k_call:.4f} ms | two calls "
                            f"{'bitwise equal' if repeats else 'DIFFER'} {'OK' if ok else 'FAIL'}")
                        if not ok:
                            raise AssertionError(f"{kname} disagrees with its plain version "
                                                 f"on {gname}.{mname}.{direction} {mode}")
                        if (kname == "segment_spmm_rows_int8"
                                and (gname, mname, direction) == F64_PATH_AT):
                            check_f64_path(f"{gname}.{mname}.{direction}", blk, x, k_alone)
                        if (kname == "segment_spmm_rows" or mode == "int8") and not repeats:
                            raise AssertionError(f"{kname}: two calls on {gname}.{mname}."
                                                 f"{direction} {mode} gave different bits")
                        if mode == "int8" and not torch.equal(got, ref):
                            raise AssertionError(f"{kname} differs from its plain version on "
                                                 f"{gname}.{mname}.{direction}: its sums are "
                                                 f"exact, the bits must agree")
                        worst = max(worst, err)
                        if gname == main_shape and mode == main_mode:
                            main["ms"] += CALLS_PER_STEP * k_ms
                            main["plain_ms"] += CALLS_PER_STEP * p_ms
                            main["library_ms"] += CALLS_PER_STEP * lib_ms
                            main["bound_ms"] += CALLS_PER_STEP * b_ms
                            bound_by.add(b_by)
                            for name, t in k_split.items():
                                main_split[name] = main_split.get(name, 0.0) + CALLS_PER_STEP * t
        rows.append(dict(
            name=kname, route="cuda",
            source="hypergraph_diffusion_for_recommendation_tpu_torch/csrc/segment_spmm.cu",
            replaces=replaces, launches=0, max_abs_err=worst,
            bound_by="bytes" if bound_by == {"bytes"} else "operations", **main,
        ))
        log(f"[kernel] {kname} per step at {main_shape} {main_mode}: wrapper {main['ms']:.4f} ms "
            f"({BEFORE_OF[kname]} {BEFORE_STEP_MS[kname]:.4f}), bound "
            f"{main['bound_ms']:.4f}, torch.sparse.mm {main['library_ms']:.4f}")
        for name, t in sorted(main_split.items(), key=lambda kv: -kv[1]):
            log(f"[kernel]   {kname} per step, split: {t:.4f}  {name[:100]}")
        bodies[kname] = sum(t for name, t in main_split.items() if "segment_spmm" in name)
        if kname == "segment_spmm_rows_int8":
            log("[kernel]   segment_spmm_rows_int8 per step, the f64 design's split: " + ", ".join(
                f"{n} {t:.4f}" for n, t in BEFORE_INT8_SPLIT.items()))
            quant_ms = main["ms"] - bodies[kname]
            log(f"[kernel] segment_spmm_rows_int8 targets at lastfm int8, per step: wrapper "
                f"{main['ms']:.4f} ms against torch.sparse.mm {main['library_ms']:.4f} "
                f"({'held' if main['ms'] <= main['library_ms'] else 'missed'}); body "
                f"{bodies[kname]:.4f} against kernel 1's bf16 body "
                f"{bodies['segment_spmm_rows']:.4f} "
                f"({'held' if bodies[kname] <= bodies['segment_spmm_rows'] else 'missed'}); "
                f"quantisation {quant_ms:.4f}; bound {main['bound_ms']:.4f} "
                f"(the f64 design: 0.7008 / 0.3601 / 0.2299 / 0.4996 / 0.2524)")
    rows.append(dict(
        name="quantize_int8", route="cuda",
        source="hypergraph_diffusion_for_recommendation_tpu_torch/csrc/segment_spmm.cu",
        replaces=f"{_TPU_SRC}:569", launches=0, max_abs_err=0.0, bound_by="bytes",
        library_ms=None, **quant,
    ))
    log(f"[quantize] quantize_int8 per step at {QUANT_SHAPE} (16 calls): kernel {quant['ms']:.4f} "
        f"ms, torch passes {quant['plain_ms']:.4f}, bound {quant['bound_ms']:.4f}")
    # does `dedup_auto` (which picks the dedup layout at ML-1M density) pick the faster kernel?
    for mode in ("bf16", "f32"):
        k2 = per_step[("segment_spmm_dedup", "ml1m", mode)]
        k1 = per_step[("segment_spmm_rows", "ml1m", mode)]
        log(f"[kernel] ML-1M density, {mode}, the same four (matrix, direction) layouts, kernel "
            f"alone per step: segment_spmm_dedup {k2:.4f} ms, segment_spmm_rows {k1:.4f} ms: "
            f"dedup_auto's pick is the {'faster' if k2 < k1 else 'slower'} kernel on this card")
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
    # the main path's encode is a replayed CUDA graph: bit for bit the eager
    # encode (no backward, no atomics), its launches counted in the trace
    eu, ei = bundle.encode_eval(rec.extras)
    replay_bitwise = torch.equal(u_emb, eu) and torch.equal(i_emb, ei)
    if not replay_bitwise:
        raise AssertionError(f"{shape}: the replayed encode differs from the eager encode")
    rep_ms = cuda_ms(lambda: rec.encode(), iters=5, warmup=1)
    rep_dev, _, rep_counts = counted_profile(f"{shape} encode", lambda: rec.encode(), 8)
    if spmm_launches(rep_counts) != 8:
        raise AssertionError(f"{shape}: a replayed encode holds {spmm_launches(rep_counts)} SpMM "
                             f"launches, expected 8")
    log(f"[slice] {shape} encode: replay wall {rep_ms:.4f} ms, device {rep_dev:.4f}, idle "
        f"{max(0.0, 1.0 - rep_dev / rep_ms):.4f}, 8 SpMM launches, bit for bit the eager encode "
        f"(wall {enc_ms:.4f}, device {enc_dev:.4f})")
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
        encode_replay_ms=round(rep_ms, 4), encode_replay_device_ms=round(rep_dev, 4),
        encode_replay_idle_share=round(max(0.0, 1.0 - rep_dev / rep_ms), 4),
        encode_replay_bitwise=replay_bitwise,
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
    through the replayed CUDA graphs (a whole epoch through
    `Recommender.train` beside the same epoch run eagerly, or `TRAIN_STEPS`
    Trainer steps) with its launches counted, the encode graph against the
    eager encode, and `graph_check`."""
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

    # --- one step through the kernels (counted) and through the plain versions;
    # an int8 layout quantises X on the card before each of its kernel's launches
    per_call = {kname: 1, "quantize_int8": 1} if int8 else {kname: 1}
    for k in S.LAUNCHES:
        S.LAUNCHES[k] = 0
    loss_k, grads_k = loss_and_grads()
    step_launches = dict(S.LAUNCHES)
    want = {k: 16 * per_call.get(k, 0) for k in S.LAUNCHES}
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
    if int8 and (loss_k != loss_p or any(not torch.equal(gk, gp)
                                         for gk, gp in zip(grads_k, grads_p))):
        raise AssertionError(f"{tag}: the int8 kernels' exact sums must give the plain step's "
                             f"loss and gradients bit for bit")

    # --- the main path, counted: the steps and encodes run as replayed CUDA graphs
    untrained = start = None
    if fit:
        rec.encode()
        untrained = rec.evaluate()
        start = ({k: v.detach().clone() for k, v in bundle.module.state_dict().items()},
                 {k: v.clone() for k, v in rec.extras.items()})
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
    # the wrappers count Python calls: a branch's eager first step and its
    # capture, the encode graph's eager first run and its capture
    py = 16 * python_steps(n_steps) + (2 * 8 if n_encodes else 0)
    want = {k: py * per_call.get(k, 0) for k in S.LAUNCHES}
    if launches != want:
        raise AssertionError(f"{tag}: {n_steps} steps and {n_encodes} encodes launched "
                             f"{launches} from Python, expected {want}")
    if not math.isfinite(loss):
        raise AssertionError(f"{tag}: non-finite training loss {loss}")
    epochs = {}
    if fit:
        # the same epoch (same state, batches and keys) eagerly; then a
        # second epoch of each, its graphs already captured
        graph_tr = rec.trainer
        bundle.module.load_state_dict(start[0])
        eager_tr = Trainer(bundle, extras=start[1], graphs=False)
        eager = eager_tr.fit(max_epoch=1, quiet=True)
        examples = graph_tr.n_batches * cfg.batch_size
        for mode, tr, res in (("graphs", graph_tr, result), ("eager", eager_tr, eager)):
            t0 = time.time()
            tr.run_epoch(1)
            torch.cuda.synchronize()
            second = time.time() - t0
            epochs[mode] = dict(
                epoch1_train_s=round(res.history[0].train_time, 4),
                epoch1_examples_per_sec=round(res.examples_per_sec, 1),
                epoch1_loss=res.history[0].losses["train_loss"],
                recall20=res.final_metrics[20]["recall"],
                epoch2_train_s=round(second, 4),
                epoch2_examples_per_sec=round(examples / second, 1))
        log(f"[train] {tag} one epoch ({graph_tr.n_batches} steps): graphs "
            f"{json.dumps(epochs['graphs'])} | eager {json.dumps(epochs['eager'])} | Recall@20 "
            f"untrained {untrained[20]['recall']:.5f}")

    # --- the trainer's encode graph over the current state (a restore in
    # place marks it new): bit for bit the eager encode
    main_tr = rec.trainer if fit else trainer
    main_tr.restore(main_tr.snapshot())
    u, i = main_tr.encode()
    eu, ei = bundle.encode_eval(main_tr.extras)
    if not (torch.equal(u, eu) and torch.equal(i, ei)):
        raise AssertionError(f"{tag}: the replayed encode differs from the eager encode")
    # --- the replayed step against the eager step, launches and times
    check = graph_check(tag, bundle, rec.extras, batches, per_full=16, int8=int8)
    rep_full, eager_full = check["branches"]["full"]["replay"], check["branches"]["full"]["eager"]
    summary = dict(
        shape=shape, gather_layout=gather_layout, kernel=kname, card=card,
        build_s=round(build_s, 3), n_train=int(bundle.cf.n_train), steps=n_steps,
        run_s=round(run_s, 3), python_launches=launches[kname],
        launches_per_step=step_launches[kname],
        replayed_step_launches=rep_full["spmm_launches"],
        quantize_launches_per_step=step_launches["quantize_int8"],
        replayed_step_quantisations=rep_full["quantise_launches"],
        loss=loss, loss_kernels=loss_k, loss_plain=loss_p, loss_rel_err=loss_rel,
        worst_grad=worst, worst_grad_rel_err=grad_rel[worst],
        step_wall_ms=rep_full["wall_ms"], step_device_ms=rep_full["device_ms"],
        step_idle_share=rep_full["idle_share"], step_spmm_kernel_ms=rep_full["spmm_kernel_ms"],
        eager_step_wall_ms=eager_full["wall_ms"], eager_step_device_ms=eager_full["device_ms"],
        eager_step_idle_share=eager_full["idle_share"], graph_compare=check["compared"],
    )
    if fit:
        summary.update(recall20_untrained=untrained[20]["recall"],
                       recall20_after_epoch=result.final_metrics[20]["recall"],
                       examples_per_sec=round(result.examples_per_sec, 1), epochs=epochs)
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
        again = G.fused_window_spmm(blk, probe.x)
        torch.cuda.synchronize()
        if not torch.equal(got, again):  # one warp a row, a fixed order, no atomics
            raise AssertionError(f"fused_window_spmm {mode}: two calls gave different bits")
        ref = G.fused_window_spmm_reference(blk, probe.x)
        scale = max(float(ref.abs().max()), 1.0)
        err = float((got - ref).abs().max())
        ok = err <= KERNEL_RTOL * scale
        err_exact = float((got - exact).abs().max())
        if mode == "f32":
            ok = ok and err_exact <= KERNEL_RTOL * scale
        log(f"[probe] fused_window_spmm {mode}: max_abs_err {err:.3e} vs plain, {err_exact:.3e} "
            f"vs scipy f32 (scale {scale:.3f}); two calls bitwise equal {'OK' if ok else 'FAIL'}")
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
        before = BEFORE_PROBE_MS.get(kname)
        log(f"[probe] {kname}: {launches[kname]} launches on the probe path; device ms per call "
            f"f32 {ms[k_probe]:.4f} (bf16 {ms[kb_probe]:.4f})"
            + (f", PR 4's design f32 {before[0]:.4f} (bf16 {before[1]:.4f})" if before else "")
            + f", plain {ms[p_probe]:.4f}, {lib_probe[3:]} {ms[lib_probe]:.4f}, bound "
            f"{b_ms:.4f} ({b_by})")
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


def spmm_launches(counts: dict[str, float]) -> float:
    """SpMM launches among a profile's launches by kernel name: the four
    segment-SpMM kernels (the dedup kernels' second pass over split
    windows is part of their launch)."""
    return sum(c for k, c in counts.items() if "segment_spmm" in k and "sum_parts" not in k)


def quantise_launches(counts: dict[str, float]) -> float:
    """Launches of the int8 quantisation's second kernel, one a call."""
    return sum(c for k, c in counts.items() if "quantise_kernel" in k and "dequantise" not in k)


def python_steps(n_steps: int) -> int:
    """Steps of one branch whose wrappers run from Python in graph mode, out
    of `n_steps`: the eager first steps and the capture (a wrapper counts
    its Python calls; a replay makes none)."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.train.trainer import (
        GRAPH_WARMUP_STEPS,
    )

    return min(n_steps, GRAPH_WARMUP_STEPS + 1)


def full_state(tr) -> dict:
    """Every tensor a training step writes: the parameters, each phase's Adam
    moments and the extras."""
    out = {f"param {k}": v.detach().clone() for k, v in tr.bundle.module.state_dict().items()}
    for phase, ph in tr._phases.items():
        for i, p in enumerate(tr._params):
            for k in ("exp_avg", "exp_avg_sq"):
                if k in ph.opt.state[p]:  # a phase that has not stepped has no state
                    out[f"{phase} {k} {i}"] = ph.opt.state[p][k].clone()
    out.update({f"extras {k}": v.clone() for k, v in tr.extras.items() if hasattr(v, "shape")})
    return out


def graph_check(tag: str, bundle, extras, batches, per_full: int, int8: bool = False,
                bitwise: bool = False, cycle=None, phase: str = "cf") -> dict:
    """The training step as a replayed CUDA graph against the same step run
    eagerly (`Trainer(..., graphs=False)`), from one full state (the
    parameters, Adam's state, the extras, the generators), after 1 and
    after GRAPH_COMPARE_STEPS[-1] steps: bit for bit where two eager runs
    from that state agree bit for bit, else within GRAPH_RTOL of each
    tensor's scale (the log names the tensors that moved and the step's
    kernels with float atomics). Then, per branch of the loss, the SpMM
    launches inside one replayed step, as its graph's capture counted them
    (`Trainer.replayed_launches`; the profiler's count by kernel name, which
    may lose an event, is kept beside it), and inside one eager step,
    counted by its wrappers (its trace holds no more) (`per_full` a full
    step, 0 a cached one; int8 also `per_full` quantisations), and both steps' wall,
    device time and idle share. With `bitwise` the replay must equal the
    eager step bit for bit in any case. `cycle` = (the extras' host step
    count, its period, {branch: (a count that takes it, SpMM launches a
    step)}) for a loss whose branch follows a host count (cached
    propagation: ("prop_age", K, {"full": (0, per_full), "cached": (1, 0)});
    AutoCF's refresh every FIX_STEPS steps); the comparison then starts at
    the first branch's step. `phase`: the loss the steps take ("kg": an
    alternating model's KG phase, over its KG `batches`)."""
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer
    from hypergraph_diffusion_for_recommendation_tpu_torch.train.trainer import (
        GRAPH_WARMUP_STEPS,
        _graph_key,
    )

    tg = Trainer(bundle, seed=SEED, extras=extras)
    te = Trainer(bundle, seed=SEED, extras=extras, graphs=False)
    n_b = batches[0].shape[0]
    keys = tg.epoch_keys(n_b)

    def batch(s):
        return tuple(t[s % n_b] for t in batches), keys[s % n_b]

    count_key, period, branches = cycle or (None, 0, {"full": (None, per_full)})
    # eager first steps and captures until every branch has its graph; the
    # comparison then starts on the first branch's step (a full one)
    n_warm = 2 * period if period else GRAPH_WARMUP_STEPS + 1
    for s in range(n_warm):
        tg.train_step(*batch(s), phase)
    if sorted(tg._step_graphs) != sorted(_graph_key(phase, b) for b in branches):
        raise AssertionError(f"{tag}: step graphs {sorted(tg._step_graphs)}, expected {branches}")
    te.train_step(*batch(0), phase)  # Adam's state exists before the restores
    snap = tg.snapshot(optimizer=True)

    def run(tr, n):
        tr.restore(snap)
        losses = [tr.train_step(*batch(n_warm + s), phase)[0].clone() for s in range(n)]
        torch.cuda.synchronize()
        return dict(full_state(tr), loss=torch.stack(losses))

    def rel(a, b):  # in f64: the extras may hold integer and bool lists (AutoCF's decoder)
        a, b = a.double(), b.double()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    compared = {}
    for n in GRAPH_COMPARE_STEPS:
        e1, e2 = run(te, n), run(te, n)
        moved = sorted(k for k in e1 if not torch.equal(e1[k], e2[k]))
        r = run(tg, n)
        errs = {k: rel(r[k], e1[k]) for k in e1}
        worst = max(errs, key=errs.get)
        same = all(torch.equal(r[k], e1[k]) for k in e1)
        compared[n] = dict(eager_repeats_bitwise=not moved, eager_tensors_moved=len(moved),
                           replay_bitwise=same, worst=worst, worst_rel_err=errs[worst])
        log(f"[graph] {tag}: after {n} step(s) from one state: two eager runs "
            f"{'bit for bit equal' if not moved else f'differ in {len(moved)} tensors'}; "
            f"replay vs eager {'bit for bit equal' if same else 'not bitwise'}, worst "
            f"{worst} rel {errs[worst]:.2e}"
            + ("" if not moved else f"; tensors that moved between eager runs: {moved[:6]}"))
        if (not moved and not same) or errs[worst] > GRAPH_RTOL or (bitwise and not same):
            raise AssertionError(f"{tag}: the replayed steps differ from the eager steps "
                                 f"({worst} rel {errs[worst]:.2e})")
    out = dict(tag=tag, compared=compared, branches={})
    for br, (count, want) in branches.items():
        def step(tr):
            if count_key is not None:  # the count that takes this branch
                tr.extras[count_key] = count
            tr.train_step(*batch(0), phase)

        # the eager step's launches as its wrappers count them, and the
        # replayed step's as its graph's capture counted them: exact, where
        # the trace may lose one (`counted_profile`)
        spmm_keys = [k for k in S.LAUNCHES if k.startswith("segment_spmm")]
        before = sum(S.LAUNCHES[k] for k in spmm_keys)
        step(te)
        torch.cuda.synchronize()
        wrapped = sum(S.LAUNCHES[k] for k in spmm_keys) - before
        before = tg.replayed_launches()
        step(tg)
        torch.cuda.synchronize()
        replayed = {k: n - before.get(k, 0) for k, n in tg.replayed_launches().items()}
        row, splits = {}, {}
        for mode, tr in (("replay", tg), ("eager", te)):
            wall = cuda_ms(lambda: step(tr), iters=10, warmup=2)
            dev, split, counts = counted_profile(f"{tag} {br} {mode}", lambda: step(tr), want)
            splits[mode] = split
            row[mode] = dict(wall_ms=round(wall, 4), device_ms=round(dev, 4),
                             idle_share=round(max(0.0, 1.0 - dev / wall), 4),
                             spmm_launches=spmm_launches(counts),
                             quantise_launches=quantise_launches(counts),
                             spmm_kernel_ms=round(kernel_only_ms(split), 4),
                             top_kernels={k[:60]: round(t, 4) for k, t in
                                          sorted(split.items(), key=lambda kv: -kv[1])[:4]})
            if mode == "eager" and not compared[GRAPH_COMPARE_STEPS[-1]]["eager_repeats_bitwise"]:
                atomics = sorted(k for k in split if any(w in k.lower() for w in
                                                         ("index", "scatter", "atomic")))
                log(f"[graph] {tag} {br}: kernels of the step with float atomics (the order "
                    f"of their sums changes from run to run): {[k[:60] for k in atomics]}")
        row["eager"]["wrapper_spmm_launches"] = wrapped
        # the replay's launches from its capture; the trace's count stays beside them
        row["replay"]["trace_spmm_launches"] = row["replay"]["spmm_launches"]
        row["replay"]["spmm_launches"] = sum(replayed.get(k, 0) for k in spmm_keys)
        row["replay"]["quantise_launches"] = replayed.get("quantize_int8", 0)
        got = (row["replay"]["spmm_launches"], row["eager"]["spmm_launches"])
        log(f"[graph] {tag} {br} step: replay wall {row['replay']['wall_ms']:.4f} ms, device "
            f"{row['replay']['device_ms']:.4f}, idle {row['replay']['idle_share']:.4f} | eager "
            f"wall {row['eager']['wall_ms']:.4f}, device {row['eager']['device_ms']:.4f}, idle "
            f"{row['eager']['idle_share']:.4f} | SpMM launches a step: replay {got[0]:g} by its "
            f"capture ({row['replay']['trace_spmm_launches']:g} in the trace), eager {got[1]:g} "
            f"in the trace, {wrapped} by the wrappers (expected {want})")
        # where the two device times part: the kernels whose time differs most
        gap = {k: splits["eager"].get(k, 0.0) - splits["replay"].get(k, 0.0)
               for k in set(splits["eager"]) | set(splits["replay"])}
        top = sorted(gap.items(), key=lambda kv: -abs(kv[1]))[:4]
        log(f"[graph] {tag} {br} step: device ms eager minus replay, largest: "
            + "; ".join(f"{k[:50]} {d:+.4f}" for k, d in top))
        # a replay's launches are its capture's; an eager step's are held by
        # its wrappers, and its trace may hold no more
        if got[0] != want or wrapped != want or got[1] > want:
            raise AssertionError(f"{tag} {br}: SpMM launches a step {got} (replay by its "
                                 f"capture, eager in the trace), {wrapped} eager by the "
                                 f"wrappers, expected {want}")
        if int8 and (row["replay"]["quantise_launches"], row["eager"]["quantise_launches"]) != (
                want, want):
            raise AssertionError(f"{tag} {br}: quantisations a step {row}, expected {want}")
        out["branches"][br] = row
    return out


def phase_hd(shape: str, data, card: str):
    """HGNN_HD3 at full width: the encode and one training step through the
    kernels against the plain versions, the launch counts, then
    `TRAIN_STEPS` Trainer steps (replayed graphs) and `graph_check`. Returns
    (summary, the Recommender, whose device data the variant phase reuses)."""
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

    # --- the encode through the kernels (counted: the encode graph's eager
    # first run and its capture) and through the plain versions
    _zero_spmm_launches()
    u_emb, i_emb = rec.encode()
    torch.cuda.synchronize()
    enc_launches = _spmm_launches()
    if sum(enc_launches.values()) != 2 * HD3_ENCODE_LAUNCHES:
        raise AssertionError(f"{tag}: one encode launched {enc_launches} from Python, expected "
                             f"2 x {HD3_ENCODE_LAUNCHES} in all")
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

    # --- the main path: Trainer steps (replayed graphs), counted
    _zero_spmm_launches()
    t0 = time.time()
    for s in range(TRAIN_STEPS):
        i = s % batches[0].shape[0]
        loss_t, _ = trainer.train_step(tuple(t[i] for t in batches), trainer.edge_keys())
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = _spmm_launches()
    want = 2 * HD3_ENCODE_LAUNCHES * python_steps(TRAIN_STEPS)
    if sum(launches.values()) != want:
        raise AssertionError(f"{tag}: {TRAIN_STEPS} steps launched {launches} from Python, "
                             f"expected {want}")
    loss = float(loss_t)
    if not math.isfinite(loss):
        raise AssertionError(f"{tag}: non-finite training loss {loss}")

    check = graph_check(tag, bundle, rec.extras, batches, per_full=2 * HD3_ENCODE_LAUNCHES)
    rep_full, eager_full = check["branches"]["full"]["replay"], check["branches"]["full"]["eager"]
    summary = dict(
        model="HGNN_HD3", shape=shape, card=card, layouts=layouts, build_s=round(build_s, 3),
        n_train=int(cf.n_train), steps=TRAIN_STEPS, run_s=round(run_s, 3),
        launches_per_encode=enc_launches, launches_per_step=step_launches,
        replayed_step_launches=rep_full["spmm_launches"], loss=loss,
        encode_max_abs_err=enc_err, loss_kernels=loss_k, loss_plain=loss_p,
        loss_rel_err=loss_rel, worst_grad=worst, worst_grad_rel_err=grad_rel[worst],
        step_wall_ms=rep_full["wall_ms"], step_device_ms=rep_full["device_ms"],
        step_idle_share=rep_full["idle_share"], step_spmm_kernel_ms=rep_full["spmm_kernel_ms"],
        eager_step_wall_ms=eager_full["wall_ms"], eager_step_device_ms=eager_full["device_ms"],
        eager_step_idle_share=eager_full["idle_share"], graph_compare=check["compared"],
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
        # counted from Python: the encode graph's eager first run and its
        # capture; the first step, eager
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
            f"launches an encode {enc}, a step {step} (expected {2 * want} and {2 * want})")
        if not finite or (enc, step) != (2 * want, 2 * want):
            raise AssertionError(f"{tag}: finite={finite}, launches ({enc}, {step}), expected "
                                 f"({2 * want}, {2 * want})")
        out.append(dict(model=name, mode=mode, loss=loss, launches_encode=enc,
                        launches_step=step, card=card))
    return out


def phase_prop_cache(name: str, data, card: str) -> dict:
    """`PROP_CACHE_RUN` Trainer steps with prop_cache_steps K, in graph
    mode: the SpMM wrappers run from Python at the first full step (eager)
    and the second (its capture) only, and no cached step runs one. Counts
    the host syncs of the cached steps that capture nothing (torch's sync
    debug mode; a capture synchronises by design). Then the replayed step
    against the eager step, per branch (`graph_check`)."""
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
    keys = trainer.epoch_keys(n_b)
    per_step = []
    syncs = []  # where each host sync of a cached step was called from
    for s in range(PROP_CACHE_RUN):
        batch = tuple(t[s % n_b] for t in batches)
        n_graphs = len(trainer._step_graphs)
        _zero_spmm_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if s % k:
                torch.cuda.set_sync_debug_mode("warn")
            trainer.train_step(batch, keys[s % n_b])
            torch.cuda.set_sync_debug_mode("default")
        if len(trainer._step_graphs) == n_graphs:
            # the sync warning itself; not torch's one-time note that the debug
            # mode "does not yet detect all synchronizing operations"
            syncs += [f"{'/'.join(Path(w.filename).parts[-3:])}:{w.lineno}" for w in caught
                      if "called a synchronizing CUDA operation" in str(w.message)]
        torch.cuda.synchronize()
        per_step.append(sum(_spmm_launches().values()))
    want = [per_full if s in (0, k) else 0 for s in range(PROP_CACHE_RUN)]
    if per_step != want:
        raise AssertionError(f"{name}: launches from Python per step {per_step}, expected {want}")
    if trainer.extras["prop_age"] != PROP_CACHE_RUN:
        raise AssertionError(f"{name}: prop_age {trainer.extras['prop_age']}")
    if syncs:
        raise AssertionError(f"{name}: cached steps synchronised with the host at {syncs}")
    check = graph_check(f"{name}/prop_cache", rec.bundle, rec.extras, batches, per_full,
                        cycle=("prop_age", k, {"full": (0, per_full), "cached": (1, 0)}))
    br = check["branches"]
    summary = dict(model=name, card=card, k=k, steps=PROP_CACHE_RUN,
                   python_launches_per_step=per_step,
                   full_step_ms=br["full"]["replay"]["wall_ms"],
                   cached_step_ms=br["cached"]["replay"]["wall_ms"],
                   eager_full_step_ms=br["full"]["eager"]["wall_ms"],
                   eager_cached_step_ms=br["cached"]["eager"]["wall_ms"],
                   cached_step_host_syncs=len(syncs), branches=br,
                   graph_compare=check["compared"])
    log(f"[prop_cache] {json.dumps(summary)}")
    return summary


def phase_family(shape: str, data, card: str) -> list[dict]:
    """HGNN, HD2 and HGNNAblation (mode wohyper) at full width (phase 6's
    configuration): one encode and one training step through the kernels
    against the plain versions (`encode_vs_plain`, `step_vs_plain`), their
    launches counted, then `FAMILY_REPLAYS` replayed steps, a replayed
    step's launches as its capture counted them, and its times."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer

    out = []
    for (name, mode), per_enc in FAMILY.items():
        tag = f"{name}/{mode}/{shape}"
        cfg = make_config(name, **dict(KHGREC_TRAIN, mode=mode), item_ranking=(10, 20, 40))
        rec = Recommender(cfg, DEVICE)
        rec.build(data)
        rec.init_weights(SEED)
        bundle = rec.bundle
        _, enc_err, _ = encode_vs_plain(tag, rec.encode, bundle, rec.extras, per_enc)
        trainer = Trainer(bundle, seed=SEED, extras=rec.extras)
        batches = trainer.sample_epoch()
        n_b = batches[0].shape[0]
        batch = tuple(t[0] for t in batches)
        step = step_vs_plain(tag, bundle, rec.extras, batch, trainer.edge_keys(), 2 * per_enc)
        # the main path: replayed steps
        n_run = python_steps(1 << 30) + FAMILY_REPLAYS  # warm-up, capture, replays
        step_keys = trainer.epoch_keys(n_run)
        _zero_spmm_launches()
        for s in range(n_run):
            loss_t, _ = trainer.train_step(tuple(t[s % n_b] for t in batches), step_keys[s])
        loss = float(loss_t)
        python = sum(_spmm_launches().values())
        if python != 2 * per_enc * python_steps(n_run) or not math.isfinite(loss):
            raise AssertionError(f"{tag}: {n_run} steps launched {python} from Python; loss "
                                 f"{loss}")
        replay = lambda: trainer.train_step(batch, step_keys[0])  # noqa: E731
        spmm = lambda: sum(n for k, n in trainer.replayed_launches().items()  # noqa: E731
                           if k.startswith("segment_spmm"))
        before = spmm()
        replay()
        replayed = spmm() - before
        if replayed != 2 * per_enc:
            raise AssertionError(f"{tag}: a replayed step's capture holds {replayed} SpMM "
                                 f"launches, expected {2 * per_enc}")
        wall = cuda_ms(replay, iters=5, warmup=1)
        dev, split, counts = counted_profile(tag, replay, 2 * per_enc, iters=3)
        top = sorted(split.items(), key=lambda kv: -kv[1])[:5]
        summary = dict(model=name, mode=mode, shape=shape, card=card,
                       launches_encode=per_enc, replayed_step_launches=replayed,
                       trace_step_launches=spmm_launches(counts),
                       encode_max_abs_err=enc_err, **step, replayed_steps=FAMILY_REPLAYS,
                       loss=loss, step_wall_ms=round(wall, 4), step_device_ms=round(dev, 4),
                       step_idle_share=round(max(0.0, 1.0 - dev / wall), 4),
                       step_spmm_kernel_ms=round(kernel_only_ms(split), 4),
                       top_kernels={k[:60]: round(t, 4) for k, t in top})
        log(f"[family] {json.dumps(summary)}")
        out.append(summary)
        del rec, trainer
    return out


def step_vs_plain(tag: str, bundle, extras, batch, keys, want: int, loss_fn=None) -> dict:
    """One training step's loss and every gradient through the kernels
    (SpMM launches counted: `want`) against the same step through the plain
    versions: the same state, batch, edge keys and a generator seeded alike
    for the loss's draws. A gradient far below the model's largest is held
    to FAMILY_GRAD_FLOOR of that instead of its own scale (an attention key
    bias has a zero gradient in exact arithmetic: both sides are rounding
    noise). `loss_fn`: another loss of the bundle (KGAT's `kg_batch_loss`)."""
    from unittest import mock

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S

    names, params = zip(*bundle.module.named_parameters())
    loss_fn = loss_fn or bundle.batch_loss

    def loss_and_grads():
        gen = torch.Generator(DEVICE).manual_seed(SEED)
        loss, _ = loss_fn(extras, batch, keys, gen)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        return float(loss.detach()), grads

    _zero_spmm_launches()
    loss_k, grads_k = loss_and_grads()
    launches = _spmm_launches()
    with mock.patch.object(sparse, "blocked_spmm", S.blocked_spmm_reference):
        loss_p, grads_p = loss_and_grads()
    if _spmm_launches() != launches:
        raise AssertionError(f"{tag}: the plain versions launched a kernel")
    loss_rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)
    g_max = max(float(gp.abs().max()) for gp in grads_p if gp is not None)
    grad_rel = {n: float((gk - gp).abs().max())
                / max(float(gp.abs().max()), FAMILY_GRAD_FLOOR * g_max, 1e-30)
                for n, gk, gp in zip(names, grads_k, grads_p) if gk is not None}
    worst = max(grad_rel, key=grad_rel.get)
    n_launches = sum(launches.values())
    log(f"[step] {tag}: loss kernels {loss_k:.6f} plain {loss_p:.6f} (rel {loss_rel:.2e}); worst "
        f"gradient {worst} rel {grad_rel[worst]:.2e}; SpMM launches {launches} (expected {want})")
    if (n_launches != want or not math.isfinite(loss_k) or not loss_rel <= LOSS_RTOL
            or grad_rel[worst] > TRAIN_RTOL
            or not all(torch.isfinite(g).all() for g in grads_k if g is not None)):
        raise AssertionError(f"{tag}: a step launched {n_launches} (expected {want}); loss "
                             f"{loss_k} rel {loss_rel:.2e}, worst gradient {worst} rel "
                             f"{grad_rel[worst]:.2e}")
    return dict(loss_kernels=loss_k, loss_plain=loss_p, loss_rel_err=loss_rel, worst_grad=worst,
                worst_grad_rel_err=grad_rel[worst], launches_step=n_launches,
                launches_by_kernel=launches)


def encode_vs_plain(tag: str, encode, bundle, extras, want: int):
    """`encode()` (a replayed encode graph: its eager first run and its
    capture count from Python, `want` SpMM launches each) against the
    plain versions' encode. Returns (tables, max abs error, launches)."""
    from unittest import mock

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S

    _zero_spmm_launches()
    u, i = encode()
    torch.cuda.synchronize()
    launches = _spmm_launches()
    with mock.patch.object(sparse, "blocked_spmm", S.blocked_spmm_reference):
        pu, pi = bundle.encode_eval(extras)
    err = max(float((u - pu).abs().max()), float((i - pi).abs().max()))
    scale = max(float(pu.abs().max()), float(pi.abs().max()))
    n = sum(launches.values())
    if (n != 2 * want or not err <= ENCODE_RTOL * max(scale, 1.0)
            or not (torch.isfinite(u).all() and torch.isfinite(i).all())):
        raise AssertionError(f"{tag}: an encode launched {launches} from Python (expected "
                             f"2 x {want}), max_abs_err {err:.3e} at table scale {scale:.3f}")
    return (u, i), err, launches


def step_times(check: dict, branch: str = "full") -> dict:
    """The replayed and the eager step's times and launches on one branch
    of the loss, from `graph_check`."""
    rep, eager = check["branches"][branch]["replay"], check["branches"][branch]["eager"]
    return dict(step_wall_ms=rep["wall_ms"], step_device_ms=rep["device_ms"],
                step_idle_share=rep["idle_share"], step_spmm_kernel_ms=rep["spmm_kernel_ms"],
                replayed_step_launches=rep["spmm_launches"], top_kernels=rep["top_kernels"],
                eager_step_wall_ms=eager["wall_ms"], eager_step_device_ms=eager["device_ms"],
                eager_step_idle_share=eager["idle_share"],
                replay_bitwise={n: c["replay_bitwise"] for n, c in check["compared"].items()})


def serve_check(tag: str, rec, name: str) -> dict:
    """Export the encoded tables and serve top-20 for 8 users through
    `Retriever`: no rated item served, scores descending, the same items as
    `Recommender.recommend`."""
    import numpy as np

    from hypergraph_diffusion_for_recommendation_tpu_torch.eval.serving import Retriever

    out = OUT_DIR / f"embeddings_{name}.npz"
    rec.export_embeddings(str(out))
    retr = Retriever.load(str(out), device=DEVICE)
    users = [int(u) for u in rec.inter.id2user[:: max(len(rec.inter.id2user) // 8, 1)][:8]]
    t0 = time.time()
    ids, scores = retr.topk(users, k=20, exclude_rated=True)
    serve_s = time.time() - t0
    rated = rec.cf_dev.rated_pad.cpu().numpy()
    for row, u in enumerate(users):
        seen = {int(rec.inter.id2item[i]) for i in rated[rec.inter.user[u]] if i >= 0}
        if seen & set(ids[row].tolist()) or np.any(np.diff(scores[row]) > 0):
            raise AssertionError(f"{tag}: user {u} served a rated item or unordered scores")
        if [i for i, _ in rec.recommend(u, k=20)] != ids[row].tolist():
            raise AssertionError(f"{tag}: Retriever and Recommender.recommend disagree")
    log(f"[serve] {tag}: top-20 for 8 users in {serve_s:.4f} s; raw user {users[0]}: "
        f"{ids[0][:5].tolist()}")
    return dict(serve_s_8_users=round(serve_s, 4))


def phase_lightgcn(shape: str, data, kname: str, card: str, fit: bool, model: str = "LightGCN"):
    """LightGCN (or SGL, `model`) at full width: one step through the kernels
    against the plain versions, its launches a step and an encode, then the
    main path through the replayed graphs (a whole `Recommender.train()`
    epoch with Recall@20 beside the untrained state's, or TRAIN_STEPS
    Trainer steps; SGL's views drawn by `epoch_setup` first, and at ML-1M
    density drawn again for TRAIN_STEPS more steps, which must read the new
    values), serving through `Retriever`, and the replayed step bit for bit
    the eager step after 1 and 8 steps (`graph_check`). Returns (summary,
    the Recommender, whose CF device data the zoo phase reads)."""
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer

    tag = f"{model}/{shape}"
    per_step, per_enc = ZOO[model] if model in ZOO else ADJACENCY[model]
    cfg = make_config(model, **(SGL_TRAIN if model == "SGL" else LIGHTGCN_TRAIN),
                      item_ranking=(10, 20, 40), max_epoch=1, early_stopping_steps=100)
    t0 = time.time()
    rec = Recommender(cfg, DEVICE)
    rec.build(data)
    build_s = time.time() - t0
    bundle = rec.bundle
    mats = (bundle.cf.adj, bundle.cf.raw_adj) if model == "SGL" else (bundle.cf.adj,)
    for side in (m for pair in mats for m in (pair.fwd, pair.bwd)):
        b = side.blocked
        if b is None or (b.dedup, b.bf16) != (KERNELS[kname][0] == "dedup", True):
            raise AssertionError(f"{tag}: expected a bf16 {KERNELS[kname][0]} layout, got "
                                 f"{b and _layout_name(b)}")
    rec.init_weights(SEED)
    trainer = Trainer(bundle, seed=SEED, extras=rec.extras)
    trainer.begin_epoch()  # SGL: the epoch's augmented views, on the card
    batches = trainer.sample_epoch()
    step = step_vs_plain(tag, bundle, trainer.extras, tuple(t[0] for t in batches),
                         trainer.edge_keys(), per_step)
    _, enc_err, _ = encode_vs_plain(tag, rec.encode, bundle, rec.extras, per_enc)
    untrained = rec.evaluate()

    # --- the main path, counted: steps and encodes as replayed CUDA graphs
    _zero_spmm_launches()
    t0 = time.time()
    views_moved = None
    if fit:
        result = rec.train(quiet=False)
        n_steps, n_encodes = rec.trainer.n_batches, 2  # the epoch's eval, the best state's
        loss = result.history[-1].losses["train_loss"]
    else:
        n_steps, n_encodes = TRAIN_STEPS, 0
        for s in range(TRAIN_STEPS):
            i = s % batches[0].shape[0]
            loss_t, _ = trainer.train_step(tuple(t[i] for t in batches), trainer.edge_keys())
        if bundle.epoch_setup is not None:  # a new epoch's views, read by the same graph
            before = {k: v.clone() for k, v in trainer.extras.items()}
            trainer.begin_epoch()
            views_moved = all(not torch.equal(before[k], v) for k, v in trainer.extras.items())
            for s in range(TRAIN_STEPS):
                i = s % batches[0].shape[0]
                loss_t, _ = trainer.train_step(tuple(t[i] for t in batches), trainer.edge_keys())
            n_steps += TRAIN_STEPS
        loss = float(loss_t)
        rec.encode()
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches = _spmm_launches()
    # from Python: each branch's eager first step and its capture, and in the
    # epoch the trainer's encode graph's eager first run and its capture
    want = per_step * python_steps(n_steps) + (2 * per_enc if n_encodes else 0)
    if (set(launches) != {kname} or launches[kname] != want or not math.isfinite(loss)
            or views_moved is False):
        raise AssertionError(f"{tag}: {n_steps} steps and their encodes launched {launches} "
                             f"from Python, expected {want} of {kname}; loss {loss}; a new "
                             f"epoch's views differ from the last: {views_moved}")
    summary = dict(model=model, shape=shape, kernel=kname, card=card,
                   build_s=round(build_s, 3), n_train=int(bundle.cf.n_train), steps=n_steps,
                   run_s=round(run_s, 3), python_launches=launches[kname], loss=loss,
                   encode_max_abs_err=enc_err,
                   recall20_untrained=untrained[20]["recall"], **step)
    if views_moved is not None:
        summary["views_moved_between_epochs"] = views_moved
    if fit:
        summary.update(recall20_after_epoch=result.final_metrics[20]["recall"],
                       examples_per_sec=round(result.examples_per_sec, 1),
                       epoch_train_s=round(result.history[0].train_time, 4))
        log(f"[{model.lower()}] {tag} one epoch ({rec.trainer.n_batches} steps): "
            f"{result.examples_per_sec:.1f} examples/s, Recall@20 "
            f"{result.final_metrics[20]['recall']:.5f} (untrained {untrained[20]['recall']:.5f})")
        if model == "SGL":
            summary.update(sgl_learns(tag, data))
    summary.update(serve_check(tag, rec, f"{model.lower()}_{shape}"))
    check = graph_check(tag, bundle, trainer.extras, batches, per_full=per_step, bitwise=True)
    summary.update(step_times(check))
    log(f"[{model.lower()}] {json.dumps(summary)}")
    return summary, rec


def sgl_learns(tag: str, data) -> dict:
    """SGL's loss adds reg times the UN-normalised L2 norms of the batch rows
    (the reference's SGL.py:73, kept by the JAX package): at MODEL_DEFAULTS'
    reg 0.1 that term outweighs BPR, and under Adam the tables of the rows
    each batch touches shrink towards 0 in the first epochs, so Recall@20
    falls below the untrained state's (the JAX package notes the collapse,
    PARITY.md §3). The learning check is the same epoch at reg 0, as that
    note advises: its Recall@20 must beat its untrained state's."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender

    cfg = make_config("SGL", **SGL_TRAIN, reg=0.0, item_ranking=(10, 20, 40), max_epoch=1,
                      early_stopping_steps=100)
    rec = Recommender(cfg, DEVICE)
    rec.build(data)
    rec.init_weights(SEED)
    rec.encode()
    before = rec.evaluate()[20]["recall"]
    after = rec.train().final_metrics[20]["recall"]
    log(f"[sgl] {tag} at reg 0: one epoch's Recall@20 {after:.5f} (untrained {before:.5f})")
    if not after > before:
        raise AssertionError(f"{tag}: at reg 0 an epoch left Recall@20 at {after:.5f}, "
                             f"untrained {before:.5f}")
    return dict(reg0_recall20_untrained=before, reg0_recall20_after_epoch=after)


def phase_zoo(cf_dev, card: str) -> list[dict]:
    """Every other model of the adjacency-only zoo on the LastFM-shape CF
    data: its encode and one step through the kernels against the plain
    versions with their launches (`ZOO`), NCL's k-means `epoch_setup` on the
    card, then the replayed step bit for bit the eager step (`graph_check`,
    its launches counted in the trace) and its times."""
    import gc

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer

    out = []
    for name, (per_step, per_enc) in ZOO.items():
        if name == "LightGCN":
            continue
        tag = f"{name}/lastfm"
        t0 = time.time()
        bundle = build_model(make_config(name, **ZOO_WIDTH), cf_dev)
        trainer = Trainer(bundle, seed=SEED)
        _, enc_err, _ = encode_vs_plain(tag, trainer.encode, bundle, trainer.extras, per_enc)
        if bundle.epoch_setup is not None:  # NCL: k-means on the card, before the epoch
            trainer.begin_epoch()
            cent = [v for k, v in trainer.extras.items() if k.endswith("centroids")]
            if not cent or not all(torch.isfinite(c).all() and c.abs().sum() > 0 for c in cent):
                raise AssertionError(f"{tag}: epoch_setup left centroids {cent}")
        batches = trainer.sample_epoch()
        step = step_vs_plain(tag, bundle, trainer.extras, tuple(t[0] for t in batches),
                             trainer.edge_keys(), per_step)
        check = graph_check(tag, bundle, trainer.extras, batches, per_full=per_step,
                            bitwise=True)
        summary = dict(model=name, shape="lastfm", card=card, launches_encode=per_enc,
                       encode_max_abs_err=enc_err, **step, **step_times(check),
                       phase_s=round(time.time() - t0, 2))
        log(f"[zoo] {json.dumps(summary)}")
        out.append(summary)
        del bundle, trainer, check
        gc.collect()
        torch.cuda.empty_cache()
    return out


def width_one_check(tag: str, raw_adj) -> dict:
    """A width-1 product on raw_adj (AutoCF's operands) and its backward run
    kernel 1 on X padded to width 8 (one launch and one padding each way),
    against the plain version."""
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S

    gen = torch.Generator(DEVICE).manual_seed(SEED)
    x = torch.rand(raw_adj.fwd.ncols, 1, device=DEVICE, generator=gen).requires_grad_(True)
    g = torch.rand(raw_adj.fwd.nrows, 1, device=DEVICE, generator=gen)
    _zero_spmm_launches()
    padded = S.PADDED["calls"]
    y = sparse.spmm_pair(raw_adj.fwd, raw_adj.bwd, x)
    (dx,) = torch.autograd.grad(y, x, g)
    torch.cuda.synchronize()
    launches, padded = _spmm_launches(), S.PADDED["calls"] - padded
    want = S.blocked_spmm_reference(raw_adj.fwd.blocked, x.detach())
    want_dx = S.blocked_spmm_reference(raw_adj.bwd.blocked, g)
    err = max(float((y - want).abs().max()), float((dx - want_dx).abs().max()))
    scale = max(float(want.abs().max()), float(want_dx.abs().max()))
    kname = "segment_spmm_dedup" if raw_adj.fwd.blocked.dedup else "segment_spmm_rows"
    log(f"[width1] {tag}: y {tuple(y.shape)} and dx {tuple(dx.shape)}, launches {launches}, "
        f"padded calls {padded}, max_abs_err {err:.3e} at scale {scale:.3e}")
    if (launches != {kname: 2} or padded != 2 or y.shape != want.shape
            or not err <= KERNEL_RTOL * scale):
        raise AssertionError(f"{tag}: a width-1 product and its backward launched {launches} "
                             f"with {padded} padded calls (expected 2 of {kname}, 2 padded); "
                             f"max_abs_err {err:.3e} at scale {scale:.3e}")
    return dict(width1_launches=launches, width1_padded_calls=padded, width1_max_abs_err=err)


def refresh_vs_plain(tag: str, bundle, trainer, batch) -> dict:
    """AutoCF's subgraph refresh (`update_extras` on a refresh step) through
    the kernels against the plain versions from one generator state:
    REFRESH_LAUNCHES launches, the seeds' decoder lists and masks equal, the
    encoder values and the mean seed score within KERNEL_RTOL. Its output
    is written into the trainer's extras (the next step's branch is a
    refresh: its loss holds the seed-score term)."""
    from unittest import mock

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S

    def refresh():
        gen = torch.Generator(DEVICE).manual_seed(SEED)
        with torch.no_grad():
            out = bundle.update_extras(dict(trainer.extras, step=0), batch, gen)
        torch.cuda.synchronize()
        return out

    _zero_spmm_launches()
    got = refresh()
    launches = _spmm_launches()
    with mock.patch.object(sparse, "blocked_spmm", S.blocked_spmm_reference):
        plain = refresh()
    same = {k: bool(torch.equal(got[k], plain[k])) for k in ("dec_rows", "dec_cols", "dec_valid")}
    errs = {k: float((got[k] - plain[k]).abs().max()) / max(float(plain[k].abs().max()), 1e-30)
            for k in ("enc_vals", "samp_score")}
    kept = int(got["dec_valid"].sum())
    log(f"[refresh] {tag}: launches {launches} (expected {REFRESH_LAUNCHES}); decoder lists "
        f"equal {same}; rel err {errs}; {kept} valid decoder edges of {got['dec_valid'].numel()}")
    if (sum(launches.values()) != REFRESH_LAUNCHES or not all(same.values())
            or max(errs.values()) > KERNEL_RTOL):
        raise AssertionError(f"{tag}: the refresh through the kernels differs from the plain one "
                             f"({launches}, {same}, {errs})")
    for k, v in got.items():
        trainer.extras[k].copy_(v)
    trainer.extras["step"] = 0
    return dict(refresh_launches=sum(launches.values()), refresh_rel_err=errs,
                decoder_valid_edges=kept)


def gt_layer_ab(tag: str, bundle, extras) -> dict:
    """AutoCF's GT layer over the decoder of the last refresh, forward and
    backward: device time with the hub-safe sums (`scatter_sum_hubs`,
    `gather_rows_hubs`, as the model runs it) beside the same layer with the
    plain fixed-order sums, whose runs of the first seed's id are added one
    element after another. Both are held against the layer in f64: the
    hub-safe sums, which add at most about RUN_CHUNK terms in a row, must be
    at least as close to it as the plain ones (a serial f32 sum of 250,000
    positive softmax terms is off by about 1e-3 of its value)."""
    import copy
    from unittest import mock

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.models import autocf
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops import sparse

    gt = getattr(bundle.module, bundle.module.gt_layers[0])
    dec = (extras["dec_rows"], extras["dec_cols"], extras["dec_valid"])
    x32 = bundle.module.ego().detach()
    w32 = torch.randn(x32.shape, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(SEED))

    def runner(layer, x0, w):
        x = x0.clone().requires_grad_(True)

        def run():
            out = layer(x, *dec)
            (g,) = torch.autograd.grad((out * w).sum(), x)
            return out.detach(), g

        return run

    ref = runner(copy.deepcopy(gt).double(), x32.double(), w32.double())()
    run = runner(gt, x32, w32)
    hub_out = run()
    hub_ms, _ = device_ms(run, iters=3)
    plain = {"scatter_sum_hubs": sparse.scatter_sum, "gather_rows_hubs": lambda t, i: t[i]}
    with mock.patch.multiple(sparse, **plain), mock.patch.multiple(autocf, **plain):
        plain_out = run()
        plain_ms, _ = device_ms(run, iters=3)

    def errs(got):  # output, input gradient: max error over the f64 value's scale
        return [float((a.double() - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                for a, r in zip(got, ref)]

    hub_err, plain_err = errs(hub_out), errs(plain_out)
    run_len = int(torch.bincount(dec[0].long()).max())
    log(f"[gt] {tag}: GT layer fwd+bwd device {hub_ms:.4f} ms with the hub-safe sums, "
        f"{plain_ms:.4f} with the plain ones (the longest run of one row id: {run_len}); "
        f"rel err against f64 (output, gradient): hub-safe {hub_err[0]:.2e} {hub_err[1]:.2e}, "
        f"plain {plain_err[0]:.2e} {plain_err[1]:.2e}")
    if not all(h <= max(p, KERNEL_RTOL) for h, p in zip(hub_err, plain_err)):
        raise AssertionError(f"{tag}: the hub-safe GT layer is further from f64 than the plain "
                             f"one: {hub_err} against {plain_err}")
    return dict(gt_hub_ms=round(hub_ms, 4), gt_plain_ms=round(plain_ms, 4),
                gt_hub_rel_err=hub_err, gt_plain_rel_err=plain_err,
                decoder_longest_row_run=run_len)


def phase_adjacency(data, card: str) -> list[dict]:
    """The other adjacency forms at the LastFM shape (`ADJACENCY` without
    SGL) on one CF device data with every representation they read and the
    KG device data: the encode and one step through the kernels against the
    plain versions with their launches; AutoCF's and LRMRec's refresh
    against the plain one, and their refresh and keep graphs, each replayed
    step bit for bit its eager step; the width-1 raw_adj product on kernel 1;
    each model's replayed-step wall, device time and idle share."""
    import gc

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import (
        build_cf_device_data,
        build_interaction,
        build_kg_device_data,
        build_knowledge,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model
    from hypergraph_diffusion_for_recommendation_tpu_torch.models.autocf import FIX_STEPS
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer

    train, test, kg_df = data
    inter = build_interaction(train, test)
    cf = build_cf_device_data(inter, DEVICE, eval_user_multiple=ADJACENCY_WIDTH["eval_user_batch"],
                              needs={"adj", "raw_adj", "raw_int", "int_norm"}, bf16=True)
    kg = build_kg_device_data(build_knowledge(kg_df, inter), DEVICE, bf16=True)
    out = [width_one_check("raw_adj/lastfm", cf.raw_adj)]
    for name, (per_step, per_enc) in ADJACENCY.items():
        if name == "SGL":
            continue
        tag = f"{name}/lastfm"
        t0 = time.time()
        bundle = build_model(make_config(name, **ADJACENCY_WIDTH), cf,
                             kg if name.startswith("KG") else None)
        trainer = Trainer(bundle, seed=SEED)
        _, enc_err, _ = encode_vs_plain(tag, trainer.encode, bundle, trainer.extras, per_enc)
        batches = trainer.sample_epoch()
        batch = tuple(t[0] for t in batches)
        summary = dict(model=name, shape="lastfm", card=card, launches_encode=per_enc,
                       encode_max_abs_err=enc_err)
        if isinstance(per_step, dict):  # AutoCF, LRMRec: a refresh, then its step
            summary.update(refresh_vs_plain(tag, bundle, trainer, batch))
            if name == "AutoCF":
                summary.update(gt_layer_ab(tag, bundle, trainer.extras))
            loss_launches = per_step["keep"]
            cycle = ("step", FIX_STEPS, {"refresh": (0, per_step["refresh"]),
                                         "keep": (1, per_step["keep"])})
        else:
            loss_launches, cycle = per_step, None
        step = step_vs_plain(tag, bundle, trainer.extras, batch, trainer.edge_keys(),
                             loss_launches)
        check = graph_check(tag, bundle, trainer.extras, batches,
                            per_full=loss_launches, bitwise=True, cycle=cycle)
        summary.update(step)
        if cycle is None:
            summary.update(step_times(check))
        else:
            summary.update(step_times(check, "keep"))
            summary["refresh_step"] = step_times(check, "refresh")
        summary["phase_s"] = round(time.time() - t0, 2)
        log(f"[adjacency] {json.dumps(summary)}")
        out.append(summary)
        del bundle, trainer, check
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_joint(shape: str, data, card: str) -> dict:
    """KHGRec's joint encode (HGDR_JOINT) in phase 6's configuration: the
    encode and one step through the kernels against the plain versions, 4
    launches an encode and 8 a step, the replayed step bit for bit the eager
    step, and its times beside the unfused step's on the same device data."""
    import os

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer

    cfg = make_config("KHGRec", **KHGREC_TRAIN, item_ranking=(10, 20, 40))
    os.environ["HGDR_JOINT"] = "1"
    try:
        rec = Recommender(cfg, DEVICE)
        rec.build(data)
    finally:
        del os.environ["HGDR_JOINT"]
    rec.init_weights(SEED)
    # each path starts from the initial state (graph_check leaves the module trained)
    start = {k: v.clone() for k, v in rec.bundle.module.state_dict().items()}
    out = dict(shape=shape, card=card)
    for kind, bundle, (per_step, per_enc) in (
            ("joint", rec.bundle, JOINT_LAUNCHES),
            ("unfused", build_model(cfg, rec.cf_dev, rec.bundle.kg), UNFUSED_LAUNCHES)):
        tag = f"KHGRec-{kind}/{shape}"
        if bundle.n_edge_keys != (1 if kind == "joint" else 2):
            raise AssertionError(f"{tag}: {bundle.n_edge_keys} edge keys a step")
        bundle.module.load_state_dict(start)
        trainer = Trainer(bundle, seed=SEED, extras=rec.extras)
        (u, i), enc_err, enc_launches = encode_vs_plain(tag, trainer.encode, bundle,
                                                        trainer.extras, per_enc)
        if kind == "joint":
            joint_tables = (u.clone(), i.clone())
            layout = next(iter(enc_launches))
        else:  # the same tables: the joint chain computes the unfused one's values
            diff = max(float((u - joint_tables[0]).abs().max()),
                       float((i - joint_tables[1]).abs().max()))
            out["joint_vs_unfused_encode_max_abs_err"] = diff
            if not diff <= ENCODE_RTOL * max(float(u.abs().max()), 1.0):
                raise AssertionError(f"{tag}: the joint encode differs from the unfused one "
                                     f"by {diff:.3e}")
        batches = trainer.sample_epoch()
        step = step_vs_plain(tag, bundle, trainer.extras, tuple(t[0] for t in batches),
                             trainer.edge_keys(), per_step)
        check = graph_check(tag, bundle, trainer.extras, batches, per_full=per_step,
                            bitwise=True)
        out[kind] = dict(encode_max_abs_err=enc_err, launches_encode=per_enc, **step,
                         **step_times(check))
        del trainer, check
        torch.cuda.empty_cache()
    out["joint_kernel"] = layout
    log(f"[joint] {json.dumps(out)}")
    log(f"[joint] replayed step: joint wall {out['joint']['step_wall_ms']:.4f} ms, device "
        f"{out['joint']['step_device_ms']:.4f} | unfused wall {out['unfused']['step_wall_ms']:.4f}"
        f" ms, device {out['unfused']['step_device_ms']:.4f}")
    return out


def kernel_of(b) -> str:
    """The segment-SpMM kernel a packed layout runs."""
    return ("segment_spmm_dedup" if b.dedup else "segment_spmm_rows") + ("_int8" if b.int8 else "")


def relation_gather_ab(tag: str, bundle, extras, kg_batch) -> dict:
    """The KG loss's relation gather `rel[r]` (8192 ids over the KG's 10
    relations, two of them holding most triples) three ways, each the KG
    step's forward and backward, device time from the profiler: a one-hot
    matmul (`kg_common.relation_lookup`, the JAX package's form, the code's),
    the hub-safe gather (`gather_rows_hubs`) and plain indexing, whose index
    backward adds each run of one id one element after another. Their
    relation gradients agree within KERNEL_RTOL of the one-hot one."""
    from unittest import mock

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.models import kgat
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.sparse import gather_rows_hubs

    params = list(bundle.module.parameters())
    at = next(i for i, p in enumerate(params) if p is bundle.module.relation_embed)
    forms = {
        "one_hot": kgat.relation_lookup,
        "hub_safe": lambda t, r: gather_rows_hubs(t, r.long()),
        "plain_index": lambda t, r: t[r.long()],
    }

    def run():
        loss, _ = bundle.kg_batch_loss(extras, kg_batch, (), None)
        return torch.autograd.grad(loss, params, allow_unused=True)

    out = {}
    grads = {}
    for name, fn in forms.items():
        with mock.patch.object(kgat, "relation_lookup", fn):
            grads[name] = run()[at].double()
            out[f"kg_step_{name}_ms"] = round(device_ms(run, iters=5)[0], 4)
    r = kg_batch[1].long()
    run_len = int(torch.bincount(r).max())
    ref = grads["one_hot"]  # exact in its forward; its backward is one GEMM
    errs = {n: float((g - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
            for n, g in grads.items()}
    log(f"[kgat] {tag}: KG step fwd+bwd device ms by relation gather: "
        + ", ".join(f"{n} {out[f'kg_step_{n}_ms']:.4f}" for n in forms)
        + f" (the longest run of one relation id: {run_len}); relation gradient rel diff "
        f"against the one-hot form {errs}")
    if max(errs.values()) > KERNEL_RTOL:
        raise AssertionError(f"{tag}: the relation gathers' gradients differ: {errs}")
    out["relation_id_longest_run"] = run_len
    return out


def refresh_check(tag: str, trainer) -> dict:
    """KGAT's attention refresh (`Trainer.end_epoch`) on the card: its device
    time, the memory it takes beyond what was allocated before it (the
    relation-batched projection of 2 x n_kg_train rows), every live head's
    weights summing to 1, and the weights within REFRESH_RTOL of the same
    refresh in f64 (its plain version)."""
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.models.kg_common import (
        attention_softmax,
        attention_values,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.sparse import scatter_sum

    bundle, kg = trainer.bundle, trainer.bundle.kg
    m = bundle.module
    refresh_ms, _ = device_ms(lambda: bundle.epoch_update_extras(trainer.extras, None), iters=3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    buf = trainer.extras["att_vals"]
    trainer.end_epoch()
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - base
    att = trainer.extras["att_vals"]
    if att is not buf:
        raise AssertionError(f"{tag}: the refresh replaced the attention buffer")
    with torch.no_grad():
        ref = attention_softmax(attention_values(m.entity_user_embed.double(),
                                                 m.relation_embed.double(), m.trans_M.double(),
                                                 kg.att_h, kg.att_t, kg.att_r),
                                kg.att_h, kg.n_entities, kg.att_valid)
    err = float((att.double() - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
    sums = scatter_sum(att.double(), kg.att_h, kg.n_entities)
    has = scatter_sum(kg.att_valid.double(), kg.att_h, kg.n_entities) > 0
    sum_err = float((sums[has] - 1).abs().max())
    log(f"[kgat] {tag}: refresh device {refresh_ms:.4f} ms, {transient / 2**20:.1f} MiB beyond "
        f"the allocated {base / 2**20:.1f} MiB, rel err against f64 {err:.2e}, rows sum to 1 "
        f"within {sum_err:.2e}")
    if err > REFRESH_RTOL or sum_err > REFRESH_RTOL or not torch.isfinite(att).all():
        raise AssertionError(f"{tag}: the refresh differs from f64 by {err:.2e} (rows {sum_err})")
    return dict(refresh_device_ms=round(refresh_ms, 4), refresh_transient_mib=round(
        transient / 2**20, 1), refresh_rel_err=err)


def learns(tag: str, model: str, data, cfg_kw: dict, lrate: float, social=None) -> dict:
    """One `Recommender.train()` epoch at `lrate` from the seeded weights:
    Recall@20 before and after, and both phases' step counts."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender

    cfg = make_config(model, **cfg_kw, lrate=lrate, item_ranking=(10, 20, 40), max_epoch=1,
                      early_stopping_steps=100)
    rec = Recommender(cfg, DEVICE, social=social)
    rec.build(data)
    rec.init_weights(SEED)
    rec.encode()
    before = rec.evaluate()[20]["recall"]
    t0 = time.time()
    result = rec.train(quiet=False)
    epoch_s = time.time() - t0
    after = result.final_metrics[20]["recall"]
    tr = rec.trainer
    log(f"[kgat] {tag} one epoch at lrate {lrate:g} ({tr.n_batches} CF steps, "
        f"{getattr(tr, 'n_kg_batches', 0)} KG steps): Recall@20 {after:.5f} (untrained "
        f"{before:.5f}), {result.examples_per_sec:.1f} examples/s, train "
        f"{result.history[0].train_time:.3f} s, {epoch_s:.2f} s with its evaluations")
    return dict(lrate=lrate, recall20_untrained=before, recall20_after_epoch=after,
                cf_steps=tr.n_batches, kg_steps=getattr(tr, "n_kg_batches", 0),
                examples_per_sec=round(result.examples_per_sec, 1),
                epoch_train_s=round(result.history[0].train_time, 4), rec=rec)


def phase_kgat(shape: str, data, card: str, fit: bool) -> dict:
    """KGAT at full width through the alternating trainer: one CF step and
    one KG step against the plain versions (0 SpMM launches: KGAT reaches no
    segment-SpMM kernel), the relation-gather A/B, the refresh against f64
    with its time and memory, the encode against the plain version; the main
    path (a whole `Recommender.train()` epoch at the LastFM shape, with
    Recall@20 beside the untrained state's and, if the paper's rate 1e-4
    leaves it there, the learning check at KGAT_LEARN_LRATE; TRAIN_STEPS
    steps of each phase and the refresh at ML-1M density), serving, and each
    phase's step graph replayed bit for bit its eager step (`graph_check`),
    with its times."""
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer

    tag = f"KGAT/{shape}"
    cfg_kw = dict(KGAT_TRAIN)
    t0 = time.time()
    rec = Recommender(make_config("KGAT", **cfg_kw, item_ranking=(10, 20, 40), max_epoch=1,
                                  early_stopping_steps=100), DEVICE)
    rec.build(data)
    build_s = time.time() - t0
    bundle = rec.bundle
    rec.init_weights(SEED)
    trainer = Trainer(bundle, seed=SEED, extras=rec.extras)
    cf, kg = trainer.sample_epoch(), trainer.sample_kg_epoch()
    cf_batch, kg_batch = tuple(t[0] for t in cf), tuple(t[0] for t in kg)
    summary = dict(model="KGAT", shape=shape, card=card, build_s=round(build_s, 3),
                   n_entities=bundle.kg.n_entities, n_kg_train=bundle.kg.n_kg_train,
                   cf_steps=trainer.n_batches, kg_steps=trainer.n_kg_batches)
    summary["cf_step"] = step_vs_plain(f"{tag} cf", bundle, trainer.extras, cf_batch, (), 0)
    summary["kg_step"] = step_vs_plain(f"{tag} kg", bundle, trainer.extras, kg_batch, (), 0,
                                       loss_fn=bundle.kg_batch_loss)
    summary.update(relation_gather_ab(tag, bundle, trainer.extras, kg_batch))
    summary.update(refresh_check(tag, trainer))
    # the encode reads a refreshed attention (the zero one gives side = 0)
    _, enc_err, _ = encode_vs_plain(tag, trainer.encode, bundle, trainer.extras, 0)
    summary["encode_max_abs_err"] = enc_err
    _zero_spmm_launches()
    t0 = time.time()
    if fit:  # the main path: one epoch through the facade at the paper's rate
        run = learns(tag, "KGAT", data, cfg_kw, rec.cfg.lrate)
        if not run["recall20_after_epoch"] > run["recall20_untrained"]:
            log(f"[kgat] {tag}: one epoch at the paper's rate {rec.cfg.lrate:g} left Recall@20 "
                f"at or below its untrained value: the learning check runs at "
                f"{KGAT_LEARN_LRATE:g}, the JAX package's learning test's rate")
            summary["paper_rate_epoch"] = {k: v for k, v in run.items() if k != "rec"}
            run = learns(tag, "KGAT", data, cfg_kw, KGAT_LEARN_LRATE)
            if not run["recall20_after_epoch"] > run["recall20_untrained"]:
                raise AssertionError(f"{tag}: an epoch at {KGAT_LEARN_LRATE:g} left Recall@20 at "
                                     f"{run['recall20_after_epoch']:.5f}")
        rec = run.pop("rec")
        summary["epoch"] = run
    else:
        for s in range(TRAIN_STEPS):
            trainer.train_step(tuple(t[s] for t in cf), ())
        for s in range(TRAIN_STEPS):
            trainer.train_step(tuple(t[s] for t in kg), (), "kg")
        trainer.end_epoch()
        rec.extras = trainer.extras
        rec.encode()
    torch.cuda.synchronize()
    summary["main_path_s"] = round(time.time() - t0, 3)
    launches = _spmm_launches()
    if launches:
        raise AssertionError(f"{tag}: KGAT's main path launched SpMM kernels: {launches}")
    summary.update(serve_check(tag, rec, f"kgat_{shape}"))
    for phase, batches in (("cf", cf), ("kg", kg)):
        check = graph_check(f"{tag} {phase}", bundle, trainer.extras, batches, per_full=0,
                            bitwise=True, phase=phase)
        summary[f"{phase}_replay"] = step_times(check)
    log(f"[kgat] {json.dumps(summary)}")
    return summary


def _expected_launches(products) -> dict:
    """{kernel name: launches} of a list of (packed layout, count) products."""
    out: dict[str, int] = {}
    for b, n in products:
        out[kernel_of(b)] = out.get(kernel_of(b), 0) + n
    return out


def phase_rest(lastfm, ml1m, card: str) -> list[dict]:
    """KTUP, HKGRippleNet, MHCN and SEPT at the LastFM shape, and MHCN at
    ML-1M density, at width 64 with the bf16 operand, each built by
    `Recommender.build` (the social models given the synthetic trust network
    of `synthetic_social(inter, 5)`): the host build times (ripple sets, the
    user-user matrices), each social matrix's shape, nnz and kernel, the
    encode and one step against the plain versions with their SpMM launches
    by kernel name (`REST`), serving, and the replayed step bit for bit its
    eager step with its times."""
    import gc
    import inspect

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import (
        build_interaction,
        build_social,
        synthetic_social,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.models import (
        ktup_ripplenet,
        social_models,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer

    out = []
    for name, shape in (("KTUP", "lastfm"), ("HKGRippleNet", "lastfm"), ("MHCN", "lastfm"),
                        ("SEPT", "lastfm"), ("MHCN", "ml1m")):
        per_step, per_enc = REST[name]
        data = lastfm if shape == "lastfm" else ml1m
        tag = f"{name}/{shape}"
        t0 = time.time()
        social = None
        summary = dict(model=name, shape=shape, card=card)
        if name in ("MHCN", "SEPT"):
            inter = build_interaction(data[0], data[1])
            t1 = time.time()
            social = build_social(synthetic_social(inter, n_per_user=5), inter)
            summary["social_build_s"] = round(time.time() - t1, 3)
            summary["social_edges"] = social.n_relations
        rec = Recommender(make_config(name, **REST_WIDTH, item_ranking=(10, 20, 40)), DEVICE,
                          social=social)
        rec.build(data)
        summary["build_s"] = round(time.time() - t0, 3)
        bundle = rec.bundle
        cf = bundle.cf
        if name == "HKGRippleNet":
            t1 = time.time()
            ktup_ripplenet.build_ripple_sets(cf, bundle.kg, rec.cfg.seed)
            summary["ripple_sets_s"] = round(time.time() - t1, 3)
        want_step, want_enc = {}, {}
        if social is not None:
            t1 = time.time()
            fn = (social_models.social_channel_mats if name == "MHCN"
                  else social_models.sept_view_mats)
            fn(cf, social.social_mat)
            summary["user_matrices_host_s"] = round(time.time() - t1, 3)
            free = inspect.getclosurevars(bundle.batch_loss).nonlocals
            mats = dict(free["channels"] if name == "MHCN" else free["views"])
            main = ("inv_int_norm", cf.inv_int_norm, 1) if name == "MHCN" else ("adj", cf.adj,
                                                                                 bundle.cfg.n_layers)
            info = {}
            products_step, products_enc = [], []
            for k, pair in list(mats.items()) + [main[:2]]:
                n = main[2] if k == main[0] else bundle.cfg.n_layers
                products_step += [(pair.fwd.blocked, n), (pair.bwd.blocked, n)]
                if name == "MHCN" or k == "adj":  # SEPT's encode: the main view only
                    products_enc.append((pair.fwd.blocked, n))
                info[k] = dict(shape=list(pair.fwd.shape), nnz=pair.fwd.nnz,
                               fwd=kernel_of(pair.fwd.blocked), bwd=kernel_of(pair.bwd.blocked))
                log(f"[rest] {tag}: {k} {pair.fwd.shape[0]}x{pair.fwd.shape[1]} nnz "
                    f"{pair.fwd.nnz}: forward on {info[k]['fwd']}, backward on {info[k]['bwd']}")
            summary["matrices"] = info
            want_step, want_enc = _expected_launches(products_step), _expected_launches(products_enc)
            if sum(want_step.values()) != per_step or sum(want_enc.values()) != per_enc:
                raise AssertionError(f"{tag}: the matrices give {want_step} a step and {want_enc} "
                                     f"an encode, expected {per_step} and {per_enc}")
        rec.init_weights(SEED)
        trainer = Trainer(bundle, seed=SEED, extras=rec.extras)
        _, enc_err, enc_launches = encode_vs_plain(tag, trainer.encode, bundle, trainer.extras,
                                                   per_enc)
        if {k: v // 2 for k, v in enc_launches.items()} != want_enc:
            raise AssertionError(f"{tag}: an encode launched {enc_launches} from Python "
                                 f"(twice {want_enc} expected)")
        batches = trainer.sample_epoch()
        step = step_vs_plain(tag, bundle, trainer.extras, tuple(t[0] for t in batches), (),
                             per_step)
        if step["launches_by_kernel"] != want_step:
            raise AssertionError(f"{tag}: a step launched {step['launches_by_kernel']}, expected "
                                 f"{want_step}")
        rec.encode()
        summary.update(encode_max_abs_err=enc_err, launches_encode=per_enc, **step)
        summary.update(serve_check(tag, rec, f"{name.lower()}_{shape}"))
        check = graph_check(tag, bundle, trainer.extras, batches, per_full=per_step,
                            bitwise=True)
        summary.update(step_times(check))
        summary["phase_s"] = round(time.time() - t0, 2)
        log(f"[rest] {json.dumps(summary)}")
        out.append(summary)
        del rec, bundle, trainer, check
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_sequential(shape: str, data, card: str) -> list[dict]:
    """SASRec and CL4SRec at full width (`SEQ_TRAIN`, dropout `SEQ_DROPOUT`):
    the encode graph's replay bit for bit the eager encode, the untrained
    state's Recall@20, the main path (SEQ_EPOCHS epochs through
    `Recommender.train()`, every step and encode a replayed graph) with 0
    SpMM launches and Recall@20 above the untrained state's, serving, and
    the replayed step bit for bit the eager step (`graph_check`) with its
    times."""
    import gc

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer

    out = []
    for model in ("SASRec", "CL4SRec"):
        tag = f"{model}/{shape}"
        t0 = time.time()
        rec = Recommender(make_config(model, **SEQ_TRAIN, drop_rate=SEQ_DROPOUT[shape],
                                      item_ranking=(10, 20, 40), max_epoch=SEQ_EPOCHS,
                                      early_stopping_steps=100), DEVICE)
        rec.build(data)
        build_s = time.time() - t0
        bundle = rec.bundle
        sd = bundle.seq
        rec.init_weights(SEED)
        trainer = Trainer(bundle, seed=SEED, extras=rec.extras)
        _zero_spmm_launches()
        u, i = (t.clone() for t in trainer.encode())  # the encode graph's first replay
        eu, ei = bundle.encode_eval(trainer.extras)
        torch.cuda.synchronize()
        if not (torch.equal(u, eu) and torch.equal(i, ei) and torch.isfinite(u).all()):
            raise AssertionError(f"{tag}: the replayed encode differs from the eager encode")
        rec.encode()
        untrained = rec.evaluate()[20]["recall"]
        batches = trainer.sample_epoch()

        # --- the main path, counted: SEQ_EPOCHS epochs of replayed steps and encodes
        _zero_spmm_launches()
        t0 = time.time()
        result = rec.train(quiet=False)
        torch.cuda.synchronize()
        run_s = time.time() - t0
        launches = _spmm_launches()
        after = result.final_metrics[20]["recall"]
        losses = [h.losses["train_loss"] for h in result.history]
        if launches or not all(math.isfinite(x) for x in losses) or not after > untrained:
            raise AssertionError(f"{tag}: {SEQ_EPOCHS} epochs launched {launches} SpMM kernels "
                                 f"(expected none), losses {losses}, Recall@20 {after:.5f} "
                                 f"against {untrained:.5f} untrained")
        # padding positions (item 0, position 0) in a batch of windows, on average: the
        # longest run of one id in the gathers' backward sums
        pad_per_batch = float((sd.seq[: sd.n_seqs] == 0).float().mean()) * sd.seq[0].numel() \
            * SEQ_TRAIN["batch_size"]
        summary = dict(model=model, shape=shape, card=card, drop_rate=SEQ_DROPOUT[shape],
                       build_s=round(build_s, 3), n_seqs=sd.n_seqs, n_pad=sd.seq.shape[0],
                       pad_positions_per_batch=round(pad_per_batch, 1),
                       steps_per_epoch=rec.trainer.n_batches, epochs=len(result.history),
                       run_s=round(run_s, 3), losses=losses, spmm_launches=0,
                       recall20_untrained=untrained, recall20_after=after,
                       examples_per_sec=round(result.examples_per_sec, 1),
                       epoch_train_s=[round(h.train_time, 4) for h in result.history])
        log(f"[seq] {tag}: {SEQ_EPOCHS} epochs of {rec.trainer.n_batches} steps in {run_s:.2f} "
            f"s with their evaluations, {result.examples_per_sec:.1f} examples/s, Recall@20 "
            f"{after:.5f} (untrained {untrained:.5f}), losses {[round(x, 4) for x in losses]}")
        summary.update(serve_check(tag, rec, f"{model.lower()}_{shape}"))
        check = graph_check(tag, bundle, trainer.extras, batches, per_full=0, bitwise=True)
        summary.update(step_times(check))
        log(f"[seq] {json.dumps(summary)}")
        out.append(summary)
        del rec, bundle, trainer, check
        gc.collect()
        torch.cuda.empty_cache()
    return out


def resume_check(tag: str, model: str, cfg_kw: dict, data, ckpt_dir: Path) -> dict:
    """Two epochs through `Trainer.fit(ckpt=..., ckpt_every=1)`; a fresh
    Trainer of the same bundle restores the last checkpoint, and its next
    epoch (eager first steps, then its own captures) must equal the third
    epoch of an uninterrupted run bit for bit: the loss, the parameters,
    every Adam state and the extras."""
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer
    from hypergraph_diffusion_for_recommendation_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    rec = Recommender(make_config(model, **cfg_kw, item_ranking=(10, 20, 40), max_epoch=3,
                                  early_stopping_steps=100), DEVICE)
    rec.build(data)
    bundle = rec.bundle
    ckpt = CheckpointManager(str(ckpt_dir), max_to_keep=2)
    t0 = time.time()
    Trainer(bundle, seed=SEED).fit(max_epoch=2, quiet=True, ckpt=ckpt, ckpt_every=1)
    saved = ckpt.latest_step()
    fit_s = time.time() - t0
    whole = Trainer(bundle, seed=SEED)  # trainers of one bundle run one after another
    want_losses = [whole.run_epoch(ep)[0] for ep in range(3)]
    torch.cuda.synchronize()
    want = full_state(whole)
    resumed = Trainer(bundle, seed=SEED)
    t0 = time.time()
    start = resumed.restore(ckpt)
    restore_s = time.time() - t0
    loss = resumed.run_epoch(2)[0]
    torch.cuda.synchronize()
    got = full_state(resumed)
    ckpt.close()
    moved = sorted(k for k in want if not torch.equal(got[k], want[k]))
    log(f"[resume] {tag}: checkpoint of epoch {saved}, restored to start at {start} in "
        f"{restore_s:.3f} s; epoch 3 loss resumed {loss!r}, uninterrupted {want_losses[2]!r}; "
        f"tensors that differ: {moved[:6]} of {len(want)}")
    if saved != 1 or start != 2 or loss != want_losses[2] or moved:
        raise AssertionError(f"{tag}: the resumed epoch differs from the uninterrupted run "
                             f"(loss {loss} vs {want_losses[2]}, tensors {moved[:6]})")
    return dict(model=model, checkpoint_epoch=saved, start_epoch=start, loss=loss,
                tensors_equal=len(want), two_epochs_with_checkpoints_s=round(fit_s, 3),
                restore_s=round(restore_s, 4), checkpoint_bytes=sum(
                    f.stat().st_size for f in ckpt_dir.glob("ckpt_*.pt")))


def cli_layouts(root: Path, common: list, ml1m) -> dict:
    """The layout variables through the CLI (`CLI_LAYOUTS`): with HGDR_DEDUP=0
    a LightGCN epoch at ML-1M density (where `dedup_auto` picks dedup) must
    launch kernel 1 and not kernel 2, with HGDR_DEDUP=1 one at the LastFM
    shape (where it picks base) kernel 2 and not kernel 1, by the wrappers'
    counts; then MHCN without social data must be refused by the CLI run as
    a user runs it, with a non-zero exit code."""
    import os

    from hypergraph_diffusion_for_recommendation_tpu_torch import cli
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import io

    io.write_interactions(str(root / "dataset" / "ml1m" / "train.txt"), ml1m[0])
    io.write_interactions(str(root / "dataset" / "ml1m" / "test.txt"), ml1m[1])
    out = {}
    for dataset, dedup, want, other in CLI_LAYOUTS:
        before = os.environ.get("HGDR_DEDUP")
        os.environ["HGDR_DEDUP"] = dedup
        _zero_spmm_launches()
        try:
            cli.main(CLI_LIGHTGCN + [f"--dataset={dataset}"] + common[1:])
        finally:
            if before is None:
                del os.environ["HGDR_DEDUP"]
            else:
                os.environ["HGDR_DEDUP"] = before
        launches = _spmm_launches()
        log(f"[cli] HGDR_DEDUP={dedup} LightGCN on {dataset}: SpMM launches from Python "
            f"{launches}")
        if not launches.get(want) or launches.get(other):
            raise AssertionError(f"cli: HGDR_DEDUP={dedup} on {dataset} launched {launches}, "
                                 f"expected {want} and no {other}")
        out[f"HGDR_DEDUP={dedup} {dataset}"] = launches
    argv = [sys.executable, "-m", "hypergraph_diffusion_for_recommendation_tpu_torch.cli",
            "--model=MHCN", "--max_epoch=1", "--dataset=lastfm"] + common[1:]
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    proc = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=path))
    said = proc.stderr.strip().splitlines()[-1:] if proc.stderr.strip() else []
    log(f"[cli] MHCN without social data: rc {proc.returncode}, {said}")
    if proc.returncode == 0 or "MHCN requires social data" not in proc.stderr:
        raise AssertionError(f"cli: MHCN without social data was not refused (rc "
                             f"{proc.returncode})")
    out["mhcn_without_social"] = dict(rc=proc.returncode, said=said)
    return out


def phase_cli(lastfm, ml1m, card: str) -> dict:
    """The CLI from files: the LastFM-shape split written in the reference
    layout (`<data_dir>/lastfm/train.txt`, `test.txt`, `processed_lastfm.kg`);
    `cli.main` for KHGRec (`CLI_KHGREC`: kernel 1 must launch; the JAX
    package's artifact headers) and SASRec (`CLI_SASREC`: no SpMM), each file
    parsed by the native library (the plain parser never called, and equal
    to it); `serving_cli` over KHGRec's export; the layout variables and
    MHCN's refusal (`cli_layouts`); then resume on the card for KHGRec and
    KGAT (`resume_check`)."""
    import csv
    import os
    import shutil

    import numpy as np

    from hypergraph_diffusion_for_recommendation_tpu_torch import cli, native, serving_cli
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import io
    from hypergraph_diffusion_for_recommendation_tpu_torch.utils.logging import run_dir

    root = OUT_DIR / "cli"
    shutil.rmtree(root, ignore_errors=True)
    ddir = root / "dataset" / "lastfm"
    train, test, kg = lastfm
    t0 = time.time()
    io.write_interactions(str(ddir / "train.txt"), train)
    io.write_interactions(str(ddir / "test.txt"), test)
    io.write_kg(str(ddir / "processed_lastfm.kg"), kg[["h", "r", "t"]].to_numpy())
    summary = dict(card=card, write_s=round(time.time() - t0, 3))
    for name in ("train.txt", "processed_lastfm.kg"):  # the library against the plain parser
        ncols = 3 if name.endswith(".kg") else 2
        t0 = time.time()
        fast = native.load_columns(str(ddir / name), ncols)
        fast_s = time.time() - t0
        t0 = time.time()
        plain = native.load_columns(str(ddir / name), ncols, plain=True)
        plain_s = time.time() - t0
        if not np.array_equal(fast, plain) or fast.shape[0] != (len(kg) if ncols == 3 else
                                                               len(train)):
            raise AssertionError(f"cli: the native parse of {name} differs from the plain one")
        summary[f"parse_{name}"] = dict(rows=int(fast.shape[0]), native_s=round(fast_s, 4),
                                        plain_s=round(plain_s, 4))
        log(f"[cli] {name}: {fast.shape[0]} rows parsed natively in {fast_s:.4f} s, plainly in "
            f"{plain_s:.4f} s (equal)")

    parses = []
    real_load = io.load_columns

    def counted_load(path, ncols, plain=False):
        parses.append((os.path.basename(path), plain))
        return real_load(path, ncols, plain)

    common = ["--dataset=lastfm", f"--data_dir={root / 'dataset'}",
              f"--output_dir={root / 'results'}", "--quiet"]
    cwd = os.getcwd()
    os.chdir(root)  # the run log (Config.log_dir, ./log) lands here
    io.load_columns = counted_load
    try:
        runs = {}
        for model, argv in (("KHGRec", CLI_KHGREC), ("SASRec", CLI_SASREC)):
            parses.clear()
            _zero_spmm_launches()
            t0 = time.time()
            result = cli.main(argv + common)
            run_s = time.time() - t0
            launches = _spmm_launches()
            cfg = cli.build_config(cli.parse_args(argv + common))
            rd = Path(run_dir(cfg))
            with open(rd / "train_performance.csv") as f:
                perf_header = f.readline().strip()
            with open(rd / "loss.csv") as f:
                loss_header = f.readline().strip()
            with open(rd / "final_metrics.csv") as f:
                final_rows = list(csv.reader(f))
            want_loss = ",".join(["epoch"] + sorted(result.history[0].losses))
            kernel_ok = (launches.get("segment_spmm_rows", 0) > 0 if model == "KHGRec"
                         else not launches)
            log(f"[cli] {model}: {len(result.history)} epochs in {run_s:.2f} s, SpMM launches "
                f"from Python {launches}, files parsed {parses}, final Recall@20 "
                f"{result.final_metrics[20]['recall']:.5f}, artifacts {sorted(os.listdir(rd))}")
            if (not kernel_ok or len(result.history) != 2 or perf_header != PERF_HEADER
                    or loss_header != want_loss or final_rows[0] != FINAL_HEADER.split(",")
                    or len(final_rows) != 4 or not parses or any(p for _, p in parses)
                    or not (rd / "embeddings.npz").exists()):
                raise AssertionError(f"cli {model}: launches {launches}, headers {perf_header!r} "
                                     f"{loss_header!r} {final_rows[:1]}, parses {parses}")
            runs[model] = dict(run_s=round(run_s, 3), launches=launches, parses=len(parses),
                               recall20=result.final_metrics[20]["recall"],
                               examples_per_sec=round(result.examples_per_sec, 1),
                               best_epoch=result.best_epoch, run_dir=str(rd.relative_to(root)))
        summary["runs"] = runs
        # serving_cli over KHGRec's export: raw ids in, ranked raw items out
        export = root / runs["KHGRec"]["run_dir"] / "embeddings.npz"
        users = [int(u) for u in np.unique(train[:, 0])[:8]]
        tsv = root / "recs.tsv"
        t0 = time.time()
        rc = serving_cli.main(["--embeddings", str(export), "--users",
                               ",".join(map(str, users)), "--k", "20", "--out", str(tsv),
                               "--device", DEVICE])
        serve_s = time.time() - t0
        rows = [line.split("\t") for line in tsv.read_text().splitlines()]
        ok = rc == 0 and len(rows) == 8 * 20 and all(
            [int(r[1]) for r in rows[k * 20:(k + 1) * 20]] == list(range(1, 21))
            and all(float(a[3]) >= float(b[3]) for a, b in
                    zip(rows[k * 20:(k + 1) * 20], rows[k * 20 + 1:(k + 1) * 20]))
            for k in range(8))
        log(f"[cli] serving_cli: top-20 for 8 users in {serve_s:.3f} s (rc {rc}); first row "
            f"{rows[0] if rows else None}")
        if not ok:
            raise AssertionError(f"cli: serving_cli gave rc {rc} and {len(rows)} rows")
        summary["serving_cli_s"] = round(serve_s, 3)
        summary["layouts"] = cli_layouts(root, common, ml1m)
    finally:
        io.load_columns = real_load
        os.chdir(cwd)
    if not native.library_path().exists():
        raise AssertionError("cli: the native library was not built")
    summary["resume"] = [resume_check("KHGRec/lastfm", "KHGRec", KHGREC_TRAIN, lastfm,
                                      root / "ckpt_khgrec"),
                         resume_check("KGAT/lastfm", "KGAT", KGAT_TRAIN, lastfm,
                                      root / "ckpt_kgat")]
    log(f"[cli] {json.dumps(summary)}")
    return summary


def kge_state(tr) -> dict:
    """Every tensor a KG-embedding step writes: the tables and Adam's moments."""
    out = {k: v.detach().clone() for k, v in tr.params.items()}
    for k, p in tr.params.items():
        for m in ("exp_avg", "exp_avg_sq"):
            out[f"{k} {m}"] = tr.opt.state[p][m].clone()
    return out


def kge_graph_check(tag: str, tr, batches) -> dict:
    """After the eager warm-up step: from one full state (`snapshot`), the
    replayed steps against the eager steps after 1 and 8 steps, bit for bit;
    then the replayed and the eager step's wall (CUDA events), device time
    (profiler) and idle share. The state is restored at the end."""
    import torch

    def batch(s):
        return tuple(t[s % tr.n_batches] for t in batches)

    tr.train_step(batch(0))  # eager: fills Adam's state
    snap = tr.snapshot()
    runs = {}
    for mode in ("replay", "eager"):
        tr.restore(snap)
        tr.graphs = mode == "replay"
        runs[mode] = {}
        for s in range(1, GRAPH_COMPARE_STEPS[-1] + 1):
            tr.train_step(batch(s))
            if s in GRAPH_COMPARE_STEPS:
                torch.cuda.synchronize()
                runs[mode][s] = kge_state(tr)
    compared = {}
    for s in GRAPH_COMPARE_STEPS:
        diff = sorted(k for k in runs["eager"][s]
                      if not torch.equal(runs["replay"][s][k], runs["eager"][s][k]))
        compared[s] = diff
        if diff:
            raise AssertionError(f"kge {tag}: after {s} steps the replayed steps differ from "
                                 f"the eager steps in {diff}")
    row = {}
    for mode in ("replay", "eager"):
        tr.graphs = mode == "replay"
        wall = cuda_ms(lambda: tr.train_step(batch(1)), iters=10, warmup=2)
        dev, split = device_ms(lambda: tr.train_step(batch(1)), iters=10)
        row[mode] = dict(wall_ms=round(wall, 4), device_ms=round(dev, 4),
                         idle_share=round(max(0.0, 1.0 - dev / wall), 4),
                         top_kernels={k[:60]: round(t, 4) for k, t in
                                      sorted(split.items(), key=lambda kv: -kv[1])[:4]})
    tr.graphs = True
    tr.restore(snap)
    log(f"[kge] {tag}: replay bit for bit the eager step after {list(GRAPH_COMPARE_STEPS)} "
        f"steps; step replay wall {row['replay']['wall_ms']:.4f} ms, device "
        f"{row['replay']['device_ms']:.4f}, idle {row['replay']['idle_share']:.4f} | eager wall "
        f"{row['eager']['wall_ms']:.4f}, device {row['eager']['device_ms']:.4f}, idle "
        f"{row['eager']['idle_share']:.4f}; replay's largest kernels "
        f"{row['replay']['top_kernels']}")
    return dict(compared_steps=list(GRAPH_COMPARE_STEPS), **row)


def kge_events(tr, max_triples: int) -> dict:
    """The evaluation's ranking events in the order `Measure.update_batch`
    receives them, per setting: (test row, position) with position "t"/"h"
    for a binary model and the entity slot j for RealE (each RealE event
    twice: its arity's Measure, then the overall one)."""
    if tr.cfg.model != "RealE":
        n = len(tr.test[:max_triples])
        raw, fil = [], []
        for s in range(0, n, 128):
            ks = range(s, min(s + 128, n))
            raw += [(k, "t") for k in ks] + [(k, "h") for k in ks]
            fil += [(k, side) for k in ks for side in ("t", "h")]
        return {"raw": raw, "fil": fil}
    test = tr.test_tup[:max_triples]
    events = []
    for s in range(0, len(test), 32):
        valid = test[s:s + 32, 1:] >= 0
        for j in range(tr.cfg.max_arity):
            events += [(s + k, j) for k in range(len(valid)) if valid[k, j] for _ in range(2)]
    return {"raw": events, "fil": events}


def kge_close_counts(tr, events) -> list[int]:
    """For each ranking event (`kge_events`): how many other entities score
    within KGE_TIE_RTOL of the row's scale of the true entity, in float64 on
    the card. A rank computed in float32 can move by at most that many."""
    import torch

    cfg = tr.cfg
    ent = tr.params["ent"].detach().double()
    rel = tr.params["rel"].detach().double()
    A, nb, w = cfg.max_arity, cfg.dim // cfg.window_size, cfg.window_size
    G = {}  # RealE: every entity's factor at a position, by position
    out = []
    for s in range(0, len(events), 32):
        block = events[s:s + 32]
        if cfg.model != "RealE":
            rows_t = torch.as_tensor(tr.test[[k for k, _ in block]], device=ent.device)
            tail = torch.as_tensor([pos == "t" for _, pos in block], device=ent.device)
            e = torch.where(tail[:, None], ent[rows_t[:, 0]], ent[rows_t[:, 2]])
            r = rel[rows_t[:, 1]]
            true = torch.where(tail, rows_t[:, 2], rows_t[:, 0])
            if cfg.model == "TransE":
                x = torch.where(tail[:, None], e + r, e - r)
                rows = -(x[:, None, :] - ent[None]).abs().sum(-1)
            else:
                rows = (e * r) @ ent.T
        else:
            rows, true = [], []
            for k, pos in block:
                tup = tr.test_tup[k]
                q = rel[int(tup[0])].clone()
                for j in range(A):
                    if tup[1 + j] >= 0 and j != pos:
                        q = q * torch.sigmoid(torch.roll(ent[int(tup[1 + j])], (j * cfg.dim) // A))
                if pos not in G:
                    G[pos] = torch.sigmoid(torch.roll(ent, (pos * cfg.dim) // A, dims=-1))
                rows.append(torch.sigmoid((G[pos].reshape(-1, nb, w) * q.reshape(nb, w))
                                          .sum(-1)).sum(-1))
                true.append(int(tup[1 + pos]))
            rows = torch.stack(rows)
            true = torch.as_tensor(true, device=ent.device)
        at = rows.gather(1, true[:, None])
        band = KGE_TIE_RTOL * rows.abs().amax(1, keepdim=True)
        out += ((rows - at).abs() <= band).sum(1).sub(1).tolist()
    return out


def kge_recorded_eval(tr, **kw):
    """`tr.evaluate(**kw)`, with every rank its Measures receive, per setting."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import kg_embedding as K

    seen = {"raw": [], "fil": []}
    update = K.Measure.update_batch

    def recording(self, ranks, setting):
        seen[setting].extend(ranks.tolist())
        return update(self, ranks, setting)

    K.Measure.update_batch = recording
    try:
        return tr.evaluate(**kw), seen
    finally:
        K.Measure.update_batch = update


def kge_run(tag: str, kg, model: str, card: str) -> dict:
    """One model at KGEConfig's defaults on one KG: the graph check, KGE_EPOCHS
    epochs (finite losses, triples a second), the evaluation on the card (its
    wall time and filtered Measure) against the CPU plain evaluation of the
    same tables: a rank may differ by no more than its near ties
    (`kge_close_counts`), and with no difference the Measures are equal."""
    import numpy as np
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.train.kg_embedding import (
        KGEConfig,
        KGEmbeddingTrainer,
    )

    n_ent = int(max(kg[:, 0].max(), kg[:, 2].max())) + 1
    n_rel = int(kg[:, 1].max()) + 1
    cfg = KGEConfig(model=model)
    t0 = time.time()
    tr = KGEmbeddingTrainer(kg, n_ent, n_rel, cfg, device=DEVICE)
    build_s = time.time() - t0
    check = kge_graph_check(tag, tr, tr.epoch_batches(tr.draw()))
    losses, epoch_s = [], []
    for _ in range(KGE_EPOCHS):
        t0 = time.time()
        losses.append(tr.run_epoch())  # ends on the host: the mean loss
        epoch_s.append(time.time() - t0)
    if not np.isfinite(losses).all():
        raise AssertionError(f"kge {tag}: non-finite losses {losses}")
    t0 = time.time()
    m, card_ranks = kge_recorded_eval(tr)
    eval_s = time.time() - t0
    cpu = KGEmbeddingTrainer(kg, n_ent, n_rel, cfg, device="cpu")
    cpu.load_params({k: v.detach().cpu() for k, v in tr.params.items()})
    t0 = time.time()
    cpu_m, cpu_ranks = kge_recorded_eval(cpu)
    cpu_eval_s = time.time() - t0
    events = kge_events(tr, 2000)
    differ = {s: [i for i, (a, b) in enumerate(zip(card_ranks[s], cpu_ranks[s])) if a != b]
              for s in ("raw", "fil")}
    if any(len(card_ranks[s]) != len(cpu_ranks[s]) or len(card_ranks[s]) != len(events[s])
           for s in ("raw", "fil")):
        raise AssertionError(f"kge {tag}: the card's and the CPU's evaluations hold different "
                             f"event counts")
    unexplained = []
    for st in differ:
        close = kge_close_counts(tr, [events[st][i] for i in differ[st]])
        unexplained += [(st, i, card_ranks[st][i], cpu_ranks[st][i], c)
                        for i, c in zip(differ[st], close)
                        if abs(card_ranks[st][i] - cpu_ranks[st][i]) > c]
    n_differ = sum(len(v) for v in differ.values())
    if unexplained or (n_differ == 0 and vars(m) != vars(cpu_m)):
        raise AssertionError(f"kge {tag}: the card's ranks differ from the CPU's by more than "
                             f"their near ties at (setting, event, card, CPU, ties) "
                             f"{unexplained[:10]}")
    drift = {k: abs(getattr(m, k)["fil"] - getattr(cpu_m, k)["fil"])
             for k in ("hit10", "mr", "mrr")}
    triples_per_s = tr.train.shape[0] / min(epoch_s)
    fil = {k: getattr(m, k)["fil"] for k in ("hit1", "hit3", "hit10", "mr", "mrr")}
    log(f"[kge] {tag}: {tr.train.shape[0]} train triples, {n_ent} entities, {tr.n_batches} "
        f"steps an epoch, losses {[round(x, 5) for x in losses]}, epoch {min(epoch_s):.4f} s "
        f"({triples_per_s:,.0f} triples/s); evaluation {eval_s:.3f} s on the card, "
        f"{cpu_eval_s:.3f} s on the CPU, {n_differ} of {2 * len(events['raw'])} rank events "
        f"differ, each by no more than its near ties (filtered Measure's difference "
        f"{drift}); filtered {fil}")
    summary = dict(tag=tag, model=model, card=card, n_train=int(tr.train.shape[0]),
                   n_entities=n_ent, steps_per_epoch=tr.n_batches, build_s=round(build_s, 3),
                   losses=losses, epoch_s=[round(x, 4) for x in epoch_s],
                   triples_per_s=round(triples_per_s, 1), eval_s=round(eval_s, 3),
                   cpu_eval_s=round(cpu_eval_s, 3), rank_events=len(events["raw"]) * 2,
                   near_tie_differences=n_differ, cpu_difference=drift, filtered=fil,
                   step=check)
    del tr, cpu
    torch.cuda.empty_cache()
    return summary


def arity3_tuples(n_tuples: int = 3000, n_ent: int = 240, n_clusters: int = 8, A: int = 6):
    """The JAX package's planted arity-3 tuples (tests/test_kg_embedding.py):
    three entities of one cluster a tuple, relation 0 or 1, pad -1."""
    import numpy as np

    rng = np.random.default_rng(5)
    cluster = rng.integers(0, n_clusters, n_ent)
    members = [np.nonzero(cluster == c)[0] for c in range(n_clusters)]
    rows = []
    for _ in range(n_tuples):
        c = rng.integers(0, n_clusters)
        rows.append([rng.integers(0, 2)] + list(rng.choice(members[c], 3, replace=False))
                    + [-1] * (A - 3))
    return np.asarray(rows, np.int64), n_ent, 2


def kge_learns() -> list[dict]:
    """The JAX slow tier's learning checks on the card: RealE's full-entity CE
    branch on `generate_kg(400, 8, 4, seed=2, max_triples_per_item=8)` (dim
    32, lr 0.03, batch 512, 40 epochs) and RealE on the planted arity-3
    tuples (30 epochs, by arity): filtered Hit@10 above 0.15, the filtered
    MRR at least the raw one."""
    import numpy as np

    from hypergraph_diffusion_for_recommendation_tpu_torch.data.synthetic import generate_kg
    from hypergraph_diffusion_for_recommendation_tpu_torch.train.kg_embedding import (
        KGEConfig,
        KGEmbeddingTrainer,
    )

    kg = generate_kg(n_items=400, n_clusters=8, n_attrs_per_cluster=4, seed=2,
                     max_triples_per_item=8)[["h", "r", "t"]].to_numpy()
    out = []
    for tag, epochs, max_triples in (("RealE full CE", 40, 200), ("RealE arity 3", 30, 150)):
        cfg = KGEConfig(model="RealE", dim=32, lrate=0.03, batch_size=512, max_epoch=epochs)
        if tag.endswith("3"):
            tuples, n_ent, n_rel = arity3_tuples()
            tr = KGEmbeddingTrainer(None, n_ent, n_rel, cfg, tuples=tuples, device=DEVICE)
        else:
            n_ent, n_rel = int(max(kg[:, 0].max(), kg[:, 2].max())) + 1, int(kg[:, 1].max()) + 1
            tr = KGEmbeddingTrainer(kg, n_ent, n_rel, cfg, device=DEVICE)
        t0 = time.time()
        losses = [tr.run_epoch() for _ in range(epochs)]
        train_s = time.time() - t0
        m = tr.evaluate(max_triples=max_triples, by_arity=tag.endswith("3"))
        if tag.endswith("3"):
            if set(m) != {3}:
                raise AssertionError(f"kge {tag}: arities {sorted(m)}")
            m = m[3]
        ok = (np.isfinite(losses).all() and losses[-1] < losses[0] and m.hit10["fil"] > 0.15
              and m.mrr["fil"] >= m.mrr["raw"] - 1e-9)
        log(f"[kge] learns, {tag}: full CE {tr.full_ce}, {epochs} epochs in {train_s:.2f} s, "
            f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, filtered Hit@10 {m.hit10['fil']:.4f}, "
            f"MRR raw {m.mrr['raw']:.4f} filtered {m.mrr['fil']:.4f}")
        if not ok:
            raise AssertionError(f"kge {tag}: did not learn (loss {losses[0]} -> {losses[-1]}, "
                                 f"hit@10 {m.hit10})")
        out.append(dict(tag=tag, full_ce=tr.full_ce, epochs=epochs, train_s=round(train_s, 3),
                        first_loss=losses[0], last_loss=losses[-1], hit10_fil=m.hit10["fil"],
                        mrr_fil=m.mrr["fil"], mrr_raw=m.mrr["raw"]))
    return out


def phase_kge(card: str) -> dict:
    """The KG-embedding trainer: TransE, DistMult and RealE at KGEConfig's
    defaults on the KG CLI's default KG and on the LastFM-shape KG
    (`kge_run`), no SpMM launched; the learning checks (`kge_learns`); then
    the KG-embedding CLI as a user runs it, in a process of its own."""
    import os

    from hypergraph_diffusion_for_recommendation_tpu_torch.data.synthetic import generate_kg

    _zero_spmm_launches()
    runs = []
    for name, kw in KGE_KGS.items():
        kg = generate_kg(**kw)[["h", "r", "t"]].to_numpy()
        for model in KGE_MODELS:
            runs.append(kge_run(f"{model}/{name}", kg, model, card))
    if _spmm_launches():
        raise AssertionError(f"kge: the KG embedding launched SpMM kernels {_spmm_launches()}")
    learned = kge_learns()
    argv = [sys.executable, "-m", "hypergraph_diffusion_for_recommendation_tpu_torch.kg_embedding_cli",
            "--model", "RealE", "--max_epoch", "3", "--test_by_arity"]
    t0 = time.time()
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_s = time.time() - t0
    lines = proc.stdout.strip().splitlines()
    log(f"[kge] kg_embedding_cli RealE, 3 epochs: rc {proc.returncode} in {cli_s:.2f} s: {lines}")
    if proc.returncode != 0 or not lines or not lines[0].startswith("fil: hit@1"):
        raise AssertionError(f"kge: the KG-embedding CLI failed (rc {proc.returncode}): "
                             f"{proc.stderr[-2000:]}")
    return dict(runs=runs, learns=learned, cli=dict(rc=proc.returncode, s=round(cli_s, 2),
                                                    lines=lines))


def _trace_spmm_launches(ps) -> dict[str, int]:
    """SpMM launches by kernel name among a traced program's device ops."""
    return {name: op.count for name, op in ps.ops.items() if spmm_launches({name: op.count})}


def phase_profile(shape: str, graph: dict, kname: str, step_device_ms: float, card: str) -> dict:
    """`Trainer.profile_epoch` of KHGRec (KHGREC_TRAIN) at this shape, its steps replayed
    graphs (captured in a first epoch): its loss and aux terms bit for bit those of the same
    epoch run unprofiled from the same restored state; the trace read by
    `utils.trace_analysis`: one execution of the step annotation a step, at most 16 SpMM
    launches of `kname` a step (a trace with fewer is taken again, up to TRACE_ATTEMPTS: the
    profiler loses events); `trace_roofline` with the kernels' bytes (`spmm_bytes` of each
    (matrix, direction), CALLS_PER_STEP times) and `cost_analysis` of one step; the trace's
    device time a step within PROFILE_RTOL of phase 6's replayed step (`step_device_ms`);
    every share at most 1."""
    import shutil

    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer
    from hypergraph_diffusion_for_recommendation_tpu_torch.train.trainer import STEP_ANNOTATION
    from hypergraph_diffusion_for_recommendation_tpu_torch.utils.profiling import cost_analysis
    from hypergraph_diffusion_for_recommendation_tpu_torch.utils.trace_analysis import (
        device_program_stats,
        trace_roofline,
    )

    rec = Recommender(make_config("KHGRec", **KHGREC_TRAIN, item_ranking=(10, 20, 40),
                                  max_epoch=1, early_stopping_steps=100), DEVICE)
    rec.build(graph["data"])
    rec.init_weights(SEED)
    tr = Trainer(rec.bundle, seed=SEED, extras=rec.extras)
    tr.run_epoch(0)  # each path's eager first step and its capture
    state = tr.snapshot(optimizer=True)
    want = tr.run_epoch(1)
    torch.cuda.synchronize()
    program = f"{STEP_ANNOTATION}:cf"
    want_launches = 16 * tr.n_batches
    root = OUT_DIR / "profile" / shape
    shutil.rmtree(root, ignore_errors=True)
    best = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        tr.restore(state)
        trace_dir = root / f"trace{attempt}"
        t0 = time.time()
        got = tr.profile_epoch(str(trace_dir), 1)
        profile_s = time.time() - t0
        if got != want:
            raise AssertionError(f"{shape}: the profiled epoch gave {got}, the unprofiled "
                                 f"one {want}")
        ps = device_program_stats(str(trace_dir))[program]
        if ps.n_executions != tr.n_batches:
            raise AssertionError(f"{shape}: {ps.n_executions} executions of {program!r} in the "
                                 f"trace, {tr.n_batches} steps run")
        by_kernel = _trace_spmm_launches(ps)
        n = sum(by_kernel.values())
        if n > want_launches or any(kname not in k for k in by_kernel):
            raise AssertionError(f"{shape}: the trace holds SpMM launches {by_kernel}, at most "
                                 f"{want_launches} of {kname} expected")
        if best is None or n > best[0]:
            best = (n, trace_dir, by_kernel, profile_s)
        if n == want_launches:
            break
        log(f"[timer] profile {shape}: the trace holds {n} SpMM launches, expected "
            f"{want_launches}: traced again")
    n, trace_dir, by_kernel, profile_s = best
    extra = sum(CALLS_PER_STEP * spmm_bytes(m, D) for mat in graph["mats"].values()
                for m in (mat, mat.T.tocsr()))
    # the work of one step, counted op by op (the kernels count 0: their bytes are `extra`)
    tr.restore(state)
    batches = tr.sample_epoch()
    cost = cost_analysis(tr._step_body, tuple(t[0] for t in batches), tr.epoch_keys(1)[0])
    torch.cuda.synchronize()
    tr.restore(state)
    r = trace_roofline(str(trace_dir), extra_bytes_per_exec=float(extra), cost=cost,
                       program=program)
    trace_ms = r["device_s_per_exec"] * 1e3
    rel = abs(trace_ms - step_device_ms) / step_device_ms
    shares = {"measured_hbm_util": r["measured_hbm_util"], "measured_mfu": r["measured_mfu"],
              "op_time_coverage": r["op_time_coverage"],
              **{f"share of {o['name']}": o["share"] for o in r["top_ops"]}}
    summary = dict(shape=shape, kernel=kname, card=card, steps=tr.n_batches, loss=got[0],
                   trace_spmm_launches=n, trace_spmm_launches_expected=want_launches,
                   launches_by_kernel=by_kernel, trace_device_ms_per_step=trace_ms,
                   replayed_step_device_ms=step_device_ms, device_ms_rel_diff=rel,
                   cost_flops_per_step=cost["flops"],
                   cost_bytes_per_step=cost["bytes accessed"], cost_ops_per_step=cost["ops"],
                   kernel_bytes_per_step=extra, profiled_epoch_s=round(profile_s, 3),
                   roofline={k: v for k, v in r.items() if k != "top_ops"},
                   top_ops=r["top_ops"])
    log(f"[profile] {json.dumps(summary)}")
    if rel > PROFILE_RTOL:
        raise AssertionError(f"{shape}: the trace's device time a step {trace_ms:.4f} ms is "
                             f"{rel:.1%} from the replayed step's {step_device_ms:.4f} ms")
    bad = {k: v for k, v in shares.items() if not 0.0 <= v <= 1.0}
    if bad:
        raise AssertionError(f"{shape}: shares outside [0, 1]: {bad}")
    if n < want_launches:
        log(f"[profile] {shape}: the best of {TRACE_ATTEMPTS} traces holds {n} of "
            f"{want_launches} SpMM launches (the profiler lost events)")
    del rec, tr
    torch.cuda.empty_cache()
    return summary


def _parallel_cases(lastfm) -> dict:
    """The inputs of phase 23 (numpy, drawn from SEED): LastFM-shape tables, a batch of
    PARALLEL_BATCH ids, every user's rated items from the LastFM-shape split."""
    import numpy as np

    n_users, n_items = SHAPES["lastfm"]["n_users"], SHAPES["lastfm"]["n_items"]
    rng = np.random.default_rng(SEED)
    f32 = np.float32
    limit = math.sqrt(6.0 / (n_items + PARALLEL_DIM))
    items = rng.uniform(-limit, limit, (n_items, PARALLEL_DIM)).astype(f32)
    idx = rng.integers(0, n_items, PARALLEL_BATCH).astype(np.int32)
    weight = rng.standard_normal((PARALLEL_BATCH, PARALLEL_DIM)).astype(f32)
    train = np.asarray(lastfm[0][:, :2], np.int64)
    per_user = [[] for _ in range(n_users)]
    for u, i in train:
        if u < n_users and i < n_items:
            per_user[u].append(i)
    rated = np.full((n_users, max(len(r) for r in per_user)), -1, np.int32)
    for u, r in enumerate(per_user):
        rated[u, :len(r)] = r
    gen_u = math.sqrt(6.0 / (n_users + PARALLEL_DIM))
    tables = (rng.uniform(-gen_u, gen_u, (n_users, PARALLEL_DIM)).astype(f32), items.copy())
    mf = {k: rng.integers(0, n_users if k == "users" else n_items,
                          (PARALLEL_MF_STEPS, PARALLEL_BATCH)).astype(np.int32)
          for k in ("users", "pos", "neg")}
    return dict(
        lookup=dict(kind="lookup", table=items, idx=idx, weight=weight),
        a2a=dict(kind="a2a", table=items, idx=idx, weight=weight, capacity_factor=2.0),
        user_topk=dict(kind="user_topk",
                       users=rng.standard_normal((n_users, PARALLEL_DIM)).astype(f32),
                       items=rng.standard_normal((n_items, PARALLEL_DIM)).astype(f32),
                       rated=rated, k=PARALLEL_K),
        sharded_mf=dict(kind="sharded_mf", n_users=n_users, n_items=n_items, dim=PARALLEL_DIM,
                        lrate=PARALLEL_MF_LRATE, tables=tables, **mf),
    )


def phase_parallel(lastfm, card: str) -> dict:
    """The collective layer on PARALLEL_MESH ranks that share the card (gloo: NCCL refuses two
    ranks on one device), started by `utils.platform.run_ranks`: `spmd_sharded_lookup` and
    `spmd_a2a_lookup` rows and table gradients bit for bit the single-device gather's (no
    a2a overflow at capacity factor 2), `sharded_user_topk` at k PARALLEL_K with TF32 off
    giving the single-device `masked_topk`'s ids but at counted near ties (TOPK_TIE_RTOL),
    PARALLEL_MF_STEPS `ShardedMF` steps within PARALLEL_MF_ATOL of the same dense SGD steps on
    one device; each rank's backend, device and each call's time (the largest over the
    ranks)."""
    import numpy as np
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.losses import bpr_loss
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.topk import (
        exact_scores,
        masked_topk,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.parallel.check import run_cases
    from hypergraph_diffusion_for_recommendation_tpu_torch.utils.platform import run_ranks

    cases = _parallel_cases(lastfm)
    n_ranks = PARALLEL_MESH[0] * PARALLEL_MESH[1]
    t0 = time.time()
    ranks = run_ranks(n_ranks, run_cases, PARALLEL_MESH, DEVICE, cases, PARALLEL_REPS,
                      device=DEVICE, timeout=600.0)
    ranks_s = time.time() - t0
    for r in ranks:
        log(f"[parallel] rank {r['rank']} at mesh coordinate {r['coordinate']}: backend "
            f"{r['backend']}, device {r['device']}")
    if {r["backend"] for r in ranks} != {"gloo"} or any(r["leaked"] for r in ranks):
        raise AssertionError(f"ranks: backends {[r['backend'] for r in ranks]}, JAX modules "
                             f"{[r['leaked'] for r in ranks]}")
    dev = torch.device(DEVICE)
    first = [r for r in ranks if r["coordinate"][0] == 0]  # data rank 0, model ranks in order

    # --- lookups against the single-device gather
    c = cases["lookup"]
    table = torch.tensor(c["table"], device=dev, requires_grad=True)
    idx = torch.tensor(c["idx"], device=dev).long()
    rows = table[idx]
    (torch.sin(rows) * torch.tensor(c["weight"], device=dev)).sum().backward()
    want_rows, want_grad = rows.detach().cpu().numpy(), table.grad.cpu().numpy()
    out = {}
    for case in ("lookup", "a2a"):
        if case == "lookup":
            got_rows = [r["lookup"]["rows"] for r in ranks]
        else:
            got_rows = [np.concatenate([r["a2a"]["rows"] for r in first])]
            overflow = {r["a2a"]["overflow"] for r in ranks}
            if overflow != {0}:
                raise AssertionError(f"a2a: overflow {overflow} at capacity factor 2")
        grads = [np.concatenate([r[case]["grad"] for r in ranks if r["coordinate"][0] == d])
                 for d in range(PARALLEL_MESH[0])]
        rows_equal = all(np.array_equal(g, want_rows) for g in got_rows)
        grads_equal = all(np.array_equal(g, want_grad) for g in grads)
        diff = max(float(np.abs(g - want_grad).max()) for g in grads)
        out[case] = dict(rows_bitwise=rows_equal, grad_bitwise=grads_equal, grad_max_diff=diff,
                         ms=max(r[case]["ms"] for r in ranks))
        log(f"[parallel] {case}: rows bit for bit {rows_equal}, gradient bit for bit "
            f"{grads_equal} (max diff {diff:.3g}); {max(r[case]['ms'] for r in ranks):.3f} ms "
            f"a lookup and its backward")
        if not (rows_equal and grads_equal):
            raise AssertionError(f"{case}: the sharded lookup differs from the dense gather")

    # --- sharded top-k against the single-device masked top-k
    c = cases["user_topk"]
    scores = exact_scores(torch.tensor(c["users"], device=dev), torch.tensor(c["items"],
                                                                             device=dev))
    rated = torch.tensor(c["rated"], device=dev)
    vals, ids = masked_topk(scores, rated, c["k"])
    vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
    s_np = scores.cpu().numpy()
    scale = np.abs(s_np).max(axis=1)
    ties = 0
    for r in ranks:
        g_ids, g_vals = r["user_topk"]["ids"], r["user_topk"]["vals"]
        for u, j in zip(*np.nonzero(g_ids != ids)):
            gap = abs(float(s_np[u, g_ids[u, j]]) - float(vals[u, j]))
            if gap > TOPK_TIE_RTOL * scale[u]:
                raise AssertionError(f"user_topk: user {u} position {j}: id {g_ids[u, j]} "
                                     f"against {ids[u, j]}, scores {gap:.3g} apart")
            ties += int(r["rank"] == 0)
        val_diff = float(np.abs(g_vals - vals).max())
        if val_diff > TOPK_TIE_RTOL * float(scale.max()):
            raise AssertionError(f"user_topk: values differ by {val_diff:.3g}")
    out["user_topk"] = dict(users=int(ids.shape[0]), k=c["k"], near_tie_ids=ties,
                            ms=max(r["user_topk"]["ms"] for r in ranks))
    log(f"[parallel] sharded_user_topk: {ids.shape[0]} users, k {c['k']}: ids equal but at "
        f"{ties} near ties; {out['user_topk']['ms']:.3f} ms")

    # --- ShardedMF against the dense SGD steps
    c = cases["sharded_mf"]
    u_t, i_t = (torch.tensor(t, device=dev) for t in c["tables"])
    losses = []
    for s in range(PARALLEL_MF_STEPS):
        uu, ii = u_t.clone().requires_grad_(), i_t.clone().requires_grad_()
        ids_s = [torch.tensor(c[k][s], device=dev).long() for k in ("users", "pos", "neg")]
        loss = bpr_loss(uu[ids_s[0]], ii[ids_s[1]], ii[ids_s[2]])
        du, di = torch.autograd.grad(loss, (uu, ii))
        u_t, i_t = u_t - PARALLEL_MF_LRATE * du, i_t - PARALLEL_MF_LRATE * di
        losses.append(float(loss.detach()))
    want_u, want_i = u_t.cpu().numpy(), i_t.cpu().numpy()
    mf_diff = max(max(float(np.abs(r["sharded_mf"]["user"] - want_u).max()),
                      float(np.abs(r["sharded_mf"]["item"] - want_i).max()),
                      float(np.abs(np.asarray(r["sharded_mf"]["losses"]) - losses).max()))
                  for r in ranks)
    out["sharded_mf"] = dict(steps=PARALLEL_MF_STEPS, max_diff=mf_diff, losses=losses,
                             ms_per_step=max(r["sharded_mf"]["ms"] for r in ranks))
    log(f"[parallel] ShardedMF: {PARALLEL_MF_STEPS} steps, tables and losses within "
        f"{mf_diff:.3g} of the dense steps; {out['sharded_mf']['ms_per_step']:.3f} ms a step")
    if mf_diff > PARALLEL_MF_ATOL:
        raise AssertionError(f"ShardedMF: {mf_diff:.3g} from the dense steps")
    summary = dict(card=card, mesh=PARALLEL_MESH, backends=[r["backend"] for r in ranks],
                   devices=[r["device"] for r in ranks], ranks_s=round(ranks_s, 2), **out)
    log(f"[parallel] {json.dumps(summary)}")
    return summary


def _perf_rows(path: Path) -> dict:
    """train_performance.csv's rows by epoch, without the two time columns and
    the header lines (a resumed run appends its own, as in the JAX package)."""
    rows = {}
    for line in path.read_text().splitlines():
        cells = line.split(",")
        if cells[0] != "epoch":
            rows[cells[0]] = [cells[0]] + cells[3:]
    return rows


def phase_supervisor(card: str) -> dict:
    """`utils.supervisor.run_supervised` around the port's CLI on the card (KHGRec,
    CLI_SUPERVISED): a watcher SIGKILLs the child's process group once its first
    checkpoint exists (epoch 10's); the restart must carry --resume once, its rows of
    train_performance.csv (times aside) must equal an uninterrupted run's, and its
    final_metrics.csv the uninterrupted run's byte for byte."""
    import os
    import shutil
    import signal
    import threading
    from unittest import mock

    from hypergraph_diffusion_for_recommendation_tpu_torch.utils import supervisor as SUP

    root = OUT_DIR / "supervisor"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)

    def command(name: str) -> list[str]:
        return [sys.executable, "-m", CLI_MODULE, *CLI_SUPERVISED, f"--output_dir={root / name}",
                "--quiet"]

    t0 = time.time()
    whole = subprocess.run(command("whole"), cwd=root, capture_output=True, text=True,
                           timeout=900, env=dict(os.environ, PYTHONPATH=path))
    whole_s = time.time() - t0
    if whole.returncode != 0:
        raise AssertionError(f"the uninterrupted CLI run exited {whole.returncode}: "
                             f"{whole.stderr[-2000:]}")
    children: list[subprocess.Popen] = []

    class Recorded(subprocess.Popen):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            children.append(self)

    killed = {}

    def watch():
        deadline = time.time() + 900
        while time.time() < deadline:
            ckpts = list((root / "supervised").glob("**/checkpoints/ckpt_*.pt"))
            if ckpts and children:
                os.killpg(children[0].pid, signal.SIGKILL)
                killed.update(after_s=round(time.time() - t0, 2), checkpoint=ckpts[0].name)
                return
            time.sleep(0.05)

    lines = []
    cwd, env_path = os.getcwd(), os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = path
    os.chdir(root)  # the run log (./log) lands here
    try:
        t0 = time.time()
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        with mock.patch.object(SUP.subprocess, "Popen", Recorded):
            report = SUP.run_supervised(command("supervised"), max_restarts=2, backoff_s=1.0,
                                        log=lambda m: (lines.append(m), log(m)))
        supervised_s = time.time() - t0
        watcher.join(timeout=5.0)
    finally:
        os.chdir(cwd)
        if env_path is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = env_path
    args = [list(p.args) for p in children]
    if not killed or report.outcomes != ["exit:-9", "ok"] or report.final_returncode != 0:
        raise AssertionError(f"supervisor: killed {killed}, outcomes {report.outcomes}, "
                             f"code {report.final_returncode}")
    if len(args) != 2 or "--resume" in args[0] or args[1].count("--resume") != 1:
        raise AssertionError(f"supervisor: the attempts ran {args}")
    runs = {name: next((root / name).glob("**/final_metrics.csv")).parent
            for name in ("whole", "supervised")}
    want_rows, got_rows = (_perf_rows(runs[n] / "train_performance.csv")
                           for n in ("whole", "supervised"))
    last = str(SUPERVISED_EPOCHS - 1)  # the file counts epochs from 0
    if last not in got_rows or any(got_rows[e] != want_rows.get(e) for e in got_rows):
        raise AssertionError(f"supervisor: the supervised run's epochs {got_rows} differ from "
                             f"the uninterrupted run's {want_rows}")
    final_equal = ((runs["whole"] / "final_metrics.csv").read_bytes()
                   == (runs["supervised"] / "final_metrics.csv").read_bytes())
    summary = dict(card=card, epochs=SUPERVISED_EPOCHS, killed=killed,
                   outcomes=report.outcomes, restart_args_tail=args[1][-3:],
                   uninterrupted_s=round(whole_s, 2), supervised_s=round(supervised_s, 2),
                   final_metrics_equal=final_equal, epochs_compared=sorted(got_rows, key=int),
                   final_metrics=(runs["supervised"] / "final_metrics.csv").read_text())
    log(f"[supervisor] {json.dumps(summary)}")
    if not final_equal:
        raise AssertionError("supervisor: final_metrics.csv differs from the uninterrupted "
                             "run's")
    return summary


def _rel(got, want) -> float:
    """max |got - want| over max |want| (0 for two zero arrays)."""
    import numpy as np

    scale = float(np.abs(want).max())
    return float(np.abs(np.asarray(got) - want).max()) / scale if scale else 0.0


def _sharded_cases(graphs) -> dict:
    """Phase 25's inputs on the ranks (numpy, drawn from SEED): the products of
    SHARDED_PRODUCTS (bf16 operand at width SHARDED_WIDTH), KHGRec in bench.py's
    configuration at the LastFM shape with the CF and KG adjacencies sharded (first step's
    loss and one epoch), MF's checkpoints on the mesh, ShardedLightGCN's steps."""
    import numpy as np

    from hypergraph_diffusion_for_recommendation_tpu_torch.data import build_interaction

    rng = np.random.default_rng(SEED)
    f32 = np.float32
    cases = {}
    for shape, name, modes, int8 in SHARDED_PRODUCTS:
        mat = graphs[shape]["mats"][name].tocoo()
        x = rng.standard_normal((mat.shape[1], SHARDED_WIDTH)).astype(f32)
        w = rng.standard_normal((mat.shape[0], SHARDED_WIDTH)).astype(f32)
        for mode in modes:
            cases[f"{shape}.{name}.{mode}" + (".int8" if int8 else "")] = dict(
                kind="shard_sparse", rows=mat.row, cols=mat.col, vals=mat.data,
                shape=mat.shape, mode=mode, x=x, weight=w, bf16=True, attach=True,
                env={"HGDR_INT8": "1"} if int8 else {}, mesh=SHARDED_SPMM_MESH, fields=False,
                outputs=False)
    data = dict(SHAPES["lastfm"], with_kg=True)
    cases["khgrec"] = dict(kind="trainer", model="KHGRec", cfg=dict(KHGREC_TRAIN), data=data,
                           epochs=1, first_step=True, mesh=SHARDED_TRAIN_MESH)
    for name, cfg in SPLIT_MODELS.items():
        cases[f"split_{name}"] = dict(kind="trainer", model=name, cfg=cfg, data=data, epochs=1,
                                      steps=SPLIT_STEPS, first_step=True, shard=False,
                                      mesh=SHARDED_TRAIN_MESH)
        cases[f"flops_{name}"] = dict(kind="step_flops", model=name, cfg=cfg, data=data,
                                      mesh=SHARDED_TRAIN_MESH)
    # KHGRec's lookup of its user and item rows in the row-sharded entity table
    # (`table_lookup`), forward and backward, at the table's and the ids' shapes
    mats, d = graphs["lastfm"]["mats"], KHGREC_TRAIN["hyper_dim"]
    n_ent, n_ui = mats["kg"].shape[0], mats["cf"].shape[0]
    cases["entity_lookup"] = dict(kind="lookup", table=rng.standard_normal((n_ent, d)).astype(f32),
                                  idx=np.arange(n_ui), mesh=SHARDED_TRAIN_MESH,
                                  weight=rng.standard_normal((n_ui, d)).astype(f32))
    ckpt = OUT_DIR / "sharded" / "ckpt"
    cases["mf_save"] = dict(kind="trainer", model="MF", cfg=dict(SHARDED_MF), data=data,
                            epochs=2, save_at=0, save_dir=str(ckpt / "mesh"),
                            mesh=SHARDED_TRAIN_MESH)
    cases["mf_resume"] = dict(kind="trainer", model="MF", cfg=dict(SHARDED_MF), data=data,
                              epochs=2, restore_dir=str(ckpt / "single"),
                              mesh=SHARDED_TRAIN_MESH)
    train, test, _ = graphs["lastfm"]["data"]
    inter = build_interaction(train, test)
    n_nodes = inter.n_users + inter.n_items
    n_pad = -(-n_nodes // SHARDED_TRAIN_MESH[1]) * SHARDED_TRAIN_MESH[1]
    g = SHARDED_GCN
    limit = math.sqrt(6.0 / (n_pad + g["dim"]))
    ids = {k: rng.integers(0, inter.n_users if k == "users" else inter.n_items,
                           (g["steps"], g["batch"])).astype(np.int32)
           for k in ("users", "pos", "neg")}
    cases["lightgcn"] = dict(kind="sharded_lightgcn", norm_adj=inter.norm_adj.tocsr(),
                             n_users=inter.n_users, n_items=inter.n_items, dim=g["dim"],
                             n_layers=g["n_layers"], lrate=g["lrate"],
                             table=rng.uniform(-limit, limit, (n_pad, g["dim"])).astype(f32),
                             mesh=SHARDED_TRAIN_MESH, **ids)
    return cases


def _single_trainer(model: str, cfg_kw: dict, data: dict):
    """The single-device eager trainer of `model` on the card (the ranks' build, no mesh)."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.parallel.check import build_on_mesh
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer

    cfg, bundle = build_on_mesh(model, cfg_kw, data, None, DEVICE)
    return cfg, bundle, Trainer(bundle, graphs=False)


def _dense_lightgcn(case) -> tuple[list, "np.ndarray"]:
    """ShardedLightGCN's steps on one device: the same propagation through kernel 1 on the
    unsharded layout, BPR over the whole batch, SGD."""
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.data.device import (
        adj_pair_from_scipy,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels.segment_spmm import (
        blocked_spmm,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.losses import bpr_loss

    mat = case["norm_adj"]
    n_pad = case["table"].shape[0]
    import scipy.sparse as sps

    padded = sps.csr_matrix((mat.data, mat.indices, mat.indptr), shape=mat.shape)
    padded.resize((n_pad, n_pad))
    adj = adj_pair_from_scipy(padded, DEVICE, gather_layout="base").fwd.blocked
    table = torch.tensor(case["table"], device=DEVICE)
    nu = case["n_users"]
    losses = []
    for s in range(case["users"].shape[0]):
        tbl = table.clone().requires_grad_()
        acc, x = tbl, tbl
        for _ in range(case["n_layers"]):
            x = blocked_spmm(adj, x)
            acc = acc + x
        out = acc / (case["n_layers"] + 1)
        u, p, n = (torch.tensor(case[k][s], device=DEVICE).long() for k in ("users", "pos", "neg"))
        loss = bpr_loss(out[u], out[nu + p], out[nu + n])
        (grad,) = torch.autograd.grad(loss, (tbl,))
        table = table - case["lrate"] * grad
        losses.append(float(loss.detach()))
    return losses, table.cpu().numpy()


def _phase_split(cases, ranks, card: str) -> dict:
    """Phase 25's data split (SPLIT_MODELS): each model's ranks against one device's eager
    steps on the card, from the same seed; raises where a check fails."""
    import numpy as np
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as S
    from hypergraph_diffusion_for_recommendation_tpu_torch.parallel.check import (
        record_steps,
        run_steps,
        steps_on_host,
    )

    model = SHARDED_TRAIN_MESH[1]
    out = {}
    for name in SPLIT_MODELS:
        c = cases[f"split_{name}"]
        _, bundle, single = _single_trainer(name, c["cfg"], c["data"])
        rec = record_steps(single, timed=True)
        before = dict(S.LAUNCHES)
        run_steps(single, SPLIT_STEPS)
        single_launches = {k: v - before[k] for k, v in S.LAUNCHES.items() if v != before[k]}
        rec = steps_on_host(rec)
        del single, bundle
        torch.cuda.empty_cache()
        got = [r[f"split_{name}"] for r in ranks]
        row = dict(card=card, data_split=[g["data_split"] for g in got])
        for phase in [p for p in ("cf", "kg") if rec[p]]:
            want = rec[phase]
            shares = [g["steps"][f"{phase}_share"][0] for g in got]
            flops = [r[f"flops_{name}"][phase] for r in ranks]
            row[phase] = dict(
                losses=want, step_ms=max(g["steps"][f"{phase}_ms"][-1] for g in got),
                single_eager_step_ms=rec[f"{phase}_ms"][-1],
                step_rel=max(_rel(g["steps"][phase], np.asarray(want)) for g in got),
                shares=shares, differ=all(shares[m] != shares[model + m] for m in range(model)),
                share_rel=max(abs(shares[m] + shares[model + m] - want[0]) / abs(want[0])
                              for m in range(model)),
                flops_data2=max(f["split"] for f in flops), flops_data1=flops[0]["whole"],
                flops_ratio=max(f["split"] / f["whole"] for f in flops) if flops[0]["whole"]
                else None)
        row["launches"] = [g["epoch_launches"] for g in got]
        row["single_launches"] = single_launches
        out[name] = row
        log(f"[sharded] data split {name} on {SHARDED_TRAIN_MESH} ({card}): "
            + "; ".join(f"{p}: {SPLIT_STEPS} steps within {row[p]['step_rel']:.3g} of one device, "
                        f"first-step shares {row[p]['shares']} add up within "
                        f"{row[p]['share_rel']:.3g}, a data rank's step FLOPs "
                        f"{row[p]['flops_data2']:.4g} against one device's "
                        f"{row[p]['flops_data1']:.4g} (ratio {row[p]['flops_ratio']}), the last "
                        f"step {row[p]['step_ms']:.2f} ms on the mesh against "
                        f"{row[p]['single_eager_step_ms']:.2f} ms eager on one device"
                        for p in ("cf", "kg") if p in row)
            + f"; SpMM launches a rank {row['launches'][0]}, one device {single_launches}")
        rtol = SPLIT_STEP_RTOL.get(name, 1e-4)
        bad = [p for p in ("cf", "kg") if p in row and (
            row[p]["step_rel"] > rtol or not row[p]["differ"]
            or row[p]["share_rel"] > SPLIT_SHARE_RTOL
            or (row[p]["flops_ratio"] or 0.0) > SPLIT_FLOPS_BOUND.get((name, p), 1.0))]
        if (bad or not all(row["data_split"])
                or any(l != single_launches for l in row["launches"])):
            raise AssertionError(f"data split {name}: {bad} {row}")
    return out


def _model_blocks(ranks, case, key):
    """A table from the model ranks' row blocks (data rank 0's), in model-rank order."""
    import numpy as np

    return np.concatenate([r[case][key] for r in ranks if r["coordinate"][0] == 0])


def phase_sharded(graphs, card: str) -> dict:
    """The sharded runtime on ranks that share the card (gloo; `run_ranks` with
    `parallel.check.run_cases`):
      * `sharded_spmm` on a (1, 4) mesh at the SHARDED_PRODUCTS matrices, bf16 operand at
        width SHARDED_WIDTH, window and forced balanced mode, and under HGDR_INT8=1: each
        rank's launches of one product (exactly one of the layout's kernel; the pooled
        decision the same kernel on every rank: kernel 2 at ML-1M density, 3 and 4 under
        HGDR_INT8), the forward and the X-gradient within
        SHARDED_SPMM_RTOL of the single-device kernel on the unsharded layout (and the share
        of elements equal bit for bit), the forward against the plain version on the card,
        each rank's layout bytes against the unsharded layout's, per-call times (a rank's
        kernel also with the card to itself, the other ranks waiting);
      * the data split (SPLIT_MODELS, `_phase_split`): SASRec, CL4SRec, KGAT (both phases),
        SGL and HGNN_HD3 on the (2, 2) mesh, each data rank computing its share of every
        step's batch, against one device's eager steps;
      * KHGRec in bench.py's configuration on a (2, 2) mesh with the CF and KG adjacencies
        sharded: the first step's loss within SHARDED_STEP_RTOL and one epoch's within
        SHARDED_EPOCH_RTOL of the single-device eager trainer from the same seed, the two
        data ranks' shares of the first loss differing and adding up to it within
        SHARDED_STEP_RTOL, 16 SpMM launches a step on every rank, `evaluate()` within
        SHARDED_EVAL_ATOL of the single-device evaluation of the same embeddings, the step's
        wall, and the time of its entity lookup (`table_lookup`) at the step's shapes;
      * MF's checkpoints at the LastFM shape: written on the mesh and resumed on one device,
        and the reverse, each resumed epoch within SHARDED_STEP_RTOL of the other side's;
      * ShardedLightGCN, SHARDED_GCN's steps within SHARDED_GCN_ATOL of the dense steps;
      * `dryrun_multichip(4, "cuda")`;
      * the CLI (`python -m ...cli` with SHARDED_CLI_FLAGS) for 2 epochs against the
        single-device CLI (final metrics within SHARDED_EPOCH_RTOL; one set of artifacts),
        and `serving_cli --mesh_model=2` over its export against the single-device
        `serving_cli`: equal ids but at counted near ties."""
    import csv
    import os
    import shutil

    import numpy as np
    import torch

    from hypergraph_diffusion_for_recommendation_tpu_torch import serving_cli
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import io
    from hypergraph_diffusion_for_recommendation_tpu_torch.data.device import make_adj_pair
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels.segment_spmm import (
        blocked_spmm,
        blocked_spmm_reference,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.parallel.check import (
        layout_env,
        dryrun_multichip,
        layout_bytes,
        run_cases,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.utils.platform import run_ranks

    root = OUT_DIR / "sharded"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cases = _sharded_cases(graphs)
    out = dict(card=card)

    # the single-device sides that the ranks read or that go first
    data = cases["mf_save"]["data"]
    _, _, mf = _single_trainer("MF", SHARDED_MF, data)
    mf_single = [mf.run_epoch(0)[0]]
    ckpt = CheckpointManager(cases["mf_resume"]["restore_dir"], background=False)
    ckpt.save(0, mf.checkpoint_state(0))
    ckpt.close()
    mf_single.append(mf.run_epoch(1)[0])
    del mf

    n_ranks = SHARDED_TRAIN_MESH[0] * SHARDED_TRAIN_MESH[1]
    t0 = time.time()
    ranks = run_ranks(n_ranks, run_cases, SHARDED_TRAIN_MESH, DEVICE, cases, SHARDED_REPS,
                      device=DEVICE, timeout=900)
    out["ranks_s"] = round(time.time() - t0, 2)
    if {r["backend"] for r in ranks} != {"gloo"}:
        raise AssertionError(f"sharded: backends {[r['backend'] for r in ranks]}")

    # --- the products
    products = []
    for key, c in cases.items():
        if c["kind"] != "shard_sparse":
            continue
        shape, name, mode = key.split(".")[:3]
        mat = graphs[shape]["mats"][name].tocoo()
        with layout_env(c["env"]):  # the same layout variables as the ranks'
            pair = make_adj_pair(mat.row, mat.col, mat.data, mat.shape, DEVICE, bf16=True)
        b = pair.fwd.blocked
        x = torch.tensor(c["x"], device=DEVICE, requires_grad=True)
        w = torch.tensor(c["weight"], device=DEVICE)
        y = blocked_spmm(b, x)
        (torch.sin(y) * w).sum().backward()
        with torch.no_grad():
            plain = blocked_spmm_reference(b, x).cpu().numpy()
            single_ms = cuda_ms(lambda: blocked_spmm(b, x))
        y, grad = y.detach().cpu().numpy(), x.grad.cpu().numpy()
        r0 = ranks[0][key]
        kname = kernel_of(b)
        # the SpMM kernel's launches (the int8 layouts also quantise X: 2 launches)
        launches = [{k: v for k, v in r[key]["launches_fwd"].items() if k != "quantize_int8"}
                    for r in ranks]
        steps = [{k: v for k, v in r[key]["launches_step"].items() if k != "quantize_int8"}
                 for r in ranks]
        dedup = {r[key]["layout"]["dedup"] for r in ranks}
        row = dict(matrix=f"{shape}.{name}", mode=mode, shape=list(mat.shape), nnz=int(mat.nnz),
                   kernel=kname, balanced=r0["balanced"],
                   fwd_rel=_rel(r0["y"], y), grad_rel=_rel(r0["grad"], grad),
                   fwd_bitwise_share=float(np.mean(r0["y"] == y)),
                   grad_bitwise_share=float(np.mean(r0["grad"] == grad)),
                   plain_rel=_rel(r0["y"], plain),
                   launches_per_rank=launches,
                   shard_bytes=[r[key]["bytes"] for r in ranks],
                   single_bytes=layout_bytes(b), single_ms=single_ms,
                   ms=max(r[key]["ms"] for r in ranks),
                   local_ms=max(r[key]["local_ms"] for r in ranks),
                   local_alone_ms=max(r[key]["local_alone_ms"] for r in ranks))
        products.append(row)
        log(f"[sharded] {key}: {kname} on every rank {launches}, forward within "
            f"{row['fwd_rel']:.3g} ({row['fwd_bitwise_share']:.4f} bit for bit), X-gradient "
            f"within {row['grad_rel']:.3g} ({row['grad_bitwise_share']:.4f}), plain "
            f"{row['plain_rel']:.3g}; layout bytes {row['shard_bytes']} against "
            f"{row['single_bytes']}; {row['ms']:.3f} ms a sharded call ({row['local_ms']:.3f} "
            f"ms its kernel, {row['local_alone_ms']:.3f} ms with the card to itself) against "
            f"{single_ms:.3f} ms unsharded")
        want = {kname: 1}
        if (any(l != want for l in launches) or any(s != want for s in steps) or len(dedup) != 1
                or (shape in SHARDED_DEDUP_SHAPES) != kname.startswith("segment_spmm_dedup")
                or bool(c["env"]) != kname.endswith("_int8")
                or r0["balanced"] != (mode == "balanced")
                or max(row["fwd_rel"], row["grad_rel"], row["plain_rel"]) > SHARDED_SPMM_RTOL):
            raise AssertionError(f"sharded {key}: {row}, step launches {steps}")
    out["products"] = products

    # --- KHGRec on the (2, 2) mesh against the single-device eager trainer
    k = cases["khgrec"]
    cfg, bundle, single = _single_trainer("KHGRec", k["cfg"], k["data"])
    first = []
    step = single.train_step

    def recorded(*a, **kw):
        loss, aux = step(*a, **kw)
        if not first:
            first.append(float(loss))
        return loss, aux

    single.train_step = recorded
    torch.cuda.synchronize()
    t0 = time.time()
    single_loss = single.run_epoch(0)[0]
    torch.cuda.synchronize()
    single_step_ms = (time.time() - t0) * 1e3 / single.n_batches
    del single, bundle
    torch.cuda.empty_cache()
    kh = [r["khgrec"] for r in ranks]
    step_launches = [{n: v / kh[0]["n_batches"] for n, v in r["epoch_launches"].items()}
                     for r in kh]
    first_rel = max(abs(r["first_loss"] - first[0]) / abs(first[0]) for r in kh)
    # the data axis splits the step: each data rank's share of the first step's loss, which
    # the shares of the other data rank at the same model coordinate add up to
    model = SHARDED_TRAIN_MESH[1]
    shares = [r["first_share"] for r in kh]
    share_rel = max(abs(shares[m] + shares[model + m] - first[0]) / abs(first[0])
                    for m in range(model))
    split = all(shares[m] != shares[model + m] for m in range(model))
    lookup_ms = max(r["entity_lookup"]["ms"] for r in ranks)
    epoch_rel = max(abs(r["losses"][0] - single_loss) / abs(single_loss) for r in kh)
    eval_diff = max(abs(r["metrics"][n][m] - r["single"][n][m])
                    for r in kh for n in r["metrics"] for m in r["metrics"][n])
    out["khgrec"] = dict(mesh=SHARDED_TRAIN_MESH, steps=kh[0]["n_batches"],
                         first_loss=first[0], first_rel=first_rel, epoch_loss=single_loss,
                         epoch_rel=epoch_rel, eval_diff=eval_diff,
                         recall20=kh[0]["metrics"][20]["recall"],
                         step_launches=step_launches, sharded=kh[0]["sharded"],
                         table_block=kh[0]["shapes"]["user_entity_emb"],
                         adam_block=kh[0]["adam_shapes"]["user_entity_emb"],
                         slots=[r["slots"] for r in kh],
                         step_ms=max(r["step_ms"][0] for r in kh),
                         single_eager_step_ms=round(single_step_ms, 3),
                         first_shares=shares, share_rel=share_rel, entity_lookup_ms=lookup_ms)
    log(f"[sharded] KHGRec on {SHARDED_TRAIN_MESH}: first step within {first_rel:.3g}, epoch of "
        f"{kh[0]['n_batches']} steps within {epoch_rel:.3g} of one device; SpMM launches a "
        f"step {step_launches}; evaluate() within {eval_diff:.3g}; "
        f"{out['khgrec']['step_ms']:.1f} ms a step against {single_step_ms:.1f} ms eager on "
        f"one device; table block {out['khgrec']['table_block']}, edge slots "
        f"{out['khgrec']['slots']}; the data ranks' shares of the first step's loss {shares} "
        f"add up to it within {share_rel:.3g}; the entity lookup (`table_lookup`) "
        f"{lookup_ms:.3f} ms forward and backward")
    if (first_rel > SHARDED_STEP_RTOL or epoch_rel > SHARDED_EPOCH_RTOL
            or not split or share_rel > SHARDED_STEP_RTOL
            or eval_diff > SHARDED_EVAL_ATOL
            or any(s != {SHARDED_KHGREC_KERNEL: SHARDED_KHGREC_LAUNCHES} for s in step_launches)
            or kh[0]["sharded"] != ["user_entity_emb"]):
        raise AssertionError(f"sharded KHGRec: {out['khgrec']}")

    # --- every model's batch over the data axis (SPLIT_MODELS)
    out["split"] = _phase_split(cases, ranks, card)

    # --- MF's checkpoints across layouts
    saved = [r["mf_save"] for r in ranks]
    resumed = [r["mf_resume"] for r in ranks]
    _, _, mf = _single_trainer("MF", SHARDED_MF, data)
    mf.restore(CheckpointManager(cases["mf_save"]["save_dir"], background=False))
    on_one = mf.run_epoch(1)[0]
    del mf
    ck = dict(mesh_epochs=saved[0]["losses"], single_epochs=mf_single,
              mesh_to_single=abs(on_one - saved[0]["losses"][1]) / abs(saved[0]["losses"][1]),
              single_to_mesh=abs(resumed[0]["losses"][0] - mf_single[1]) / abs(mf_single[1]),
              sharded=saved[0]["sharded"], resumed_from=resumed[0]["start"])
    out["checkpoint"] = ck
    log(f"[sharded] MF checkpoints: mesh -> one device within {ck['mesh_to_single']:.3g}, one "
        f"device -> mesh within {ck['single_to_mesh']:.3g} (sharded {ck['sharded']})")
    if (max(ck["mesh_to_single"], ck["single_to_mesh"]) > SHARDED_STEP_RTOL
            or ck["resumed_from"] != 1 or not ck["sharded"]):
        raise AssertionError(f"sharded checkpoints: {ck}")

    # --- ShardedLightGCN against the dense steps
    c = cases["lightgcn"]
    want_losses, want_table = _dense_lightgcn(c)
    got_table = _model_blocks(ranks, "lightgcn", "table")
    gcn_diff = max(float(np.abs(got_table - want_table).max()),
                   max(float(np.abs(np.asarray(r["lightgcn"]["losses"]) - want_losses).max())
                       for r in ranks))
    out["lightgcn"] = dict(steps=len(want_losses), max_diff=gcn_diff, losses=want_losses,
                           launches=ranks[0]["lightgcn"]["launches"],
                           ms_per_step=max(r["lightgcn"]["ms"] for r in ranks))
    log(f"[sharded] ShardedLightGCN: {len(want_losses)} steps within {gcn_diff:.3g} of the dense "
        f"steps; launches {out['lightgcn']['launches']}; {out['lightgcn']['ms_per_step']:.2f} ms "
        "a step")
    if gcn_diff > SHARDED_GCN_ATOL:
        raise AssertionError(f"ShardedLightGCN: {gcn_diff:.3g} from the dense steps")

    # --- dryrun_multichip
    t0 = time.time()
    dry = dryrun_multichip(4, DEVICE)
    out["dryrun"] = dict(s=round(time.time() - t0, 2), **dry[0])
    log(f"[sharded] dryrun_multichip(4): {json.dumps(out['dryrun'])}")

    # --- the CLI on the mesh against one device, and serving_cli --mesh_model=2
    ddir = root / "dataset" / "lastfm"
    train, test, kg = graphs["lastfm"]["data"]
    io.write_interactions(str(ddir / "train.txt"), train)
    io.write_interactions(str(ddir / "test.txt"), test)
    io.write_kg(str(ddir / "processed_lastfm.kg"), kg[["h", "r", "t"]].to_numpy())
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    runs = {}
    for name, extra in (("single", []), ("mesh", SHARDED_CLI_FLAGS)):
        cwd = root / name
        cwd.mkdir()
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m", CLI_MODULE, *CLI_KHGREC,
                               "--dataset=lastfm", f"--data_dir={root / 'dataset'}",
                               f"--output_dir={cwd / 'results'}", "--quiet", *extra],
                              cwd=cwd, capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=path))
        run_s = time.time() - t0
        if proc.returncode != 0:
            raise AssertionError(f"sharded CLI {name} exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        finals = list((cwd / "results").glob("**/final_metrics.csv"))
        exports = list((cwd / "results").glob("**/embeddings.npz"))
        logs = list((cwd / "log").glob("**/*")) if (cwd / "log").exists() else []
        with open(finals[0]) as f:
            rows = {r[0]: [float(v) for v in r[1:]] for r in list(csv.reader(f))[1:]}
        runs[name] = dict(run_s=round(run_s, 2), finals=len(finals), exports=len(exports),
                          logs=len([p for p in logs if p.is_file()]), final=rows,
                          export=str(exports[0]) if exports else None)
    metric_diff = max(abs(a - b) / max(abs(b), 1e-12)
                      for n in runs["single"]["final"]
                      for a, b in zip(runs["mesh"]["final"][n], runs["single"]["final"][n]))
    users = [int(u) for u in np.unique(train[:, 0])]
    tsv = {}
    for name, extra in (("single", []), ("mesh", ["--mesh_model=2"])):
        tsv[name] = root / f"recs_{name}.tsv"
        t0 = time.time()
        rc = serving_cli.main(["--embeddings", runs["mesh"]["export"], "--users", "all", "--k",
                               "20", "--out", str(tsv[name]), "--device", DEVICE, *extra])
        runs[name]["serve_s"] = round(time.time() - t0, 2)
        if rc != 0:
            raise AssertionError(f"serving_cli {name} returned {rc}")
    got, want = ([line.split("\t") for line in tsv[n].read_text().splitlines()]
                 for n in ("mesh", "single"))
    differ = [(a, b) for a, b in zip(got, want) if a[2] != b[2]]
    ties = sum(1 for a, b in differ
               if abs(float(a[3]) - float(b[3])) <= TOPK_TIE_RTOL * max(abs(float(b[3])), 1.0))
    out["cli"] = dict(runs=runs, metric_rel=metric_diff, served=len(want),
                      users=len(users), differing_ids=len(differ), near_ties=ties)
    log(f"[sharded] CLI on the mesh: final metrics within {metric_diff:.3g} of one device; "
        f"artifacts {runs['mesh']['finals']} final_metrics, {runs['mesh']['exports']} export, "
        f"{runs['mesh']['logs']} log; {runs['mesh']['run_s']} s against "
        f"{runs['single']['run_s']} s; serving_cli --mesh_model=2: {len(want)} rows, "
        f"{len(differ)} ids differ, {ties} at near ties")
    if (metric_diff > SHARDED_EPOCH_RTOL or runs["mesh"]["finals"] != 1
            or runs["mesh"]["exports"] != 1 or runs["mesh"]["logs"] != runs["single"]["logs"]
            or len(got) != len(want) or ties != len(differ)):
        raise AssertionError(f"sharded CLI: {out['cli']}")
    log(f"[sharded] {json.dumps(out)}")
    return out


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

    seconds = {}

    def timed(name: str, fn, *args, **kw):
        t0 = time.time()
        out = fn(*args, **kw)
        seconds[name] = round(time.time() - t0, 1)
        log(f"[time] {name}: {seconds[name]} s")
        return out

    card = timed("1 device", phase_device)
    timed("2 build", phase_build)
    graphs = timed("data", make_graphs)
    rows = timed("3 kernels", phase_kernels, graphs)
    summaries = []
    for shape, kname in (("lastfm", "segment_spmm_rows"), ("ml1m", "segment_spmm_dedup")):
        layout = KERNELS[kname][0]
        launches, summary = timed(f"{4 if shape == 'lastfm' else 5} serving {shape}", phase_slice,
                                  shape, graphs[shape]["data"], layout, card)
        # the encode graph's eager first run and its capture, 8 launches each
        want = {k: (2 * 8 if k == kname else 0) for k in launches}
        if launches != want:
            raise AssertionError(f"{shape}: one encode launched {launches} from Python, "
                                 f"expected {want}")
        summaries.append(summary)
    trains = []
    for i, (shape, gather_layout, kname) in enumerate(TRAIN_PHASES):
        t = timed(f"6 training {shape}/{gather_layout}", phase_train, shape,
                  graphs[shape]["data"], gather_layout, kname, card, fit=i == 0)
        # per replayed training step (the profiler's count), as the row's times
        next(r for r in rows if r["name"] == kname)["launches"] = int(t["replayed_step_launches"])
        if shape == QUANT_SHAPE and kname.endswith("_int8"):
            next(r for r in rows if r["name"] == "quantize_int8")["launches"] = int(
                t["replayed_step_quantisations"])
        trains.append(t)
    rows += timed("7 probe", phase_probe)
    lastfm = graphs["lastfm"]["data"]
    hd, hd_rec = timed("8 HGNN_HD3", phase_hd, "lastfm", lastfm, card)
    variants = timed("9 HD variants", phase_hd_variants, hd_rec, card)
    del hd_rec
    caches = [timed(f"10 prop_cache {name}", phase_prop_cache, name, lastfm, card)
              for name in ("KHGRec", "HGNN_HD3")]
    family = timed("11 KHGRec family", phase_family, "lastfm", lastfm, card)
    lightgcn = []
    for shape, kname, fit in LIGHTGCN_PHASES:
        summary, rec = timed(f"12 LightGCN {shape}", phase_lightgcn, shape,
                             graphs[shape]["data"], kname, card, fit)
        lightgcn.append(summary)
        if shape == "lastfm":  # the zoo reads the same CF device data
            zoo_cf = rec.cf_dev
        del rec
    zoo = timed("13 zoo", phase_zoo, zoo_cf, card)
    del zoo_cf
    joint = timed("14 joint", phase_joint, "lastfm", lastfm, card)
    sgl = []
    for shape, kname, fit in LIGHTGCN_PHASES:
        summary, rec = timed(f"15 SGL {shape}", phase_lightgcn, shape, graphs[shape]["data"],
                             kname, card, fit, model="SGL")
        sgl.append(summary)
        del rec
    adjacency = timed("16 adjacency forms", phase_adjacency, lastfm, card)
    kgat = [timed(f"17 KGAT {shape}", phase_kgat, shape, graphs[shape]["data"], card,
                  fit=shape == "lastfm") for shape in ("lastfm", "ml1m")]
    rest = timed("18 KTUP, HKGRippleNet, MHCN, SEPT", phase_rest, lastfm,
                 graphs["ml1m"]["data"], card)
    sequential = [s for shape in ("lastfm", "ml1m") for s in timed(
        f"19 SASRec, CL4SRec {shape}", phase_sequential, shape, graphs[shape]["data"], card)]
    cli_run = timed("20 CLI", phase_cli, lastfm, graphs["ml1m"]["data"], card)
    kge = timed("21 KG embedding", phase_kge, card)
    profiles = [timed(f"22 profile {shape}", phase_profile, shape, graphs[shape], kname,
                      next(t for t in trains if t["shape"] == shape
                           and t["gather_layout"] == "auto")["step_device_ms"], card)
                for shape, kname in PROFILE_SHAPES]
    parallel = timed("23 parallel", phase_parallel, lastfm, card)
    supervised = timed("24 supervisor", phase_supervisor, card)
    sharded = timed("25 sharded", phase_sharded, graphs, card)
    (OUT_DIR / "summary.json").write_text(json.dumps(dict(
        kernels=rows, slices=summaries, training=trains, hd=hd, hd_variants=variants,
        prop_cache=caches, family=family, lightgcn=lightgcn, zoo=zoo, joint=joint, sgl=sgl,
        adjacency=adjacency, kgat=kgat, rest=rest, sequential=sequential, cli=cli_run,
        kge=kge, profile=profiles, parallel=parallel, supervisor=supervised, sharded=sharded,
        seconds=seconds), indent=1))
    log(f"[time] per phase: {json.dumps(seconds)}")
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
