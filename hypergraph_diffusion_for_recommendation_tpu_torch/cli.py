"""Command-line interface of the PyTorch port — the port of the JAX
package's `cli.py`: the same flags (reference `main.py:6-95`), names,
defaults and choices, and the orchestration of `SELFRec.py`.

    python -m hypergraph_diffusion_for_recommendation_tpu_torch.cli \
        --model=KHGRec --dataset=lastfm --lrate=0.001 --experiment=full

It trains on the GPU; `main(argv, device="cpu")` and `run(cfg,
device="cpu")` run on the CPU when asked. Experiment-aware loading
(SELFRec.py:12-33): pre-generated variant files (missing/train_30.txt etc.)
are used when present, otherwise the variant is derived in memory from the
base split (`data/experiments.py`). Files are parsed by the port's native
library (`native/`). `--dataset=synthetic` generates the planted-structure
benchmark dataset. A run writes the reference's artifacts under
`<output_dir>/<model>/<dataset>/<experiment>@<hyperparameters>/`
(`utils/logging.py`), checkpoints there with `--save_checkpoints` (every 10
epochs) and resumes with `--resume`; `--export_embeddings` writes the
`embeddings.npz` that `serving_cli` reads. The multi-device flags
(`--mesh_data`/`--mesh_model` above 1, `--shard_graph=on`) raise
NotImplementedError: the port runs on one device (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import argparse
import json
import os
import time

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Hypergraph-diffusion recommender, PyTorch + CUDA (one GPU)")
    p.add_argument("--experiment", type=str, default="full",
                   choices=["full", "cold_start", "missing", "add_noise"])
    p.add_argument("--group_id", type=int, default=1, choices=[1, 2, 3, 4])
    p.add_argument("--missing_pct", type=int, default=0, choices=[0, 10, 20, 30, 40, 50])
    p.add_argument("--noise_pct", type=int, default=0, choices=[0, 10, 20, 30, 40, 50])
    p.add_argument("--model", type=str, default="HCCF")
    p.add_argument("--conf", type=str, default="",
                   help="reference-format .conf file (utils/conf.py); CLI flags override")
    p.add_argument("--dataset", type=str, default="synthetic")
    p.add_argument("--data_dir", type=str, default="./dataset")
    p.add_argument("--seed", type=int, default=60)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--lrate", type=float, default=None)
    p.add_argument("--item_ranking", type=str, default="10,20,40")
    p.add_argument("--max_epoch", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--hyperedge_num", type=int, default=None)
    p.add_argument("--batch_size_kg", type=int, default=None)
    p.add_argument("--n_layers", type=int, default=None)
    p.add_argument("--embedding_size", type=int, default=None)
    p.add_argument("--input_dim", type=int, default=None)
    p.add_argument("--relation_dim", type=int, default=None)
    p.add_argument("--hyper_dim", type=int, default=None)
    p.add_argument("--lr_decay", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--reg", type=float, default=None)
    p.add_argument("--reg_kg", type=float, default=None)
    p.add_argument("--p", type=float, default=None)
    p.add_argument("--drop_rate", type=float, default=None)
    p.add_argument("--nheads", type=int, default=None)
    p.add_argument("--temp", type=float, default=None)
    p.add_argument("--cl_rate", type=float, default=None)
    p.add_argument("--mode", type=str, default="full",
                   choices=["full", "woatt", "wossl", "wohyper", "woglobal", "local_only",
                            "group_only"])
    p.add_argument("--aug_type", type=int, default=None)
    p.add_argument("--laplacian_type", type=str, default=None)
    p.add_argument("--aggregation_type", type=str, default=None)
    p.add_argument("--conv_dim_list", type=str, default=None, help="e.g. '[64, 32, 16]'")
    p.add_argument("--mess_dropout", type=str, default=None, help="e.g. '[0.1, 0.1, 0.1]'")
    p.add_argument("--early_stopping_steps", type=int, default=None)
    p.add_argument("--early_stop_smooth", type=int, default=None,
                   help="trailing moving-average window for the early-stop "
                        "signal (1 = reference-parity raw recall; >1 smooths "
                        "the patience signal against plateau-lottery stops)")
    p.add_argument("--early_stop_patience_scale", type=int, default=None,
                   help="patience multiplier: 0 = model default (x2 for "
                        "self-att encoders and HCCF, whose measured recall "
                        "troughs outlast the standard patience); explicit "
                        "value pins it (1 = reference protocol)")
    p.add_argument("--evaluate_every", type=int, default=None)
    p.add_argument("--sht_reg", type=str, default=None,
                   choices=["batch", "full"],
                   help="SHT regularisation: 'batch' (product default, "
                        "batch-row L2) or 'full' (the reference's exact "
                        "full-parameter calcRegLoss — norm-collapse seed "
                        "lottery at the pinned parity config)")
    p.add_argument("--prop_cache_steps", type=int, default=None,
                   help="K>1 trains the KHGRec and HD families on cached "
                        "propagated tables refreshed by a true full-graph "
                        "step every K steps (straight-through gradients "
                        "between refreshes) — skips the full-graph spmm "
                        "chains on K-1 of K steps; 0/1 = off "
                        "(reference-parity semantics); models outside "
                        "those families ignore the knob. Quality A/B: "
                        "results/prop_cache_ab/")
    # accepted for reference run-script compatibility (main.py:16,87-89):
    # the card is the current CUDA device; print cadences map to log verbosity
    p.add_argument("--gpu_id", type=int, default=0,
                   help="ignored (the port runs on the current CUDA device; kept for "
                        "reference-script compatibility)")
    p.add_argument("--cf_print_every", type=int, default=1, help="ignored (per-epoch logging)")
    p.add_argument("--kg_print_every", type=int, default=1, help="ignored (per-epoch logging)")
    # additions of the JAX package, kept with their names, defaults and choices
    p.add_argument("--async_eval", action="store_true",
                   help="accepted for compatibility; a no-op since the "
                        "one-epoch-lag machinery was measured to hide 0% "
                        "(train and eval share one device queue)")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel mesh axis; the port runs on one device, and a value "
                        "above 1 raises NotImplementedError (multi-device: ROADMAP.md)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel mesh axis; above 1 raises NotImplementedError")
    p.add_argument("--gather_layout", type=str, default="auto",
                   choices=("auto", "base", "dedup", "int8", "dedup_int8"),
                   help="segment-SpMM kernel layout: auto selects dedup by column "
                        "multiplicity (the JAX package's rule); the int8 variants "
                        "quantise the gathered operand (~1%% fwd error)")
    p.add_argument("--shard_graph", type=str, default="auto",
                   choices=("auto", "on", "off"),
                   help="row-window-shard graph adjacencies over the model "
                        "axis; the port runs on one device: auto and off replicate, "
                        "on raises NotImplementedError")
    p.add_argument("--sampler", type=str, default=None,
                   choices=("redraw", "exact"),
                   help="negative sampler: redraw = on-device fixed-round "
                        "redraw (default); exact = host-side exact rejection "
                        "with the reference's semantics (not for sequence models)")
    p.add_argument("--output_dir", type=str, default="./results")
    p.add_argument("--export_embeddings", action="store_true",
                   help="write <run_dir>/embeddings.npz for standalone "
                        "serving (serving_cli / eval.serving.Retriever)")
    p.add_argument("--save_checkpoints", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--debug_nans", action="store_true",
                   help="run every training step eagerly (no CUDA graph) under "
                        "torch.autograd.detect_anomaly and raise at the first "
                        "non-finite loss (reference parity: KGAT NaN checks / "
                        "HGNN_HD3 set_detect_anomaly)")
    return p.parse_args(argv)


def extract_overrides(args: argparse.Namespace) -> dict:
    overrides = {}
    for key in (
        "experiment", "group_id", "missing_pct", "noise_pct", "dataset", "data_dir",
        "seed", "alpha", "lrate", "max_epoch", "batch_size", "hyperedge_num",
        "batch_size_kg", "n_layers", "embedding_size", "input_dim", "relation_dim",
        "hyper_dim", "lr_decay", "weight_decay", "reg", "reg_kg", "p", "drop_rate",
        "nheads", "temp", "cl_rate", "mode", "aug_type", "laplacian_type",
        "aggregation_type", "early_stopping_steps", "early_stop_smooth",
        "early_stop_patience_scale", "evaluate_every", "prop_cache_steps",
        "sht_reg",
        "mesh_data", "mesh_model", "shard_graph", "gather_layout", "sampler",
        "output_dir", "save_checkpoints", "resume",
    ):
        v = getattr(args, key)
        if v is not None:
            overrides[key] = v
    if args.export_embeddings:
        overrides["export_embeddings"] = True
    overrides["item_ranking"] = tuple(int(x) for x in args.item_ranking.split(","))
    if args.conv_dim_list:
        overrides["conv_dim_list"] = tuple(json.loads(args.conv_dim_list))
    if args.mess_dropout:
        overrides["mess_dropout"] = tuple(json.loads(args.mess_dropout))
    return overrides


def extract_overrides(args: argparse.Namespace) -> dict:
    overrides = {}
    for key in (
        "experiment", "group_id", "missing_pct", "noise_pct", "dataset", "data_dir",
        "seed", "alpha", "lrate", "max_epoch", "batch_size", "hyperedge_num",
        "batch_size_kg", "n_layers", "embedding_size", "input_dim", "relation_dim",
        "hyper_dim", "lr_decay", "weight_decay", "reg", "reg_kg", "p", "drop_rate",
        "nheads", "temp", "cl_rate", "mode", "aug_type", "laplacian_type",
        "aggregation_type", "early_stopping_steps", "early_stop_smooth",
        "early_stop_patience_scale", "evaluate_every", "prop_cache_steps",
        "sht_reg",
        "mesh_data", "mesh_model", "shard_graph", "gather_layout", "sampler",
        "output_dir", "save_checkpoints", "resume",
    ):
        v = getattr(args, key)
        if v is not None:
            overrides[key] = v
    if args.export_embeddings:
        overrides["export_embeddings"] = True
    overrides["item_ranking"] = tuple(int(x) for x in args.item_ranking.split(","))
    if args.conv_dim_list:
        overrides["conv_dim_list"] = tuple(json.loads(args.conv_dim_list))
    if args.mess_dropout:
        overrides["mess_dropout"] = tuple(json.loads(args.mess_dropout))
    return overrides


def build_config(args: argparse.Namespace):
    from .core.config import make_config

    return make_config(args.model, **extract_overrides(args))


def build_config(args: argparse.Namespace):
    from .core.config import make_config

    return make_config(args.model, **extract_overrides(args))


def load_dataset(cfg):
    """Resolve train/test/kg data for the configured experiment."""
    from .data import apply_experiment, synthetic_dataset
    from .data.io import load_data_set, load_kg_data

    if cfg.dataset == "synthetic":
        need_kg = cfg.use_knowledge
        train, test, kg_df = synthetic_dataset(
            n_users=1890, n_items=17632, mean_degree=49.0, seed=7, with_kg=need_kg
        )
        train, test = apply_experiment(train, test, cfg.experiment, cfg.seed, cfg.missing_pct,
                                       cfg.noise_pct, cfg.group_id)
        return train, test, kg_df

    base = os.path.join(cfg.data_dir, cfg.dataset)
    # pre-generated variant files take precedence (SELFRec.py:19-33)
    variant_paths = {
        "missing": (f"missing/train_{cfg.missing_pct}.txt",
                    f"missing/test_{cfg.missing_pct}.txt"),
        "add_noise": (f"add_noise/train_{cfg.noise_pct}.txt",
                      f"add_noise/test_{cfg.noise_pct}.txt"),
        "cold_start": ("cold-start/train.txt", f"cold-start/test_group_{cfg.group_id}.txt"),
    }
    if cfg.experiment in variant_paths:
        tr_p, te_p = (os.path.join(base, q) for q in variant_paths[cfg.experiment])
        if os.path.exists(tr_p) and os.path.exists(te_p):
            train, test = load_data_set(tr_p), load_data_set(te_p)
        else:
            train = load_data_set(os.path.join(base, cfg.training_set))
            test = load_data_set(os.path.join(base, cfg.test_set))
            train, test = apply_experiment(train, test, cfg.experiment, cfg.seed,
                                           cfg.missing_pct, cfg.noise_pct, cfg.group_id)
    else:
        train = load_data_set(os.path.join(base, cfg.training_set))
        test = load_data_set(os.path.join(base, cfg.test_set))

    kg_df = None
    if cfg.use_knowledge:
        kg_path = cfg.knowledge_file or os.path.join(base, f"processed_{cfg.dataset}.kg")
        kg_df = load_kg_data(kg_path)
    return train, test, kg_df


def check_single_device(cfg) -> None:
    """The multi-device options are not ported yet: refuse them rather than
    train on one device."""
    if max(cfg.mesh_data, 1) * max(cfg.mesh_model, 1) > 1 or cfg.shard_graph == "on":
        raise NotImplementedError(
            f"mesh_data={cfg.mesh_data}, mesh_model={cfg.mesh_model}, "
            f"shard_graph={cfg.shard_graph!r}: the PyTorch port runs on one device; "
            "multi-device training (the port of parallel/) is the last item of ROADMAP.md's "
            "Queue 1")


def run(cfg, quiet: bool = False, device=None, debug_nans: bool = False):
    """Build, train (`Trainer.fit` with the run artifacts, and checkpoints
    under `--save_checkpoints` / `--resume`), export, on `device` (the GPU
    unless the caller asks for the CPU)."""
    from .train import Recommender, Trainer
    from .utils.logging import RunArtifacts, run_dir

    check_single_device(cfg)
    t0 = time.time()
    rec = Recommender(cfg, device)
    rec.build()
    inter = rec.inter
    print(f"data: {inter.n_users} users / {inter.n_items} items / "
          f"{inter.n_cf_train} train edges ({time.time() - t0:.1f}s)")
    trainer = Trainer(rec.bundle, debug_nans=debug_nans)

    artifacts = RunArtifacts(cfg)
    ckpt = None
    start_epoch = 0
    if cfg.save_checkpoints or cfg.resume:
        from .utils.checkpoint import CheckpointManager

        ckpt = CheckpointManager(os.path.join(run_dir(cfg), "checkpoints"))
        if cfg.resume:
            start_epoch = trainer.restore(ckpt)
            if start_epoch and not quiet:
                print(f"resumed from epoch {start_epoch}")
    try:
        result = trainer.fit(quiet=quiet, artifacts=artifacts, ckpt=ckpt,
                             start_epoch=start_epoch)
    finally:
        if ckpt is not None:
            # joins the in-flight background save (and raises its error)
            # before the process can exit and drop it
            ckpt.close()
    if cfg.export_embeddings:
        # fit() has restored the best epoch's state
        from .eval.serving import export_embeddings

        u_emb, i_emb = trainer.encode()
        path = export_embeddings(
            os.path.join(run_dir(cfg), "embeddings.npz"), u_emb, i_emb, inter.id2user,
            inter.id2item, rated_pad=rec.cf_dev.rated_pad,
            meta={"model": cfg.model, "dataset": cfg.dataset, "best_epoch": result.best_epoch})
        print(f"embeddings exported: {path}")
    print(f"best epoch {result.best_epoch}: {result.best_metrics}")
    print(f"final metrics: {result.final_metrics}")
    print(f"throughput: {result.examples_per_sec:,.0f} examples/sec")
    return result


def main(argv=None, device=None):
    """Parse `argv` and run on `device` (the GPU unless "cpu" is given)."""
    args = parse_args(argv)
    if args.conf:
        # the conf file supplies defaults; CLI flags win (reference
        # precedence, survey 2.10)
        from .utils.conf import config_from_conf

        cfg = config_from_conf(args.conf, **extract_overrides(args))
    else:
        cfg = build_config(args)
    s = time.time()
    result = run(cfg, quiet=args.quiet, device=device, debug_nans=args.debug_nans)
    print(f"Running time: {time.time() - s:.1f} s")
    return result


if __name__ == "__main__":
    main()
