"""Results aggregation — the port's copy of the JAX package's
`utils/results.py`, the reference's `generate_output.ipynb` layer.

The reference collects per-run `results/<model>/<dataset>/<exp>@<hp>/`
CSVs into a flat `output.csv` of best metrics per run via notebooks
(root generate_output.ipynb / generate_output_hgnn.ipynb, survey
section 4). This module is the scripted equivalent over the artifact
layout written by utils/logging.RunArtifacts.
"""

from __future__ import annotations

import csv
import glob
import os


def _read_final_metrics(path: str) -> dict:
    """final_metrics.csv -> {"<metric>@<K>": value, ...}."""
    out = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            k = row["topN"]
            for m in ("hit_ratio", "precision", "recall", "ndcg"):
                if row.get(m) not in (None, ""):
                    out[f"{m}@{k}"] = float(row[m])
    return out


def _best_from_train_performance(path: str) -> dict:
    """Fallback for unfinished runs: best recall row of
    train_performance.csv (the reference's per-epoch Current/Best
    tracking, base/main_recommender.py:161-176)."""
    best = {}
    best_recall = -1.0
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            rec_keys = [k for k in row if k.startswith("recall@")]
            if not rec_keys:
                continue
            r = float(row[rec_keys[0]])
            if r > best_recall:
                best_recall = r
                best = {
                    k: float(v)
                    for k, v in row.items()
                    if "@" in k and v not in (None, "")
                }
                best["best_epoch"] = int(row["epoch"])
    return best


def aggregate_results(root: str = "./results") -> list[dict]:
    """Walk results/<model>/<dataset>/<exp>@<hp>/ into flat rows."""
    rows = []
    for run_dir in sorted(glob.glob(os.path.join(root, "*", "*", "*"))):
        if not os.path.isdir(run_dir):
            continue
        exp_tag = os.path.basename(run_dir)
        dataset = os.path.basename(os.path.dirname(run_dir))
        model = os.path.basename(os.path.dirname(os.path.dirname(run_dir)))
        exp, _, hp = exp_tag.partition("@")
        row = {"model": model, "dataset": dataset, "experiment": exp, "hparams": hp}
        final = os.path.join(run_dir, "final_metrics.csv")
        perf = os.path.join(run_dir, "train_performance.csv")
        if os.path.exists(final):
            row.update(_read_final_metrics(final))
        elif os.path.exists(perf):
            row.update(_best_from_train_performance(perf))
        else:
            continue
        rows.append(row)
    return rows


def write_output_csv(rows: list[dict], path: str = "output.csv") -> None:
    """Flat CSV with the union of metric columns (reference output.csv)."""
    if not rows:
        return
    lead = ["model", "dataset", "experiment", "hparams"]
    metric_cols = sorted({k for r in rows for k in r if k not in lead})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=lead + metric_cols)
        w.writeheader()
        for r in rows:
            w.writerow(r)
