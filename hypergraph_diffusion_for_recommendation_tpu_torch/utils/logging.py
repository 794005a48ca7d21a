"""Run logging + CSV artifacts — the port's copy of the JAX package's
`utils/logging.py` (the same files, headers and columns), parity with the
reference's outputs.

Reference artifacts (survey section 5):
  * `./log/<model timestamp>.log` via `Log.add` (util/logger.py:5-17);
  * run dir `results/<model>/<dataset>/<experiment>[@hyperparams]/`
    (base/main_recommender.py:42-44);
  * per-epoch `train_performance.csv` (ep, train_time, test_time,
    hit@K, prec@K, recall@K, ndcg@K — base/main_recommender.py:191-213)
    and `loss.csv` (:215-226);
  * end-of-run `train_loss.csv` / `cf_loss.csv` / `kg_loss.csv` /
    `cl_loss.csv` (:228-239);
  * top-N recommendation dump `<Model>-top-N items.txt`
    (base/graph_recommender.py:94-118).
"""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import Iterable


class Log:
    """util/logger.py equivalent: timestamped run log file."""

    def __init__(self, module: str, filename: str, log_dir: str = "./log"):
        os.makedirs(log_dir, exist_ok=True)
        self.logger = logging.getLogger(f"{module}:{filename}")
        self.logger.setLevel(logging.INFO)
        self.logger.handlers = []
        handler = logging.FileHandler(os.path.join(log_dir, f"{filename}.log"))
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        self.logger.addHandler(handler)

    def add(self, text) -> None:
        self.logger.info(str(text))


def run_dir(cfg) -> str:
    """results/<model>/<dataset>/<experiment tag>/ naming (reference
    base/main_recommender.py:42-44 builds it from the hyperparameters)."""
    if cfg.experiment == "missing":
        exp = f"missing_{cfg.missing_pct}"
    elif cfg.experiment == "add_noise":
        exp = f"add_noise_{cfg.noise_pct}"
    elif cfg.experiment == "cold_start":
        exp = f"cold_start_g{cfg.group_id}"
    else:
        exp = "full"
    hp = f"@lr{cfg.lrate}-reg{cfg.reg}-dim{cfg.hyper_dim}-L{cfg.n_layers}-seed{cfg.seed}"
    return os.path.join(cfg.output_dir, cfg.model, cfg.dataset, exp + hp)


class RunArtifacts:
    """Streams the reference's CSV artifacts during training."""

    def __init__(self, cfg, out_dir: str | None = None):
        self.cfg = cfg
        self.dir = out_dir or run_dir(cfg)
        os.makedirs(self.dir, exist_ok=True)
        stamp = time.strftime("%Y-%m-%d %H-%M-%S")
        self.log = Log(cfg.model, f"{cfg.model} {stamp}", cfg.log_dir)
        self.log.add(f"config: {cfg}")
        self._perf_path = os.path.join(self.dir, "train_performance.csv")
        self._loss_path = os.path.join(self.dir, "loss.csv")
        self._wrote_perf_header = False
        self._wrote_loss_header = False
        self._loss_rows: list[dict] = []

    def on_epoch(self, record) -> None:
        cfg = self.cfg
        max_n = cfg.max_n
        perf = record.metrics[max_n]
        with open(self._perf_path, "a", newline="") as f:
            w = csv.writer(f)
            if not self._wrote_perf_header:
                w.writerow(
                    ["epoch", "train_time", "test_time", f"hit@{max_n}",
                     f"precision@{max_n}", f"recall@{max_n}", f"ndcg@{max_n}"]
                )
                self._wrote_perf_header = True
            w.writerow(
                [record.epoch, round(record.train_time, 4), round(record.test_time, 4),
                 perf["hit_ratio"], perf["precision"], perf["recall"], perf["ndcg"]]
            )
        with open(self._loss_path, "a", newline="") as f:
            w = csv.writer(f)
            keys = sorted(record.losses)
            if not self._wrote_loss_header:
                w.writerow(["epoch"] + keys)
                self._wrote_loss_header = True
            w.writerow([record.epoch] + [round(record.losses[k], 6) for k in keys])
        self._loss_rows.append({"epoch": record.epoch, **record.losses})
        self.log.add(f"epoch {record.epoch}: loss={record.losses} perf@{max_n}={perf}")

    def finish(self, result) -> None:
        # per-loss-component end-of-run CSVs (base/main_recommender.py:228-239)
        keys = {k for row in self._loss_rows for k in row if k != "epoch"}
        for key in keys:
            path = os.path.join(self.dir, f"{key}.csv")
            with open(path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["epoch", key])
                for row in self._loss_rows:
                    if key in row:
                        w.writerow([row["epoch"], round(row[key], 6)])
        self.log.add(f"### Final (best epoch {result.best_epoch}) ###")
        self.log.add(result.final_metrics)
        with open(os.path.join(self.dir, "final_metrics.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["topN", "hit_ratio", "precision", "recall", "ndcg"])
            for n, m in (result.final_metrics or {}).items():
                w.writerow([n, m["hit_ratio"], m["precision"], m["recall"], m["ndcg"]])


def dump_recommendations(
    path: str,
    user_ids_raw: Iterable,
    item_ids_raw,
    top_ids,
    top_scores,
    test_membership,
) -> None:
    """`<Model>-top-N items.txt` dump: 'user: (item,score)[*hit]' lines
    (base/graph_recommender.py:94-118)."""
    with open(path, "w") as f:
        f.write("userId: recommendations in (itemId, ranking score) pairs, "
                "* means the item is hit.\n")
        for u, ids, scores, hits in zip(user_ids_raw, top_ids, top_scores, test_membership):
            line = [f"{u}:"]
            for i, s, h in zip(ids, scores, hits):
                star = "*" if h else ""
                line.append(f" ({item_ids_raw[i]},{s:.4f}){star}")
            f.write("".join(line) + "\n")
