"""Reference-style facade — the port of the JAX package's
`train/recommender.py`:

    rec = Recommender(make_config("KHGRec"))   # or "HGNN_HD3"; runs on cuda by default
    rec.execute()                              # build -> train -> test
    rec.recommend(raw_user_id, k=20)           # [(raw_item_id, score)]

or, to serve given weights:

    rec.build()                                # data + device graphs + model
    rec.init_weights(seed=0)                   # or rec.load_weights(sd, extras)
    rec.encode()                               # full-graph encode -> tables
    rec.evaluate()                             # {N: {metric: value}}
    rec.export_embeddings("embeddings.npz")    # for eval.serving.Retriever
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device


class Recommender:
    def __init__(self, cfg: Config, device: torch.device | str | None = None, social=None):
        """`social`: a `data.social.SocialData`, which the social models
        (MHCN, SEPT) require: without it `build` refuses them, as the JAX
        package does."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.social = social
        self.bundle = None
        self.extras = None
        self.trainer = None
        self.result = None
        self.user_emb = self.item_emb = None
        self._encoder = None  # the encode's CUDA graph, over the current extras

    @classmethod
    def from_conf(cls, conf_path: str, device: torch.device | str | None = None,
                  social=None, **overrides) -> "Recommender":
        """From a reference-format .conf file (`utils.conf.config_from_conf`;
        `overrides` win over the file's values)."""
        from ..utils.conf import config_from_conf

        return cls(config_from_conf(conf_path, **overrides), device, social=social)

    # -- lifecycle ------------------------------------------------------
    def build(self, data=None) -> None:
        """Build the interaction data (and, with `cfg.use_knowledge`, the
        knowledge data), their device graphs and the model. `data` is a
        (train, test, kg_df) triple, kg_df None or ignored for a model
        without knowledge; None resolves the configured dataset and
        experiment (`cli.load_dataset`: the synthetic dataset, or the files
        under `cfg.data_dir`). A social model given no social data raises
        ValueError (`build_model`)."""
        from ..cli import load_dataset
        from ..data import (
            build_cf_device_data,
            build_interaction,
            build_kg_device_data,
            build_knowledge,
        )
        from ..models import build_model, model_data_needs

        cfg = self.cfg
        train, test, kg_df = load_dataset(cfg) if data is None else data
        # the kernel layout's gathered operand and kind: the JAX package's
        # PALLAS_BF16 / PALLAS_DEDUP / PALLAS_INT8 switches, passed explicitly
        layout = dict(bf16=cfg.compute_dtype == "bfloat16", gather_layout=cfg.gather_layout)
        self.inter = build_interaction(train, test)
        self.cf_dev = build_cf_device_data(
            self.inter, self.device, eval_user_multiple=cfg.eval_user_batch,
            needs=model_data_needs(cfg.model), **layout,
        )
        kg_dev = None
        if cfg.use_knowledge and kg_df is not None:
            self.kg = build_knowledge(kg_df, self.inter)
            kg_dev = build_kg_device_data(self.kg, self.device, **layout)
        self.bundle = build_model(cfg, self.cf_dev, kg_dev, social=self.social)
        self._encoder = None

    def init_weights(self, seed: int) -> None:
        """Native random initialisation from a seeded `torch.Generator`."""
        self.extras = self.bundle.init(torch.Generator().manual_seed(seed))

    def load_weights(self, state_dict: dict, extras: dict) -> None:
        """Trained weights, e.g. from `weights.khgrec_params_from_jax` or
        `weights.params_from_jax`; extras that are not tensors (the
        cached-propagation age) are kept as they are."""
        self.bundle.module.load_state_dict(state_dict)
        self.extras = {k: v.to(self.device) if torch.is_tensor(v) else v
                       for k, v in extras.items()}

    def train(self, quiet: bool = True):
        """Fit the model (`Trainer.fit`, `cfg.max_epoch` epochs at most),
        from the current weights if they were set, else from `cfg.seed`;
        leaves the best state's tables encoded."""
        from .trainer import Trainer

        if self.bundle is None:
            self.build()
        self.trainer = Trainer(self.bundle, extras=self.extras)
        self.result = self.trainer.fit(quiet=quiet)
        self.extras = self.trainer.extras
        self.user_emb, self.item_emb = self.trainer.encode()  # the final evaluation's tables
        return self.result

    def test(self) -> dict:
        """Final metrics at every configured top-N (the reference's
        `test()` + `evaluate()`, as structured values)."""
        return self.evaluate()

    def execute(self, quiet: bool = True) -> dict:
        """build -> train -> test (base/recommender.py:80-114)."""
        self.train(quiet=quiet)
        return self.test()

    def encode(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The full-graph encode: the user table and the item table that
        scoring reads. On a CUDA card it replays a CUDA graph of the encode,
        as the trainer does, captured anew when `extras` is replaced (update
        its tensors in place or assign a new dict); the tables are then the
        graph's outputs, which the next encode writes again."""
        if self.device.type == "cuda":
            from .graphs import EncodeGraph

            if self._encoder is None or self._encoder.extras is not self.extras:
                self._encoder = EncodeGraph(self.bundle, self.extras)
            self.user_emb, self.item_emb = self._encoder()
        else:
            self.user_emb, self.item_emb = self.bundle.encode_eval(self.extras)
        return self.user_emb, self.item_emb

    def evaluate(self) -> dict:
        """Full-catalog ranking metrics over the test users at every
        configured top-N."""
        from ..eval.metrics import metrics_to_host, ranking_metrics

        top_ns = tuple(self.cfg.top_ns)
        m = ranking_metrics(
            self.user_emb, self.item_emb, self.cf_dev.rated_pad, self.cf_dev.eval_data,
            top_ns, block=self.cfg.eval_user_batch,
        )
        return metrics_to_host(m, top_ns)

    # -- serving --------------------------------------------------------
    def predict(self, raw_user_id) -> np.ndarray:
        """Full-catalog scores for one user (reference `predict(u)`)."""
        from ..ops.topk import exact_scores

        uid = self.inter.user[int(raw_user_id)]
        return exact_scores(self.user_emb[uid : uid + 1], self.item_emb)[0].cpu().numpy()

    def recommend(self, raw_user_id, k: int = 20, exclude_rated: bool = True):
        """Top-k (raw_item_id, score) pairs, ties to the lower item id."""
        from ..ops.topk import exact_scores, masked_topk, topk_ids

        uid = self.inter.user[int(raw_user_id)]
        scores = exact_scores(self.user_emb[uid : uid + 1], self.item_emb)
        if exclude_rated:
            vals, ids = masked_topk(scores, self.cf_dev.rated_pad[uid : uid + 1], k)
        else:
            vals, ids = topk_ids(scores, k)
        return [(int(self.inter.id2item[i]), float(s))
                for i, s in zip(ids[0].tolist(), vals[0].tolist())]

    def export_embeddings(self, path: str) -> str:
        """Persist the encoded tables for standalone retrieval
        (eval/serving.Retriever, serving_cli)."""
        from ..eval.serving import export_embeddings

        return export_embeddings(
            path, self.user_emb, self.item_emb, self.inter.id2user, self.inter.id2item,
            rated_pad=self.cf_dev.rated_pad,
            meta={"model": self.cfg.model, "dataset": self.cfg.dataset},
        )

    def dump_recommendations(self, path: str | None = None, k: int | None = None) -> str:
        """The `<Model>-top-N items.txt` artefact (base/graph_recommender.py:
        94-118): each test user's top-k unrated items with their scores, a
        star on each test hit; under the run directory unless `path` is
        given."""
        from ..ops.topk import exact_scores, masked_topk
        from ..utils.logging import dump_recommendations, run_dir

        cfg = self.cfg
        k = k or cfg.max_n
        path = path or os.path.join(run_dir(cfg), f"{cfg.model}-top-{k}items.txt")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        ed = self.cf_dev.eval_data
        users = ed.test_users[: ed.n_test_users].long()
        scores = exact_scores(self.user_emb[users], self.item_emb)
        vals, ids = masked_topk(scores, self.cf_dev.rated_pad[users], k)
        ids_np = ids.cpu().numpy()
        test_pos = ed.test_pos_pad[: ed.n_test_users].cpu().numpy()
        hits = (ids_np[:, :, None] == test_pos[:, None, :]).any(-1)
        raw_users = [int(self.inter.id2user[u]) for u in users.cpu().numpy()]
        dump_recommendations(path, raw_users, self.inter.id2item, ids_np, vals.cpu().numpy(),
                             hits)
        return path
