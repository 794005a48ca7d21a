"""Standalone serving: embedding export + batched top-k retrieval — the
port of the JAX package's `eval/serving.py`.

  * `export_embeddings` writes the serving artifact, one `.npz` in the JAX
    package's format: the encoded user/item tables, the raw<->dense id
    maps, the per-user rated-item mask and a JSON `meta` blob, so either
    package's `Retriever.load` reads either package's export;
  * `Retriever` holds the tables on the device and answers batched top-k
    queries through the evaluation's ranking (`eval.metrics.top_items`):
    exact-f32 scores, rated-item mask, top-k with ties to the lower item
    id. With a mesh (`mesh=`, every rank of it constructs the Retriever and
    asks the same queries) each rank holds its row block of the item table,
    and with a model axis above 1 the top-k merges the blocks' over the
    model group (`parallel.sharded_user_topk`, the JAX `Retriever`,
    serving.py:83-147).

Raw-id translation happens on the host: id vocabularies are dataset
artifacts, not model state.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.topk import exact_scores
from .metrics import top_items


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def export_embeddings(
    path: str,
    user_emb,
    item_emb,
    id2user: np.ndarray,
    id2item: np.ndarray,
    rated_pad=None,
    meta: dict | None = None,
) -> str:
    """Write the serving artifact. `rated_pad` is the [n_users, max_deg]
    padded training-history table (pad = -1); None disables rated-item
    exclusion at serving time."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {
        "user_emb": _host(user_emb).astype(np.float32),
        "item_emb": _host(item_emb).astype(np.float32),
        "id2user": np.asarray(id2user, np.int64),
        "id2item": np.asarray(id2item, np.int64),
        "meta": np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8),
    }
    if rated_pad is not None:
        arrays["rated_pad"] = _host(rated_pad).astype(np.int32)
    np.savez_compressed(path, **arrays)
    return path


class Retriever:
    """Top-k retrieval over exported embedding tables held on `device`.

    >>> r = Retriever.load("results/.../embeddings.npz")
    >>> ids, scores = r.topk([raw_user, ...], k=20)
    """

    def __init__(
        self,
        user_emb: np.ndarray,
        item_emb: np.ndarray,
        id2user: np.ndarray,
        id2item: np.ndarray,
        rated_pad: np.ndarray | None = None,
        meta: dict | None = None,
        block: int = 1024,
        device: torch.device | str | None = None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.meta = meta or {}
        self.block = int(block)
        self.id2user = np.asarray(id2user)
        self.id2item = np.asarray(id2item)
        self.user_index = {int(u): i for i, u in enumerate(self.id2user)}
        self.n_users, self.dim = user_emb.shape
        self.n_items = item_emb.shape[0]
        self.user_emb = torch.as_tensor(np.asarray(user_emb, np.float32), device=self.device)
        self.item_emb = torch.as_tensor(np.asarray(item_emb, np.float32), device=self.device)
        if mesh is not None:
            from ..parallel.mesh import row_block

            self.item_emb = row_block(self.item_emb, mesh)  # this rank's block, rows padded
        self.rated_pad = (
            None if rated_pad is None
            else torch.as_tensor(np.asarray(rated_pad, np.int32), device=self.device)
        )

    @classmethod
    def load(cls, path: str, block: int = 1024, device: torch.device | str | None = None,
             mesh=None) -> "Retriever":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z.files else {}
            return cls(
                z["user_emb"], z["item_emb"], z["id2user"], z["id2item"],
                z["rated_pad"] if "rated_pad" in z.files else None,
                meta=meta, block=block, device=device, mesh=mesh,
            )

    def dense_user_ids(self, raw_user_ids) -> np.ndarray:
        unknown = [u for u in raw_user_ids if int(u) not in self.user_index]
        if unknown:
            raise KeyError(
                f"{len(unknown)} user id(s) not in the export's vocabulary "
                f"(first few: {unknown[:5]})"
            )
        return np.asarray([self.user_index[int(u)] for u in raw_user_ids], np.int64)

    def topk(
        self,
        raw_user_ids,
        k: int = 20,
        exclude_rated: bool = True,
        raw_ids: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched retrieval: ([B] raw user ids) -> (ids [B, k], scores
        [B, k]), k at most the catalogue's size. `raw_ids=False` returns
        dense item ids instead of raw. `top_items` ranks the queries, `block`
        users at a time where it ranks in blocks."""
        users = torch.as_tensor(self.dense_user_ids(raw_user_ids), device=self.device)
        vals, ids = top_items(self.user_emb, users, self.item_emb,
                              self.rated_pad if exclude_rated else None, k, block=self.block,
                              mesh=self.mesh, n_items=self.n_items)
        out_ids = ids.cpu().numpy()
        if raw_ids:
            out_ids = self.id2item[out_ids]
        return out_ids, vals.cpu().numpy()

    def scores(self, raw_user_id) -> np.ndarray:
        """Full-catalog scores for one user (the facade `predict(u)`)."""
        uid = int(self.dense_user_ids([raw_user_id])[0])
        scores = exact_scores(self.user_emb[uid : uid + 1], self.item_emb)[0]
        if self.mesh is not None:
            from ..parallel.mesh import MODEL_AXIS, all_gather_cat

            scores = all_gather_cat(scores, self.mesh.get_group(MODEL_AXIS))[: self.n_items]
        return scores.cpu().numpy()
