"""Device-resident graph bundles consumed by every model.

The port's counterpart of the JAX package's `data/device.py`: the
host->device boundary. Everything is built once on the host with numpy
and moved to `device`; training and eval then never touch host data.

Every matrix placed on a CUDA device gets a CUDA segment-SpMM layout,
whatever its nnz: the kernels take any matrix, empty windows included, so
every product on the card runs a kernel. Above `PALLAS_MAX_NNZ` edges
building the device data raises. On the CPU no layout is attached and the
plain segment sum runs. Two arguments take the place of the JAX package's
module-level switches, read when a layout is packed:

  * `bf16` selects the bf16 gathered operand (`PALLAS_BF16`);
  * `gather_layout` picks the layout (`PALLAS_DEDUP`, `PALLAS_INT8`), as
    the JAX CLI maps `Config.gather_layout` onto them (cli.py:225-237):
    "base" and "dedup" force one, "int8" and "dedup_int8" force base or
    dedup and set `BlockedCOO.int8`; under "auto" the environment decides,
    read when the layout is packed: `HGDR_DEDUP=0` or `1` forces base or
    dedup, unset or any other value picks per matrix with `dedup_auto`,
    and `HGDR_INT8=1` sets `BlockedCOO.int8`.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import SparseCOO, pad_to_multiple, padded_rows_from_lists
from ..native import sort_pairs
from ..ops.dropout import hash_keep_mask
from ..ops.kernels.segment_spmm import ROW_BLOCK, pack_blocked, pack_blocked_dedup
from ..ops.sampling import CSRMembership, membership_from_lists
from .dataset import InteractionData
from .knowledge import KnowledgeData

# the kernels index the packed slots with int32: this keeps n_blocks * eb
# (nnz plus at most one block of padding per window) far below 2^31
PALLAS_MAX_NNZ = 64_000_000
# max bytes for a padded membership table before sampling uses the O(nnz)
# CSR binary-search form (both exact); HGDR_PAD_TABLE_BUDGET sets it at
# import, as in the JAX package
PAD_TABLE_BUDGET = int(os.environ.get("HGDR_PAD_TABLE_BUDGET", 256 * 1024 * 1024))
GATHER_LAYOUTS = ("auto", "base", "dedup", "int8", "dedup_int8")


class HostEdges:
    """Host-side (row, col, val) snapshot of an AdjPair's live edges,
    sorted by (row, col)."""

    __slots__ = ("rows", "cols", "vals", "shape")

    def __init__(self, rows, cols, vals, shape):
        self.rows = rows
        self.cols = cols
        self.vals = vals
        self.shape = shape


@dataclass(frozen=True)
class AdjPair:
    """A sparse matrix with its transpose structure and the permutation
    linking their value arrays (`bwd.vals == fwd.vals[t_perm]`)."""

    fwd: SparseCOO
    bwd: SparseCOO
    t_perm: torch.Tensor
    host: HostEdges | None = None

    def replace(self, **kw) -> "AdjPair":
        return dataclasses.replace(self, **kw)

    def dropped(self, key: tuple[int, int] | torch.Tensor, keep_rate: float) -> "AdjPair":
        """Edge dropout applied consistently to every layout of the pair:
        each representation masks its own values with the hash of its own
        constant id array (the identity on `fwd`, `t_perm` on `bwd`,
        `blocked.canon` on each packed layout), so one edge gets one draw
        everywhere; survivors are rescaled by 1/keep_rate. `key` is the
        pair of uint32 key words, two integers or an int64 tensor [2] on
        the pair's device (see `ops.dropout.hash_keep_mask`)."""
        if keep_rate >= 1.0:
            return self
        # a fill on the device, not a copy from the host, which would wait
        # for the card
        keep = torch.full((), keep_rate, dtype=torch.float32, device=self.t_perm.device)

        def masked(vals, ids):
            # divide by a device tensor: a CUDA division by a host scalar
            # multiplies by its reciprocal, which can differ in the last bit
            return torch.where(hash_keep_mask(key, ids, keep_rate), vals / keep, 0.0)

        def side(sp: SparseCOO, ids) -> SparseCOO:
            new = sp.replace(vals=masked(sp.vals, ids))
            if sp.blocked is not None:
                b = sp.blocked
                new = new.replace(blocked=b.replace(vals=masked(b.vals, b.canon)))
            return new

        ids = torch.arange(self.fwd.vals.shape[0], device=self.t_perm.device)
        return self.replace(fwd=side(self.fwd, ids), bwd=side(self.bwd, self.t_perm))


def dedup_auto(h_rows, h_cols, shape, row_block: int, threshold: float = 4.0) -> bool:
    """Pick the dedup-gather layout when the pooled within-window column
    multiplicity (nnz / |distinct (window, col) pairs|) reaches
    `threshold` (the JAX package's rule, calibrated there)."""
    h_rows_np = np.asarray(h_rows)
    h_cols_np = np.asarray(h_cols)
    live = h_rows_np < shape[0]
    if not live.any():
        return False
    key = (h_rows_np[live] // row_block).astype(np.int64) * shape[1] + h_cols_np[live]
    n_unique = np.unique(key).shape[0]
    return bool(live.sum() >= threshold * max(n_unique, 1))


def pick_layout(gather_layout: str, h_rows, h_cols, shape) -> tuple[bool, bool]:
    """(dedup, int8) for one matrix under `gather_layout` (module docstring)."""
    if gather_layout == "auto":
        force = os.environ.get("HGDR_DEDUP", "auto")
        dedup = (force == "1" if force in ("0", "1")
                 else dedup_auto(h_rows, h_cols, shape, ROW_BLOCK))
        return dedup, os.environ.get("HGDR_INT8") == "1"
    return gather_layout.startswith("dedup"), gather_layout.endswith("int8")


def attach_blocked(sp: SparseCOO, h_rows, h_cols, h_vals, canon_map=None,
                   bf16: bool = False, gather_layout: str = "auto") -> SparseCOO:
    """Pack the kernel layout from the HOST arrays, on `sp`'s device; the
    layout is chosen by `pick_layout`."""
    use_dedup, int8 = pick_layout(gather_layout, h_rows, h_cols, sp.shape)
    pack = pack_blocked_dedup if use_dedup else pack_blocked
    blocked = pack(h_rows, h_cols, h_vals, sp.shape, bf16=bf16, canon_map=canon_map,
                   device=sp.rows.device)
    return sp.replace(blocked=blocked.replace(int8=int8))


def _maybe_attach_blocked(sp: SparseCOO, h_rows, h_cols, h_vals, canon_map=None,
                          bf16: bool = False, gather_layout: str = "auto") -> SparseCOO:
    """Attach the kernel layout to every matrix on a CUDA device; other
    devices keep the plain COO path."""
    if sp.rows.device.type != "cuda":
        return sp
    if sp.nnz > PALLAS_MAX_NNZ:
        raise ValueError(f"a {sp.nrows}x{sp.ncols} matrix with {sp.nnz} edges is above the "
                         f"{PALLAS_MAX_NNZ} the CUDA segment-SpMM layout takes")
    return attach_blocked(sp, h_rows, h_cols, h_vals, canon_map, bf16, gather_layout)


def make_adj_pair(rows, cols, vals, shape, device: torch.device | str | None = None,
                  pad_multiple: int = 8, bf16: bool = False,
                  gather_layout: str = "auto") -> AdjPair:
    """Build fwd + transpose structure + linking permutation (host-side)."""
    if gather_layout not in GATHER_LAYOUTS:
        raise ValueError(f"gather_layout {gather_layout!r} is not one of {GATHER_LAYOUTS}")
    device = resolve_device(device)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    nnz = rows.shape[0]
    order = sort_pairs(rows, cols)
    rows, cols, vals = rows[order], cols[order], vals[order]

    nnz_pad = max(pad_to_multiple(max(nnz, 1), pad_multiple), pad_multiple)
    pad = nnz_pad - nnz

    f_rows = np.concatenate([rows, np.full(pad, shape[0], np.int64)]).astype(np.int32)
    f_cols = np.concatenate([cols, np.zeros(pad, np.int64)]).astype(np.int32)
    f_vals = np.concatenate([vals, np.zeros(pad, np.float32)])

    t_order = sort_pairs(cols, rows)  # transpose: sort by (col, row)
    b_rows = np.concatenate([cols[t_order], np.full(pad, shape[1], np.int64)]).astype(np.int32)
    b_cols = np.concatenate([rows[t_order], np.zeros(pad, np.int64)]).astype(np.int32)
    t_perm = np.concatenate([t_order, np.arange(nnz, nnz_pad)]).astype(np.int32)
    b_vals = f_vals[t_perm]

    def coo(r, c, v, nr, nc):
        return SparseCOO(
            rows=torch.as_tensor(r, device=device), cols=torch.as_tensor(c, device=device),
            vals=torch.as_tensor(v, device=device), nrows=int(nr), ncols=int(nc), nnz=int(nnz),
        )

    fwd = coo(f_rows, f_cols, f_vals, shape[0], shape[1])
    bwd = coo(b_rows, b_cols, b_vals, shape[1], shape[0])
    return AdjPair(
        fwd=_maybe_attach_blocked(fwd, f_rows, f_cols, f_vals, bf16=bf16,
                                  gather_layout=gather_layout),
        # bwd slots take fwd edge t_perm[src]: canon ids stay in the
        # SHARED fwd edge-id space so dropout masks agree across layouts
        bwd=_maybe_attach_blocked(bwd, b_rows, b_cols, b_vals, canon_map=t_perm, bf16=bf16,
                                  gather_layout=gather_layout),
        t_perm=torch.as_tensor(t_perm, device=device),
        host=HostEdges(rows, cols, vals, (int(shape[0]), int(shape[1]))),
    )


def blockdiag_pair(a: AdjPair, b: AdjPair, device: torch.device | str | None = None,
                   pad_multiple: int = 8, bf16: bool = False,
                   gather_layout: str = "auto") -> AdjPair:
    """blockdiag(A, B) as one AdjPair, from the two pairs' host edge
    snapshots: two independent product chains over A and B (KHGRec's CF
    and KG encoders) run as one product over the stacked node space. The
    kernel layout is packed under `gather_layout` and `bf16`, as the pairs'
    own layouts are."""
    ah, bh = a.host, b.host
    if ah is None or bh is None:
        raise ValueError("blockdiag_pair needs the host edges of both pairs")
    rows = np.concatenate([ah.rows, bh.rows + ah.shape[0]])
    cols = np.concatenate([ah.cols, bh.cols + ah.shape[1]])
    vals = np.concatenate([ah.vals, bh.vals])
    shape = (ah.shape[0] + bh.shape[0], ah.shape[1] + bh.shape[1])
    return make_adj_pair(rows, cols, vals, shape, device, pad_multiple, bf16, gather_layout)


def adj_pair_from_scipy(mat, device: torch.device | str | None = None, pad_multiple: int = 8,
                        bf16: bool = False, gather_layout: str = "auto") -> AdjPair:
    coo = mat.tocoo()
    return make_adj_pair(coo.row, coo.col, coo.data, mat.shape, device, pad_multiple, bf16,
                         gather_layout)


@dataclass(frozen=True)
class EvalData:
    """Padded test-set arrays for fully on-device evaluation."""

    test_users: torch.Tensor  # [n_pad] dense user ids (pad 0)
    user_valid: torch.Tensor  # [n_pad] bool
    test_pos_pad: torch.Tensor  # [n_pad, Tmax] dense item ids; -1 pad, -2 unseen-in-train
    test_counts: torch.Tensor  # [n_pad] int32, includes unseen items
    n_test_users: int
    total_test_interactions: int


@dataclass(frozen=True)
class CFDeviceData:
    """Everything a CF model needs on device; the adjacency
    representations a model does not need are None."""

    adj: AdjPair | None  # normalised (U+I)^2 bipartite
    int_norm: AdjPair | None  # row-normalised U x I
    inv_int_norm: AdjPair | None  # row-normalised I x U
    b_hyper: AdjPair | None  # D_v^-1/2 H D_e^-1/2 (U x I)
    raw_int: AdjPair | None  # unnormalised U x I incidence H
    raw_adj: AdjPair | None  # unnormalised (U+I)^2 bipartite adjacency
    # bip_src[k]: the index into raw_int.fwd's values of the interaction
    # edge behind raw_adj.fwd entry k, so that dropping a (u, i) pair zeroes
    # both of its bipartite entries (SGL's augmented views); pads map to 0,
    # and it is empty when raw_adj is not built
    bip_src: torch.Tensor  # [raw_adj nnz_pad] int32
    edge_u: torch.Tensor  # [n_train] int32
    edge_i: torch.Tensor
    rated_pad: torch.Tensor  # [U, max_deg] dense item ids, pad -1 (eval masking)
    rated_csr: CSRMembership  # O(nnz) membership (the sampler's form past the budget)
    eval_data: EvalData
    n_users: int
    n_items: int
    n_train: int

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    @property
    def sample_membership(self):
        """Membership table for negative sampling: the padded table when
        it fits `PAD_TABLE_BUDGET` (one row gather per test), else the
        O(nnz) CSR binary search."""
        if self.rated_pad.numel() * 4 <= PAD_TABLE_BUDGET:
            return self.rated_pad
        return self.rated_csr

    def replace(self, **kw) -> "CFDeviceData":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class KGDeviceData:
    """Knowledge-graph arrays on device (KHGRec family)."""

    kg_adj: AdjPair  # normalised E x E kg adjacency
    # attention edge list (the kg_train triples), sorted by (head, tail)
    att_h: torch.Tensor  # [n_kg_pad] int32, pad = n_entities
    att_r: torch.Tensor  # [n_kg_pad]
    att_t: torch.Tensor  # [n_kg_pad], pad = 0
    att_valid: torch.Tensor  # [n_kg_pad] bool
    att_t_perm: torch.Tensor  # transpose permutation over the SAME edge list
    att_h_t: torch.Tensor  # transpose structure: rows (=tails) sorted, pad = n_entities
    att_t_t: torch.Tensor  # transpose structure cols (=heads)
    head_tails: object  # per-head true-tail membership: padded tensor or CSRMembership
    user_idx: torch.Tensor  # [n_users] entity ids of CF users (dense order)
    item_idx: torch.Tensor  # [n_items] entity ids of CF items
    n_entities: int
    n_relations: int
    n_kg_train: int

    def replace(self, **kw) -> "KGDeviceData":
        return dataclasses.replace(self, **kw)


CF_FIELDS = ("adj", "int_norm", "inv_int_norm", "b_hyper", "raw_int", "raw_adj")


def build_cf_device_data(
    inter: InteractionData,
    device: torch.device | str | None = None,
    pad_multiple: int = 8,
    eval_user_multiple: int = 256,
    needs: frozenset | set | None = None,
    bf16: bool = False,
    gather_layout: str = "auto",
) -> CFDeviceData:
    """`needs` (from `models.model_data_needs(name)`) selects which
    adjacency representations to build; None builds all of them. Edge
    arrays, rated-item masks and eval data are always built."""
    import scipy.sparse as sp

    device = resolve_device(device)
    unknown = set(needs or ()) - set(CF_FIELDS)
    if unknown:
        raise NotImplementedError(f"adjacency representations not ported yet: {sorted(unknown)}")

    def want(field: str) -> bool:
        return needs is None or field in needs

    def pair(field: str, mat, wanted: bool | None = None):
        if not (want(field) if wanted is None else wanted):
            return None
        return adj_pair_from_scipy(mat, device, pad_multiple, bf16, gather_layout)

    b_hyper = None
    if want("b_hyper"):
        # B = D_v^-1/2 H D_e^-1/2 so that Theta_uu = B B^T (data/graph.py:27-42)
        h_mat = inter.interaction_mat
        dv = np.asarray(h_mat.sum(1)).flatten()
        de = np.asarray(h_mat.sum(0)).flatten()
        with np.errstate(divide="ignore"):
            dv_is = np.power(dv, -0.5)
            de_is = np.power(de, -0.5)
        dv_is[np.isinf(dv_is)] = 0.0
        de_is[np.isinf(de_is)] = 0.0
        b_hyper = pair("b_hyper", (sp.diags(dv_is) @ h_mat @ sp.diags(de_is)).tocsr())

    # the raw bipartite adjacency, each entry tracing back to its interaction
    # edge (the JAX data/device.py:391-413)
    n_users, n_items = inter.n_users, inter.n_items
    raw_adj = None
    bip_src = np.zeros(0, np.int32)
    if want("raw_adj"):
        icoo = inter.interaction_mat.tocoo()
        iorder = sort_pairs(icoo.row, icoo.col)  # raw_int.fwd's order
        iu, ii = icoo.row[iorder], icoo.col[iorder]
        n_int = iu.shape[0]
        src = np.arange(n_int)
        bip_rows = np.concatenate([iu, ii + n_users])
        bip_cols = np.concatenate([ii + n_users, iu])
        border = sort_pairs(bip_rows, bip_cols)
        raw_adj = make_adj_pair(bip_rows[border], bip_cols[border],
                                np.ones(2 * n_int, np.float32), (n_users + n_items,) * 2,
                                device, pad_multiple, bf16, gather_layout)
        # pad entries are inert (their rows are out of range), so any
        # in-range source index does
        pad_n = raw_adj.fwd.nnz_pad - 2 * n_int
        bip_src = np.concatenate([np.concatenate([src, src])[border],
                                  np.zeros(pad_n, np.int64)]).astype(np.int32)

    rated_lists = inter.rated_lists()
    rated = padded_rows_from_lists(rated_lists, fill=-1, pad_multiple=pad_multiple)

    test_users, test_groups, test_counts = inter.test_lists()
    n_tu = len(test_users)
    n_pad = max(pad_to_multiple(max(n_tu, 1), eval_user_multiple), eval_user_multiple)
    tu = np.zeros(n_pad, np.int32)
    tu[:n_tu] = test_users
    valid = np.zeros(n_pad, bool)
    valid[:n_tu] = True
    tmax = max((len(g) for g in test_groups), default=1)
    tmax = max(pad_to_multiple(tmax, pad_multiple), pad_multiple)
    pos = np.full((n_pad, tmax), -1, np.int32)
    for k, g in enumerate(test_groups):
        pos[k, : len(g)] = g[:tmax]
    counts = np.zeros(n_pad, np.int32)
    counts[:n_tu] = test_counts

    def t(a):
        return torch.as_tensor(a, device=device)

    eval_data = EvalData(
        test_users=t(tu), user_valid=t(valid), test_pos_pad=t(pos), test_counts=t(counts),
        n_test_users=int(n_tu), total_test_interactions=int(test_counts.sum()),
    )
    return CFDeviceData(
        adj=pair("adj", inter.norm_adj),
        int_norm=pair("int_norm", inter.norm_interaction_mat),
        inv_int_norm=pair("inv_int_norm", inter.norm_inv_interaction_mat),
        b_hyper=b_hyper,
        raw_int=pair("raw_int", inter.interaction_mat, want("raw_int") or want("raw_adj")),
        raw_adj=raw_adj,
        bip_src=t(bip_src),
        edge_u=t(inter.train_u),
        edge_i=t(inter.train_i),
        rated_pad=t(rated),
        rated_csr=membership_from_lists(rated_lists, device),
        eval_data=eval_data,
        n_users=n_users,
        n_items=n_items,
        n_train=inter.n_cf_train,
    )


def build_kg_device_data(kg: KnowledgeData, device: torch.device | str | None = None,
                         pad_multiple: int = 8, bf16: bool = False,
                         gather_layout: str = "auto") -> KGDeviceData:
    device = resolve_device(device)
    kg_adj = adj_pair_from_scipy(kg.norm_kg_adj, device, pad_multiple, bf16, gather_layout)

    n_kg = kg.h.shape[0]
    order = sort_pairs(kg.h, kg.t)
    h_s, r_s, t_s = kg.h[order], kg.r[order], kg.t[order]
    nnz_pad = max(pad_to_multiple(n_kg, pad_multiple), pad_multiple)
    pad = nnz_pad - n_kg
    h_p = np.concatenate([h_s, np.full(pad, kg.n_entities, np.int32)])
    r_p = np.concatenate([r_s, np.zeros(pad, np.int32)])
    t_p = np.concatenate([t_s, np.zeros(pad, np.int32)])
    valid = np.concatenate([np.ones(n_kg, bool), np.zeros(pad, bool)])

    t_order = sort_pairs(t_s, h_s)
    att_h_t = np.concatenate([t_s[t_order], np.full(pad, kg.n_entities, np.int32)])
    att_t_t = np.concatenate([h_s[t_order], np.zeros(pad, np.int32)])
    t_perm = np.concatenate([t_order, np.arange(n_kg, nnz_pad)]).astype(np.int32)

    def i32(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)

    # exact per-head true-tail membership for the corrupted-tail sampler: a
    # padded [E, max_head_deg] table (one row gather per test) when it fits
    # the budget, else the O(n_kg) sorted CSR
    ht_lists = kg.head_tail_lists()
    max_w = max((len(l) for l in ht_lists), default=1)
    if kg.n_entities * pad_to_multiple(max(max_w, 1), pad_multiple) * 4 <= PAD_TABLE_BUDGET:
        head_tails = i32(padded_rows_from_lists(ht_lists, fill=-1, pad_multiple=pad_multiple))
    else:
        head_tails = membership_from_lists(ht_lists, device)

    return KGDeviceData(
        kg_adj=kg_adj,
        att_h=i32(h_p),
        att_r=i32(r_p),
        att_t=i32(t_p),
        att_valid=torch.as_tensor(valid, device=device),
        att_t_perm=i32(t_perm),
        att_h_t=i32(att_h_t),
        att_t_t=i32(att_t_t),
        head_tails=head_tails,
        user_idx=i32(kg.user_entity_ids),
        item_idx=i32(kg.item_entity_ids),
        n_entities=kg.n_entities,
        n_relations=kg.n_relations,
        n_kg_train=kg.n_kg_train,
    )
