"""Model bundle + registry — the port of the JAX package's `models/base.py`.

A plain registry maps a model name to a `build(cfg, cf, kg) -> ModelBundle`
factory. In the port a bundle holds its `nn.Module` (which owns the
parameters) and the functions around it; `extras` carries state that the
optimiser does not train (KHGRec's KG attention adjacency, the tables and
the host-integer age of cached propagation). A step's new extras have the
same keys, shapes and dtypes at every step, so that the trainer copies
them into fixed buffers (which a CUDA graph of the step reads).

Registered so far: the KHGRec family (KHGRec, HGNN, HD2, HGNNAblation),
the HD family, the models that read only the CF adjacency (LightGCN,
MF, HCCF, HGCN, SHT and the SSL family: DirectAU, SimGCL, XSimGCL, NCL,
MixGCF, SSL4Rec, BUIR, SelfCF), and those of the other adjacency forms
(SGL, DHCF, DHCF_diffusion, HCCF_diffusion, KGIN, KGCL, AutoCF, LRMRec),
the KG recommenders (KGAT with its alternating epoch, KTUP, HKGRippleNet)
the social models (MHCN, SEPT, which take `social`) and the sequential
models (SASRec, CL4SRec, whose bundles carry `seq` and train on sequence
batches).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch import nn

from ..core.config import Config
from ..data.device import CFDeviceData, KGDeviceData

Extras = dict[str, "torch.Tensor | int"]  # tensors, and cached propagation's host-int age


@dataclass
class ModelBundle:
    name: str
    cfg: Config
    cf: CFDeviceData
    kg: Optional[KGDeviceData]
    uses_kg: bool
    module: nn.Module
    # torch.Generator -> extras: initialises `module`'s parameters in place
    # and returns the initial extras
    init: Callable[[torch.Generator], Extras]
    # extras -> (user_emb [U, d], item_emb [I, d]): deterministic, full graph
    encode_eval: Callable[[Extras], tuple[torch.Tensor, torch.Tensor]]
    # (extras, batch, edge_keys, generator=None) -> (loss, aux): the training
    # loss of one batch; aux["_new_extras"], when present, replaces the
    # extras for the NEXT step (KHGRec's attention, KHGRec.py:120-126).
    # edge_keys: one pair of uint32 dropout key words per dropped adjacency;
    # generator: the torch.Generator on the card that the loss's random
    # draws come from (feature dropout, SimGCL's noise, sampled pairs;
    # a model without draws ignores it)
    batch_loss: Optional[Callable[..., tuple[torch.Tensor, dict]]] = None
    # adjacencies batch_loss drops edges on, so edge_keys pairs it takes
    n_edge_keys: int = 0
    # whether the reference steps ReduceLROnPlateau for this model
    lr_plateau: bool = True
    # early-stopping patience multiplier (2 for the self-attention encoders)
    early_stop_patience_scale: int = 1
    # the step's gradients are scaled by min(1, c / (global norm + 1e-6))
    # (the JAX trainer's clip); None leaves them as they are
    grad_clip_norm: Optional[float] = None
    # extras -> the name of the code path `batch_loss` takes on them, read
    # from the host values in the extras (cached propagation: "full" or
    # "cached"); the trainer keeps one CUDA graph of the step per name.
    # None: one path
    step_branch: Optional[Callable[[Extras], str]] = None
    # (extras, batch, generator) -> new extras tensors, run before the loss
    # from the parameters before the step (BUIR's EMA target tables,
    # AutoCF's masked subgraphs); the trainer writes them into the extras
    # buffers in place, inside the step graph. `generator` is the trainer's
    # card generator, registered with the step graphs, that its draws come
    # from (a hook without draws ignores it)
    update_extras: Optional[Callable[[Extras, tuple, torch.Generator], Extras]] = None
    # (extras, generator) -> new extras tensors, run eagerly at the start of
    # each epoch, outside the graphs (NCL's k-means centroids); the trainer
    # copies them into the extras buffers in place, which the graphs read
    epoch_setup: Optional[Callable[[Extras, torch.Generator], Extras]] = None
    # KGAT-style alternating optimisation (KGAT.py:66-125): the epoch runs a
    # CF phase (`batch_loss`, the CF optimiser) over the CF batches, then a KG
    # phase (`kg_batch_loss`, a second optimiser over the same parameters)
    # over KG batches drawn on their own; `epoch_update_extras` runs after both
    alternating: bool = False
    # (extras, kg_batch, edge_keys, generator=None) -> (loss, aux): the KG
    # phase's loss of one (h, r, pos_t, neg_t) batch
    kg_batch_loss: Optional[Callable[..., tuple[torch.Tensor, dict]]] = None
    # (extras, generator) -> new extras tensors, run eagerly after the epoch's
    # steps and before its evaluation (KGAT's attention refresh from the full
    # triple list, KGAT.py:128-133); the trainer copies them into the extras
    # buffers in place, which the graphs read
    epoch_update_extras: Optional[Callable[[Extras, torch.Generator], Extras]] = None
    # batch_loss returns this data rank's share of the global batch's loss
    # (every builder sets it for a mesh whose data axis is above 1: the
    # per-example work over `parallel.mesh.data_share`'s rows, so the data
    # ranks' losses add up to the global one); the trainer then sums the
    # gradients and the loss terms over the data group. False: built without
    # a mesh, or for one data rank
    data_split: bool = False
    # sequential models carry padded sequence arrays (`data.sequence.SeqDeviceData`)
    # and switch the trainer to windowed batches (base/seq_recommender.py)
    seq: Any = None
    batch_kind: str = "pairwise"  # 'pairwise' | 'sequence'


def flax_init(module: nn.Module) -> Callable[[torch.Generator], Extras]:
    """The `init` of a bundle without extras: flax's default initialisers
    (`weights.init_flax`) drawn into `module` in place; no extras."""

    def init(generator: torch.Generator) -> Extras:
        from ..weights import init_flax

        module.load_state_dict(init_flax(module, generator))
        return {}

    return init


MODEL_REGISTRY: dict[str, Callable[..., ModelBundle]] = {}

def register_model(name: str):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


# Which CFDeviceData adjacency representations each model module's
# builders consume (the JAX package's table, cut to the ported modules)
_MODULE_DATA_NEEDS = {
    "mf": frozenset(),
    "sasrec": frozenset(),
    "kgat": frozenset(),
    "ktup_ripplenet": frozenset(),
    "lightgcn": frozenset({"adj"}),
    "hccf": frozenset({"adj"}),
    "hccf_diffusion": frozenset({"adj"}),
    "hgcn": frozenset({"adj"}),
    "sht": frozenset({"adj"}),
    "ssl_family": frozenset({"adj"}),
    "khgrec": frozenset({"adj"}),
    "dhcf": frozenset({"raw_int"}),
    "dhcf_diffusion": frozenset({"raw_int"}),
    "hd_family": frozenset({"adj", "b_hyper"}),
    "kgin_kgcl": frozenset({"adj", "int_norm"}),
    "autocf": frozenset({"adj", "raw_adj"}),
    "sgl": frozenset({"adj", "raw_adj", "raw_int"}),
    "social_models": frozenset({"adj", "inv_int_norm"}),
}


# Which adjacency representations may be built ROW-WINDOW SHARDED for each
# model NAME (the JAX package's table): only representations the model
# touches exclusively through spmm/spmm_pair/two_hop and AdjPair.dropped
# qualify. Scatter-form models (HD, HGNN_HD2) and the augmentation models
# (SGL/AutoCF) keep replicated adjacencies. "kg" marks the KG adjacency.
_MODEL_SHARD_NEEDS = {
    "MF": frozenset(),
    "LightGCN": frozenset({"adj"}),
    "HCCF": frozenset({"adj"}),
    "HGCN": frozenset({"adj"}),
    "SHT": frozenset({"adj"}),
    "HGNN_HD": frozenset({"adj", "b_hyper"}),
    "HGNN_HD3": frozenset({"adj", "b_hyper"}),
    "HGNN_HD4": frozenset({"adj", "b_hyper"}),
    "LocalEncoder": frozenset({"adj", "b_hyper"}),
    "WaveletHD": frozenset({"adj", "b_hyper"}),
    "WaveletHD2": frozenset({"adj", "b_hyper"}),
    "KHGRec": frozenset({"adj", "kg"}),
}


def model_shard_needs(name: str) -> frozenset:
    """Adjacency representations safe to shard for `name` (possibly
    empty). Unlisted models keep fully replicated adjacencies."""
    return _MODEL_SHARD_NEEDS.get(name, frozenset())


def model_data_needs(name: str):
    """Adjacency representations `name`'s builder consumes, or None
    (= build everything) for unregistered names."""
    if name not in MODEL_REGISTRY:
        return None
    mod = MODEL_REGISTRY[name].__module__.rsplit(".", 1)[-1]
    return _MODULE_DATA_NEEDS.get(mod)


def build_model(cfg: Config, cf: CFDeviceData, kg: Optional[KGDeviceData] = None,
                social: Any = None, mesh: Any = None) -> ModelBundle:
    """`social` (a `data.social.SocialData`) goes to the model functions
    that take it (MHCN, SEPT); `mesh` (a `parallel.make_mesh` mesh) to
    every one: each splits its batch's per-example work over the mesh's data
    axis (`ModelBundle.data_split`), and KHGRec looks its entity rows up in
    the row-sharded table through the explicit collective
    (`table_lookup`)."""
    if cfg.model not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model {cfg.model!r}. Registered: {sorted(MODEL_REGISTRY)}")
    import inspect

    fn = MODEL_REGISTRY[cfg.model]
    kw = {"social": social} if "social" in inspect.signature(fn).parameters else {}
    return fn(cfg, cf, kg, mesh=mesh, **kw)
