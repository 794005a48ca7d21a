"""Model bundle + registry — the port of the JAX package's `models/base.py`.

A plain registry maps a model name to a `build(cfg, cf, kg) -> ModelBundle`
factory. In the port a bundle holds its `nn.Module` (which owns the
parameters) and the functions around it; `extras` carries state that the
optimiser does not train (KHGRec's KG attention adjacency, the tables and
the host-integer age of cached propagation). A step's new extras have the
same keys, shapes and dtypes at every step, so that the trainer copies
them into fixed buffers (which a CUDA graph of the step reads).

Registered so far: the KHGRec family (KHGRec, HGNN, HD2, HGNNAblation),
the HD family, and the models that read only the CF adjacency (LightGCN,
MF, HCCF, HGCN, SHT and the SSL family: DirectAU, SimGCL, XSimGCL, NCL,
MixGCF, SSL4Rec, BUIR, SelfCF); the rest of the zoo comes with later
slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

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
    # (extras, batch) -> new extras tensors, run before the loss from the
    # parameters before the step (BUIR's EMA target tables); the trainer
    # writes them into the extras buffers in place, inside the step graph
    update_extras: Optional[Callable[[Extras, tuple], Extras]] = None
    # (extras, generator) -> new extras tensors, run eagerly at the start of
    # each epoch, outside the graphs (NCL's k-means centroids); the trainer
    # copies them into the extras buffers in place, which the graphs read
    epoch_setup: Optional[Callable[[Extras, torch.Generator], Extras]] = None


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
    "lightgcn": frozenset({"adj"}),
    "hccf": frozenset({"adj"}),
    "hgcn": frozenset({"adj"}),
    "sht": frozenset({"adj"}),
    "ssl_family": frozenset({"adj"}),
    "khgrec": frozenset({"adj"}),
    "hd_family": frozenset({"adj", "b_hyper"}),
}


def model_data_needs(name: str):
    """Adjacency representations `name`'s builder consumes, or None
    (= build everything) for unregistered names."""
    if name not in MODEL_REGISTRY:
        return None
    mod = MODEL_REGISTRY[name].__module__.rsplit(".", 1)[-1]
    return _MODULE_DATA_NEEDS.get(mod)


def build_model(cfg: Config, cf: CFDeviceData, kg: Optional[KGDeviceData] = None) -> ModelBundle:
    if cfg.model not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model {cfg.model!r}. Registered: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[cfg.model](cfg, cf, kg)
