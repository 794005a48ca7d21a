"""Model bundle + registry — the port of the JAX package's `models/base.py`.

A plain registry maps a model name to a `build(cfg, cf, kg) -> ModelBundle`
factory. In the port a bundle holds its `nn.Module` (which owns the
parameters) and the functions around it; `extras` carries state that the
optimiser does not train (KHGRec's KG attention adjacency, the tables and
the host-integer age of cached propagation).

The KHGRec family and the HD family are registered so far; the rest of
the zoo comes with later slices of the port.
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
    # generator: the torch.Generator on the card that feature dropout draws
    # from (the HD family's; KHGRec has none and ignores it)
    batch_loss: Optional[Callable[..., tuple[torch.Tensor, dict]]] = None
    # adjacencies batch_loss drops edges on, so edge_keys pairs it takes
    n_edge_keys: int = 0
    # whether the reference steps ReduceLROnPlateau for this model
    lr_plateau: bool = True
    # early-stopping patience multiplier (2 for the self-attention encoders)
    early_stop_patience_scale: int = 1


MODEL_REGISTRY: dict[str, Callable[..., ModelBundle]] = {}


def register_model(name: str):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


# Which CFDeviceData adjacency representations each model module's
# builders consume (the JAX package's table, cut to the ported modules)
_MODULE_DATA_NEEDS = {
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
