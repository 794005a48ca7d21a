"""Weights for the port's models: carried across from the JAX package, or
initialised natively.

`khgrec_params_from_jax` maps the flax parameter tree of the JAX KHGRec
(`params["params"]`, given as numpy arrays, so this module imports no
JAX) onto `KHGRecModule.state_dict()` names:

  * a flax `Dense` kernel is [in, out]; a torch `Linear` weight is
    [out, in], so Dense kernels are transposed;
  * a flax `LayerNorm`'s `scale` is torch's `weight`.

The self-attention blocks of HGNN and HD2 (`cf_encoder/att_blocks_k`) map
by path as the HD family's modules do (below), their attention kernels
flattened to 2-D first. `init_flax` draws the same distributions the flax
initialisers draw (Xavier-uniform tables with flax's fan convention,
LeCun truncated-normal Dense kernels, zero biases, unit LayerNorm scales)
from a `torch.Generator`, for runs on a machine without JAX.

The HD family's modules and the zoo's (LightGCN, MF, HCCF, HGCN, SHT,
the SSL family, SGL, DHCF, DHCF_diffusion, HCCF_diffusion, KGIN, KGCL,
AutoCF, LRMRec, KGAT, KTUP, HKGRippleNet, MHCN and SEPT) name their
parameters and submodules after flax's, so
`params_from_jax` maps any of their flax trees (parameters or gradients)
by path: `a/b/kernel` -> `a.b.weight` transposed (an attention
`DenseGeneral` kernel flattened to 2-D first), `a/b/scale` -> `a.b.weight`,
any other leaf by its own name. `init_flax` draws flax's default
initialisers for all of them (Xavier-uniform tables, LeCun normal Dense
kernels), `init_hd` adds the `HWNNLayer` ones (`par` from U[0, 0.99),
`diagonal_weight_filter` from U(0.99, 1.01)).
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .core.device import resolve_device

# flax truncated_normal's stddev correction for truncation at +-2 sigma
_TRUNC_STD = 0.87962566103423978


def _xavier_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """flax `xavier_uniform()`: the last axis is fan-out, the one before it
    fan-in, and any leading axes are the receptive field."""
    receptive = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


def _lecun_normal(out_features: int, in_features: int, generator: torch.Generator) -> torch.Tensor:
    """flax `Dense`'s default kernel init, as a torch [out, in] weight."""
    std = math.sqrt(1.0 / in_features) / _TRUNC_STD
    w = torch.empty(out_features, in_features)
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _flax_init(owner: nn.Module, leaf: str, shape: tuple, generator: torch.Generator
               ) -> torch.Tensor:
    """flax's default initialiser of one parameter: a `Dense` kernel (a torch
    `Linear` weight) LeCun truncated-normal, a bias zeros, a `LayerNorm`
    scale ones, a table or any other parameter of two or more axes
    Xavier-uniform (the models' `self.param(..., xavier_uniform(), ...)`)."""
    if isinstance(owner, nn.Linear) and leaf == "weight":
        return _lecun_normal(shape[0], shape[1], generator)
    if leaf == "bias":
        return torch.zeros(shape)
    if isinstance(owner, nn.LayerNorm) and leaf == "weight":
        return torch.ones(shape)
    if len(shape) >= 2:
        return _xavier_uniform(shape, generator)
    raise KeyError(f"no flax initialiser for {type(owner).__name__}.{leaf} {shape}")


def init_flax(module: nn.Module, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A fresh state dict for a module of flax-initialised parameters (the
    KHGRec family and every model of the zoo: Xavier-uniform tables, with
    the leading axes of KGAT's `trans_M` and RippleNet's `relation_mat` as
    flax's receptive field), drawn on
    the CPU from `generator` in state-dict order (so a seed gives the same
    weights on every device) and placed on the module's device. The
    attention projections are flax Dense kernels too (LeCun normal over
    their fan-in)."""
    kinds = dict(module.named_modules())
    out: dict[str, torch.Tensor] = {}
    for name, p in module.state_dict().items():
        owner_name, _, leaf = name.rpartition(".")
        v = _flax_init(kinds[owner_name], leaf, tuple(p.shape), generator)
        out[name] = v.to(device=p.device, dtype=p.dtype)
    return out


def khgrec_params_from_jax(
    params_np: dict, extras_np: dict | None = None, device: torch.device | str | None = None,
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor] | None]:
    """(flax `params["params"]` tree of numpy arrays, JAX extras) ->
    (KHGRecModule state dict, attention extras), on `device` (the GPU
    unless the caller asks for the CPU)."""
    device = resolve_device(device)

    def t(a, transpose: bool = False):
        a = np.asarray(a, np.float32)
        return torch.tensor(a.T if transpose else a, device=device)  # a copy: JAX arrays are read-only

    sd = {
        "user_entity_emb": t(params_np["user_entity_emb"]),
        "relation_emb": t(params_np["relation_emb"]),
        "trans_M": t(params_np["trans_M"]),
    }
    for enc in ("cf_encoder", "kg_encoder"):
        lns = sorted((k for k in params_np[enc] if k.startswith("lns_")),
                     key=lambda k: int(k.split("_")[1]))
        for k in lns:
            i = int(k.split("_")[1])
            sd[f"{enc}.lns.{i}.weight"] = t(params_np[enc][k]["scale"])
            sd[f"{enc}.lns.{i}.bias"] = t(params_np[enc][k]["bias"])
    # flax creates the fusion's parameters only where it runs (modes full
    # and wossl); without them the module's own stay as they are
    att = params_np.get("attention_item")
    if att is not None:
        sd["attention_item.dense0.weight"] = t(att["Dense_0"]["kernel"], transpose=True)
        sd["attention_item.dense0.bias"] = t(att["Dense_0"]["bias"])
        sd["attention_item.dense1.weight"] = t(att["Dense_1"]["kernel"], transpose=True)
    # the self-attention blocks of HGNN and HD2, by flax path
    for k, block in params_np["cf_encoder"].items():
        if k.startswith("att_blocks_"):
            i = k[len("att_blocks_"):]
            sd.update(_flax_tree_to_torch(block, f"cf_encoder.att_blocks.{i}.", device))

    extras = None
    if extras_np is not None:
        extras = {
            "att_h": torch.as_tensor(np.asarray(extras_np["att_h"], np.int32), device=device),
            "att_t": torch.as_tensor(np.asarray(extras_np["att_t"], np.int32), device=device),
            "att_v": torch.as_tensor(np.asarray(extras_np["att_v"], np.float32), device=device),
        }
    return sd, extras


def init_hd(module: nn.Module, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A fresh state dict for an `HDModule`, drawn on the CPU from
    `generator` in state-dict order and placed on the module's device: the
    `HWNNLayer`s' own initialisers, flax's defaults (`_flax_init`) for the
    rest."""
    from .models.layers import HWNNLayer

    kinds = dict(module.named_modules())
    out: dict[str, torch.Tensor] = {}
    for name, p in module.state_dict().items():
        owner_name, _, leaf = name.rpartition(".")
        owner = kinds[owner_name]
        shape = tuple(p.shape)
        if isinstance(owner, HWNNLayer) and leaf == "par":
            v = torch.rand(shape, generator=generator) * 0.99
        elif isinstance(owner, HWNNLayer) and leaf == "diagonal_weight_filter":
            v = 0.99 + 0.02 * torch.rand(shape, generator=generator)
        else:
            v = _flax_init(owner, leaf, shape, generator)
        out[name] = v.to(device=p.device, dtype=p.dtype)
    return out


def _flax_tree_to_torch(tree: Mapping, prefix: str, device) -> dict[str, torch.Tensor]:
    """A flax parameter (or gradient) subtree of numpy arrays -> torch state
    dict entries by path: `a/b/kernel` -> `a.b.weight` as a torch [out, in]
    weight (a `DenseGeneral` kernel of attention, [in, heads, head_dim] or,
    for `out`, [heads, head_dim, out], flattened to 2-D first), `a/b/scale`
    -> `a.b.weight`, a bias flattened to 1-D, any other leaf by its own name."""
    out: dict[str, torch.Tensor] = {}
    for key, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flax_tree_to_torch(v, f"{prefix}{key}.", device))
            continue
        a = np.asarray(v, np.float32)
        if key == "kernel":  # flax Dense [in, out] -> torch Linear [out, in]
            if a.ndim == 3:
                is_out = prefix.rsplit(".", 2)[-2] == "out"
                a = a.reshape(-1, a.shape[-1]) if is_out else a.reshape(a.shape[0], -1)
            key, a = "weight", a.T
        elif key == "scale":  # flax LayerNorm
            key = "weight"
        elif key == "bias":
            a = a.reshape(-1)
        out[prefix + key] = torch.tensor(a, device=device)  # a copy: JAX arrays are read-only
    return out


def params_from_jax(params_np: dict, device: torch.device | str | None = None
                    ) -> dict[str, torch.Tensor]:
    """flax `params["params"]` tree (or a gradient tree of the same shape),
    as numpy arrays, of a model whose torch module names its parameters by
    flax path -> that module's state dict on `device` (the GPU unless the
    caller asks for the CPU). It covers the HD family and every model of
    the zoo: LightGCN, MF, HCCF, HGCN (its `TransformerEncoderLayer_k`
    blocks and their two-head attention kernels), SHT, the SSL family (the
    BUIR and SelfCF `predictor`, the SSL4Rec towers), and the other
    adjacency forms (the ED-HNN wrappers `EquivSetGNNScatter_k` and
    `DenseEquivSetGNN_0`, AutoCF's `gt_layers_0`, LRMRec's `mask_token` and
    its `recon_mlp` `nn.Sequential`, whose Dense layers are `layers_0` and
    `layers_2`), the KG recommenders (KGAT's `entity_user_embed`,
    `relation_embed`, `trans_M` and `aggregators_k` with their `Dense_k` and
    `LayerNorm_k`; KTUP's five tables; RippleNet's `entity_emb` and
    `relation_mat`) and the social models (MHCN's `channel_att`, SEPT's
    tables)."""
    return _flax_tree_to_torch(params_np, "", resolve_device(device))


def kge_params_from_jax(params_np: dict, device: torch.device | str | None = None
                        ) -> dict[str, torch.Tensor]:
    """The JAX `KGEmbeddingTrainer.params` ({"ent": [E, d], "rel": [R, d]},
    as numpy arrays) -> the same tables as tensors on `device` (the GPU
    unless the caller asks for the CPU), for `KGEmbeddingTrainer.load_params`."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(params_np[k], np.float32), device=dev)
            for k in ("ent", "rel")}


def sharded_mf_from_jax(user_table, item_table) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX `ShardedMF`'s initial tables (`np.asarray(mf.user_table)`,
    `np.asarray(mf.item_table)`: full, padded to a multiple of the model
    axis), as the float32 CPU tensors `parallel.ShardedMF(tables=...)`
    takes. JAX draws them with `jax.random`, which torch cannot replay."""
    return (torch.tensor(np.asarray(user_table, np.float32)),
            torch.tensor(np.asarray(item_table, np.float32)))
