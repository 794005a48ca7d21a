"""Weights for the port's models: carried across from the JAX package, or
initialised natively.

`khgrec_params_from_jax` maps the flax parameter tree of the JAX KHGRec
(`params["params"]`, given as numpy arrays, so this module imports no
JAX) onto `KHGRecModule.state_dict()` names:

  * a flax `Dense` kernel is [in, out]; a torch `Linear` weight is
    [out, in], so Dense kernels are transposed;
  * a flax `LayerNorm`'s `scale` is torch's `weight`.

`init_khgrec` draws the same distributions the flax initialisers draw
(Xavier-uniform tables with flax's fan convention, LeCun truncated-normal
Dense kernels, zero biases, unit LayerNorm scales) from a
`torch.Generator`, for runs on a machine without JAX.

The HD family's modules name their submodules after flax's auto-names, so
`hd_params_from_jax` maps any flax tree of an `HDModule` (its parameters
or their gradients) by path: `a/b/kernel` -> `a.b.weight` transposed,
`a/b/scale` -> `a.b.weight`, any other leaf by its own name. `init_hd`
draws flax's initialisers for it (`HWNNLayer`: `par` from U[0, 0.99),
`diagonal_weight_filter` from U(0.99, 1.01), a Xavier `weight_matrix`).
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


def init_khgrec(module: nn.Module, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A fresh state dict for a `KHGRecModule`, drawn on the CPU from
    `generator` (so a seed gives the same weights on every device) and
    placed on the module's device."""
    out: dict[str, torch.Tensor] = {}
    for name, p in module.state_dict().items():
        if name in ("user_entity_emb", "relation_emb", "trans_M"):
            v = _xavier_uniform(tuple(p.shape), generator)
        elif name.endswith("dense0.weight") or name.endswith("dense1.weight"):
            v = _lecun_normal(p.shape[0], p.shape[1], generator)
        elif name.endswith(".bias"):
            v = torch.zeros(p.shape)
        elif name.endswith(".weight"):  # LayerNorm scale
            v = torch.ones(p.shape)
        else:
            raise KeyError(f"init_khgrec: no initialiser for {name}")
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
    att = params_np["attention_item"]
    sd["attention_item.dense0.weight"] = t(att["Dense_0"]["kernel"], transpose=True)
    sd["attention_item.dense0.bias"] = t(att["Dense_0"]["bias"])
    sd["attention_item.dense1.weight"] = t(att["Dense_1"]["kernel"], transpose=True)

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
    `generator` in state-dict order and placed on the module's device."""
    from .models.layers import HWNNLayer

    kinds = dict(module.named_modules())
    out: dict[str, torch.Tensor] = {}
    for name, p in module.state_dict().items():
        owner_name, _, leaf = name.rpartition(".")
        owner = kinds[owner_name]
        shape = tuple(p.shape)
        if isinstance(owner, HWNNLayer):
            if leaf == "par":
                v = torch.rand(shape, generator=generator) * 0.99
            elif leaf == "diagonal_weight_filter":
                v = 0.99 + 0.02 * torch.rand(shape, generator=generator)
            else:
                v = _xavier_uniform(shape, generator)
        elif leaf in ("user_emb", "item_emb"):
            v = _xavier_uniform(shape, generator)
        elif isinstance(owner, nn.Linear) and leaf == "weight":
            v = _lecun_normal(shape[0], shape[1], generator)
        elif leaf == "bias":
            v = torch.zeros(shape)
        elif isinstance(owner, nn.LayerNorm) and leaf == "weight":
            v = torch.ones(shape)
        else:
            raise KeyError(f"init_hd: no initialiser for {name}")
        out[name] = v.to(device=p.device, dtype=p.dtype)
    return out


def hd_params_from_jax(params_np: dict, device: torch.device | str | None = None
                       ) -> dict[str, torch.Tensor]:
    """flax `params["params"]` tree of an HD model (or a gradient tree of
    the same shape), as numpy arrays -> `HDModule` state dict on `device`
    (the GPU unless the caller asks for the CPU)."""
    device = resolve_device(device)
    out: dict[str, torch.Tensor] = {}

    def walk(tree: dict, prefix: str) -> None:
        for key, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{key}.")
                continue
            a = np.asarray(v, np.float32)
            if key == "kernel":  # flax Dense [in, out] -> torch Linear [out, in]
                key, a = "weight", a.T
            elif key == "scale":  # flax LayerNorm
                key = "weight"
            out[prefix + key] = torch.tensor(a, device=device)  # a copy: JAX arrays are read-only

    walk(params_np, "")
    return out
