"""No entry point of the port defaults to the CPU: the port runs on the card
unless the caller asks for the CPU (`core.device.resolve_device`).

An inspection pass walks every function and method of every module of the
port and fails on a parameter named `device` whose default is the CPU. Each
function that once defaulted to the CPU, called without a device where no
card is visible, raises `resolve_device`'s error."""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import hypergraph_diffusion_for_recommendation_tpu_torch as P

_NO_CARD = "no CUDA device is available"


def _modules():
    out = [P]
    for info in pkgutil.walk_packages(P.__path__, P.__name__ + "."):
        out.append(importlib.import_module(info.name))
    return out


def _callables(module):
    """Functions and classes' methods defined in `module`."""
    for _, obj in inspect.getmembers(module):
        if getattr(obj, "__module__", None) != module.__name__:
            continue
        if inspect.isfunction(obj):
            yield obj.__qualname__, obj
        elif inspect.isclass(obj):
            for name, member in vars(obj).items():
                fn = member.__func__ if isinstance(member, (staticmethod, classmethod)) else member
                if inspect.isfunction(fn):
                    yield f"{obj.__qualname__}.{name}", fn


def _is_cpu(default) -> bool:
    if isinstance(default, str):
        return default.split(":")[0] == "cpu"
    return isinstance(default, torch.device) and default.type == "cpu"


def test_no_device_parameter_defaults_to_the_cpu():
    seen, bad = 0, []
    for module in _modules():
        for name, fn in _callables(module):
            try:
                params = inspect.signature(fn).parameters
            except (TypeError, ValueError):
                continue
            p = params.get("device")
            if p is None:
                continue
            seen += 1
            if _is_cpu(p.default):
                bad.append(f"{module.__name__}.{name}")
    assert seen > 20, f"the pass found only {seen} device parameters"
    assert not bad, f"device defaults to the CPU in {bad}"


def _make_mesh():
    from hypergraph_diffusion_for_recommendation_tpu_torch.parallel.mesh import make_mesh

    make_mesh(1, 1)


def _sharded_mf():
    from hypergraph_diffusion_for_recommendation_tpu_torch.parallel.sharded_mf import ShardedMF

    ShardedMF(None, 4, 4, 2)


def _sharded_lightgcn():
    from hypergraph_diffusion_for_recommendation_tpu_torch.parallel.sharded_gcn import (
        ShardedLightGCN,
    )

    ShardedLightGCN(None, sps.eye(4, format="csr", dtype=np.float32), 2, 2, 2)


def _run_ranks():
    from hypergraph_diffusion_for_recommendation_tpu_torch.parallel.check import run_cases
    from hypergraph_diffusion_for_recommendation_tpu_torch.utils.platform import run_ranks

    run_ranks(1, run_cases, (1, 1), "cpu", {})


def _node_dropout_mask():
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.dropout import node_dropout_mask

    node_dropout_mask(None, 8, 0.5)


@pytest.mark.parametrize("call", [_make_mesh, _sharded_mf, _sharded_lightgcn, _run_ranks,
                                  _node_dropout_mask], ids=lambda f: f.__name__.lstrip("_"))
def test_repaired_entry_points_default_to_the_card(monkeypatch, call):
    # wherever the test runs, the card is out of sight: the default must not fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=_NO_CARD):
        call()
