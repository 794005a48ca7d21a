"""The system under test: the PyTorch port, driven through its normal path.

`build` hands the port the generated pairs and triples and builds its
device data and model as its CLI does (`build_interaction`,
`build_knowledge`, `build_cf_device_data`, `build_kg_device_data`,
`build_model`); the benchmark then loads its own seeded weights into the
model and gives `train.Trainer` its own initial extras. Nothing else of
the program is read but what it produces: losses, Adam's state,
parameters, encoded tables, evaluation metrics, and its trace.
"""

from __future__ import annotations

import numpy as np


def build(config: dict, train: np.ndarray, test: np.ndarray, kg, device, log):
    """(bundle, its Config, InteractionData) of the configuration's model
    over the generated data, on `device`."""
    import pandas as pd

    from hypergraph_diffusion_for_recommendation_tpu_torch.core.config import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import (
        build_cf_device_data,
        build_interaction,
        build_kg_device_data,
        build_knowledge,
    )
    from hypergraph_diffusion_for_recommendation_tpu_torch.models import (
        build_model,
        model_data_needs,
    )

    cfg = make_config(config["model"], **config["settings"])
    bf16 = cfg.compute_dtype == "bfloat16"
    inter = build_interaction(train, test)
    cf = build_cf_device_data(inter, device, cfg.pad_multiple, cfg.eval_user_batch,
                              needs=model_data_needs(cfg.model), bf16=bf16,
                              gather_layout=cfg.gather_layout)
    kgd = None
    if kg is not None:
        know = build_knowledge(pd.DataFrame(kg, columns=["h", "r", "t"]), inter)
        kgd = build_kg_device_data(know, device, cfg.pad_multiple, bf16=bf16,
                                   gather_layout=cfg.gather_layout)
    bundle = build_model(cfg, cf, kgd)
    for name, (part, field) in adjacencies(bundle, config).items():
        pair = getattr(getattr(bundle, part), field)
        for side in ("fwd", "bwd"):
            b = getattr(pair, side).blocked
            layout = "none" if b is None else ("dedup" if b.dedup else "base") + (
                "_int8" if b.int8 else "") + (" bf16" if b.bf16 else "")
            log(f"[program] {name}.{side}: {pair.fwd.nrows}x{pair.fwd.ncols}, "
                f"{getattr(pair, side).nnz} entries, layout {layout}")
    return bundle, cfg, inter


def adjacencies(bundle, config: dict) -> dict:
    from harness.spec import model_module

    return model_module("counts", config).ADJACENCIES


def load_weights(bundle, weights: dict) -> None:
    """The benchmark's weights into the model's parameters, by name (every
    parameter, no other)."""
    import torch

    with torch.no_grad():
        bundle.module.load_state_dict(weights, strict=True)


def trainer(bundle, seed: int, extras: dict):
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer

    return Trainer(bundle, seed=seed, extras=extras)


def dropout_state(trainer):
    """The state of the generator that the trainer's steps draw their
    in-step randomness from (feature dropout; the loss gets it as its
    `generator`), as `torch.Generator.get_state` gives it. A captured step
    graph registers that generator, so each replay draws from it as an
    eager step would."""
    return trainer.drop_gen.get_state()


def params(bundle) -> dict:
    return {n: p for n, p in bundle.module.named_parameters()}


def step_annotation() -> str:
    """The range the trainer records around each training step, with ':'."""
    from hypergraph_diffusion_for_recommendation_tpu_torch.train.trainer import STEP_ANNOTATION

    return STEP_ANNOTATION + ":"


def spmm_pair():
    from hypergraph_diffusion_for_recommendation_tpu_torch.ops.sparse import spmm_pair as fn

    return fn
