from .base import (
    MODEL_REGISTRY,
    ModelBundle,
    build_model,
    model_data_needs,
    model_shard_needs,
    register_model,
)

# import model modules for their registrations
from . import (  # noqa: F401
    autocf,
    dhcf,
    dhcf_diffusion,
    hccf,
    hccf_diffusion,
    hd_family,
    hgcn,
    kgat,
    kgin_kgcl,
    khgrec,
    ktup_ripplenet,
    lightgcn,
    mf,
    sasrec,
    sgl,
    sht,
    social_models,
    ssl_family,
)

__all__ = ["MODEL_REGISTRY", "ModelBundle", "build_model", "model_data_needs", "model_shard_needs",
           "register_model"]
