from .base import MODEL_REGISTRY, ModelBundle, build_model, model_data_needs, register_model

# import model modules for their registrations
from . import hccf, hd_family, hgcn, khgrec, lightgcn, mf, sht, ssl_family  # noqa: F401

__all__ = ["MODEL_REGISTRY", "ModelBundle", "build_model", "model_data_needs", "register_model"]
