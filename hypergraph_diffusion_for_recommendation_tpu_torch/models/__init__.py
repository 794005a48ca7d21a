from .base import MODEL_REGISTRY, ModelBundle, build_model, model_data_needs, register_model

# import model modules for their registrations
from . import hd_family, khgrec  # noqa: F401

__all__ = ["MODEL_REGISTRY", "ModelBundle", "build_model", "model_data_needs", "register_model"]
