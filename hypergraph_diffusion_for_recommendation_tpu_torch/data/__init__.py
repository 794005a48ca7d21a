from .dataset import InteractionData, build_interaction
from .device import (
    AdjPair,
    CFDeviceData,
    EvalData,
    KGDeviceData,
    adj_pair_from_scipy,
    build_cf_device_data,
    build_kg_device_data,
    make_adj_pair,
)
from .experiments import apply_experiment
from .knowledge import KnowledgeData, build_knowledge
from .social import SocialData, build_social, synthetic_social
from .synthetic import synthetic_dataset

__all__ = [
    "InteractionData",
    "build_interaction",
    "AdjPair",
    "CFDeviceData",
    "EvalData",
    "KGDeviceData",
    "adj_pair_from_scipy",
    "build_cf_device_data",
    "build_kg_device_data",
    "make_adj_pair",
    "apply_experiment",
    "KnowledgeData",
    "build_knowledge",
    "SocialData",
    "build_social",
    "synthetic_social",
    "synthetic_dataset",
]
