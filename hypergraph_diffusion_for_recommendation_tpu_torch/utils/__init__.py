"""Run artifacts, reference `.conf` files, checkpoints, results
aggregation, cost analysis and trace reading, the supervisor, similarity
measures, dataset tools and converters, and the rank launcher: the port of
the JAX package's `utils/`."""

from .logging import Log, RunArtifacts, dump_recommendations, run_dir
from .profiling import cost_analysis, flops_estimate

__all__ = [
    "Log", "RunArtifacts", "dump_recommendations", "run_dir",
    "cost_analysis", "flops_estimate",
]
