"""Run artifacts, reference `.conf` files, checkpoints and results
aggregation: the port of the JAX package's `utils/` (`logging`, `conf`,
`checkpoint`, `results`)."""

from .logging import Log, RunArtifacts, dump_recommendations, run_dir

__all__ = ["Log", "RunArtifacts", "dump_recommendations", "run_dir"]
