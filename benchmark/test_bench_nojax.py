"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level module names (the port's own name begins with the JAX package's)."""

import json
import subprocess
import sys

from harness.spec import BENCH_DIR, ROOT

PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import run
from harness.small import cells, run_small
for cell in cells():
    run_small(cell)
print(json.dumps(run.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(bench=str(BENCH_DIR), root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_names_are_compared_whole(monkeypatch):
    import run

    for name in ("hypergraph_diffusion_for_recommendation_tpu_torch",
                 "hypergraph_diffusion_for_recommendation_tpu_torch.models", "jaxtyping", "flaxx"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    for name in ("hypergraph_diffusion_for_recommendation_tpu.models", "jax", "optax.tree"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == ["hypergraph_diffusion_for_recommendation_tpu.models",
                                       "jax", "optax.tree"]
