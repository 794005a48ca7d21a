"""The PyTorch port stands alone: importing it (and serving and training
KHGRec, HGNN_HD3, LightGCN, BUIR, SGL, AutoCF, LRMRec, KGIN, KGAT,
HKGRippleNet and MHCN on the CPU, training SASRec through the CLI on
written files, and training RealE through the KG-embedding CLI) pulls in
neither JAX, flax, optax, nor the JAX package."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import hypergraph_diffusion_for_recommendation_tpu_torch as P
from hypergraph_diffusion_for_recommendation_tpu_torch import (
    cli, core, data, eval, kg_embedding_cli, models, native, ops, serving_cli, train, utils,
    weights)
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import (
    build, gather_fusion, segment_spmm)
from hypergraph_diffusion_for_recommendation_tpu_torch.ops import dropout, losses, sampling
from hypergraph_diffusion_for_recommendation_tpu_torch.train import (
    graphs, kg_embedding, optim, recommender, trainer)
from hypergraph_diffusion_for_recommendation_tpu_torch.models import (
    autocf, dhcf, dhcf_diffusion, hccf, hccf_diffusion, hd_family, hgcn, kgat, kgin_kgcl, khgrec,
    ktup_ripplenet, layers, lightgcn, mf, sasrec, sgl, sht, social_models, ssl_family)
from hypergraph_diffusion_for_recommendation_tpu_torch.data import (
    experiments, io, knowledge, normalize, sequence, social, synthetic)
from hypergraph_diffusion_for_recommendation_tpu_torch.utils import (
    checkpoint, conf, logging, results)
from hypergraph_diffusion_for_recommendation_tpu_torch.bench import gather_fusion as probe, timing
{extra}
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                    'hypergraph_diffusion_for_recommendation_tpu'))
print('LEAKED', bad)
sys.exit(1 if bad else 0)
"""

# the facade end to end at a small size, on the CPU
_RUN = """
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data import synthetic_dataset
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender
rec = Recommender(make_config('KHGRec', hyper_dim=16, relation_dim=8, batch_size_kg=64,
                              eval_user_batch=64, item_ranking=(10, 20)), device='cpu')
rec.build(synthetic_dataset(n_users=60, n_items=80, mean_degree=10.0, seed=1, with_kg=True))
rec.init_weights(0)
rec.encode()
assert set(rec.evaluate()) == {10, 20}
# and trains it for one epoch
rec.cfg.max_epoch = 1
assert set(rec.execute()) == {10, 20}
assert len(rec.result.history) == 1
"""

# an HD-family model (no knowledge graph), trained with cached propagation
_RUN_HD = """
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data import synthetic_dataset
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender
rec = Recommender(make_config('HGNN_HD3', hyper_dim=16, batch_size=256, eval_user_batch=64,
                              item_ranking=(10, 20), max_epoch=2, prop_cache_steps=2),
                  device='cpu')
rec.build(synthetic_dataset(n_users=60, n_items=80, mean_degree=10.0, seed=1))
assert rec.bundle.kg is None and rec.cf_dev.b_hyper is not None
out = rec.execute()
assert set(out) == {10, 20}
assert len(rec.result.history) == 2
assert set(rec.result.history[0].losses) == {'train_loss', 'rec_loss', 'reg_loss', 'cl_loss'}
assert rec.extras['prop_age'] == 2 * rec.trainer.n_batches
"""


# the adjacency-only zoo: LightGCN and BUIR (its update_extras hook) for one epoch
_RUN_ZOO = """
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data import synthetic_dataset
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender
data = synthetic_dataset(n_users=60, n_items=80, mean_degree=10.0, seed=1)
for name in ('LightGCN', 'BUIR'):
    rec = Recommender(make_config(name, embedding_size=16, batch_size=128, eval_user_batch=64,
                                  item_ranking=(10, 20), max_epoch=1), device='cpu')
    rec.build(data)
    assert rec.cf_dev.b_hyper is None and rec.bundle.kg is None
    assert set(rec.execute()) == {10, 20}
    assert len(rec.result.history) == 1
    assert 'rec_loss' in rec.result.history[0].losses
assert set(rec.extras) == {'target_u', 'target_i'}
"""


# the other adjacency forms: SGL (epoch_setup's views), AutoCF and LRMRec (the
# refresh and keep branches, the profiles' stand-in) and KGIN (the KG) for one epoch
_RUN_ADJACENCY = """
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data import synthetic_dataset
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender
data = synthetic_dataset(n_users=60, n_items=80, mean_degree=10.0, seed=1, with_kg=True)
for name in ('SGL', 'AutoCF', 'LRMRec', 'KGIN'):
    rec = Recommender(make_config(name, embedding_size=16, batch_size=64, eval_user_batch=64,
                                  item_ranking=(10, 20), max_epoch=1), device='cpu')
    rec.build(data)
    assert set(rec.execute()) == {10, 20}
    assert (rec.bundle.kg is not None) == (name == 'KGIN')
    if name in ('AutoCF', 'LRMRec'):
        assert rec.extras['step'] == rec.trainer.n_batches
"""


# the KG recommenders and the social models: KGAT (the alternating epoch and its
# refresh), HKGRippleNet (its host ripple sets) and MHCN (on the synthetic trust
# network, passed explicitly) for one epoch
_RUN_KG_SOCIAL = """
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data import (
    build_interaction, build_social, synthetic_dataset, synthetic_social)
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender
data = synthetic_dataset(n_users=60, n_items=80, mean_degree=10.0, seed=1, with_kg=True)
inter = build_interaction(data[0], data[1])
social = build_social(synthetic_social(inter, n_per_user=5), inter)
for name in ('KGAT', 'HKGRippleNet', 'MHCN'):
    rec = Recommender(make_config(name, embedding_size=16, relation_dim=16, batch_size=64,
                                  batch_size_kg=128, eval_user_batch=64, item_ranking=(10, 20),
                                  max_epoch=1), device='cpu',
                      social=social if name == 'MHCN' else None)
    rec.build(data)
    assert set(rec.execute()) == {10, 20}
    losses = rec.result.history[0].losses
    if name == 'KGAT':
        assert set(losses) == {'cf_loss', 'kg_loss', 'train_loss'}
        assert rec.extras['att_vals'].abs().sum() > 0
    assert (rec.bundle.kg is not None) == (name != 'MHCN')
"""


# the CLI from written files: SASRec through cli.main on the CPU, the files
# parsed by the native library, its artifacts written and a checkpoint saved
_RUN_CLI = """
import os, tempfile
from hypergraph_diffusion_for_recommendation_tpu_torch import cli, native
from hypergraph_diffusion_for_recommendation_tpu_torch.data import synthetic_dataset
from hypergraph_diffusion_for_recommendation_tpu_torch.data.io import write_interactions
root = tempfile.mkdtemp()
train, test, _ = synthetic_dataset(n_users=60, n_items=80, mean_degree=10.0, seed=1)
write_interactions(os.path.join(root, 'data', 'tiny', 'train.txt'), train)
write_interactions(os.path.join(root, 'data', 'tiny', 'test.txt'), test)
cfg = cli.build_config(cli.parse_args([
    '--model=SASRec', '--dataset=tiny', '--data_dir=' + os.path.join(root, 'data'),
    '--max_epoch=2', '--batch_size=32', '--embedding_size=16', '--item_ranking=10,20',
    '--output_dir=' + os.path.join(root, 'results'), '--save_checkpoints', '--quiet']))
result = cli.run(cfg.replace(log_dir=os.path.join(root, 'log'), eval_user_batch=64), True, 'cpu')
assert len(result.history) == 2 and native.library_path().exists()
run = os.path.join(root, 'results', 'SASRec', 'tiny')
assert 'train_performance.csv' in os.listdir(os.path.join(run, os.listdir(run)[0]))
"""


# the KG-embedding CLI on its synthetic KG, RealE by arity, one epoch
_RUN_KGE = """
from hypergraph_diffusion_for_recommendation_tpu_torch import kg_embedding_cli
m = kg_embedding_cli.main(['--max_epoch', '1', '--dim', '16', '--test_by_arity'], device='cpu')
assert 0.0 <= m.hit10['fil'] <= 1.0 and m.mr['fil'] >= 1.0
"""


def _probe(extra: str = ""):
    return subprocess.run([sys.executable, "-c", _PROBE.format(extra=extra)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_import_pulls_in_no_jax():
    proc = _probe()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_serving_and_training_run_without_jax():
    proc = _probe(_RUN)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_hd_training_runs_without_jax():
    proc = _probe(_RUN_HD)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_zoo_training_runs_without_jax():
    proc = _probe(_RUN_ZOO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_adjacency_forms_training_runs_without_jax():
    proc = _probe(_RUN_ADJACENCY)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_kg_and_social_training_runs_without_jax():
    proc = _probe(_RUN_KG_SOCIAL)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_cli_training_runs_without_jax():
    proc = _probe(_RUN_CLI)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_kg_embedding_runs_without_jax():
    proc = _probe(_RUN_KGE)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout and "arity 2: hit@1" in proc.stdout


def test_no_source_names_jax():
    pkg = REPO / "hypergraph_diffusion_for_recommendation_tpu_torch"
    sources = list(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for src in sources:
        for line in src.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax"), f"{src}: {line}"
                assert top != "hypergraph_diffusion_for_recommendation_tpu", f"{src}: {line}"
