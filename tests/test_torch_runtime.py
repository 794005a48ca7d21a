"""The port's training runtime against the JAX package on the CPU: the file
loaders (the native library and the plain numpy path), the experiment
variants, reference `.conf` files, the run artifacts, `metrics_from_topk`,
the CLI's flags, `cli.run` end to end on written files, checkpoint/resume
and the refused multi-device flags.

Loaders, variants, configs and artifacts must be equal bit for bit (or
byte for byte); `metrics_from_topk` within 1e-6 (float32 sums of one
order). A resumed run's next epoch equals the uninterrupted run's bit for
bit: the checkpoint holds every tensor and generator state a step reads.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu import cli as jcli
from hypergraph_diffusion_for_recommendation_tpu import data as jd
from hypergraph_diffusion_for_recommendation_tpu.core import make_config as j_make_config
from hypergraph_diffusion_for_recommendation_tpu.data import experiments as jexp
from hypergraph_diffusion_for_recommendation_tpu.data import io as jio
from hypergraph_diffusion_for_recommendation_tpu.eval.metrics import (
    metrics_from_topk as j_metrics_from_topk,
)
from hypergraph_diffusion_for_recommendation_tpu.utils import conf as jconf
from hypergraph_diffusion_for_recommendation_tpu.utils import logging as jlog
from hypergraph_diffusion_for_recommendation_tpu.utils import results as jres
from hypergraph_diffusion_for_recommendation_tpu_torch import cli, native
from hypergraph_diffusion_for_recommendation_tpu_torch import data as td
from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
from hypergraph_diffusion_for_recommendation_tpu_torch.data import experiments as texp
from hypergraph_diffusion_for_recommendation_tpu_torch.data import io as tio
from hypergraph_diffusion_for_recommendation_tpu_torch.eval.metrics import metrics_from_topk
from hypergraph_diffusion_for_recommendation_tpu_torch.models import build_model
from hypergraph_diffusion_for_recommendation_tpu_torch.train import Trainer
from hypergraph_diffusion_for_recommendation_tpu_torch.train.trainer import EpochRecord, FitResult
from hypergraph_diffusion_for_recommendation_tpu_torch.utils import conf as tconf
from hypergraph_diffusion_for_recommendation_tpu_torch.utils import logging as tlog
from hypergraph_diffusion_for_recommendation_tpu_torch.utils import results as tres
from hypergraph_diffusion_for_recommendation_tpu_torch.utils.checkpoint import CheckpointManager

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
INTERACTION_FIXTURES = ["lastfm_slice_tab.txt", "ml1m_slice_comma.txt"]
EXPERIMENTS = ([("full", 0)] + [("missing", p) for p in (0, 10, 20, 30, 40, 50)]
               + [("add_noise", p) for p in (0, 10, 20, 30, 40, 50)]
               + [("cold_start", g) for g in (1, 2, 3, 4)])
ARGVS = [
    [],
    ["--model=KHGRec", "--lrate=0.01", "--batch_size=1024", "--item_ranking=5,10"],
    ["--model=KGAT", "--conv_dim_list=[64, 32]", "--mess_dropout=[0.1, 0.2]", "--resume"],
    ["--model=SASRec", "--experiment=cold_start", "--group_id=3", "--drop_rate=0.5",
     "--export_embeddings", "--save_checkpoints", "--quiet"],
    ["--model=HGNN_HD3", "--experiment=missing", "--missing_pct=20", "--prop_cache_steps=8",
     "--gather_layout=dedup_int8", "--sampler=exact", "--early_stop_smooth=3"],
    ["--model=SHT", "--sht_reg=full", "--mode=wohyper", "--mesh_data=2", "--shard_graph=off",
     "--gpu_id=3", "--async_eval", "--debug_nans", "--conf=x.conf"],
]
RESUME = {
    "LightGCN": dict(embedding_size=16, batch_size=256),
    "CL4SRec": dict(embedding_size=16, batch_size=32, cl_rate=0.1, temp=1.0),
    "KHGRec": dict(hyper_dim=16, relation_dim=8, batch_size=256, batch_size_kg=256),
    "KGAT": dict(embedding_size=16, relation_dim=16, conv_dim_list=(16, 8),
                 mess_dropout=(0.1, 0.1), batch_size=256, batch_size_kg=256),
}


@pytest.fixture(scope="module")
def split():
    return td.synthetic_dataset(n_users=80, n_items=200, mean_degree=15.0, seed=9, with_kg=True)


# -- loaders -------------------------------------------------------------------
@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
@pytest.mark.parametrize("fixture", INTERACTION_FIXTURES)
def test_load_data_set_matches_jax(fixture, plain):
    path = os.path.join(FIX, fixture)
    got = tio.load_data_set(path, plain=plain)
    want = jio.load_data_set(path)
    assert got.dtype == want.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
def test_load_kg_data_matches_jax(plain):
    path = os.path.join(FIX, "lastfm_slice.kg")
    got = tio.load_kg_data(path, plain=plain)
    want = jio.load_kg_data(path)
    assert list(got.columns) == list(want.columns) == ["h", "r", "t"]
    assert list(got.dtypes) == list(want.dtypes)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
def test_written_files_load_back(tmp_path, split, plain):
    train, _, kg = split
    tio.write_interactions(str(tmp_path / "train.txt"), train)
    tio.write_kg(str(tmp_path / "kg.kg"), kg[["h", "r", "t"]].to_numpy())
    np.testing.assert_array_equal(tio.load_data_set(str(tmp_path / "train.txt"), plain=plain),
                                  jio.load_data_set(str(tmp_path / "train.txt")))
    np.testing.assert_array_equal(tio.load_kg_data(str(tmp_path / "kg.kg"), plain).to_numpy(),
                                  kg[["h", "r", "t"]].to_numpy())


@pytest.mark.parametrize("n", [0, 1, 7, 5000, 70000])
def test_native_sort_and_factorize_match_numpy(n):
    rng = np.random.default_rng(n)
    major = rng.integers(0, 70000, n)
    minor = rng.integers(0, 1 << 20, n)
    assert np.array_equal(native.sort_pairs(major, minor), np.lexsort((minor, major)))
    assert np.array_equal(native.sort_pairs(major, minor, plain=True),
                          np.lexsort((minor, major)))
    vals = rng.integers(-50, 3000, n)
    want_codes, want_uniq = pd.factorize(vals)
    for plain in (False, True):
        codes, uniq = native.factorize(vals, plain=plain)
        assert codes.dtype == np.int32 and uniq.dtype == np.int64
        assert np.array_equal(codes, want_codes) and np.array_equal(uniq, want_uniq)


def test_native_library_is_built_and_refuses_negative_keys():
    native.library()
    assert native.library_path().exists()
    with pytest.raises(ValueError, match="negative"):
        native.sort_pairs(np.array([1, -1]), np.array([0, 0]))


# -- experiments and configuration ------------------------------------------------
@pytest.mark.parametrize("experiment,arg", EXPERIMENTS, ids=[f"{e}-{a}" for e, a in EXPERIMENTS])
def test_apply_experiment_matches_jax(split, experiment, arg):
    train, test, _ = split
    kw = dict(missing_pct=arg, noise_pct=arg, group_id=arg or 1)
    got = texp.apply_experiment(train, test, experiment, 60, **kw)
    want = jexp.apply_experiment(train, test, experiment, 60, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_make_split_matches_jax(split):
    pairs = np.concatenate(split[:2])
    for g, w in zip(texp.make_split(pairs, np.random.default_rng(3)),
                    jexp.make_split(pairs, np.random.default_rng(3))):
        assert np.array_equal(g, w)


def test_config_from_conf_matches_jax(tmp_path):
    path = tmp_path / "KHGRec.conf"
    path.write_text("model.name=KHGRec\ndataset=lastfm\nembedding.size=64\nnum.max.epoch=7\n"
                    "batch_size=1024\nlearnRate=0.005\nreg.lambda=0.02\nhyper.size=96\n"
                    "gnn_layer=3\nleaky=0.2\ntemp=0.5\nss_rate=0.05\ndropout=0.1\n"
                    "use.knowledge=true\ntraining.set=train.txt\ntest.set=test.txt\n"
                    "item.ranking=-topN 10,20,50\nnot.a.key=1\nlearnRateDecay=oops\n")
    for overrides in ({}, dict(lrate=0.1, seed=3)):
        got = tconf.config_from_conf(str(path), **overrides)
        want = jconf.config_from_conf(str(path), **overrides)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("argv", ARGVS, ids=[str(i) for i in range(len(ARGVS))])
def test_parse_args_and_overrides_match_jax(argv):
    got, want = cli.parse_args(argv), jcli.parse_args(argv)
    assert vars(got) == vars(want)
    assert cli.extract_overrides(got) == jcli.extract_overrides(want)
    assert dataclasses.asdict(cli.build_config(got)) == dataclasses.asdict(
        jcli.build_config(want))


@pytest.mark.parametrize("bad", ["--experiment=none", "--group_id=5", "--missing_pct=15",
                                 "--gather_layout=fp8", "--sampler=other", "--mode=x"])
def test_parse_args_refuses_what_jax_refuses(bad):
    for parse in (cli.parse_args, jcli.parse_args):
        with pytest.raises(SystemExit):
            parse([bad])


# -- artifacts and metrics ---------------------------------------------------------
def _records():
    rng = np.random.default_rng(0)

    def metrics():
        return {n: {m: round(float(rng.random()), 5) for m in
                    ("hit_ratio", "precision", "recall", "ndcg")} for n in (10, 20)}

    recs = [EpochRecord(ep, float(rng.random()), float(rng.random()),
                        {"train_loss": float(rng.random()), "rec_loss": float(rng.random()),
                         "cl_loss": float(rng.random())}, metrics()) for ep in range(3)]
    return recs, FitResult(best_epoch=2, best_metrics=recs[1].metrics[20],
                           final_metrics=metrics())


def test_run_artifacts_byte_equal(tmp_path):
    recs, result = _records()
    dirs = {}
    for side, mod, make in (("port", tlog, make_config), ("jax", jlog, j_make_config)):
        cfg = make("SASRec", item_ranking=(10, 20), log_dir=str(tmp_path / side / "log"),
                   output_dir=str(tmp_path / side / "results"), experiment="missing",
                   missing_pct=20)
        art = mod.RunArtifacts(cfg)
        for r in recs:
            art.on_epoch(r)
        art.finish(result)
        dirs[side] = art.dir
        assert os.path.relpath(art.dir, tmp_path / side) == os.path.relpath(
            jlog.run_dir(cfg), tmp_path / side)
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"])) and "final_metrics.csv" in names
    for name in names:
        with open(os.path.join(dirs["port"], name), "rb") as a, \
                open(os.path.join(dirs["jax"], name), "rb") as b:
            assert a.read() == b.read(), name
    rows = {side: mod.aggregate_results(str(tmp_path / side / "results"))
            for side, mod in (("port", tres), ("jax", jres))}
    assert rows["port"] == rows["jax"] and rows["port"]
    tres.write_output_csv(rows["port"], str(tmp_path / "port.csv"))
    jres.write_output_csv(rows["jax"], str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_dump_recommendations_byte_equal(tmp_path):
    rng = np.random.default_rng(1)
    ids, scores = rng.integers(0, 30, (4, 5)), rng.random((4, 5))
    hits = rng.random((4, 5)) < 0.3
    args = ([11, 12, 13, 14], np.arange(100, 130), ids, scores, hits)
    tlog.dump_recommendations(str(tmp_path / "a.txt"), *args)
    jlog.dump_recommendations(str(tmp_path / "b.txt"), *args)
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()


@pytest.mark.parametrize("top_ns", [(10, 20, 40), (5,)])
def test_metrics_from_topk_matches_jax(split, top_ns):
    train, test, _ = split
    jcf = jd.build_cf_device_data(jd.build_interaction(train, test), eval_user_multiple=32,
                                  needs=set())
    tcf = td.build_cf_device_data(td.build_interaction(train, test), "cpu",
                                  eval_user_multiple=32, needs=set())
    n_pad = tcf.eval_data.test_users.shape[0]
    assert n_pad == jcf.eval_data.test_users.shape[0]
    top = np.random.default_rng(2).permuted(
        np.tile(np.arange(tcf.n_items, dtype=np.int32), (n_pad, 1)), axis=1)[:, :max(top_ns)]
    # plant hits so that every metric is non-zero
    tp = tcf.eval_data.test_pos_pad.numpy()
    top[:, 0] = np.where(tp[:, 0] >= 0, tp[:, 0], top[:, 0])
    got = metrics_from_topk(torch.as_tensor(top), tcf.eval_data, top_ns, block=32)
    want = j_metrics_from_topk(jnp.asarray(top), jcf.eval_data, top_ns, block=32)
    for k in want:
        assert float(np.asarray(want[k]).min()) > 0
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=k)


# -- the CLI ---------------------------------------------------------------------
def _write_dataset(root, split, name="tiny"):
    train, test, kg = split
    ddir = root / "dataset" / name
    tio.write_interactions(str(ddir / "train.txt"), train)
    tio.write_interactions(str(ddir / "test.txt"), test)
    tio.write_kg(str(ddir / f"processed_{name}.kg"), kg[["h", "r", "t"]].to_numpy())
    return root / "dataset"


@pytest.mark.parametrize("model,extra", [
    ("MF", ["--experiment=missing", "--missing_pct=10", "--lrate=0.05"]),
    ("SASRec", ["--experiment=cold_start", "--group_id=1", "--batch_size=32"]),
])
def test_cli_run_end_to_end_on_written_files(tmp_path, split, model, extra):
    from hypergraph_diffusion_for_recommendation_tpu_torch.eval.serving import Retriever

    data_dir = _write_dataset(tmp_path, split)
    args = cli.parse_args([f"--model={model}", "--dataset=tiny", f"--data_dir={data_dir}",
                           "--max_epoch=3", "--batch_size=256", "--item_ranking=10,20",
                           f"--output_dir={tmp_path / 'results'}", "--quiet",
                           "--export_embeddings", *extra])
    cfg = cli.build_config(args).replace(log_dir=str(tmp_path / "log"), eval_user_batch=64)
    result = cli.run(cfg, quiet=True, device="cpu")
    assert len(result.history) == 3
    rd = tlog.run_dir(cfg)
    with open(os.path.join(rd, "train_performance.csv")) as f:
        assert f.readline() == ("epoch,train_time,test_time,hit@20,precision@20,recall@20,"
                                "ndcg@20\n")
    with open(os.path.join(rd, "loss.csv")) as f:
        assert f.readline().strip().split(",") == ["epoch"] + sorted(result.history[0].losses)
    with open(os.path.join(rd, "final_metrics.csv")) as f:
        assert f.readline() == "topN,hit_ratio,precision,recall,ndcg\n"
    r = Retriever.load(os.path.join(rd, "embeddings.npz"), device="cpu")
    assert r.meta["model"] == model and r.meta["best_epoch"] == result.best_epoch
    ids, scores = r.topk([int(r.id2user[0])], k=5)
    assert ids.shape == (1, 5) and np.isfinite(scores).all()
    # the data the run trained on is the JAX package's for the same config
    want = jcli.load_dataset(jcli.build_config(jcli.parse_args(
        [f"--model={model}", "--dataset=tiny", f"--data_dir={data_dir}", *extra])))
    got = cli.load_dataset(cfg)
    for g, w in zip(got[:2], want[:2]):
        assert np.array_equal(g, w)


def test_cli_main_resumes_from_its_checkpoint(tmp_path, split, capsys):
    data_dir = _write_dataset(tmp_path, split)
    argv = ["--model=LightGCN", "--dataset=tiny", f"--data_dir={data_dir}",
            "--batch_size=256", "--item_ranking=10,20", f"--output_dir={tmp_path / 'r'}",
            "--embedding_size=16", "--save_checkpoints"]
    cfg_kw = dict(log_dir=str(tmp_path / "log"), eval_user_batch=64)
    cfg = cli.build_config(cli.parse_args(argv + ["--max_epoch=10"])).replace(**cfg_kw)
    cli.run(cfg, quiet=True, device="cpu")  # saves after its 10th epoch
    ckpt = CheckpointManager(os.path.join(tlog.run_dir(cfg), "checkpoints"))
    assert ckpt.latest_step() == 9
    ckpt.close()
    cfg = cli.build_config(cli.parse_args(argv + ["--max_epoch=11", "--resume"])
                           ).replace(**cfg_kw)
    result = cli.run(cfg, device="cpu")
    assert "resumed from epoch 10" in capsys.readouterr().out
    assert [h.epoch for h in result.history] == [10]


@pytest.mark.parametrize("flag", [dict(mesh_data=2), dict(mesh_model=4), dict(shard_graph="on")],
                         ids=["mesh_data", "mesh_model", "shard_graph"])
def test_multi_device_flags_raise(flag):
    cfg = make_config("LightGCN", **flag)
    with pytest.raises(NotImplementedError, match="one device"):
        cli.run(cfg, device="cpu")


def test_debug_nans_raises_at_the_first_non_finite_loss(split):
    train, test, _ = split
    tcf = td.build_cf_device_data(td.build_interaction(train, test), "cpu",
                                  eval_user_multiple=64, needs=set())
    b = build_model(make_config("MF", embedding_size=8, batch_size=256), tcf)
    tr = Trainer(b, debug_nans=True)
    assert not tr.graphs
    tr.run_epoch(0)
    with torch.no_grad():
        b.module.user_emb.fill_(float("nan"))
    with pytest.raises((FloatingPointError, RuntimeError)):
        tr.run_epoch(1)


# -- checkpoints -------------------------------------------------------------------
def _state(tr):
    out = {f"param {k}": v.clone() for k, v in tr.bundle.module.state_dict().items()}
    for name, ph in tr._phases.items():
        for i, p in enumerate(tr._params):
            out.update({f"{name} {k} {i}": v.clone() for k, v in ph.opt.state[p].items()})
    out.update({f"extras {k}": v.clone() for k, v in tr.extras.items() if torch.is_tensor(v)})
    for g, gen in zip(("host", "card", "drop"), (tr.host_gen, tr.dev_gen, tr.drop_gen)):
        out[f"gen {g}"] = gen.get_state()
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.fixture
def one_thread():
    """The CPU's multi-threaded backward sums in an order that can change from
    run to run (KGAT's gradients parted in the last bit): one thread, as on
    the card every sum has one fixed order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("model", list(RESUME))
def test_checkpoint_resume_is_bit_for_bit(tmp_path, split, model, one_thread):
    train, test, kg_df = split
    cfg = make_config(model, **RESUME[model], item_ranking=(10, 20), eval_user_batch=64,
                      max_epoch=3, early_stopping_steps=100)

    def trainer():
        rec_data = td.build_interaction(train, test)
        cf = td.build_cf_device_data(rec_data, "cpu", eval_user_multiple=64)
        kg = (td.build_kg_device_data(td.build_knowledge(kg_df, rec_data), "cpu")
              if cfg.use_knowledge else None)
        return Trainer(build_model(cfg, cf, kg))

    ckpt = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    first = trainer()
    first.fit(max_epoch=2, quiet=True, ckpt=ckpt, ckpt_every=1)
    assert ckpt.latest_step() == 1 and ckpt.steps() == [0, 1]

    whole = trainer()
    losses = [whole.run_epoch(ep)[0] for ep in range(2)]
    resumed = trainer()
    assert resumed.restore(ckpt) == 2
    _assert_same(_state(resumed), _state(whole))  # Adam's state created by the restore
    assert [float(g["lr"]) for ph in resumed._phases.values()
            for g in ph.opt.param_groups] == [cfg.lrate] * len(resumed._phases)
    losses.append(whole.run_epoch(2)[0])
    assert resumed.run_epoch(2)[0] == losses[2]
    _assert_same(_state(resumed), _state(whole))
    ckpt.close()


def test_checkpoint_manager_keeps_the_newest_and_reports_failures(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    assert ckpt.latest_step() is None and ckpt.restore() is None
    for step in range(4):
        ckpt.save(step, {"epoch": step, "x": torch.full((3,), float(step)), "n": [step, "a"]})
    assert ckpt.steps() == [2, 3]
    state = ckpt.restore()
    assert state["epoch"] == 3 and torch.equal(state["x"], torch.full((3,), 3.0))
    assert ckpt.restore(2)["n"] == [2, "a"]
    ckpt.save(9, {"bad": lambda: 0})  # torch.save cannot pickle it: the save fails
    with pytest.raises(RuntimeError, match="background checkpoint save failed"):
        ckpt.latest_step()
    ckpt.close()
