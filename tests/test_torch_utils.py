"""The rest of the port's `utils/` against the JAX package on the CPU:

  * `similarity`: `cosine_matrix` and `pearson_matrix` within 1e-6 of
    JAX's; the per-pair forms equal JAX's floats exactly, quirks included
    (the cases of tests/test_similarity.py);
  * `convert`: every file that the converters write (`.inter`, `.item`,
    `.user`, `ratings.txt` and the id maps) byte for byte the JAX
    converter's, for ml-1m, lastfm, amazon-books, yelp and steam from the
    raw dumps of tests/test_convert.py; `kcore_filter`, `atomic_to_ratings`'
    threshold and dedup, `write_atomic`'s refusal of bad fields, the CLI;
  * `dataset_tools`: every file of `main` (splits, missing, noise, cold
    start, edgelist, GraphSAGE JSON), `make_kg_subset`, `merge_edgelists`
    and `shuffle_interactions` byte for byte JAX's for the same seed;
  * `supervisor`: the cases of tests/test_supervisor.py, each report equal
    to the JAX supervisor's (the hang case on the port only: it waits for
    its timeout);
  * `profiling`: a lone matmul counts 2*M*K*N FLOPs (as JAX's cost
    analysis does) and its operands' and output's bytes exactly, on
    concrete, meta and fake tensors; a fake placeholder never reads the
    tensor `fn` closes over; `roofline`'s keys are JAX's;
  * `trace_analysis`: written Chrome traces of known durations,
    correlations and nesting, every field exactly;
  * `Trainer.profile_epoch`: writes a trace and returns `run_epoch`'s loss
    bit for bit from the same restored state.
"""

import filecmp
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu.utils import convert as JC
from hypergraph_diffusion_for_recommendation_tpu.utils import dataset_tools as JD
from hypergraph_diffusion_for_recommendation_tpu.utils import profiling as JPR
from hypergraph_diffusion_for_recommendation_tpu.utils import similarity as JS
from hypergraph_diffusion_for_recommendation_tpu.utils import supervisor as JSUP
from hypergraph_diffusion_for_recommendation_tpu_torch.utils import convert as PC
from hypergraph_diffusion_for_recommendation_tpu_torch.utils import dataset_tools as PD
from hypergraph_diffusion_for_recommendation_tpu_torch.utils import profiling as PPR
from hypergraph_diffusion_for_recommendation_tpu_torch.utils import similarity as PS
from hypergraph_diffusion_for_recommendation_tpu_torch.utils import supervisor as PSUP
from hypergraph_diffusion_for_recommendation_tpu_torch.utils import trace_analysis as TA

PY = sys.executable


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fp:
        fp.write(text)


def _same_tree(a, b):
    """Both directories hold the same files with the same bytes."""
    files_a = sorted(os.path.relpath(os.path.join(r, f), a) for r, _, fs in os.walk(a) for f in fs)
    files_b = sorted(os.path.relpath(os.path.join(r, f), b) for r, _, fs in os.walk(b) for f in fs)
    assert files_a == files_b
    assert files_a
    for f in files_a:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f
    return files_a


# -- similarity --------------------------------------------------------------

@pytest.fixture(scope="module")
def vecs():
    rng = np.random.default_rng(0)
    return rng.standard_normal((6, 12)), rng.standard_normal((4, 12))


@pytest.mark.parametrize("name", ["cosine_matrix", "pearson_matrix"])
@pytest.mark.parametrize("pair", [True, False])
def test_batched_similarity_matches_jax(vecs, name, pair):
    x, y = vecs
    args = (x, y) if pair else (x,)
    got = getattr(PS, name)(*(torch.as_tensor(a) for a in args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(JS, name)(*args)), rtol=0,
                               atol=1e-6)


def test_batched_similarity_zero_rows_match_jax():
    z, v = np.zeros(5), np.arange(5.0)
    got = PS.cosine_matrix(torch.as_tensor(np.stack([z, v]))).numpy()
    np.testing.assert_allclose(got, np.asarray(JS.cosine_matrix(np.stack([z, v]))), atol=1e-6)
    assert got[0, 1] == 0.0


def test_per_pair_similarity_equals_jax(vecs):
    x, y = vecs
    z, v = np.zeros(5), np.arange(5.0)
    dense = [(x[i], y[j]) for i in range(6) for j in range(4)] + [(z, v), (v, v), (z, z)]
    for name in ("cosine", "pearson", "euclidean"):
        for a, b in dense:
            assert getattr(PS, name)(a, b) == getattr(JS, name)(a, b), name
    x1 = {1: 2.0, 2: 1.0, 5: 3.0}
    x2 = {1: 1.0, 5: 2.0, 9: 4.0}
    sparse = [(x1, x2), (x1, {7: 1.0}), ({1: 1.0, 2: 1.0}, {1: 5.0, 9: 1.0}),
              ({1: 1.0}, {1: 1.0}), ({}, x1)]
    for name in ("cosine_sp", "pearson_sp", "euclidean_sp"):
        for a, b in sparse:
            assert getattr(PS, name)(a, b) == getattr(JS, name)(a, b), name
    for sim in ("pcc", "euclidean", "cosine"):
        assert PS.similarity(x1, x2, sim) == JS.similarity(x1, x2, sim)
    # the quirks
    assert PS.pearson_sp({1: 1.0, 2: 1.0}, {1: 5.0, 9: 1.0}) == 1.0
    assert PS.euclidean_sp(x1, x2) == 1.0 / ((4 - 1) + (9 - 4))


# -- convert -----------------------------------------------------------------

def _raw_dumps(raw, name):
    if name == "ml-1m":
        _write(raw + "/ratings.dat",
               "1::1193::5::978300760\n1::661::3::978302109\n2::1193::4::978298413\n")
        _write(raw + "/movies.dat",
               "1193::One Flew Over the Cuckoo's Nest (1975)::Drama\n"
               "661::James and the Giant Peach (1996)::Animation|Children's|Musical\n")
        _write(raw + "/users.dat", "1::F::1::10::48067\n2::M::56::16::70072\n")
    elif name == "lastfm":
        _write(raw + "/user_artists.dat",
               "userID\tartistID\tweight\n2\t51\t13883\n2\t52\t11690\n3\t51\t100\n")
        _write(raw + "/artists.dat", "id\tname\turl\n51\tDuran Duran\thttp://x\n")
    elif name == "amazon-books":
        _write(raw + "/ratings_Books.csv",
               "A1,0001,5.0,1362268800\nA2,0001,1.0,1362268801\nA1,0002,4.0,2\n")
    elif name == "yelp":
        recs = [{"review_id": "r1", "user_id": "uA", "business_id": "b1", "stars": 5.0,
                 "date": "2016-01-01"},
                {"review_id": "r2", "user_id": "uB", "business_id": "b2", "stars": 3.0,
                 "date": "2016-01-02"}]
        _write(raw + "/yelp_academic_dataset_review.json",
               "\n".join(json.dumps(r) for r in recs) + "\n")
    else:
        _write(raw + "/steam_reviews.json",
               "{'username': 'alice', 'product_id': '10', 'hours': 12.5, "
               "'date': '2015-01-01'}\n"
               "{'username': 'bob', 'product_id': '20', 'hours': 1.0}\n"
               "not a record\n")


@pytest.mark.parametrize("name", ["ml-1m", "lastfm", "amazon-books", "yelp", "steam"])
@pytest.mark.parametrize("min_rating, k_core", [(0.0, 0), (4.0, 1)])
def test_converters_write_jax_bytes(tmp_path, name, min_rating, k_core):
    raw = str(tmp_path / "raw")
    _raw_dumps(raw, name)
    want = JC.convert_dataset(name, raw, str(tmp_path / "jax"), min_rating=min_rating,
                              k_core=k_core)
    got = PC.convert_dataset(name, raw, str(tmp_path / "port"), min_rating=min_rating,
                             k_core=k_core)
    assert {k: v[1] for k, v in got.items()} == {k: v[1] for k, v in want.items()}
    files = _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert "ratings.txt" in files and any(f.endswith(".inter") for f in files)


def test_convert_primitives_match_jax(tmp_path):
    pairs = [("u1", "i1"), ("u1", "i2"), ("u1", "i3"), ("u2", "i1"), ("u3", "i1"),
             ("u3", "i2")]
    for k in (1, 2, 3):
        assert PC.kcore_filter(pairs, k) == JC.kcore_filter(pairs, k)
    header = ["user_id:token", "item_id:token", "rating:float"]
    rows = [["u", "i", "5"], ["u", "i", "3"], ["v", "j", "4"], ["w", "j", "2"]]
    for mod, d in ((JC, "jax"), (PC, "port")):
        path = str(tmp_path / d / "d.inter")
        assert mod.write_atomic(path, header, rows) == 4
        assert mod.read_atomic(path) == (header, rows)
        assert mod.atomic_to_ratings(path, str(tmp_path / d / "all.txt")) == 3  # dedup
        assert mod.atomic_to_ratings(path, str(tmp_path / d / "kept.txt"), min_rating=3.5) == 2
        assert mod.atomic_to_ratings(path, str(tmp_path / d / "dups.txt"), dedup=False) == 4
        for bad_header, bad_rows in ((["user_id:int64"], []), ([":token"], []),
                                     (["user_id:token", "item_id:token"], [["u"]])):
            with pytest.raises(ValueError):
                mod.write_atomic(str(tmp_path / d / "bad.inter"), bad_header, bad_rows)
    os.remove(str(tmp_path / "jax" / "bad.inter"))
    os.remove(str(tmp_path / "port" / "bad.inter"))
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_convert_cli_matches_jax(tmp_path, capsys):
    raw = str(tmp_path / "raw")
    _raw_dumps(raw, "lastfm")
    for mod, d in ((JC, "jax"), (PC, "port")):
        assert mod.main(["--dataset", "lastfm", "--input", raw, "--output",
                         str(tmp_path / d), "--k_core", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 6 and [s.replace("/port", "/jax") for s in out[3:]] == out[:3]
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


# -- dataset tools -------------------------------------------------------------

def test_dataset_tools_main_writes_jax_bytes(tmp_path):
    from hypergraph_diffusion_for_recommendation_tpu.data import synthetic_dataset
    from hypergraph_diffusion_for_recommendation_tpu.data.io import write_interactions

    train, test, _ = synthetic_dataset(n_users=60, n_items=150, mean_degree=12.0, seed=5)
    for d in ("jax", "port"):
        write_interactions(str(tmp_path / d / "ratings.txt"), np.concatenate([train, test]))
    make = "splits,missing,noise,coldstart,graphs"
    JD.main(["--dir", str(tmp_path / "jax"), "--make", make, "--seed", "3"])
    PD.main(["--dir", str(tmp_path / "port"), "--make", make, "--seed", "3"])
    files = _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    for f in ("train.txt", "missing/train_50.txt", "add_noise/test_10.txt",
              "cold-start/test_group_4.txt", "edgelist/interaction.edgelist",
              "graphsage/interaction-G.json", "graphsage/interaction-id_map.json"):
        assert f in files, f


def test_dataset_tools_functions_write_jax_bytes(tmp_path):
    from hypergraph_diffusion_for_recommendation_tpu.data import synthetic_dataset
    from hypergraph_diffusion_for_recommendation_tpu.data.io import write_interactions

    train, test, _ = synthetic_dataset(n_users=40, n_items=90, mean_degree=10.0, seed=8)
    for mod, d in ((JD, "jax"), (PD, "port")):
        root = str(tmp_path / d)
        write_interactions(os.path.join(root, "ratings.txt"), np.concatenate([train, test]))
        mod.make_split_files(root, seed=11)
        mod.make_missing_files(root, pcts=(10, 30), seed=12)
        mod.make_noise_files(root, pcts=(20,), seed=13)
        mod.make_coldstart_files(root)
        mod.export_edgelist(train, os.path.join(root, "e", "train.edgelist"))
        mod.export_graphsage_json(train, os.path.join(root, "g"), prefix="tr")
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_kg_subset_and_graph_utils_match_jax(tmp_path):
    src = tmp_path / "src"
    _write(str(src / "inter.txt"), "user\titem\trating\n1\t10\t1\n2\t11\t1\n3\t99\t1\n")
    _write(str(src / "links.tsv"),
           "item_id:token\tentity_id:token\n10\te10\n11\te11\n55\te55\n")
    _write(str(src / "full.kg"),
           "e10\tr1\te20\ne20\tr1\te30\ne30\tr2\te40\ne55\tr1\te56\ne11\tr2\te10\n")
    _write(str(src / "a.edgelist"), "1 2\n2 3\n")
    _write(str(src / "b.edgelist"), "2 3\n3 4\n")
    for mod, d in ((JD, "jax"), (PD, "port")):
        out = tmp_path / d
        got = [mod.make_kg_subset(str(src / "inter.txt"), str(src / "full.kg"),
                                  str(src / "links.tsv"), str(out / f"hop{h}"), hop=h)
               for h in (1, 2, 3)]
        got.append(mod.make_kg_subset(str(src / "inter.txt"), str(src / "full.kg"),
                                      str(src / "links.tsv"), str(out / "r1"), hop=3,
                                      relations={"r1"}))
        got.append(mod.merge_edgelists([str(src / "a.edgelist"), str(src / "b.edgelist")],
                                       str(out / "m.edgelist")))
        mod.shuffle_interactions(str(src / "inter.txt"), str(out / "sh.txt"), seed=1)
        if d == "jax":
            want = got
    assert got == want
    assert want[0] == (2, 2) and want[-1] == 3
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


# -- supervisor ------------------------------------------------------------------

def _crash_once_child(tmp_path, mod_name):
    marker = tmp_path / f"crashed_once_{mod_name}"
    script = tmp_path / f"child_{mod_name}.py"
    script.write_text(
        "import os, sys\n"
        f"marker = {str(marker)!r}\n"
        "if not os.path.exists(marker):\n"
        "    open(marker, 'w').close()\n"
        "    sys.exit(17)\n"
        "assert sys.argv.count('--resume') == 1, sys.argv\n"
        "print('resumed ok')\n")
    return [PY, str(script)]


@pytest.mark.parametrize("case", ["clean", "crash_once", "budget", "resume_arg_off"])
def test_supervisor_reports_as_jax(tmp_path, case):
    reports = []
    for name, mod in (("jax", JSUP), ("port", PSUP)):
        kw = dict(backoff_s=0.0, log=lambda *_: None)
        if case == "clean":
            r = mod.run_supervised([PY, "-c", "print('fine')"], max_restarts=3, **kw)
        elif case == "crash_once":
            r = mod.run_supervised(_crash_once_child(tmp_path, name), max_restarts=2, **kw)
        elif case == "budget":
            r = mod.run_supervised([PY, "-c", "import sys; sys.exit(3)"], max_restarts=1, **kw)
        else:  # restarted verbatim: the child fails while it sees --resume
            r = mod.run_supervised([PY, "-c", "import sys; sys.exit(5 + sys.argv.count('--resume'))"],
                                   max_restarts=2, resume_arg=None, **kw)
        reports.append((r.outcomes, r.final_returncode, r.restarts))
    assert reports[1] == reports[0]
    want = {"clean": (["ok"], 0, 0), "crash_once": (["exit:17", "ok"], 0, 1),
            "budget": (["exit:3", "exit:3"], 3, 1),
            "resume_arg_off": (["exit:5"] * 3, 5, 2)}[case]
    assert reports[1] == want


def test_supervisor_kills_a_hang_by_process_group(tmp_path):
    import time

    marker = tmp_path / "hung_once"
    script = tmp_path / "child.py"
    script.write_text(
        "import os, sys, time\n"
        f"marker = {str(marker)!r}\n"
        "if not os.path.exists(marker):\n"
        "    open(marker, 'w').close()\n"
        "    sys.stdout.write('starting\\n'); sys.stdout.flush()\n"
        "    time.sleep(600)\n"
        "print('recovered')\n")
    t0 = time.monotonic()
    report = PSUP.run_supervised([PY, str(script)], max_restarts=1, hang_timeout=5.0,
                                 backoff_s=0.0, log=lambda *_: None)
    assert report.outcomes == ["hang", "ok"]
    assert report.final_returncode == 0
    assert time.monotonic() - t0 < 60


def test_supervisor_main_matches_jax(capsys):
    for argv, rc in ((["--max_restarts", "0", "--", PY, "-c", "print('x')"], 0),
                     (["--max_restarts", "0", "--", PY, "-c", "import sys; sys.exit(9)"], 9),
                     (["--max_restarts", "0"], 2)):
        assert PSUP.main(argv) == JSUP.main(argv) == rc
    assert "hypergraph_diffusion_for_recommendation_tpu_torch.cli" in PSUP.__doc__


# -- profiling -------------------------------------------------------------------

M, K, N = 64, 128, 32


def test_cost_analysis_counts_a_matmul_as_jax():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from hypergraph_diffusion_for_recommendation_tpu_torch.utils import (
        cost_analysis,
        flops_estimate,
    )

    want_bytes = 4 * (M * K + K * N + M * N)
    jax_flops = JPR.flops_estimate(lambda a, b: a @ b, jax.ShapeDtypeStruct((M, K), jnp.float32),
                                   jax.ShapeDtypeStruct((K, N), jnp.float32))
    assert jax_flops == 2 * M * K * N
    with FakeTensorMode():
        fakes = (torch.empty(M, K), torch.empty(K, N))
    for a, b in ((torch.randn(M, K), torch.randn(K, N)),
                 (torch.empty(M, K, device="meta"), torch.empty(K, N, device="meta")),
                 fakes):
        stats = cost_analysis(lambda x, y: x @ y, a, b)
        assert stats["flops"] == jax_flops
        assert stats["bytes accessed"] == want_bytes
        assert flops_estimate(lambda x, y: x @ y, a, b) == jax_flops


def test_cost_analysis_counts_the_backward():
    a = torch.randn(M, K)
    w = torch.randn(K, N, requires_grad=True)
    stats = PPR.cost_analysis(lambda: (a @ w).sum().backward())
    # forward a @ w, backward a.T @ g (no gradient to `a`)
    assert stats["flops"] == 2 * (2 * M * K * N)


def test_cost_analysis_never_reads_a_closed_over_tensor(monkeypatch):
    """A fake placeholder turns the tensor `fn` closes over into a fake: its
    data is never read (on the card, never copied to the host)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    big = torch.ones(512, 512)
    with FakeTensorMode():
        x = torch.empty(8, 512)

    def refuse(*a, **k):
        raise AssertionError("the closed-over tensor's data was read")

    for name in ("cpu", "numpy", "tolist", "item", "clone", "__array__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    stats = PPR.cost_analysis(lambda t: (t @ big).sum(), x)
    monkeypatch.undo()
    assert stats["flops"] == 2 * 8 * 512 * 512
    assert stats["bytes accessed"] >= 4 * (8 * 512 + 512 * 512 + 8 * 512)


def test_roofline_keys_and_peaks():
    want = JPR.roofline(2e12, 1e12, 1.0, device=type("D", (), {"device_kind": "unknown"})())
    got = PPR.roofline(2e12, 1e12, 1.0, device="unknown")
    assert got == want  # unknown devices: raw rates, zero shares
    h100 = PPR.roofline(989.4e12, 3.35e12, 2.0, device="NVIDIA H100 80GB HBM3")
    assert set(h100) == set(want)
    assert h100["mfu"] == 0.5 and h100["hbm_util"] == 0.5
    assert h100["ridge_intensity"] == 989.4e12 / 3.35e12
    assert not any(k.startswith("TPU") for k in PPR.GPU_PEAKS)


# -- trace analysis ---------------------------------------------------------------

def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _trace_events():
    """Two executions of "train_step:cf" on thread (1, 1): the first an eager
    launch and a copy (the copy inside a nested Adam annotation), the second
    a graph launch of two kernels on stream 7 and a kernel on stream 9;
    launches outside the ranges, or on another thread, do not count."""
    return [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "args": {"name": "python"}},
        _x("user_annotation", "train_step:cf", 100, 100),
        _x("user_annotation", "Optimizer.step#Adam.step", 115, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 3, correlation=1),
        _x("kernel", "void segment_spmm_rows_kernel<float>", 150, 20, pid=0, tid=7, stream=7,
           correlation=1),
        _x("cuda_runtime", "cudaMemcpyAsync", 120, 2, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 175, 5, pid=0, tid=7, stream=7,
           correlation=2, bytes=4096),
        _x("user_annotation", "train_step:cf", 300, 100),
        _x("cuda_runtime", "cudaGraphLaunch", 310, 4, correlation=3),
        _x("kernel", "void add_kernel", 350, 10, pid=0, tid=7, stream=7, correlation=3),
        _x("kernel", "void segment_spmm_dedup_kernel", 362, 8, pid=0, tid=7, stream=7,
           correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 320, 3, correlation=4),
        _x("kernel", "void side_kernel", 355, 30, pid=0, tid=9, stream=9, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 500, 3, correlation=5),
        _x("kernel", "void later_kernel", 520, 50, pid=0, tid=7, stream=7, correlation=5),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 3, tid=2, correlation=6),
        _x("kernel", "void other_thread_kernel", 160, 40, pid=0, tid=7, stream=7, correlation=6),
        _x("cpu_op", "aten::mm", 130, 5),
    ]


@pytest.fixture
def trace_dir(tmp_path):
    d = tmp_path / "trace"
    _write(str(d / "old.pt.trace.json"), json.dumps({"traceEvents": []}))
    os.utime(str(d / "old.pt.trace.json"), (1, 1))
    _write(str(d / "sub" / "epoch_0.1.pt.trace.json"), json.dumps({"traceEvents": _trace_events()}))
    return str(d)


def test_newest_trace(trace_dir):
    assert TA.newest_trace(trace_dir).endswith("epoch_0.1.pt.trace.json")
    with pytest.raises(FileNotFoundError):
        TA.newest_trace(os.path.join(trace_dir, "nothing"))


def test_device_program_stats_reads_every_field(trace_dir):
    stats = TA.device_program_stats(trace_dir)
    assert set(stats) == {"train_step:cf", "Optimizer.step#Adam.step"}
    ps = stats["train_step:cf"]
    assert ps.program_id == "train_step:cf" and ps.n_executions == 2
    assert ps.module_dur_s == 0.0 + (180.0 - 150.0) / 1e6 + (385.0 - 350.0) / 1e6
    assert ps.ops_dur_s == 0.0 + 20.0 / 1e6 + 5.0 / 1e6 + 10.0 / 1e6 + 8.0 / 1e6
    assert ps.bytes == 4096 and ps.flops == 0
    assert set(ps.ops) == {"void segment_spmm_rows_kernel<float>",
                           "Memcpy DtoD (Device -> Device)", "void add_kernel",
                           "void segment_spmm_dedup_kernel", "void side_kernel"}
    want = {"void segment_spmm_rows_kernel<float>": ("custom-call", 20.0, 0, False),
            "Memcpy DtoD (Device -> Device)": ("memcpy", 5.0, 4096, False),
            "void add_kernel": ("kernel", 10.0, 0, False),
            "void segment_spmm_dedup_kernel": ("custom-call", 8.0, 0, False),
            "void side_kernel": ("kernel", 30.0, 0, True)}
    for name, (cat, dur, byt, is_async) in want.items():
        op = ps.ops[name]
        assert (op.name, op.category, op.dur_s, op.bytes, op.flops, op.count, op.is_async) == (
            name, cat, 0.0 + dur / 1e6, byt, 0, 1, is_async)
    adam = stats["Optimizer.step#Adam.step"]
    assert (adam.n_executions, adam.module_dur_s, adam.ops_dur_s, adam.bytes) == (
        1, 0.0 + 5.0 / 1e6, 0.0 + 5.0 / 1e6, 4096)
    assert TA.main_program(stats) is ps
    with pytest.raises(ValueError):
        TA.main_program({})


def test_trace_roofline_reads_every_key(trace_dir):
    jax_keys = {"program_id", "n_executions", "device_s_per_exec", "measured_gbps",
                "measured_hbm_util", "measured_tflops", "measured_mfu", "bytes_per_exec",
                "xla_bytes_per_exec", "extra_bytes_per_exec", "flops_per_exec",
                "custom_call_s_per_exec", "pallas_gbps", "op_time_coverage", "top_ops"}
    r = TA.trace_roofline(trace_dir, top_k=3, extra_bytes_per_exec=1e5,
                          cost={"flops": 1e6, "bytes accessed": 2e6})
    assert set(r) == jax_keys
    ops_s = 0.0 + 20.0 / 1e6 + 5.0 / 1e6 + 10.0 / 1e6 + 8.0 / 1e6
    span_s = 0.0 + 30.0 / 1e6 + 35.0 / 1e6
    per_exec = ops_s / 2
    cc = (0.0 + 20.0 / 1e6 + 8.0 / 1e6) / 2
    assert r["program_id"] == "train_step:cf" and r["n_executions"] == 2
    assert r["device_s_per_exec"] == per_exec
    assert r["bytes_per_exec"] == 2e6 + 1e5 and r["xla_bytes_per_exec"] == 2e6
    assert r["extra_bytes_per_exec"] == 1e5 and r["flops_per_exec"] == 1e6
    assert r["measured_gbps"] == (2e6 + 1e5) / per_exec / 1e9
    assert r["measured_tflops"] == 1e6 / per_exec / 1e12
    assert r["custom_call_s_per_exec"] == cc
    assert r["pallas_gbps"] == (1e5 / cc) / 1e9
    assert r["op_time_coverage"] == ops_s / span_s
    assert [(o["name"], o["category"], o["dur_ms_per_exec"]) for o in r["top_ops"]] == [
        ("void segment_spmm_rows_kernel<float>", "custom-call", (0.0 + 20.0 / 1e6) * 1e3 / 2),
        ("void add_kernel", "kernel", (0.0 + 10.0 / 1e6) * 1e3 / 2),
        ("void segment_spmm_dedup_kernel", "custom-call", (0.0 + 8.0 / 1e6) * 1e3 / 2)]
    assert r["top_ops"][0]["share"] == (0.0 + 20.0 / 1e6) / span_s
    if not torch.cuda.is_available():  # an unknown device: zero shares, as in JAX
        assert r["measured_mfu"] == 0.0 and r["measured_hbm_util"] == 0.0
    adam = TA.trace_roofline(trace_dir, program="Optimizer.step#Adam.step")
    assert adam["n_executions"] == 1 and adam["pallas_gbps"] is None
    assert adam["xla_bytes_per_exec"] == 0.0


# -- Trainer.profile_epoch ------------------------------------------------------------

def test_profile_epoch_writes_a_trace_and_returns_run_epochs_loss(tmp_path):
    from hypergraph_diffusion_for_recommendation_tpu_torch.core import make_config
    from hypergraph_diffusion_for_recommendation_tpu_torch.data import synthetic_dataset
    from hypergraph_diffusion_for_recommendation_tpu_torch.train import Recommender, Trainer
    from hypergraph_diffusion_for_recommendation_tpu_torch.train.trainer import STEP_ANNOTATION

    rec = Recommender(make_config("LightGCN", batch_size=256, embedding_size=16,
                                  item_ranking=(10,), eval_user_batch=64), device="cpu")
    rec.build(synthetic_dataset(n_users=120, n_items=300, mean_degree=20.0, seed=3))
    tr = Trainer(rec.bundle, seed=0)
    tr.run_epoch(0)
    state = tr.snapshot(optimizer=True)
    want = tr.run_epoch(1)
    tr.restore(state)
    got = tr.profile_epoch(str(tmp_path / "trace"), 1)
    assert got == want  # the loss and every aux term, bit for bit
    path = TA.newest_trace(str(tmp_path / "trace"))
    assert os.path.basename(path).startswith("epoch_1.")
    stats = TA.device_program_stats(str(tmp_path / "trace"))
    ps = stats[f"{STEP_ANNOTATION}:cf"]
    assert ps.n_executions == tr.n_batches
    assert ps.ops == {}  # on the CPU no device op runs
