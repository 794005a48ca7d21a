"""Offline dataset-preparation tooling — the port of the JAX package's
`utils/dataset_tools.py`, on the port's `data/experiments.py` and
`data/io.py` (byte for byte the same files for the same seed). Parity with reference
`dataset_util.py` (split/missing/noise/cold-start file generation) and
`util/graph/get_graph.py` (edgelist / GraphSAGE-JSON graph exporters,
without the networkx dependency).

CLI:
    python -m hypergraph_diffusion_for_recommendation_tpu_torch.utils.dataset_tools \
        --dir ./dataset/lastfm --make splits,missing,noise,coldstart,graphs
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.experiments import (
    add_noise_variant,
    cold_start_variant,
    make_split,
    missing_variant,
)
from ..data.io import load_data_set, write_interactions


def make_split_files(dir_: str, infile: str = "ratings.txt", seed: int = 0) -> None:
    """75/25 split -> train.txt/test.txt (dataset_util.py:20-37)."""
    pairs = load_data_set(os.path.join(dir_, infile))
    rng = np.random.default_rng(seed)
    train, test = make_split(pairs, rng)
    write_interactions(os.path.join(dir_, "train.txt"), train)
    write_interactions(os.path.join(dir_, "test.txt"), test)


def make_missing_files(dir_: str, pcts=(10, 20, 30, 40, 50), seed: int = 0) -> None:
    """missing/train_<p>.txt + test_<p>.txt (dataset_util.py:39-59)."""
    train = load_data_set(os.path.join(dir_, "train.txt"))
    test = load_data_set(os.path.join(dir_, "test.txt"))
    rng = np.random.default_rng(seed)
    for p in pcts:
        tr, te = missing_variant(train, test, p, rng)
        write_interactions(os.path.join(dir_, "missing", f"train_{p}.txt"), tr)
        write_interactions(os.path.join(dir_, "missing", f"test_{p}.txt"), te)


def make_noise_files(dir_: str, pcts=(10, 20, 30, 40, 50), seed: int = 0) -> None:
    """add_noise/train_<p>.txt + test_<p>.txt (dataset_util.py:115-199)."""
    train = load_data_set(os.path.join(dir_, "train.txt"))
    test = load_data_set(os.path.join(dir_, "test.txt"))
    rng = np.random.default_rng(seed)
    for p in pcts:
        tr, te = add_noise_variant(train, test, p, rng)
        write_interactions(os.path.join(dir_, "add_noise", f"train_{p}.txt"), tr)
        write_interactions(os.path.join(dir_, "add_noise", f"test_{p}.txt"), te)


def make_coldstart_files(dir_: str) -> None:
    """cold-start/train.txt + test_group_{1..4}.txt (dataset_util.py:61-109)."""
    train = load_data_set(os.path.join(dir_, "train.txt"))
    test = load_data_set(os.path.join(dir_, "test.txt"))
    write_interactions(os.path.join(dir_, "cold-start", "train.txt"), train)
    for g in (1, 2, 3, 4):
        _, te = cold_start_variant(train, test, g)
        write_interactions(os.path.join(dir_, "cold-start", f"test_group_{g}.txt"), te)


def export_edgelist(pairs: np.ndarray, path: str) -> None:
    """Plain space-delimited edgelist (get_graph.py:61 nx.write_edgelist)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for u, v in pairs[:, :2]:
            f.write(f"{int(u)} {int(v)}\n")


def export_graphsage_json(pairs: np.ndarray, out_dir: str, prefix: str = "interaction") -> None:
    """GraphSAGE-style artefacts: <prefix>-G.json (node-link graph),
    <prefix>-id_map.json (get_graph.py:63-75), without networkx."""
    os.makedirs(out_dir, exist_ok=True)
    nodes = np.unique(pairs[:, :2])
    id_map = {str(int(n)): k for k, n in enumerate(nodes)}
    g = {
        "directed": True,
        "multigraph": False,
        "graph": {},
        "nodes": [{"id": str(int(n)), "test": False, "val": False} for n in nodes],
        "links": [
            {"source": str(int(u)), "target": str(int(v))} for u, v in pairs[:, :2]
        ],
    }
    with open(os.path.join(out_dir, f"{prefix}-G.json"), "w") as f:
        json.dump(g, f)
    with open(os.path.join(out_dir, f"{prefix}-id_map.json"), "w") as f:
        json.dump(id_map, f)


def make_kg_subset(
    inter_file: str,
    kg_file: str,
    link_file: str,
    out_prefix: str,
    hop: int = 1,
    relations: set[str] | None = None,
) -> tuple[int, int]:
    """n-hop KG subset around the interaction items' linked entities.

    Capability parity with the reference's vendored conversion tool
    (util/knowledge/conversion_tools/add_knowledge.py ->
    KGDataset.generate_link/generate_knowledge): given interactions, a
    full KG triple dump (h \\t r \\t t) and an item->entity link table,
    writes `<out_prefix>.link` (links restricted to items that actually
    appear in the interactions) and `<out_prefix>.kg` (every triple
    within `hop` hops of the seed entities, frontier-expanded exactly
    like extract_hop_graph: a triple joins when its head OR tail touches
    the frontier). Returns (n_links, n_triples)."""
    assert hop <= 3, "hop must be less than 4 (reference add_knowledge.py:24)"
    pairs = load_data_set(inter_file)
    items = {str(int(i)) for i in np.unique(pairs[:, 1].astype(np.int64))}

    seed_link: dict[str, str] = {}
    with open(link_file) as fp:
        for line in fp:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2 or parts[1] == "entity_id:token":
                continue
            if parts[0] in items:
                seed_link[parts[0]] = parts[1]

    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    with open(out_prefix + ".link", "w") as fp:
        fp.write("item_id:token\tentity_id:token\n")
        for item, ent in seed_link.items():
            fp.write(f"{item}\t{ent}\n")

    frontier = set(seed_link.values())
    history: set[str] = set()
    kept: list[str] = []
    seen: set[str] = set()
    for _ in range(hop):
        history |= frontier
        new_frontier: set[str] = set()
        with open(kg_file) as fp:
            for line in fp:
                h, r, t = line.rstrip("\n").split("\t")[:3]
                if relations is not None and r not in relations:
                    continue
                if h in frontier or t in frontier:
                    row = f"{h}\t{r}\t{t}\n"
                    # deduped (the reference re-appends hop-k triples whose
                    # endpoints re-enter the hop-k+1 frontier)
                    if row not in seen:
                        seen.add(row)
                        kept.append(row)
                    new_frontier.add(h)
                    new_frontier.add(t)
        frontier = new_frontier - history
    with open(out_prefix + ".kg", "w") as fp:
        fp.writelines(kept)
    return len(seed_link), len(kept)


def merge_edgelists(paths: list[str], out_path: str) -> int:
    """Concatenate + dedupe edgelists (util/graph/merge_graphs.py role)."""
    edges: set[tuple[str, str]] = set()
    for p in paths:
        with open(p) as fp:
            for line in fp:
                a = line.split()
                if len(a) >= 2:
                    edges.add((a[0], a[1]))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fp:
        for a, b in sorted(edges):
            fp.write(f"{a} {b}\n")
    return len(edges)


def shuffle_interactions(path: str, out_path: str, seed: int = 0) -> None:
    """Line-shuffle an interaction file (util/graph/shuffle_graph.py role)."""
    with open(path) as fp:
        lines = fp.readlines()
    header, body = lines[:1], lines[1:]
    np.random.default_rng(seed).shuffle(body)
    with open(out_path, "w") as fp:
        fp.writelines(header + body)


def main(argv=None):
    p = argparse.ArgumentParser(description="Dataset preparation tooling")
    p.add_argument("--dir", required=True)
    p.add_argument("--infile", default="ratings.txt")
    p.add_argument("--make", default="splits",
                   help="comma list: splits,missing,noise,coldstart,graphs")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    steps = set(args.make.split(","))
    if "splits" in steps:
        make_split_files(args.dir, args.infile, args.seed)
    if "missing" in steps:
        make_missing_files(args.dir, seed=args.seed)
    if "noise" in steps:
        make_noise_files(args.dir, seed=args.seed)
    if "coldstart" in steps:
        make_coldstart_files(args.dir)
    if "graphs" in steps:
        pairs = load_data_set(os.path.join(args.dir, "train.txt"))
        export_edgelist(pairs, os.path.join(args.dir, "edgelist", "interaction.edgelist"))
        export_graphsage_json(pairs, os.path.join(args.dir, "graphsage"))


if __name__ == "__main__":
    main()
