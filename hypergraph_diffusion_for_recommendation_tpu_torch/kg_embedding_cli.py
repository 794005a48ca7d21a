"""KG-embedding CLI of the PyTorch port — the port of the JAX package's
`kg_embedding_cli.py` (the working replacement for the reference's broken
`main_kg_embedding.py`): the same flags, defaults and choices, and the same
printed lines.

    python -m hypergraph_diffusion_for_recommendation_tpu_torch.kg_embedding_cli \
        --model RealE --kg_file dataset/lastfm/processed_lastfm.kg --max_epoch 100

It trains on the GPU; `main(argv, device="cpu")` runs on the CPU when asked.
Without `--kg_file` the KG is the synthetic `generate_kg(n_items=2000,
n_clusters=16, seed=1)`.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Standalone KG triple-embedding trainer")
    p.add_argument("--model", default="RealE", choices=["TransE", "DistMult", "RealE"])
    p.add_argument("--kg_file", default="")
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--lrate", type=float, default=0.001)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--max_epoch", type=int, default=100)
    p.add_argument("--reg", type=float, default=1e-5)
    p.add_argument("--margin", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    # ReAlE knobs (reference conf/kg_embedding/RealE.conf)
    p.add_argument("--window_size", type=int, default=2)
    p.add_argument("--max_arity", type=int, default=6)
    p.add_argument("--nr", type=int, default=10, help="negatives per position")
    p.add_argument("--non_linearity", default="sigmoid",
                   choices=["sigmoid", "tanh", "relu", "none"])
    p.add_argument("--ent_non_linearity", default="sigmoid",
                   choices=["sigmoid", "tanh", "relu", "none"])
    p.add_argument("--test_by_arity", action="store_true",
                   help="report Measure per tuple arity (RealE)")
    return p.parse_args(argv)


def main(argv=None, device=None):
    """Parse `argv`, train and evaluate on `device` (the GPU unless "cpu" is
    given); returns the filtered-and-raw `Measure`."""
    args = parse_args(argv)

    from .data.io import load_kg_data
    from .data.synthetic import generate_kg
    from .train.kg_embedding import KGEConfig, KGEmbeddingTrainer

    if args.kg_file:
        kg = load_kg_data(args.kg_file).to_numpy()
    else:
        kg = generate_kg(n_items=2000, n_clusters=16, seed=1)[["h", "r", "t"]].to_numpy()
    n_entities = int(max(kg[:, 0].max(), kg[:, 2].max())) + 1
    n_relations = int(kg[:, 1].max()) + 1
    cfg = KGEConfig(
        model=args.model, dim=args.dim, lrate=args.lrate, batch_size=args.batch_size,
        max_epoch=args.max_epoch, reg=args.reg, margin=args.margin, seed=args.seed,
        window_size=args.window_size, max_arity=args.max_arity, neg_ratio=args.nr,
        non_linearity=args.non_linearity, ent_non_linearity=args.ent_non_linearity,
    )
    trainer = KGEmbeddingTrainer(kg, n_entities, n_relations, cfg, device=device)
    m = trainer.train_and_eval(quiet=False)
    if args.test_by_arity and args.model == "RealE":
        for ar, ma in sorted(trainer.evaluate(by_arity=True).items()):
            print(
                f"arity {ar}: hit@1 {ma.hit1['fil']:.4f} hit@3 {ma.hit3['fil']:.4f} "
                f"hit@10 {ma.hit10['fil']:.4f} MR {ma.mr['fil']:.1f} MRR {ma.mrr['fil']:.4f}"
            )
    return m


if __name__ == "__main__":
    main()
