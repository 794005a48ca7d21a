"""PyTorch + CUDA port of the TPU-native hypergraph-diffusion recommender.

The JAX package `hypergraph_diffusion_for_recommendation_tpu` beside this
one is the reference; this package keeps its layout and names (`core/`,
`data/`, `native/`, `ops/`, `models/`, `eval/`, `train/`, `utils/`, `cli.py`,
`serving_cli.py`) and never imports it, nor JAX. Entry points run on the
GPU unless the caller passes `device="cpu"`.
The TPU's Pallas kernels become CUDA kernels written for Hopper
(`csrc/`, bound in `ops/kernels/`).
"""
