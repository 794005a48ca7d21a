"""The numbers that decide `correct`, each the gap between what the timed
path produced and what the reference computes from the same inputs.

Training (the first three steps of the trainer that the window drives):
  * `loss_gap`: the largest relative gap of a step's loss; `first_loss_gap`:
    the first step's;
  * `grad_gap`: the worst leaf's gap between the norms of the first
    gradient as Adam got it (the program's read back from its first
    moment after one step), over the reference's norm of that leaf or of
    the median leaf, whichever is larger;
  * `change_gap`: the same for the parameters' change over the three
    steps, leaving out the leaves whose first gradient in the reference is
    under a thousandth of the median leaf's (Adam moves them by round-off);
    `whole_change_gap`: the relative gap of the norms of the change of all
    parameters together.
A configuration's `limits` name the numbers its cells compare.
Evaluation (every pass of the window):
  * `table_gap`: the larger of the user and item tables' relative gaps,
    ||program - reference|| / ||reference||;
  * `metric_gap`: the largest absolute gap of a pass's metric (Hit ratio,
    Precision, Recall, NDCG at each cut-off) from the reference's.
"""

from __future__ import annotations

import statistics

import torch

ADAM_BETA1 = 0.9


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    """Worst leaf of |‖prog‖ - ‖ref‖| over max(‖ref leaf‖, median ‖ref leaf‖)."""
    leaves = list(ref) if leaves is None else list(leaves)
    pn, rn = _norms({k: prog[k] for k in leaves}), _norms({k: ref[k] for k in leaves})
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med) for k in leaves)


def moving_leaves(ref_grad: dict) -> list:
    """The leaves whose reference gradient norm reaches a thousandth of the
    median leaf's."""
    n = _norms(ref_grad)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= 1e-3 * med]


def train_gaps(prog: dict, ref: dict) -> dict:
    """`prog` and `ref`: losses [3], grad {leaf: first gradient as Adam got
    it}, change {leaf: parameters after three steps - before}; `ref` also
    raw_grad {leaf: the first gradient}."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    whole = [float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(v.double())
                                                         for v in side["change"].values()])))
             for side in (prog, ref)]
    return {"loss_gap": max(gaps), "first_loss_gap": gaps[0],
            "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], moving_leaves(ref["raw_grad"])),
            "whole_change_gap": abs(whole[0] - whole[1]) / whole[1]}


def table_gap(prog: tuple, ref: tuple) -> float:
    return max(float(torch.linalg.vector_norm((p.double() - r.double())))
               / float(torch.linalg.vector_norm(r.double())) for p, r in zip(prog, ref))


def metric_gap(prog: dict, ref: dict) -> float:
    """Largest |program - reference| over cut-offs and metrics."""
    return max(abs(float(prog[n][m]) - float(ref[n][m])) for n in ref for m in ref[n])


def first_gradient(exp_avg: torch.Tensor) -> torch.Tensor:
    """The gradient Adam used on its first step, from its first moment."""
    return exp_avg.double() / (1.0 - ADAM_BETA1)


def log_train(prog: dict, ref: dict, log) -> None:
    """Each step's losses, and each leaf's norms, on the log."""
    for k, (p, r) in enumerate(zip(prog["losses"], ref["losses"])):
        log(f"[check] step {k + 1} loss {p!r} reference {r!r}")
    moving = set(moving_leaves(ref["raw_grad"]))
    for part in ("grad", "change"):
        pn, rn = _norms(prog[part]), _norms(ref[part])
        for leaf in rn:
            log(f"[check] {part} {leaf}: {pn[leaf]!r} reference {rn[leaf]!r}"
                + ("" if part == "grad" or leaf in moving else " (not moving)"))
