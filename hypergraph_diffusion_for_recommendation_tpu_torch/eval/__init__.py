from .metrics import metrics_from_topk, metrics_to_host, ranking_metrics
from .serving import Retriever, export_embeddings


def early_stopping(
    recall_list: list[float], stopping_steps: int, smooth: int = 1
) -> tuple[float, bool]:
    """Stop when Recall has not improved for `stopping_steps` epochs —
    the JAX package's rule (reference util/evaluation.py:195-202 at
    smooth=1). smooth>1 runs the same patience rule on a trailing moving
    average of width `smooth`; only the stop decision changes, the
    best-model vote stays on the raw per-epoch metrics."""
    if smooth > 1:
        sig = [
            sum(recall_list[max(0, i - smooth + 1): i + 1]) / (i + 1 - max(0, i - smooth + 1))
            for i in range(len(recall_list))
        ]
    else:
        sig = recall_list
    best = max(sig)
    best_step = sig.index(best)
    should_stop = len(sig) - best_step - 1 >= stopping_steps
    return best, should_stop


__all__ = ["ranking_metrics", "metrics_from_topk", "metrics_to_host", "Retriever",
           "export_embeddings", "early_stopping"]
