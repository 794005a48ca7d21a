"""Checkpoint / resume on `torch.save` — the port of the JAX package's
`utils/checkpoint.py` (orbax there).

The reference is save-only (base/recommender.py:74-75); here a checkpoint
round-trips: a state is a dict of tensors, host numbers, lists and dicts
(`Trainer.checkpoint_state`: the parameters, every Adam state, the extras,
the learning rates, the epoch and the generators' states), written as
`<dir>/ckpt_<step>.pt` and read back on the host. The `max_to_keep`
newest checkpoints stay.

Saves run in a background thread by default, one in flight at a time:
any read (`steps`, `latest_step`, `restore`, `close`) and the next save join the
pending save first and raise its error. The caller hands the save a state
that nothing updates in place afterwards (the trainer's copies on the
card, taken before the next step); the thread copies it to the host and
writes it, while the next epoch runs.
"""

from __future__ import annotations

import atexit
import os
import re
import threading
from typing import Any

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_host(tree: Any) -> Any:
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, background: bool = True):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.background = background
        self._thread: threading.Thread | None = None
        self._worker_exc: BaseException | None = None
        self._closed = False
        # the worker is a daemon thread: without this hook an in-flight final
        # save would be killed at interpreter exit and lost
        self._atexit = atexit.register(self.close)

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._worker_exc is not None:
            exc, self._worker_exc = self._worker_exc, None
            raise RuntimeError("background checkpoint save failed") from exc

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.dir)) if m)

    def steps(self) -> list[int]:
        """The steps of the checkpoints on disk, ascending (after the pending
        save)."""
        self._join()
        return self._steps()

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step}.pt")

    def _do_save(self, step: int, state: dict) -> None:
        try:
            tmp = self._path(step) + f".tmp{os.getpid()}"
            torch.save(_to_host(state), tmp)
            os.replace(tmp, self._path(step))
            for old in self._steps()[: -self.max_to_keep]:
                os.remove(self._path(old))
        except BaseException as e:  # re-raised on the next _join()
            self._worker_exc = e

    def save(self, step: int, state: dict) -> None:
        """Queue (background) or perform (foreground) one save; the state's
        tensors must not be updated in place until it completes."""
        self._join()
        if not self.background:
            self._do_save(step, state)
            self._join()
            return
        self._thread = threading.Thread(target=self._do_save, args=(step, state), daemon=True)
        self._thread.start()

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> dict | None:
        """The state saved at `step` (default the latest), on the host; None
        when there is no checkpoint."""
        self._join()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self._atexit)
        self._join()
