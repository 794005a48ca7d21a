"""Rank launcher for the collective layer — the port's counterpart of the
JAX package's `utils/platform.py`.

JAX's `force_virtual_cpu(n)` gives one process n virtual CPU devices, and
`shard_map` runs the n shards inside it. The port runs one process per
rank (`torch.distributed`), so its counterpart starts them:
`run_ranks(n, target, *args)` spawns n processes (the `spawn` start
method: a process in which JAX has started must not be forked),
initialises a process group across them from a `file://` path under a
fresh temporary directory (no TCP port to collide with another run),
calls `target(*args)` on every rank, and returns each rank's result in
rank order, or raises the first failed rank's error.

`target` is a module-level function that each rank imports by name: it
lives in this package, so that no rank imports JAX. With `device="cpu"` the
group runs gloo; on the cards (the default) each rank computes on card
`rank % n_cards`, and the backend is the one `parallel.mesh.pick_backend`
picks for that layout (gloo when ranks share a card, NCCL when each has
its own). Each rank runs one intra-op thread.
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback


def _rank_main(rank: int, n: int, tmp: str, backend: str, device_type: str, results) -> None:
    import torch
    import torch.distributed as dist

    try:
        # the ranks share the host's cores: several intra-op threads a rank
        # oversubscribe them (a 32 x 16 index_add took 200 ms at 8 threads
        # in each of 4 ranks on 8 cores, 0.02 ms at 1)
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:  # written by run_ranks
            target, args = pickle.load(f)
        dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'init')}",
                                world_size=n, rank=rank)
        try:
            results.put((rank, True, target(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(n: int, target, *args, device: str | None = None,
              timeout: float = 600.0) -> list:
    """Run `target(*args)` on `n` spawned ranks of one process group;
    returns their results in rank order. `device`: where the ranks compute
    (default: the card; `core.device.resolve_device`). Raises RuntimeError with a
    failed rank's traceback, or on a rank that neither answers nor exits
    within `timeout` seconds (every rank is then killed)."""
    import multiprocessing as mp

    import torch

    from ..core.device import resolve_device
    from ..parallel.mesh import pick_backend

    device = resolve_device(device).type
    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    backend = pick_backend(device, n, n_cards)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_")
    # the call goes through a file, not the processes' start pipes: a start
    # blocks until its child has read the pipe, and a child that dies first
    # would leave it blocked for good
    with open(os.path.join(tmp, "call.pkl"), "wb") as f:
        pickle.dump((target, args), f)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, n, tmp, backend, device, results),
                         daemon=True) for r in range(n)]
    try:
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        errors: dict[int, str] = {}
        deadline = time.monotonic() + timeout
        while len(got) < n and not errors:  # drain the queue before joining
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                silent = [r for r in range(n) if r not in got]
                dead = [r for r in silent if procs[r].exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} without a result") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks {silent} gave no result within "
                                       f"{timeout:.0f} s") from None
                continue
            # after a failure the others may wait on it in a collective: stop there
            (got if ok else errors)[rank] = value
        if errors:
            rank = min(errors)
            raise RuntimeError(f"rank {rank} of {n} failed:\n{errors[rank]}")
        for p in procs:
            p.join(timeout=60.0)
        return [got[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
