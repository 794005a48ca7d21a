"""Cost analysis and the roofline — the port of the JAX package's
`utils/profiling.py`.

The JAX package reads XLA's cost analysis of a compiled function. Eager
PyTorch compiles nothing, so `cost_analysis` runs the function once and
counts what the dispatcher sees: FLOPs from
`torch.utils.flop_counter.FlopCounterMode`, and bytes from a dispatch
mode that adds up each aten op's input and output bytes, as XLA's per-op
`bytes accessed` does. `Trainer.profile_epoch` (train/trainer.py) takes
the torch.profiler trace that `utils/trace_analysis.py` reads.

Two known differences from XLA's numbers:
  * `FlopCounterMode` counts the FLOPs of matmuls, convolutions and
    attention only; XLA also counts elementwise ops and reductions, so a
    function's FLOPs here are at most XLA's.
  * The port's CUDA kernels are `torch.autograd.Function`s that call the
    built library through ctypes: the dispatcher never sees them, so they
    count 0 FLOPs and 0 bytes, as a Pallas custom call reports 0 bytes to
    XLA. The caller adds their bytes through
    `trace_roofline(extra_bytes_per_exec=)`, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves

# ops that move no bytes: allocations that nothing has written yet
_NO_TRAFFIC = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                         "new_empty_strided", "detach", "lift_fresh"})


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree) if torch.is_tensor(t))


class _ByteCounter(TorchDispatchMode):
    """Adds up each aten op's input and output bytes (views and fresh
    allocations move none)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket.__name__ not in _NO_TRAFFIC:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            self.ops += 1
        return out


def _fake_mode(flat):
    from torch._subclasses.fake_tensor import FakeTensor

    return next((t.fake_mode for t in flat if isinstance(t, FakeTensor)), None)


def cost_analysis(fn: Callable, *args: Any, **kwargs: Any) -> Mapping[str, float]:
    """FLOPs and bytes of one call of `fn(*args, **kwargs)`, counted op by
    op as it runs: {"flops", "bytes accessed", "ops"} ("ops": the aten ops
    counted for bytes).

    Works with concrete tensors (the call runs on their device), with
    tensors on the `meta` device, and with placeholders made under a
    `FakeTensorMode`: then the call runs under that mode, and any tensor
    `fn` closes over becomes a fake of the same shape, dtype and device
    without its data being read, so nothing is copied from the card to
    the host. The port's CUDA kernels need real tensors on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    flat, _ = tree_flatten((args, kwargs))
    fake = _fake_mode(flat)
    counter = _ByteCounter()
    flops = FlopCounterMode(display=False)
    if fake is not None:
        prev = fake.allow_non_fake_inputs
        fake.allow_non_fake_inputs = True
        try:
            with fake, flops, counter:
                fn(*args, **kwargs)
        finally:
            fake.allow_non_fake_inputs = prev
    else:
        with flops, counter:
            fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()), "bytes accessed": float(counter.bytes),
            "ops": float(counter.ops)}


def flops_estimate(fn: Callable, *args: Any, **kwargs: Any) -> float:
    """Total FLOPs of one call of `fn`."""
    return float(cost_analysis(fn, *args, **kwargs).get("flops", 0.0))


# Hardware roofs per device name (`torch.cuda.get_device_name()`): (dense
# bf16 matmul peak FLOP/s, HBM bandwidth B/s). NVIDIA's published figures
# for the SXM part at its full 700 W power limit.
GPU_PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),
}


def roofline(flops: float, bytes_accessed: float, seconds: float,
             device=None) -> Mapping[str, float]:
    """Express a measured workload against the hardware roof.

    Returns MFU (achieved FLOP/s over the device's dense-matmul peak),
    HBM utilisation (achieved B/s over HBM bandwidth), the workload's
    arithmetic intensity, and the machine-balance ridge point. `device`
    is a device name (default: `torch.cuda.get_device_name()` when a card
    is present); unknown names report raw rates with zero shares."""
    if device is None:
        device = torch.cuda.get_device_name() if torch.cuda.is_available() else ""
    peak_flops, peak_bw = GPU_PEAKS.get(device, (0.0, 0.0))
    achieved_flops = flops / max(seconds, 1e-12)
    achieved_bw = bytes_accessed / max(seconds, 1e-12)
    return {
        "flops": flops,
        "bytes": bytes_accessed,
        "seconds": seconds,
        "achieved_tflops": achieved_flops / 1e12,
        "achieved_gbps": achieved_bw / 1e9,
        "mfu": achieved_flops / peak_flops if peak_flops else 0.0,
        "hbm_util": achieved_bw / peak_bw if peak_bw else 0.0,
        "arithmetic_intensity": flops / max(bytes_accessed, 1.0),
        "ridge_intensity": peak_flops / peak_bw if peak_bw else 0.0,
    }
