"""Kernel 3's decisions (`segment_spmm_rows_int8`, csrc/segment_spmm.cu),
written again in numpy for the tests and `chip_smoke.py`: which warps sum
in integers and which in f64, and a graph that puts rows on both paths.

A warp's slots (a row, or a hub warp's share of one) whose bf16 edge values
are m * 2^e (m the significand with its leading bit, |m| < 256) are summed
as W * q with W = m << (e - t), t their least exponent. W fits dp2a's int16
while span (the greatest e less t) is at most MAX_SPAN; an int32 sum of at
most CHUNK slots is then exact (255 * 127 * CHUNK * 2^MAX_SPAN < 2^31), and
a hub warp flushes its sum to f64 every CHUNK slots.
"""

import numpy as np

from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import segment_spmm as tsp

MAX_SPAN = 7  # the kernel's kMaxSpan
CHUNK = 512  # the kernel's kSumSlots
_NO_EXP = 0x7FFFFFFF  # a zero value's exponent
_BAD_EXP = 1 << 20  # an inf's or nan's


def int8_decode(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's reading of float32 values already rounded to bf16: (m,
    e) with v = m * 2^e, m the signed significand with its leading bit
    (|m| < 256), e the exponent of its last bit; e = 0x7FFFFFFF for a zero
    and 2^20 for an inf or a nan."""
    bits = np.ascontiguousarray(vals, np.float32).view(np.uint32).astype(np.int64)
    ex = (bits >> 23) & 0xFF
    mant = (bits >> 16) & 0x7F
    mag = np.where(ex > 0, mant | 0x80, mant)
    m = np.where(bits >> 31, -mag, mag)
    e = np.where(ex == 0xFF, _BAD_EXP, np.where(mag == 0, _NO_EXP, np.maximum(ex, 1) - 134))
    return m, e


def int8_scale(vals: np.ndarray) -> tuple[int, bool]:
    """The kernel's choice for one warp's slots from their bf16-rounded
    values: (t, fast), t their least exponent (0 if all are zero), `fast`
    whether they take the integer path (else the f64 path)."""
    _, e = int8_decode(vals)
    e = e[e != _NO_EXP]
    if e.size == 0:
        return 0, True
    lo, hi = int(e.min()), int(e.max())
    return lo, hi < _BAD_EXP and hi - lo <= MAX_SPAN


def int8_shares(n: int) -> list[tuple[int, int]]:
    """The slot ranges the kernel's warps take of a row of n slots: the
    whole row, or for a hub row (more than ROW_SLOTS) WARPS_PER_CTA shares."""
    if n <= tsp.ROW_SLOTS:
        return [(0, n)]
    w = tsp.WARPS_PER_CTA
    return [(n * k // w, n * (k + 1) // w) for k in range(w)]


def int8_row_scales(blocked) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's choices for each output row of a base layout, from its
    current values: (t, fast), t the least exponent of the row's
    bf16-rounded values, `fast` whether every warp's share of it takes the
    integer path."""
    v = blocked.vals.reshape(-1).cpu().bfloat16().float().numpy()
    rs = blocked.row_start.cpu().numpy()
    n = blocked.row_end.cpu().numpy() - rs
    t = np.zeros(n.shape[0], np.int64)
    fast = np.ones(n.shape[0], bool)
    for r in np.nonzero(n)[0]:
        choices = [int8_scale(v[rs[r] + a: rs[r] + b]) for a, b in int8_shares(int(n[r]))]
        t[r] = min(c[0] for c in choices)
        fast[r] = all(c[1] for c in choices)
    return t, fast


SPAN_F64_ROWS = [1, 3, 5]  # the rows of `span_graph` on the f64 path


def span_graph():
    """The kernel's two paths side by side: rows whose values span the
    integer path's widest range, and one binade more (the f64 path), a hub
    row of each, a hub whose shares run past one chunk, values whose least
    exponent leaves f32's normal range either way, zeros and empty rows.
    Returns ((n, m), rows, cols, vals) as padded COO."""
    rng = np.random.default_rng(5)
    n, m = 40, 300
    parts = []

    def add(r, v, replace=False):
        v = np.asarray(v, np.float64)
        parts.append((np.full(v.shape[0], r), rng.choice(m, v.shape[0], replace=replace), v))

    add(0, rng.uniform(0.5, 0.9, 3000) * 2.0 ** rng.integers(0, 8, 3000), True)  # shares: span 7
    add(1, rng.standard_normal(3000), True)                    # a hub on the f64 path
    add(2, [1.0, -(2.0 ** 7)])                                 # span 7, the widest
    add(3, [1.0, 2.0 ** 8])                                    # span 8: f64 path
    add(4, np.concatenate([[1.0, 2.0 ** 7], 2.0 ** rng.integers(0, 8, 62)])
        * rng.choice([-1.0, 1.0], 64) * rng.uniform(1.0, 1.5, 64))  # 64 slots: span 7
    add(5, np.concatenate([[1.0, 2.0 ** 8], rng.uniform(1.0, 2.0, 62)]))  # span 8: f64 path
    add(6, [0.3])
    add(7, [1e-39, -3e-39, 2e-38])                             # t = -133: through f64
    add(8, rng.uniform(0.25, 1.0, 33) * rng.choice([-1.0, 1.0], 33))  # two batches of slots
    add(10, np.zeros(5))                                       # explicit zeros
    add(11, [2.0 ** 104, -3 * 2.0 ** 104])                     # t = 97: through f64
    # shares of 1300 slots at span 7, nearly all W = 255 << 7: three int32 chunks each, flushed
    # to f64; on a column where q = 127 throughout, one int32 sum of a share would overflow
    add(12, np.where(np.arange(10400) % 50, 255.0, 1.0), True)
    rows = np.concatenate([p[0] for p in parts])
    cols = np.concatenate([p[1] for p in parts])
    vals = np.concatenate([p[2] for p in parts]).astype(np.float32)
    order = np.lexsort((cols, rows))
    rows = np.concatenate([rows[order], np.full(5, n)]).astype(np.int32)
    cols = np.concatenate([cols[order], np.zeros(5, np.int64)]).astype(np.int32)
    return (n, m), rows, cols, np.concatenate([vals[order], np.zeros(5, np.float32)])
