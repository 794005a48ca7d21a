"""The masked top-k select (`ops/kernels/topk_select.py`) on the CPU: its
plain version against an order written out in numpy, the order of the CUDA
kernel's 64-bit keys against the stable sort's, and the dispatch of
`ops.topk.masked_topk` and `topk_ids` to the plain version for CPU tensors.
The kernel itself runs in `tests/test_torch_kernels_gpu.py` on a card."""

import math

import numpy as np
import pytest
import torch

from hypergraph_diffusion_for_recommendation_tpu_torch.ops import topk as tt
from hypergraph_diffusion_for_recommendation_tpu_torch.ops.kernels import topk_select as ts


def _case(width: int, seed: int, negative_nan: bool = True):
    """[6, width] f32 scores with many exact ties, +-0.0, NaN, +-inf and a
    raw -1e9 planted (and a NaN with the sign bit set, which the CPU's sort
    puts first and the card's last), and rated lists with pads, ids >= width
    and repeats; row 0 has every item rated, row 1 all but three."""
    rng = np.random.default_rng(seed)
    scores = (rng.integers(-6, 6, (6, width)) / 4).astype(np.float32)
    planted = [(0.0, 3), (-0.0, 5), (np.nan, 7), (np.inf, 11), (-np.inf, 13), (tt.NEG_INF, 1)]
    for v, j in planted + ([(-np.nan, 2)] if negative_nan else []):
        scores[2:, j % width] = v
    deg = 12
    rated = np.full((6, width + deg), -1, np.int32)
    rated[0, :width] = rng.permutation(width)
    keep = rng.choice(width, min(3, width), replace=False)
    rest = np.setdiff1d(np.arange(width), keep)
    rated[1, : rest.size] = rest
    for r in range(2, 6):
        ids = rng.integers(0, width, deg)
        ids[:3] = [width, width + 7, ids[3]]  # outside [0, width), and a repeat
        rated[r, :deg] = ids
    return scores, rated


def _numpy_topk(scores: np.ndarray, rated: np.ndarray | None, k: int):
    """The sort's order written out: NEG_INF into each valid rated id, then
    NaN first, score descending (-0.0 ties +0.0), ties to the lower index."""
    masked = scores.copy()
    if rated is not None:
        for r in range(scores.shape[0]):
            ids = rated[r][(rated[r] >= 0) & (rated[r] < scores.shape[1])]
            masked[r, ids] = np.float32(tt.NEG_INF)
    order = [sorted(range(scores.shape[1]),
                    key=lambda j, row=row: (not math.isnan(row[j]),
                                            0.0 if math.isnan(row[j]) else -float(row[j]), j))
             for row in masked]
    ids = np.asarray(order, np.int64)[:, :k]
    return np.take_along_axis(masked, ids, 1), ids


def _kernel_keys(scores: np.ndarray) -> np.ndarray:
    """The CUDA kernel's keys (`order_key` and the complemented index), in
    numpy: uint64, larger first in the kernel's order."""
    u = scores.view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0  # -0.0 as +0.0
    key = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    idx = np.arange(scores.shape[1], dtype=np.uint64)
    return (key.astype(np.uint64) << np.uint64(32)) | (~idx & np.uint64(0xFFFFFFFF))


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.int32)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("k", [1, 10, 40, ts.KMAX, ts.KMAX + 1])
@pytest.mark.parametrize("width", [1, 31, 4097])
def test_reference_matches_the_written_out_order(width, k, masked):
    scores, rated = _case(width, seed=width + k)
    vals, ids = ts.topk_select_reference(torch.as_tensor(scores),
                                         torch.as_tensor(rated) if masked else None, k)
    want_vals, want_ids = _numpy_topk(scores, rated if masked else None, k)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int64
    assert tuple(ids.shape) == (6, min(k, width))
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(_bits(vals), want_vals.view(np.int32))


@pytest.mark.parametrize("width", [1, 31, 4097])
def test_kernel_key_order_is_the_stable_sort_order(width):
    # without a NaN whose sign bit is set, where the CPU's and the card's sorts differ
    scores, rated = _case(width, seed=3 * width, negative_nan=False)
    masked = tt.mask_rated(torch.as_tensor(scores), torch.as_tensor(rated)).numpy()
    _, want = ts.topk_select_reference(torch.as_tensor(scores), torch.as_tensor(rated), width)
    keys = _kernel_keys(masked)
    assert np.unique(keys, axis=1).shape[1] == width  # distinct in every row
    got = np.asarray([sorted(range(width), key=lambda j, row=row: -int(row[j])) for row in keys])
    np.testing.assert_array_equal(got, want.numpy())
    # the masked value -1e9 has the kernel's kKeyNegInf
    assert _kernel_keys(np.float32([[tt.NEG_INF]]))[0, 0] >> np.uint64(32) == 0x319194D7


def test_kernel_keys_place_nan_by_its_sign_as_the_card_sort():
    # the card's stable sort (cub's radix sort) of this row, read on the H100:
    # +NaN, +inf, then -0.0 and +0.0 tied in index order, ..., -inf, -NaN last
    row = np.float32([1.0, np.nan, -np.inf, -0.0, 0.0, -np.nan, np.inf, tt.NEG_INF])
    order = np.argsort(-_kernel_keys(row[None, :])[0].astype(object))
    assert order.tolist() == [1, 6, 0, 3, 4, 7, 2, 5]


def test_mask_rated_ignores_ids_outside_the_catalog_and_repeats():
    scores = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    rated = torch.tensor([[-1, 6, 9, 2, 2], [5, 0, -1, -1, 100]], dtype=torch.int32)
    got = tt.mask_rated(scores, rated)
    want = scores.clone()
    want[0, 2] = want[1, 5] = want[1, 0] = tt.NEG_INF
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(scores, torch.arange(12, dtype=torch.float32).reshape(2, 6))  # a new tensor


@pytest.mark.parametrize("fn", ["masked_topk", "topk_ids"])
def test_cpu_tensors_take_the_plain_version(monkeypatch, fn):
    scores, rated = _case(31, seed=5)
    calls = []

    def reference(s, r, k):
        calls.append((r is not None, k))
        return orig(s, r, k)

    orig = ts.topk_select_reference
    monkeypatch.setattr(ts, "topk_select_reference", reference)
    before = dict(ts.LAUNCHES)
    args = (torch.as_tensor(scores), torch.as_tensor(rated)) if fn == "masked_topk" else (
        torch.as_tensor(scores),)
    vals, ids = getattr(tt, fn)(*args, 10)
    assert calls == [(fn == "masked_topk", 10)]
    assert ts.LAUNCHES == before  # no kernel on the CPU
    want_vals, want_ids = _numpy_topk(scores, rated if fn == "masked_topk" else None, 10)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(_bits(vals), want_vals.view(np.int32))


def test_cpu_select_returns_min_k_width_columns():
    scores, rated = _case(31, seed=9)
    vals, ids = ts.topk_select(torch.as_tensor(scores), torch.as_tensor(rated), 300)
    assert tuple(ids.shape) == (6, 31)  # min(k, I) columns, as the slice gives
    want_vals, want_ids = _numpy_topk(scores, rated, 300)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(_bits(vals), want_vals.view(np.int32))


WINDOW = 4096 * 32  # the kernel's kWindow: the items one bitmap of the mask covers


def _select_walk(scores: np.ndarray, rated: np.ndarray | None, k: int, first: int = 0):
    """The CUDA kernel's selection for one row, walked in numpy. In rounds
    of up to KMAX columns, each taking only keys below the last key of the
    round before; in a round, window by window of WINDOW items, the head
    scores before the first 16-byte boundary (the row starts at float
    `first` of an aligned buffer) and the tail, then chunks of 4,096
    scores, each key appended when it beats the threshold; after the head
    and tail and after each chunk, with more than KMAX keys, the 8-bit
    radix select that keeps the round's largest and makes the last of them
    the threshold; at the round's end the same select to its width and a
    descending sort. Returns (values, ids, the number of selects, the
    number of rounds)."""
    width = scores.shape[0]
    k = min(k, width)
    raw = _kernel_keys(scores[None, :])[0] >> np.uint64(32)
    is_rated = np.zeros(width, bool)
    if rated is not None:
        ok = rated[(rated >= 0) & (rated < width)]
        is_rated[ok] = True
    neg = np.uint64(0x319194D7)
    idx = np.arange(width, dtype=np.uint64)
    low = ~idx & np.uint64(0xFFFFFFFF)
    state = dict(buf=np.zeros(0, np.uint64), thresh=np.uint64(0), lim=~np.uint64(0), selects=0)

    def consider(j: np.ndarray) -> None:
        key = raw[j]
        cand = (key >= (state["thresh"] >> np.uint64(32))) | (key <= neg)
        key = np.where(cand & is_rated[j], neg, key)
        full = (key << np.uint64(32)) | low[j]
        enter = cand & (full > state["thresh"]) & (full <= state["lim"])
        state["buf"] = np.concatenate([state["buf"], full[enter]])

    def keep(kk: int) -> None:
        buf, need, prefix, shift = state["buf"], kk, 0, 64
        while True:
            shift -= 8
            live = buf if shift == 56 else buf[(buf >> np.uint64(shift + 8)) == prefix]
            hist = np.bincount(((live >> np.uint64(shift)) & np.uint64(255)).astype(np.int64),
                               minlength=256)
            above = np.concatenate([[0], np.cumsum(hist[::-1])])  # keys in bins above 255 - i
            digit = 255 - int(np.argmax(above[1:] >= need))
            need -= int(above[255 - digit])
            prefix = (prefix << 8) | digit
            if hist[digit] == need:
                break
        kept = buf[buf >= np.uint64(prefix << shift)]
        assert kept.size == kk
        state.update(buf=kept, thresh=kept.min(), selects=state["selects"] + 1)

    out, rounds = [], 0
    for done in range(0, k, ts.KMAX):
        kr = min(ts.KMAX, k - done)
        state.update(buf=np.zeros(0, np.uint64), thresh=np.uint64(0))
        for w0 in range(0, width, WINDOW):
            length = min(WINDOW, width - w0)
            head = min(length, (4 - (first + w0) % 4) % 4)
            n4 = (length - head) // 4
            chunks = [np.r_[0:head, head + 4 * n4:length]]
            chunks += [np.arange(c, min(c + 4096, head + 4 * n4))
                       for c in range(head, head + 4 * n4, 4096)]
            for chunk in chunks:
                consider(w0 + chunk)
                if state["buf"].size > ts.KMAX:
                    keep(kr)
        if state["buf"].size > kr:
            keep(kr)
        assert state["buf"].size == kr
        got = np.sort(state["buf"])[::-1]
        out.append(got)
        state["lim"] = got[-1] - np.uint64(1)
        rounds += 1
    out = np.concatenate(out)
    ids = (~out & np.uint64(0xFFFFFFFF)).astype(np.int64)
    vals = np.where(out >> np.uint64(32) == neg, np.float32(tt.NEG_INF), scores[ids])
    return vals.astype(np.float32), ids, state["selects"], rounds


@pytest.mark.parametrize("kind", ["ties", "normal", "rising"])
@pytest.mark.parametrize("k", [1, 40, ts.KMAX, ts.KMAX + 1, 3 * ts.KMAX + 5])
@pytest.mark.parametrize("width", [31, 4097, 91599, 2 * WINDOW + 3])
def test_select_walk_matches_the_sort(width, k, kind):
    # the kernel's rounds, windows, threshold and radix select, walked in
    # numpy over rows that start at each float of a 16-byte group; the widest
    # rows span three windows of the mask, with rated ids in each
    rng = np.random.default_rng(width + k)
    if kind == "ties":
        scores, rated = _case(width, seed=width + k, negative_nan=False)
        scores, rated = scores[1:5], rated[1:5]  # row 1: all but three items rated
    else:
        scores = rng.standard_normal((4, width)).astype(np.float32)
        if kind == "rising":
            scores += np.linspace(0, 8, width, dtype=np.float32)
        rated = rng.integers(-1, width + 3, (4, 500)).astype(np.int32)
    want_vals, want_ids = ts.topk_select_reference(torch.as_tensor(scores),
                                                   torch.as_tensor(rated), k)
    for r in range(scores.shape[0]):
        vals, ids, selects, rounds = _select_walk(scores[r], rated[r], k, first=r)
        np.testing.assert_array_equal(ids, want_ids[r].numpy())
        np.testing.assert_array_equal(vals.view(np.int32), want_vals[r].numpy().view(np.int32))
        assert selects >= (1 if width > ts.KMAX else 0)
        assert rounds == -(-min(k, width) // ts.KMAX)


def test_select_walk_masks_every_item_of_a_row_past_one_window():
    # a row whose every item is rated, over three windows of the mask: every
    # value is NEG_INF and the ids run in index order, in rounds past KMAX
    width = 2 * WINDOW + 3
    scores = np.random.default_rng(4).standard_normal(width).astype(np.float32)
    vals, ids, _, rounds = _select_walk(scores, np.arange(width, dtype=np.int32), 600, first=1)
    np.testing.assert_array_equal(ids, np.arange(600))
    assert (vals == np.float32(tt.NEG_INF)).all() and rounds == 3
