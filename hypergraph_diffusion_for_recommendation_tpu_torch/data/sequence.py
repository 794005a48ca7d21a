"""Sequential-recommendation data path — the port of the JAX package's
`data/sequence.py`, parity with reference `data/sequence.py` +
`util/sampler.py:292-320`:
  * item ids are 1-based with 0 as the padding placeholder
    (data/sequence.py:27);
  * a user's sequence is their training items in interaction order;
    users with < 2 items are dropped (data/sequence.py:40-44);
  * training windows: seq = items[:-1] (last max_len), positions
    1..len, targets y = items shifted by one, one negative per
    position not in the user's history (util/sampler.py:302-318).

All windows are padded to [n_pad, max_len] on the device once (n_pad a
multiple of 8); an epoch's batches are a shuffled row gather
(`train.trainer._sequence_epoch_batches`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import pad_to_multiple, padded_rows_from_lists
from .dataset import InteractionData


@dataclass
class SeqDeviceData:
    seq: torch.Tensor  # [n_pad, max_len] int32 1-based item ids, 0 pad
    pos: torch.Tensor  # [n_pad, max_len] int32 positions 1.., 0 pad
    y: torch.Tensor  # [n_pad, max_len] int32 1-based targets, 0 pad
    seq_len: torch.Tensor  # [n_pad] int32
    seq_valid: torch.Tensor  # [n_pad] bool (false for padding rows)
    seq_user: torch.Tensor  # [n_pad] int32 dense user id of each sequence row
    rated_pad_1b: torch.Tensor  # [n_users, max_deg] int32 1-based history, -1 pad
    max_len: int
    n_items: int  # item_num (1-based ids 1..n_items)
    n_seqs: int


def seq_device_data(users: np.ndarray, items: np.ndarray, n_users: int, n_items: int,
                    device: torch.device | str | None = None, max_len: int = 50,
                    pad_multiple: int = 8) -> SeqDeviceData:
    """The padded windows of the training edges (dense users, dense 0-based
    items) in their stored order: each user's items in that order."""
    order = np.argsort(users, kind="stable")
    u_sorted = users[order]
    i_sorted = items[order] + 1  # 1-based
    splits = np.searchsorted(u_sorted, np.arange(1, n_users))
    per_user = np.split(i_sorted, splits)

    rows = [(u, its) for u, its in enumerate(per_user) if len(its) >= 2]
    n_seqs = len(rows)
    n_pad = max(pad_to_multiple(max(n_seqs, 1), pad_multiple), pad_multiple)
    seq = np.zeros((n_pad, max_len), np.int32)
    pos = np.zeros((n_pad, max_len), np.int32)
    y = np.zeros((n_pad, max_len), np.int32)
    seq_len = np.zeros(n_pad, np.int32)
    seq_user = np.zeros(n_pad, np.int32)
    valid = np.zeros(n_pad, bool)
    for k, (u, its) in enumerate(rows):
        window = its[-(max_len + 1):] if len(its) > max_len else its
        end = min(len(window) - 1, max_len)
        seq[k, :end] = window[:-1][:end]
        pos[k, :end] = np.arange(1, end + 1)
        y[k, :end] = window[1:][:end]
        seq_len[k] = end
        seq_user[k] = u
        valid[k] = True
    rated_1b = padded_rows_from_lists([np.asarray(its, np.int32) for its in per_user], fill=-1,
                                      pad_multiple=pad_multiple)

    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return SeqDeviceData(seq=t(seq), pos=t(pos), y=t(y), seq_len=t(seq_len),
                         seq_valid=t(valid), seq_user=t(seq_user), rated_pad_1b=t(rated_1b),
                         max_len=max_len, n_items=int(n_items), n_seqs=n_seqs)


def build_seq_device_data(inter: InteractionData, max_len: int = 50, pad_multiple: int = 8,
                          device: torch.device | str | None = None) -> SeqDeviceData:
    """The windows of `inter`'s training edges, on `device` (the GPU unless
    the caller asks for the CPU)."""
    return seq_device_data(inter.train_u, inter.train_i, inter.n_users, inter.n_items, device,
                           max_len, pad_multiple)
