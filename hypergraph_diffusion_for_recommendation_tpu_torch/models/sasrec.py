"""SASRec and CL4SRec — the sequential family, the port of the JAX
package's `models/sasrec.py`.

SASRec: causal self-attention blocks over 1-based padded item sequences,
learned positional embeddings, per-position BCE with one sampled negative
(reference util/sampler.py:292-320, util/structure.py:4-18). CL4SRec adds
InfoNCE between two augmented views of each sequence (crop / item mask /
reorder, data/augmentor.py:66-97) at their last non-empty positions.

The encoder names its parameters and submodules after flax's
(`item_emb`, `pos_emb`, `LayerNorm_0..2L`, `MultiHeadDotProductAttention_k`
with `query`/`key`/`value`/`out`, `PointWiseFeedForward_k/Dense_0..1`), so
`weights.params_from_jax` carries a JAX tree across unchanged. flax's
`MultiHeadDotProductAttention` is written out as matmuls and a softmax:
the query scaled by 1/sqrt(head_dim) before the product, masked scores
set to the dtype's least finite value (a fully masked row, a padding
sequence or a view that masked every item, softmaxes to uniform weights,
not NaN), and attention dropout as one [1, 1, L, L] keep mask broadcast
over batch and heads, scaled by 1/keep. Feature dropout is elementwise.

The draws (dropout's keep masks, the augmentations' uniforms and choices)
come from the generator the trainer passes, through `_keep_mask`,
`_uniform` and `_randint`; torch cannot reproduce JAX's streams, so tests
replace these functions and the JAX calls with one numpy draw.

Built for a mesh whose data axis is above 1 (`data_split`), a data rank
runs the encoder on its share of the batch's sequences
(`parallel.mesh.data_share`), both of CL4SRec's views too. Its draws are
the whole batch's, of which it takes its rows: the generator advances as
on one device, and the ranks' masks are the one device's. The BCE's mean
keeps the whole batch's count of valid positions; CL4SRec's InfoNCE adds
its share's rows' terms over every row of the second view, which
`gather_shares` brings from the other data ranks.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import Config
from ..data.device import CFDeviceData
from ..data.sequence import SeqDeviceData, seq_device_data
from ..ops.losses import info_nce
from ..ops.sparse import gather_rows_hubs, scatter_sum
from ..parallel.mesh import data_ranks, data_share, gather_shares
from .base import ModelBundle, flax_init, register_model
from .layers import LN_EPS, FlaxNamed, MultiHeadAttention


def _uniform(shape: tuple, generator: torch.Generator | None, device) -> torch.Tensor:
    """U[0, 1) float32 draws (`jax.random.uniform`)."""
    return torch.rand(shape, generator=generator, device=device)


def _randint(shape: tuple, high: int, generator: torch.Generator | None, device) -> torch.Tensor:
    """Integers from [0, high) (`jax.random.randint`)."""
    return torch.randint(0, high, shape, generator=generator, device=device)


def _keep_mask(shape: tuple, keep: float, generator: torch.Generator | None,
               device) -> torch.Tensor:
    """Bernoulli(keep) booleans (`jax.random.bernoulli`)."""
    return torch.rand(shape, generator=generator, device=device) < keep


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for ids of any shape; on the card the backward sums each
    id's rows in a bounded fixed order (`gather_rows_hubs`): the padding
    item and position 0 repeat thousands of times a batch."""
    return gather_rows_hubs(table, ids.reshape(-1).long()).reshape(*ids.shape, table.shape[1])


Whole = tuple[slice, int] | None  # (rows, n): x holds the rows `rows` of an n-row batch


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
             train: bool, whole: Whole = None) -> torch.Tensor:
    """flax `nn.Dropout` (`ops.dropout.feature_dropout`), its keep mask
    from `_keep_mask`. `whole` = (rows, n): `x` holds the rows `rows` of an
    n-row batch; the mask is drawn for the whole batch and its rows taken."""
    if not train or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    if whole is None:
        mask = _keep_mask(tuple(x.shape), keep, generator, x.device)
    else:
        mask = _keep_mask((whole[1],) + tuple(x.shape[1:]), keep, generator, x.device)[whole[0]]
    return torch.where(mask, x / keep, 0.0)


class CausalAttention(MultiHeadAttention):
    """flax `MultiHeadDotProductAttention(num_heads, qkv_features=dim,
    dropout_rate)` called as `(q, kv, mask=mask)` on [B, L, dim] rows: the
    `MultiHeadAttention` projections with a boolean [B, 1, L, L] mask and
    attention dropout."""

    def __init__(self, dim: int, n_heads: int, dropout: float):
        super().__init__(dim, n_heads)
        self.dropout = dropout

    def forward(self, q_in: torch.Tensor, kv: torch.Tensor, mask: torch.Tensor,
                train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        b, length, _ = q_in.shape

        def heads(t):  # [B, L, dim] -> [B, heads, L, head_dim]
            return t.reshape(b, length, self.n_heads, self.head_dim).transpose(1, 2)

        q = heads(self.query(q_in)) / torch.full((), float(self.head_dim),
                                                  device=q_in.device).sqrt()
        scores = q @ heads(self.key(kv)).transpose(-1, -2)
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores, dim=-1)
        if train and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            mask_keep = _keep_mask((1, 1, length, length), keep, generator, q_in.device)
            weights = weights * (mask_keep.to(weights.dtype)
                                 / torch.full((), keep, device=q_in.device))
        out = (weights @ heads(self.value(kv))).transpose(1, 2).reshape(b, length, -1)
        return self.out(out)


class PointWiseFeedForward(FlaxNamed):
    """util/structure.py:4-18: Dense-Dropout-ReLU-Dense-Dropout plus the
    residual (`Dense_0`, `Dense_1`)."""

    def __init__(self, dim: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self._new("Dense", nn.Linear(dim, dim))
        self._new("Dense", nn.Linear(dim, dim))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, whole: Whole = None) -> torch.Tensor:
        h = _dropout(self.Dense_0(x), self.dropout, generator, train, whole)
        h = _dropout(self.Dense_1(torch.relu(h)), self.dropout, generator, train, whole)
        return x + h


class SASRecEncoder(FlaxNamed):
    """Returns (h [B, L, dim], the item table [n_items + 1, dim]); row 0 of
    the table is the padding item. `whole` = (rows, n): the sequences are
    the rows `rows` of an n-row batch, whose dropout masks are drawn whole
    (`_dropout`)."""

    def __init__(self, n_items: int, dim: int, max_len: int, n_blocks: int = 2,
                 n_heads: int = 1, dropout: float = 0.2):
        super().__init__()
        self.dim, self.n_blocks, self.dropout = dim, n_blocks, dropout
        self.item_emb = nn.Parameter(torch.empty(n_items + 1, dim))
        self.pos_emb = nn.Parameter(torch.empty(max_len + 1, dim))
        # flax's creation order: per block LayerNorm, attention, LayerNorm,
        # feed-forward; then the last LayerNorm
        self.blocks = []
        for _ in range(n_blocks):
            self.blocks.append((
                self._new("LayerNorm", nn.LayerNorm(dim, eps=LN_EPS)),
                self._new("MultiHeadDotProductAttention", CausalAttention(dim, n_heads, dropout)),
                self._new("LayerNorm", nn.LayerNorm(dim, eps=LN_EPS)),
                self._new("PointWiseFeedForward", PointWiseFeedForward(dim, dropout)),
            ))
        self.last_norm = self._new("LayerNorm", nn.LayerNorm(dim, eps=LN_EPS))

    def forward(self, seq: torch.Tensor, pos: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, whole: Whole = None):
        pad = (seq > 0)[..., None]
        scale = torch.full((), float(self.dim), device=seq.device).sqrt()
        x = _rows(self.item_emb, seq) * scale + _rows(self.pos_emb, pos)
        x = _dropout(x, self.dropout, generator, train, whole) * pad
        length = seq.shape[1]
        causal = torch.tril(torch.ones(length, length, dtype=torch.bool, device=seq.device))
        mask = causal[None, None] & pad[:, None, None, :, 0]
        for ln_q, att, ln_ff, ff in self.blocks:
            q = getattr(self, ln_q)(x)
            x = q + getattr(self, att)(q, x, mask, train, generator)
            x = getattr(self, ff)(getattr(self, ln_ff)(x), train, generator, whole) * pad
        return getattr(self, self.last_norm)(x), self.item_emb


def _seq_augment(seq: torch.Tensor, pos: torch.Tensor, seq_len: torch.Tensor,
                 generator: torch.Generator | None, crop_ratio: float = 0.6,
                 mask_ratio: float = 0.3, reorder_ratio: float = 0.3):
    """One CL4SRec view (SequenceAugmentor, data/augmentor.py:71-97): per
    row crop, item mask or reorder, picked uniformly, as static-shape
    transforms. The draws, in the JAX package's order: the crop starts, the
    mask's keep bits, the reorder starts, the reorder keys, the choice."""
    dev = seq.device
    b, max_len = seq.shape
    idx = torch.arange(max_len, device=dev)[None, :]
    seq_len = torch.clamp(seq_len, min=1)
    len_f = seq_len.float()

    def ratio(r):  # an f32 factor, as JAX multiplies by a weakly typed float
        return torch.full((), r, dtype=torch.float32, device=dev)

    # crop (item_crop): the window [start, start + floor(len * ratio) + 1)
    # moved to the front, positions renumbered 1..crop_len
    keep_len = (len_f * ratio(crop_ratio)).int()
    crop_len = torch.minimum(keep_len + 1, seq_len)
    max_start = torch.clamp(seq_len - keep_len, min=1)
    start = (_uniform((b,), generator, dev) * max_start.float()).int()
    src = torch.clamp(start[:, None] + idx, 0, max_len - 1)
    shifted = torch.gather(seq, 1, src.long())
    cvalid = idx < crop_len[:, None]
    cropped = torch.where(cvalid, shifted, 0)
    cropped_pos = torch.where(cvalid, idx + 1, 0).to(pos.dtype)

    # item mask (item_mask): each position kept with probability 1 - ratio
    # (mask token = pad 0)
    masked = torch.where(_keep_mask(tuple(seq.shape), 1.0 - mask_ratio, generator, dev), seq, 0)

    # reorder (item_reorder): shuffle a window of floor(len * ratio) + 1 in
    # place: random sort keys inside the window, position keys outside, so a
    # stable argsort permutes only the window
    w = (len_f * ratio(reorder_ratio)).int() + 1
    rmax_start = torch.clamp(seq_len - (w - 1), min=1)
    rstart = (_uniform((b,), generator, dev) * rmax_start.float()).int()
    in_win = ((idx >= rstart[:, None]) & (idx < (rstart + w)[:, None])
              & (idx < seq_len[:, None]))
    rnd = _uniform((b, max_len), generator, dev)
    key = torch.where(in_win, rstart[:, None].float() + rnd * w[:, None].float(), idx.float())
    reordered = torch.gather(seq, 1, torch.argsort(key, dim=1, stable=True))

    choice = _randint((b,), 3, generator, dev)[:, None]
    out = torch.where(choice == 0, cropped, torch.where(choice == 1, masked, reordered))
    out_pos = torch.where(choice == 0, cropped_pos, pos)
    return out, out_pos


def _last_rep(h: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Each row's representation at its last non-empty position (a crop may
    remove the original final position); row 0's for an empty view."""
    idx = torch.arange(s.shape[1], device=s.device)[None, :]
    last = torch.amax(torch.where(s > 0, idx, -1), dim=1)
    return h[torch.arange(h.shape[0], device=h.device), torch.clamp(last, min=0)]


def build_seq_from_cf(cf: CFDeviceData, max_len: int = 50) -> SeqDeviceData:
    """Per-user ordered sequences from the CF device data's training edges
    in their stored order (`edge_u`, `edge_i`), on the same device."""
    return seq_device_data(cf.edge_u.cpu().numpy(), cf.edge_i.cpu().numpy(), cf.n_users,
                           cf.n_items, cf.edge_u.device, max_len)


def _build_sasrec_like(name: str, use_cl: bool):
    def builder(cfg: Config, cf: CFDeviceData, kg=None, mesh=None) -> ModelBundle:
        seq_data = build_seq_from_cf(cf)
        module = SASRecEncoder(seq_data.n_items, cfg.embedding_size, seq_data.max_len,
                               n_blocks=cfg.n_layers, n_heads=1,
                               dropout=cfg.drop_rate).to(cf.edge_u.device)

        def batch_loss(extras, batch, edge_keys=(), generator=None):
            seq, pos, y, neg, valid_row = batch
            b = seq.shape[0]
            rows = data_share(mesh, b).rows
            whole = (rows, b) if data_ranks(mesh) > 1 else None
            h, item_emb = module(seq[rows], pos[rows], True, generator, whole)
            pos_logits = torch.sum(h * _rows(item_emb, y[rows]), dim=-1)
            neg_logits = torch.sum(h * _rows(item_emb, neg[rows]), dim=-1)
            vf = ((y > 0) & valid_row[:, None]).to(h.dtype)
            bce = -(torch.log(torch.sigmoid(pos_logits) + 1e-24)
                    + torch.log(1.0 - torch.sigmoid(neg_logits) + 1e-24))
            rec = torch.sum(bce * vf[rows]) / torch.clamp(torch.sum(vf), min=1.0)
            aux = {"rec_loss": rec.detach()}
            loss = rec
            if use_cl:
                seq_len = torch.sum((seq > 0).int(), dim=1)
                s1, p1 = _seq_augment(seq, pos, seq_len, generator)
                s2, p2 = _seq_augment(seq, pos, seq_len, generator)
                s1, p1, s2, p2 = s1[rows], p1[rows], s2[rows], p2[rows]
                h1, _ = module(s1, p1, True, generator, whole)
                h2, _ = module(s2, p2, True, generator, whole)
                # both views' rows of every data rank, in one gather
                reps = gather_shares(torch.cat([_last_rep(h1, s1), _last_rep(h2, s2)], dim=1),
                                     mesh, b)
                v1, v2 = reps.chunk(2, dim=1)
                cl = cfg.cl_rate * info_nce(v1, v2, cfg.temp, rows=rows)
                aux["cl_loss"] = cl.detach()
                loss = loss + cl
            return loss, aux

        @torch.no_grad()
        def encode_eval(extras):
            h, item_emb = module(seq_data.seq, seq_data.pos)
            last = torch.clamp(seq_data.seq_len.long() - 1, min=0)
            reps = h[torch.arange(h.shape[0], device=h.device), last]  # [n_pad, d]
            # the sequences' representations into their users' rows, in a
            # fixed order; the padding rows point at user 0 with weight 0, and
            # users with < 2 training items keep a zero row
            vf = seq_data.seq_valid[:, None].to(reps.dtype)
            return scatter_sum(reps * vf, seq_data.seq_user, cf.n_users), item_emb[1:].clone()

        return ModelBundle(
            name=name, cfg=cfg, cf=cf, kg=None, uses_kg=False, module=module,
            init=flax_init(module), encode_eval=encode_eval, batch_loss=batch_loss,
            seq=seq_data, batch_kind="sequence", data_split=data_ranks(mesh) > 1,
        )

    return builder


register_model("SASRec")(_build_sasrec_like("SASRec", use_cl=False))
register_model("CL4SRec")(_build_sasrec_like("CL4SRec", use_cl=True))
