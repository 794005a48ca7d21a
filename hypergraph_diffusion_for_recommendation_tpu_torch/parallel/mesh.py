"""Device mesh and collectives — the port of the JAX package's
`parallel/mesh.py`.

The JAX package runs a 2-D logical mesh with a `data` axis (batch/data
parallelism) and a `model` axis (row-sharded embedding tables,
item-sharded eval scoring and distributed top-k) inside one process, its
shards under `shard_map`. The port runs one process per rank
(`torch.distributed`, started by `utils.platform.run_ranks`): `make_mesh`
arranges the ranks into a `DeviceMesh` with the same dimension names, and
each rank holds its own row block of a sharded table (`row_block`).

The process-group backend follows from the layout (`pick_backend`): NCCL
when every rank has a card of its own, gloo on the CPU and when several
ranks share one card (NCCL refuses two ranks on one device). Gloo takes
CUDA tensors for `all_reduce` only among the collectives used here, so
`all_to_all` and `all_gather_cat` stage a CUDA tensor through the host
under gloo, in `_via_host` and nowhere else; the compute around the
collectives stays on the rank's device.

The sharded products and tables (`sharded_adj`, `sharded_gcn`, the
trainer's row blocks) keep every activation replicated over the model
group: each model rank computes the same loss from the same tensors. Three
autograd collectives follow from that:

  * `gather_rows` (all-gather of row blocks): its backward is this rank's
    block of its own gradient. The transpose of the gather, the sum over
    the group followed by this rank's block, would count the group's one
    loss S times;
  * `sum_over_group` (all_reduce): the balanced products' full-row
    partials; its backward passes the gradient on, which every rank holds
    whole already;
  * `copy_to_group` (identity): the operand of a product of which each
    rank computes its own part; its backward sums the parts' gradients
    over the group.

The data axis splits the per-example work of a batch (`data_share`):
each data rank's loss is its share of the global batch's (the terms that
couple the batch's rows, computed whole, at weight 1 / data ranks, or as
the share's rows' terms over every row's denominator), the shares add up
to it, and the trainer sums the gradients over the data group. There each
rank computes a different loss, so the data axis's gather (`gather_shares`:
every data rank's share of a split activation, concatenated) has the
transpose of the all-gather as its backward: the group's cotangents
summed, this rank's block kept (a reduce-scatter).
"""

from __future__ import annotations

import re
from typing import NamedTuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_shape(n: int, data: int = 0, model: int = 0) -> tuple[int, int]:
    """The (data, model) factoring of `n` devices, as the JAX `make_mesh`
    factors them: with data = model = 0, the model axis is 2 when n is
    even and above 2, else 1, and data takes the rest; one of them 0 takes
    what the other leaves."""
    if data <= 0 and model <= 0:
        # favour the data axis; model axis only when n is even and > 2
        model = 2 if n % 2 == 0 and n > 2 else 1
        data = n // model
    elif data <= 0:
        data = n // model
    elif model <= 0:
        model = n // data
    if data * model > n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} devices, have {n}")
    return data, model


def pick_backend(device_type: str, world_size: int, n_cards: int) -> str:
    """NCCL when every rank has a CUDA card of its own; gloo on the CPU and
    when several ranks share a card (NCCL refuses two ranks on one device)."""
    if device_type == "cuda" and world_size <= n_cards:
        return "nccl"
    return "gloo"


def make_mesh(data: int = 0, model: int = 0, device=None, backend: str | None = None):
    """A (data, model) `DeviceMesh` over every rank of the default process
    group (which `utils.platform.run_ranks` initialises), factored as
    `mesh_shape` factors the world size; `device` is the device this rank
    computes on (default: its card, `core.device.resolve_device`). The
    group's backend must be `backend` (default: the one `pick_backend`
    picks for this layout). Unlike the JAX mesh, which may
    leave devices out, every rank must belong to the mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..core.device import resolve_device

    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(utils.platform.run_ranks starts one per rank)")
    world = dist.get_world_size()
    data, model = mesh_shape(world, data, model)
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh leaves ranks out of the {world} started: "
                         "every rank must belong to the mesh")
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    want = backend or pick_backend(device.type, world, n_cards)
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"the default group runs {have}, but {world} ranks on "
                         f"{max(n_cards, 1)} {device.type} device(s) need {want}")
    return init_device_mesh(device.type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def replicated(mesh):
    """Replicated over both axes."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def row_sharded(mesh):
    """Rows over the model axis — embedding tables."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if n == MODEL_AXIS else Replicate() for n in mesh.mesh_dim_names)


def batch_sharded(mesh):
    """Leading axis over the data axis — per-step batches."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if n == DATA_AXIS else Replicate() for n in mesh.mesh_dim_names)


# parameter names that are embedding tables: rows sharded over MODEL_AXIS
# (the survey 2.8 "row-sharded user/item/entity tables" obligation)
TABLE_PARAM_NAMES = frozenset(
    {
        "user_emb",
        "item_emb",
        "user_entity_emb",
        "entity_user_embed",
    }
)


def param_shardings(params, mesh, min_rows: int = 1024):
    """Placements for a params tree (nested dicts of tensors, a module's
    `state_dict` too: a dotted name is judged by its last part): embedding
    tables row-sharded over the model axis (when divisible and large
    enough), everything else replicated."""
    model_size = axis_size(mesh, MODEL_AXIS)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        shape = tuple(getattr(tree, "shape", ()))
        leaf = name.rsplit(".", 1)[-1] if isinstance(name, str) else name
        if (
            leaf in TABLE_PARAM_NAMES
            and len(shape) == 2
            and shape[0] >= min_rows
            and shape[0] % model_size == 0
            and model_size > 1
        ):
            return row_sharded(mesh)
        return replicated(mesh)

    return walk(params)


def row_block(table: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous row block of a full table, row-sharded over the
    model axis, its rows padded with zeros to a multiple of the axis size
    first (a copy)."""
    shards = axis_size(mesh, MODEL_AXIS)
    rows = -(-table.shape[0] // shards)
    start = mesh.get_local_rank(MODEL_AXIS) * rows
    block = table.new_zeros((rows,) + tuple(table.shape[1:]))
    part = table[start:start + rows]
    block[: part.shape[0]] = part
    return block


def _via_host(t: torch.Tensor, group) -> bool:
    """Whether a collective other than all_reduce must stage `t` through
    the host: gloo takes CUDA tensors for all_reduce and broadcast only."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place."""
    dist.all_reduce(t, group=group)
    return t


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-to-all over the leading axis (group-size equal blocks):
    block s goes to group rank s, and block s of the result came from it."""
    host = _via_host(t, group)
    src = (t.cpu() if host else t).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(t.device) if host else out


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every group rank's `t`, concatenated along `dim` in group-rank order."""
    host = _via_host(t, group)
    src = (t.cpu() if host else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if host else out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every group rank's rows of `x`, concatenated in group-rank order.
    Backward: this rank's block of its own gradient (the group computes one
    loss on every rank)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, group)
    return all_gather_cat(x, group)


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """all_reduce (sum) over `group`; the backward passes the gradient on
    (every rank holds the whole gradient of the replicated sum)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOverGroup.apply(x, group)
    return all_reduce_(x.clone(), group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; its backward sums the gradient over `group` (each rank
    computed the part of it that its own share of the work gives)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToGroup.apply(x, group)
    return x


def data_ranks(mesh) -> int:
    """The data axis's size (1 without a mesh)."""
    return 1 if mesh is None else axis_size(mesh, DATA_AXIS)


class DataShare(NamedTuple):
    """A data rank's share of a global batch (`data_share`)."""

    rows: slice  # the rows whose per-example terms this rank computes
    part: float  # their part of the batch: the weight of a mean over them
    whole: float  # 1 / data ranks: the weight of a term over the whole batch


def data_share(mesh, n: int) -> DataShare:
    """This data rank's share of a global batch of `n` rows (the same on
    every rank): its rows are `torch.tensor_split`'s split of the batch over
    the data axis. A per-example mean over the rows is weighted by `part`; a
    term that couples the rows is computed whole and weighted by `whole` (a
    norm over the whole batch), or as its share's rows' terms over every
    row's denominator (a contrast: `ops.losses`' `rows=`; `gather_shares`
    brings a split activation's other rows). The data ranks' losses then add
    up to the global batch's. Without a mesh, or with one data rank, every
    row at weight 1."""
    k = data_ranks(mesh)
    if k == 1:
        return DataShare(slice(None), 1.0, 1.0)
    if n < k:
        raise ValueError(f"a batch of {n} rows does not split over {k} data ranks")
    r = mesh.get_local_rank(DATA_AXIS)
    sizes = share_sizes(mesh, n)
    lo = sum(sizes[:r])
    return DataShare(slice(lo, lo + sizes[r]), sizes[r] / n, 1.0 / k)


def share_sizes(mesh, n: int) -> list[int]:
    """Every data rank's share size of a batch of `n` rows, in data-rank
    order (`data_share`'s split)."""
    k = data_ranks(mesh)
    return [n // k + (r < n % k) for r in range(k)]


def _concat_shares(x: torch.Tensor, group, sizes: list[int]) -> torch.Tensor:
    """Every group rank's `x` ([sizes[rank], ...]), concatenated: padded to
    the largest share for the all-gather, then trimmed."""
    width = max(sizes)
    pad = x.new_zeros((width - x.shape[0],) + tuple(x.shape[1:]))
    parts = all_gather_cat(torch.cat([x, pad]), group)
    return torch.cat([parts[s * width:s * width + n] for s, n in enumerate(sizes)])


class _GatherShares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sizes):
        ctx.group, ctx.sizes = group, sizes
        return _concat_shares(x, group, sizes)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        lo = sum(ctx.sizes[:r])
        total = all_reduce_(g.contiguous().clone(), ctx.group)
        return total[lo:lo + ctx.sizes[r]], None, None


def gather_shares(x: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """Every data rank's share (`data_share`'s rows of a batch of `n`) of
    a split activation, `x` being this rank's, concatenated in data-rank
    order: the whole batch's [n, ...] rows (uneven shares are padded to the
    largest for the all-gather). Backward: the data group's cotangents
    summed, this rank's rows kept (each data rank computes its own loss).
    Without a data axis, `x`."""
    if data_ranks(mesh) == 1:
        return x
    group = mesh.get_group(DATA_AXIS)
    sizes = share_sizes(mesh, n)
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherShares.apply(x, group, sizes)
    return _concat_shares(x, group, sizes)


_PARAMETRIZED = re.compile(r"parametrizations\.([^.]+)\.original")


def canonical_name(name: str) -> str:
    """A parameter's name without the parametrization that row-shards it
    (`parametrizations.user_emb.original` -> `user_emb`)."""
    return _PARAMETRIZED.sub(r"\1", name)


class _RowBlocks(torch.nn.Module):
    """The parametrization of a row-sharded table: the module holds this
    rank's row block; reading the table all-gathers the blocks over the
    model group (backward: this rank's block of the gradient, since every
    model rank computes the same loss)."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh

    def forward(self, block: torch.Tensor) -> torch.Tensor:
        return gather_rows(block, self.mesh.get_group(MODEL_AXIS))

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return row_block(full, self.mesh)


def shard_tables(module: torch.nn.Module, mesh, min_rows: int = 1024) -> list[str]:
    """Row-shard, in place, the parameters of `module` that `param_shardings`
    marks row-sharded over the model axis: each rank keeps its own row block
    as the parameter (so an optimiser built afterwards keeps its state per
    block), and reading the table gathers it. Returns the canonical names
    of the sharded tables (those sharded already included)."""
    from torch.distributed.tensor import Shard
    from torch.nn.utils import parametrize

    params = {canonical_name(n): p for n, p in module.named_parameters()}
    placements = param_shardings(params, mesh, min_rows)
    done = []
    for name, p in params.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        if parametrize.is_parametrized(owner, leaf):
            done.append(name)
        elif any(isinstance(q, Shard) for q in placements[name]):
            parametrize.register_parametrization(owner, leaf, _RowBlocks(mesh), unsafe=True)
            done.append(name)
    return done


def unshard_tables(module: torch.nn.Module) -> None:
    """Undo `shard_tables`: every table whole again on every rank (a
    collective: every rank of the model group calls it)."""
    from torch.nn.utils import parametrize

    for name, _ in list(module.named_parameters()):
        if name != canonical_name(name):
            owner_name, _, leaf = canonical_name(name).rpartition(".")
            with torch.no_grad():
                parametrize.remove_parametrizations(module.get_submodule(owner_name), leaf)


def local_table(module: torch.nn.Module, name: str) -> torch.Tensor | None:
    """This rank's row block of the row-sharded table `name` of `module`, or
    None when the table is not sharded."""
    from torch.nn.utils import parametrize

    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    if not parametrize.is_parametrized(owner, leaf):
        return None
    return owner.parametrizations[leaf].original
