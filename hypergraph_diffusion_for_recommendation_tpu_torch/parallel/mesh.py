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
"""

from __future__ import annotations

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


def make_mesh(data: int = 0, model: int = 0, device="cpu", backend: str | None = None):
    """A (data, model) `DeviceMesh` over every rank of the default process
    group (which `utils.platform.run_ranks` initialises), factored as
    `mesh_shape` factors the world size; `device` is the device this rank
    computes on. The group's backend must be `backend` (default: the one
    `pick_backend` picks for this layout). Unlike the JAX mesh, which may
    leave devices out, every rank must belong to the mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(utils.platform.run_ranks starts one per rank)")
    device = torch.device(device)
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
