"""Process group, DDP wrapper and collectives.

Port of ``npp_tpu/parallel/mesh.py:25-72``. npp_tpu runs one SPMD program
over a ``data`` mesh: the batch is one global array, BN takes global
moments, every loss is a loss of the global batch and the gradient is
that loss's. The PyTorch idiom is one process per GPU, launched by
``python -m torch.distributed.run`` (torchrun), each with its shard of
the batch. The port keeps npp_tpu's semantics: at world size N with
per-rank batch b, one step gives the losses, gradients, BN running stats,
lambdas and updated weights of npp_tpu's one-process step on the N*b
batch that concatenates the ranks' batches in rank order:

- every BatchNorm takes the moments of the whole batch
  (``sync_bn.convert_sync_bn``);
- the criterion takes its thresholds, counts and sums over all ranks and
  returns N * (local numerator) / (global denominator)
  (``core/criterion.py``, ``group=``), so the mean of the ranks' losses is
  the global loss and DDP's mean of their gradients is its gradient;
- the loss lambdas, which are not model parameters, get their gradient
  averaged by ``core/train.backward``.

At world size 1 the model keeps plain ``nn.BatchNorm2d`` and the
criterion takes no group, so a step under a group is the step without
one, bit for bit; DDP still wraps the model.

``make_grid`` is the counterpart of ``make_mesh_2d``
(``npp_tpu/parallel/spatial.py:40-50``) and of ``make_mesh_3d``
(``npp_tpu/parallel/tensor.py:35-45``): the ranks form a ``data x space
x model`` grid, model minor (rank = (d * n_space + s) * n_model + m); a
rank holds data shard d, rows [s * H / n_space, (s + 1) * H / n_space)
of its images (``parallel/spatial.py``) and channel block m of every
conv and BN whose width n_model divides (``parallel/tensor.py``).

Not ported: ``make_mesh``, ``batch_sharding``, ``replicated_sharding``,
``shard_batch`` and ``replicate``. A process holds one device and feeds
it its own shard (``data/loader.py``), and DDP broadcasts rank 0's
weights at wrap time, so there is nothing to place.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel


def initialize_distributed(device="cuda", backend: str | None = None) -> bool:
    """Join the process group that torchrun's environment describes:
    ``RANK`` and ``WORLD_SIZE`` (both or neither), ``MASTER_ADDR`` and
    ``MASTER_PORT``, and ``LOCAL_RANK`` for the card. Without them it does
    nothing. ``backend=None`` takes ``nccl`` for a CUDA ``device`` and
    ``gloo`` otherwise; ``gloo`` on a card lets several ranks share one.
    Returns whether this call started the group (the caller then ends it
    with ``torch.distributed.destroy_process_group``)."""
    rank, world = os.environ.get("RANK"), os.environ.get("WORLD_SIZE")
    if not rank and not world:
        return False
    if bool(rank) != bool(world):
        raise RuntimeError(
            f"RANK and WORLD_SIZE must be set together (got RANK={rank!r}, "
            f"WORLD_SIZE={world!r}); launch with python -m "
            f"torch.distributed.run")
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
               if not os.environ.get(k)]
    if missing:
        raise RuntimeError(f"{' and '.join(missing)} not set; launch with "
                           f"python -m torch.distributed.run")
    if dist.is_initialized():
        return False
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(local_device(device).index or 0)
    dist.init_process_group(backend, init_method="env://", rank=int(rank),
                            world_size=int(world))
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Rank 0 (or no group): the process that logs and writes."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def data_group():
    """The group the data is sharded over: the world, or None without a
    process group."""
    return dist.group.WORLD if dist.is_initialized() else None


def multi_rank(group):
    """``group`` if it spans more than one rank, else None: what the
    cross-rank BN and the criterion take (at world size 1 they run their
    one-process code)."""
    if group is None or dist.get_world_size(group) == 1:
        return None
    return group


def local_device(device) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for a CUDA device given
    without an index under torchrun, else ``device`` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None \
            and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def wrap_model(model: torch.nn.Module, group=None) -> torch.nn.Module:
    """``DistributedDataParallel(model)`` over ``group`` (the world by
    default) whenever a process group is up, world size 1 included; the
    model itself without one. Buffers are not broadcast at each forward:
    the cross-rank BN leaves the same running stats on every rank.
    ``find_unused_parameters`` stays off: every parameter of NPPNet and of
    the supernet gets a gradient from the dual-task loss."""
    if not dist.is_initialized():
        return model
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=group, broadcast_buffers=False)


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (a new tensor)."""
    t = t.clone()
    dist.all_reduce(t, group=group)
    return t


def all_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of ``t`` over the ranks of ``group`` (a new
    tensor in ``wire``'s dtype): one MAX all-reduce, counted in
    ``all_max.calls``."""
    t = wire(t).clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    all_max.calls += 1
    return t


all_max.calls = 0  # MAX all-reduces issued, read by the tests and chip_smoke


def wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a dtype every backend all-reduces (bf16 / fp16 as fp32)."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def all_slots(t: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *t.shape) in ``wire``'s dtype: every rank's ``t`` (one shape on
    all ranks) in its slot, in rank order. Each rank writes its own slot
    of a zeroed buffer and one all-reduce sums them, since gloo has no
    all-gather of CUDA tensors. Adding zeros is exact."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    buf = wire(t).new_zeros((n,) + tuple(t.shape))
    buf[r] = t
    dist.all_reduce(buf, group=group)
    return buf


def all_concat(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order
    (``all_slots``), in ``t``'s dtype."""
    buf = all_slots(t, group)
    return buf.reshape((buf.shape[0] * t.shape[0],) + tuple(t.shape[1:])
                       ).to(t.dtype)


def all_gather_numpy(arr) -> list:
    """Every rank's ``arr`` (any picklable value, e.g. a numpy array), in
    rank order; ``[arr]`` without a process group."""
    if not dist.is_initialized():
        return [arr]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, arr)
    return out


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in a ``data x space x model`` grid of ranks: its
    data index ``d`` of ``n_data``, space index ``s`` of ``n_space`` and
    model index ``m`` of ``n_model``, and its groups: ``world`` (every
    rank of the grid), ``data_group`` (the ranks with this ``s`` and
    ``m``), ``space_group`` (the ranks with this ``d`` and ``m``, which
    hold the rows of the same images), ``model_group`` (the ranks with
    this ``d`` and ``s``, which hold the channel blocks of the same rows)
    and ``replica_group`` (the ranks with this ``m``, which hold the same
    channel block: DDP, the cross-rank BN and the criterion span it). At
    ``n_model`` 1 the replica group is the world."""
    n_data: int
    n_space: int
    d: int
    s: int
    world: object
    data_group: object
    space_group: object
    n_model: int = 1
    m: int = 0
    model_group: object = None
    replica_group: object = None

    def __post_init__(self):
        if self.replica_group is None and self.n_model == 1:
            object.__setattr__(self, "replica_group", self.world)


def make_grid(n_data: int, n_space: int, n_model: int | None = None,
              ranks=None) -> Grid | None:
    """The ``n_data x n_space x n_model`` grid over ``ranks`` (default:
    every rank of the process group), model minor: ``ranks[(d * n_space
    + s) * n_model + m]`` holds data shard d, row block s and channel
    block m. Without ``n_model`` it is the ``data x space`` grid (and
    its message names two axes, as ``make_mesh_2d``'s). Every process of
    the group must call it with the same arguments
    (``torch.distributed.new_group`` is a collective); a process outside
    ``ranks`` gets None."""
    if not dist.is_initialized():
        raise RuntimeError("a grid needs a process group; launch with "
                           "python -m torch.distributed.run")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    shape = (n_data, n_space) if n_model is None else (n_data, n_space,
                                                       n_model)
    n_model = n_model or 1
    size = n_data * n_space * n_model
    if size != len(ranks):
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {size} "
                         f"devices, got {len(ranks)}")
    at = lambda d, s, m: ranks[(d * n_space + s) * n_model + m]
    world = (dist.group.WORLD if len(ranks) == dist.get_world_size()
             else dist.new_group(ranks))
    data_groups = {(s, m): dist.new_group([at(d, s, m)
                                           for d in range(n_data)])
                   for s in range(n_space) for m in range(n_model)}
    space_groups = {(d, m): dist.new_group([at(d, s, m)
                                            for s in range(n_space)])
                    for d in range(n_data) for m in range(n_model)}
    model_groups, replica_groups = {}, {}
    if n_model > 1:
        model_groups = {(d, s): dist.new_group([at(d, s, m)
                                                for m in range(n_model)])
                        for d in range(n_data) for s in range(n_space)}
        replica_groups = {m: dist.new_group([at(d, s, m)
                                             for d in range(n_data)
                                             for s in range(n_space)])
                          for m in range(n_model)}
    me = dist.get_rank()
    if me not in ranks:
        return None
    ds, m = divmod(ranks.index(me), n_model)
    d, s = divmod(ds, n_space)
    return Grid(n_data, n_space, d, s, world, data_groups[s, m],
                space_groups[d, m], n_model, m, model_groups.get((d, s)),
                replica_groups.get(m))
