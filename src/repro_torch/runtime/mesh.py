"""A mesh of ``torch.distributed`` ranks: the port's ``jax.sharding.Mesh``.

The reference places a distributed solve on a ``jax.sharding.Mesh`` (an
ndarray of devices with named axes) and lets ``shard_map`` give each
device its block and run ``lax.pmin``/``psum`` over named axes.  The port
runs SPMD instead: one process per rank, every rank running the same
program on its own block, with ``torch.distributed`` collectives.
:class:`Mesh` is that program's view of the placement:

* ``devices`` — an ndarray of ranks, so ``tuple(mesh.devices.shape)``
  reads as in the reference; ``axis_names``; ``shape`` (name -> size);
* the calling rank's ``coordinate`` in it (None for a rank outside the
  mesh: the surplus ranks an elastic mesh leaves out);
* :meth:`Mesh.group` — the process group over a tuple of axes: the ranks
  that share the calling rank's coordinates on the other axes (the
  reference's ``axis_name=`` of a collective);
* :meth:`Mesh.shard_index` — the rank's block of an array sharded over a
  tuple of axes, the first axis major (``PartitionSpec((a, b))``);
* ``device`` — the rank's own device: ``cuda:(local_rank %
  device_count())`` unless the caller names one (the tests pass
  ``device="cpu"``).  Without CUDA and without a named device the mesh
  raises; it never lands on the CPU on its own.

The process-group backend (``"nccl"`` on the card, ``"gloo"`` on the
CPU or for ranks that share a card) is whatever the caller initialised
with ``torch.distributed.init_process_group``; nothing here changes it.

Groups are made with ``use_local_synchronization=True``: only the members
of a group take part in making it.  That is what lets a mesh live on a
subset of the world — after an elastic shrink the ranks shed from the
mesh have left the solve and make no further calls — where the default
mode needs every rank of the world, member or not, in every
``new_group`` call in the same order.  Each rank makes each distinct
group once per process group world and reuses it
(:func:`group_of`); a group that spans the whole world is the default
group itself.  ``torch.distributed.device_mesh.DeviceMesh`` is not used:
it covers neither a product of axes without private API nor a mesh over
part of the world.

:class:`AbstractMesh` is ``jax.sharding.AbstractMesh``'s counterpart:
axis names and sizes, no ranks and no process group, so the production
meshes (16 x 16, 2 x 16 x 16) resolve their placements on one host.
``AbstractMesh.at(rank)`` is one rank of it, priced rather than run
(:class:`PricedRank`): the ``Mesh`` interface the models read, on the
``meta`` device, whose collectives return a ``meta`` tensor of the
result's shape and record what they would move
(``repro_torch.launch.dryrun`` prices a rank's program on it).

The collectives the LM needs run over :meth:`Mesh.group`:
:func:`all_reduce`, :func:`all_gather` along one dim and
:func:`reduce_scatter` along one dim, each returning a new tensor and
counted (calls and input bytes: :func:`collective_stats`).  They
take the process group's backend as they find it.  Under ``nccl`` they
are NCCL's own (``reduce_scatter_tensor``).  Under ``gloo`` a tensor on
the card is staged through the host (gloo's collectives are host
collectives), and a reduce-scatter is composed as an all-reduce followed
by taking the rank's block: gloo has no ``reduce_scatter_tensor``.  The
choice is made by the backend's name, before any call.
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.graphs.structs import DeviceLike

# (ranks) -> (the world group it was made under, the group); a group made
# under a world that has since been destroyed is made again
_GROUPS: Dict[Tuple[int, ...], tuple] = {}


def group_of(ranks: Sequence[int]):
    """The process group over ``ranks`` (in that order), made on first use
    by the members only; ``None`` (the default group) when ``ranks`` is
    the whole world.  Every member must call it at the same point of the
    program, as for any collective."""
    ranks = tuple(int(r) for r in ranks)
    if ranks == tuple(range(dist.get_world_size())):
        return None
    world = dist.group.WORLD
    made = _GROUPS.get(ranks)
    if made is None or made[0] is not world:
        made = (world, dist.new_group(list(ranks),
                                      use_local_synchronization=True))
        _GROUPS[ranks] = made
    return made[1]


def local_rank() -> int:
    """The rank's index on its host: ``LOCAL_RANK`` (set by ``torchrun``),
    else the global rank, else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def mesh_device(device: DeviceLike = None) -> torch.device:
    """A rank's device: the named one, else ``cuda:(local_rank %
    device_count())``; raises without CUDA when none is named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "mesh's ranks on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


class AbstractMesh:
    """Axis names and sizes with no ranks behind them: what
    ``resolve_spec``, ``shardings_for`` and ``cache_shardings`` read of a
    mesh (``shape``, ``axis_names``).  ``AbstractMesh((16, 16), ("data",
    "model"))``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"{len(names)} distinct axis names {names} "
                             f"for a mesh of shape {shape}")
        self.axis_names = names
        self.shape = dict(zip(names, shape))

    def __repr__(self) -> str:
        return f"AbstractMesh({tuple(self.shape.values())}, {self.axis_names})"

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def at(self, rank: int) -> "PricedRank":
        """Rank ``rank`` of this mesh (ranks numbered row-major over the
        axes), priced rather than run."""
        return PricedRank(self, rank)


class Mesh:
    """An ndarray of ``torch.distributed`` ranks with named axes.

    ``Mesh(np.arange(8).reshape(2, 4), ("pod", "data"))`` places ranks
    0-7 on a 2 x 4 grid.  The ranks need not be the whole world: the
    calling rank may lie outside the mesh (``coordinate`` is None), and
    then takes part in none of its collectives.  The calling rank is read
    from the initialised default process group when it is first needed,
    so a mesh can be built (and a ``SolveOptions`` holding it validated)
    before ``init_process_group``.
    """

    def __init__(self, devices, axis_names: Sequence[str], *,
                 device: DeviceLike = None):
        ranks = np.asarray(devices)
        if ranks.dtype.kind not in "iu":
            raise TypeError(f"a mesh holds integer ranks, got {ranks.dtype}")
        names = tuple(axis_names)
        if ranks.ndim != len(names):
            raise ValueError(f"{len(names)} axis names {names} for a mesh of "
                             f"shape {ranks.shape}")
        if len(set(names)) != len(names):
            raise ValueError(f"axis names must be distinct, got {names}")
        if len(np.unique(ranks)) != ranks.size or ranks.size == 0:
            raise ValueError(f"a mesh holds distinct ranks, got "
                             f"{ranks.tolist()}")
        self.devices = ranks.astype(np.int64)
        self.axis_names = names
        self.shape = dict(zip(names, ranks.shape))
        self.device = mesh_device(device)

    def __repr__(self) -> str:
        return (f"Mesh({self.devices.tolist()}, {self.axis_names}, "
                f"device={str(self.device)!r})")

    @property
    def rank(self) -> int:
        """The calling process's global rank."""
        return dist.get_rank()

    def coordinate_of(self, rank: int) -> Optional[Tuple[int, ...]]:
        """``rank``'s index on each axis; None outside the mesh."""
        at = np.argwhere(self.devices == rank)
        return tuple(int(i) for i in at[0]) if len(at) else None

    @property
    def coordinate(self) -> Optional[Tuple[int, ...]]:
        """The calling rank's index on each axis; None outside the mesh."""
        return self.coordinate_of(self.rank)

    def _check_axes(self, axes: Sequence[str]) -> Tuple[str, ...]:
        axes = tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or not axes or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} must be distinct names of the "
                             f"mesh's axes {self.axis_names}")
        return axes

    def _member_coordinate(self, rank: Optional[int]) -> Tuple[int, ...]:
        rank = self.rank if rank is None else rank
        coord = self.coordinate_of(rank)
        if coord is None:
            raise ValueError(f"rank {rank} is not in {self!r}")
        return coord

    def n_shards(self, axes: Sequence[str]) -> int:
        """How many blocks an array sharded over ``axes`` has."""
        return int(np.prod([self.shape[a] for a in self._check_axes(axes)]))

    def shard_index(self, axes: Sequence[str],
                    rank: Optional[int] = None) -> int:
        """The block of an array sharded over ``axes`` that ``rank``
        (default: the calling rank) holds, the first axis major (as
        ``PartitionSpec(axes)`` lays it out)."""
        axes = self._check_axes(axes)
        coord = self._member_coordinate(rank)
        index = 0
        for a in axes:
            k = self.axis_names.index(a)
            index = index * self.shape[a] + coord[k]
        return index

    def group_ranks(self, axes: Sequence[str],
                    rank: Optional[int] = None) -> Tuple[int, ...]:
        """The ranks that share ``rank``'s (default: the calling rank's)
        coordinates on every axis but ``axes``, in shard order."""
        axes = self._check_axes(axes)
        coord = self._member_coordinate(rank)
        index = tuple(slice(None) if a in axes else coord[k]
                      for k, a in enumerate(self.axis_names))
        # the kept axes in the order named, so the first is major
        kept = [a for a in self.axis_names if a in axes]
        block = self.devices[index]
        block = np.transpose(block, [kept.index(a) for a in axes])
        return tuple(int(r) for r in block.reshape(-1))

    def group(self, axes: Sequence[str]):
        """The process group of the collectives over ``axes``
        (:func:`group_of`)."""
        return group_of(self.group_ranks(axes))


class Collective(NamedTuple):
    """One collective a :class:`PricedRank` would have run: the
    function's name, the group's size and the bytes of its input and its
    result on the rank."""
    kind: str
    n: int
    in_bytes: int
    out_bytes: int


class PricedRank(Mesh):
    """One rank of an :class:`AbstractMesh`, for pricing its program on
    ``meta`` tensors with no process group: ``devices`` numbers the ranks
    row-major, ``rank`` is the chosen one, ``device`` is ``meta``.  The
    collectives below return a ``meta`` tensor of the result's shape
    instead of running, and append a :class:`Collective` to
    ``records``; they take a live NCCL rank's path (a reduce-scatter
    over axes not in the mesh's order is an all-reduce and the rank's
    block)."""

    def __init__(self, mesh: AbstractMesh, rank: int):
        shape = tuple(mesh.shape.values())
        if not 0 <= rank < mesh.size:
            raise ValueError(f"rank {rank} is not in {mesh!r}")
        self.devices = np.arange(mesh.size, dtype=np.int64).reshape(shape)
        self.axis_names = mesh.axis_names
        self.shape = dict(mesh.shape)
        self.device = torch.device("meta")
        self._rank = int(rank)
        self.records: List[Collective] = []

    def __repr__(self) -> str:
        return (f"PricedRank({tuple(self.shape.values())}, "
                f"{self.axis_names}, rank={self._rank})")

    @property
    def rank(self) -> int:
        return self._rank

    def group(self, axes: Sequence[str]):
        raise RuntimeError(f"{self!r} has no process group")

    def record(self, kind: str, axes: Sequence[str], x: torch.Tensor,
               shape: Sequence[int]) -> torch.Tensor:
        """A ``meta`` tensor of ``shape`` (``x``'s type) standing for the
        result of ``kind`` over ``axes``, recorded."""
        out = torch.empty(tuple(shape), dtype=x.dtype, device="meta")
        self.records.append(Collective(
            kind, self.n_shards(axes), x.numel() * x.element_size(),
            out.numel() * out.element_size()))
        return out


# ---------------------------------------------------------------------------
# Collectives over a group of axes
# ---------------------------------------------------------------------------

# calls and bytes (of the input, on the calling rank) of each collective
# below since the last reset_collective_stats(): what a step moves
COLLECTIVES: Dict[str, list] = {}


def reset_collective_stats() -> None:
    COLLECTIVES.clear()


def collective_stats() -> Dict[str, dict]:
    """``{name: {"calls", "bytes"}}`` since the last reset."""
    return {k: {"calls": v[0], "bytes": v[1]} for k, v in
            sorted(COLLECTIVES.items())}


def _count(name: str, x: torch.Tensor) -> None:
    entry = COLLECTIVES.setdefault(name, [0, 0])
    entry[0] += 1
    entry[1] += x.numel() * x.element_size()


def _is_gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _run(fn, x: torch.Tensor, group):
    """``fn(t)`` on ``x``'s host copy where the group is gloo and ``x``
    lies on the card (the result goes back to ``x``'s device), else on
    ``x`` itself."""
    if _is_gloo(group) and x.device.type != "cpu":
        return fn(x.cpu()).to(x.device)
    return fn(x)


def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced (``op``) over the ranks of ``axes``, a new tensor."""
    if mesh.n_shards(axes) == 1:
        return x.clone()
    if isinstance(mesh, PricedRank):
        return mesh.record("all_reduce", axes, x, x.shape)
    group = mesh.group(axes)
    _count("all_reduce", x)

    def reduce(t):
        t = t.contiguous().clone()
        dist.all_reduce(t, op=op, group=group)
        return t

    return _run(reduce, x, group)


def all_gather(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """The blocks of ``axes``' ranks joined along ``dim`` in shard order
    (the first axis major)."""
    n = mesh.n_shards(axes)
    if n == 1:
        return x.clone()
    if isinstance(mesh, PricedRank):
        shape = list(x.shape)
        shape[dim] *= n
        return mesh.record("all_gather", axes, x, shape)
    group = mesh.group(axes)
    _count("all_gather", x)
    ranks = mesh.group_ranks(axes)
    # a group numbers its members in ascending global rank
    order = [sorted(ranks).index(r) for r in ranks]

    def gather(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat([parts[i] for i in order], dim=dim)

    return _run(gather, x, group)


def block_of(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
             dim: int) -> torch.Tensor:
    """The calling rank's block of ``x`` along ``dim`` over ``axes``
    (a view)."""
    n = mesh.n_shards(axes)
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split into "
                         f"{n} blocks over {tuple(axes)}")
    k = size // n
    return x.narrow(dim, mesh.shard_index(axes) * k, k)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
                   dim: int) -> torch.Tensor:
    """``x`` summed over the ranks of ``axes``, and the calling rank's
    block of the sum along ``dim``.  ``reduce_scatter_tensor`` under
    NCCL; an all-reduce then the block under gloo."""
    n = mesh.n_shards(axes)
    if n == 1:
        return x.clone()
    priced = isinstance(mesh, PricedRank)
    group = None if priced else mesh.group(axes)
    ranks = mesh.group_ranks(axes)
    if list(ranks) != sorted(ranks) or not priced and _is_gloo(group):
        # gloo has no reduce_scatter_tensor; NCCL's hands out blocks in
        # ascending global rank, which is shard order only for axes
        # named in the mesh's order
        return block_of(all_reduce(x, mesh, axes), mesh, axes,
                        dim).contiguous()
    if priced:
        shape = list(x.shape)
        shape[dim] //= n
        return mesh.record("reduce_scatter", axes, x, shape)
    _count("reduce_scatter", x)
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // n,) + moved.shape[1:],
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()
