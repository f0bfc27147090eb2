"""The cost of a rank's program, counted op by op as it runs (the port's
counterpart of ``repro/roofline/hlo_cost.py``).

The reference compiles a program and re-derives FLOPs, HBM bytes and
collective bytes from XLA's optimized HLO text, multiplying each ``while``
body by its trip count (XLA's own ``cost_analysis`` counts a body once).
The port has no HLO: its program runs eagerly, on ``meta`` tensors (shape
and type, no storage) or on the card, under :class:`OpCost`, a
``TorchDispatchMode`` that sees every aten op the program dispatches,
forward and backward.  A Python loop is counted trip by trip, because
each trip dispatches its ops again, so the loop-once pitfall does not
arise.  Per op:

  * FLOPs   — products only, as the reference's ``_dot_flops`` counts
              ``dot``: 2 x output elements x contracted size, for ``mm``,
              ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``addmv`` and
              ``dot`` (``matmul``, ``linear`` and ``einsum`` arrive as
              these);
  * bytes   — each op's tensor inputs plus its outputs (an eager op reads
              its inputs from HBM and writes its outputs there: no fusion
              model).  Views and the reference's ``_FREE_OPS``
              counterparts (``view``, ``expand``, ``permute``, ``t``,
              ``detach``, ``_unsafe_view``, ``empty``, ...) are free, and
              an op on a view is charged the view's elements, not its
              storage's.  ``copy_`` is charged its source and destination,
              ``fill_``/``zero_`` their output.  An indexed op is charged
              the region it addresses, as ``hlo_cost.py`` charges
              gather/scatter: a gather (``index``, ``index_select``,
              ``gather``, ``embedding``) 2 x output + indices, a scatter
              (``index_put_``, ``scatter*``, ``index_add_``, ...) 2 x
              updates + indices;
  * peak    — the largest sum of live storage bytes while the program
              runs: every storage the program is given (:meth:`OpCost.hold`)
              or an op creates is counted once, however many views share
              it, until its last reference goes (a weak reference to the
              storage's Python object, which lives exactly as long as the
              storage).  A ``meta`` storage has no data pointer (it is 0
              for all of them), so storages are told apart by the address
              of the storage object itself (``untyped_storage()._cdata``);
  * collectives — not aten ops: a :class:`repro_torch.runtime.mesh.PricedRank`
              records each one the program would run (kind, group size,
              bytes), and :meth:`Cost.add_collectives` prices them by the
              reference's ring model (``analysis.collective_stats``),
              charging their input and result to ``bytes`` as
              ``hlo_cost.py`` charges a collective's operands and output.

What the model leaves out: XLA's fusion (an eager op's traffic is what it
is, where XLA would keep a fused chain's temporaries on chip), buffer
assignment (the peak is the traced live bytes, not a liveness plan), and
the caching allocator's rounding and workspaces on the card.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline.analysis import collective_stats

_aten = torch.ops.aten

# products: (the op, the position of its left operand)
_PRODUCTS = {
    _aten.mm: 0, _aten.bmm: 0, _aten.mv: 0, _aten.dot: 0,
    _aten.addmm: 1, _aten.baddbmm: 1, _aten.addmv: 1,
}
# ops that move no data themselves (beyond the views, which are found by
# their schema)
_FREE = {
    _aten._unsafe_view, _aten.empty, _aten.empty_strided, _aten.empty_like,
    _aten.new_empty, _aten.new_empty_strided, _aten.detach, _aten.set_,
    _aten.resize_, _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
    _aten.sym_storage_offset,
}
# indexed reads: charged 2 x output + indices
_GATHERS = {
    _aten.index, _aten._unsafe_index, _aten.index_select, _aten.gather,
    _aten.embedding,
}
# indexed writes: (the position of the updates, of the indices), charged
# 2 x updates + indices
_SCATTERS = {
    _aten.index_put: (2, 1), _aten.index_put_: (2, 1),
    _aten._index_put_impl_: (2, 1), _aten._unsafe_index_put: (2, 1),
    _aten.scatter: (3, 2), _aten.scatter_: (3, 2),
    _aten.scatter_add: (3, 2), _aten.scatter_add_: (3, 2),
    _aten.scatter_reduce: (3, 2), _aten.scatter_reduce_: (3, 2),
    _aten.index_add: (3, 2), _aten.index_add_: (3, 2),
    _aten.index_copy: (3, 2), _aten.index_copy_: (3, 2),
}
# ops that write their output without reading it
_WRITES = {_aten.fill_, _aten.zero_}
# ops left out of the count: a tensor made from Python data
# (``torch.tensor``) dispatches ``lift_fresh`` on the CPU and the card,
# not on ``meta``
_UNCOUNTED = {_aten.lift_fresh}


def tensors_of(tree) -> Iterator[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and NamedTuples (an
    op's arguments or results, or a program's)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_of(x))


@dataclasses.dataclass
class Cost:
    """What a program costs one rank (``hlo_cost.Cost``'s fields, plus
    ``ops``: the aten ops it dispatched)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_link_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    ops: int = 0

    def add_collectives(self, records: Iterable) -> None:
        """Price a :class:`~repro_torch.runtime.mesh.PricedRank`'s
        records: link bytes by the ring model, their input and result to
        ``bytes``."""
        records = list(records)
        stats = collective_stats(records)
        for k, v in stats.link_bytes.items():
            self.coll_link_bytes[k] = self.coll_link_bytes.get(k, 0) + v
        for k, v in stats.op_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v
        self.bytes += sum(r.in_bytes + r.out_bytes for r in records)

    @property
    def total_coll_link_bytes(self) -> float:
        return sum(self.coll_link_bytes.values())


@dataclasses.dataclass
class Memory:
    """A rank's bytes: what the program is given, what it returns and
    the most it holds at once (``peak_bytes``, its arguments included)."""
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0


def op_cost(func, args, kwargs, out) -> tuple:
    """(FLOPs, bytes) of one aten op ``func`` called with ``args``,
    ``kwargs`` and giving ``out``."""
    packet = func.overloadpacket
    flops = 0.0
    if packet in _PRODUCTS:
        lhs = args[_PRODUCTS[packet]]
        flops = 2.0 * out.numel() * (lhs.shape[-1] if lhs.dim() else 1)
    if func.is_view or packet in _FREE:
        return flops, 0
    if packet in _GATHERS:
        index = args[1:] if packet is not _aten.embedding else args[1:2]
        return flops, 2 * _nbytes(out) + _nbytes(index)
    if packet in _SCATTERS:
        upd, idx = _SCATTERS[packet]
        updates = args[upd] if len(args) > upd else kwargs.get("src")
        written = (_nbytes(updates) if isinstance(updates, torch.Tensor)
                   # a scalar value: one element an index
                   else args[idx].numel() * args[0].element_size())
        return flops, 2 * written + _nbytes(args[idx])
    if packet is _aten.copy_:
        return flops, _nbytes(args[0]) + _nbytes(args[1])
    if packet in _WRITES:
        return flops, _nbytes(out)
    return flops, (_nbytes(args) + _nbytes(list(kwargs.values()))
                   + _nbytes(out))


class OpCost(TorchDispatchMode):
    """Counts every aten op dispatched while it is active (but
    ``lift_fresh``): ``cost`` (:class:`Cost`: ops, FLOPs, bytes) and the
    live storage bytes (``live_bytes``, ``peak_bytes``).  Storages made
    before it are counted from :meth:`hold`."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live_bytes = 0
        self.peak_bytes = 0
        # storage address -> (bytes, a weak reference that drops it)
        self._live: Dict[int, tuple] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # a composite op (``matmul``, ``einsum``, ``linear``) arrives
        # whole under ``torch.inference_mode``: count what it runs
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        if func.overloadpacket not in _UNCOUNTED:
            flops, nbytes = op_cost(func, args, kwargs, out)
            self.cost.ops += 1
            self.cost.flops += flops
            self.cost.bytes += nbytes
        for t in tensors_of(out):
            self._hold(t)
        return out

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (dicts, lists, tuples
        and NamedTuples) as live; returns the bytes newly counted."""
        before = self.live_bytes
        for t in tensors_of(tree):
            self._hold(t)
        return self.live_bytes - before

    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = (n, weakref.ref(storage,
                                          lambda _, key=key: self._drop(key)))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _drop(self, key: int) -> None:
        n, _ = self._live.pop(key)
        self.live_bytes -= n


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of ``tree``'s tensors."""
    seen: Dict[int, int] = {}
    for t in tensors_of(tree):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def price(fn, *args, mesh: Optional[Any] = None, **kwargs) -> tuple:
    """``(fn(*args, **kwargs), Cost, Memory)``: the call counted by
    :class:`OpCost`, with ``mesh``'s collective records (a
    :class:`~repro_torch.runtime.mesh.PricedRank`) made during it.  The
    arguments are live from the start; the peak counts them."""
    start = len(mesh.records) if mesh is not None else 0
    with OpCost() as counter:
        argument_bytes = counter.hold((args, kwargs))
        out = fn(*args, **kwargs)
    cost = counter.cost
    if mesh is not None:
        cost.add_collectives(mesh.records[start:])
    memory = Memory(argument_bytes=argument_bytes,
                    output_bytes=storage_bytes(out),
                    peak_bytes=counter.peak_bytes)
    return out, cost, memory
