"""The two min-mapping sweep kernels: wrappers, plain versions, counters,
and plain replays of the kernels' updates.

The port's counterpart of ``repro.kernels.contour_mm.blocked``.  Both
kernels are hand-written CUDA for Hopper in ``csrc/contour_mm.cu`` (see
its header for what bounds them and how the design answers it):

* :func:`fused_relax` — one synchronous order-2 sweep straight off the
  edge list (replaces ``fused_relax_pallas``).  It carries every order-2
  sweep of the main path, at any ``n``: the TPU kernel's single-VMEM-tile
  limit has no counterpart here.
* :func:`scatter_min` — ``L.at[targets].min(values)`` over an update
  stream (replaces ``binned_scatter_min_pallas``); the order-1 and
  order-h sweeps go through it.

A warp takes a step of ``32 * E`` consecutive items (``E`` =
:data:`FUSED_ITEMS_PER_LANE` edges or :data:`SCATTER_ITEMS_PER_LANE`
updates), lane ``l`` items ``l, l + 32, ...``; slot ``j`` of a step is
the lanes' ``j``-th update (an edge makes four: ``s, d, L[s], L[d]``).
An edge's four targets are deduplicated, an update that cannot lower its
target's input label is dropped, the rest read the output label through
L1 and drop out where it is already low enough, and in a hot slot (its
first live lane's target shared by :data:`HOT_LANES` live lanes, before
that test) the lanes of each target combine into one red.
:func:`fused_relax_combined_replay` and :func:`scatter_min_combined_replay`
replay that in plain torch, item to (step, slot, lane) as the kernels map
them, and return the labels with the counts that depend only on the
input: the updates before the test and the hot slots.  On the CPU they
are test-only, and on the card ``chip_smoke.py`` holds the kernels'
counts to theirs.

Each wrapper runs its kernel on a CUDA tensor, or raises; its plain torch
version (``*_plain``) runs only when the tensors lie on the CPU.  The
wrapper allocates the output (a copy of ``L``), launches on the current
stream, raises if the launch reports an error, and adds one to its
``launches`` count for every kernel launch.  :func:`fused_relax_sweep` and
:func:`scatter_min_sweep` launch on CUDA tensors and, with ``counts``,
return the kernel's counts of :data:`COUNTERS` too.

Every wrapper and plain version takes ``done``, the fixpoint loop's flag
word (``converged.py``): an int32 tensor of one element on the labels'
device, or None.  Where it is set the sweep returns a copy of ``L``: past
the loop's early-convergence point a sweep is an exact no-op, and the
kernel then skips its pass over the edges.  The kernel reads the word on
the card, so the host does not wait for it.

The fleet's entry points, :func:`fused_relax_batched` and
:func:`scatter_min_batched` (``solve_batch``'s dense loop), sweep ``B``
graphs in one launch: lane ``b``'s vertex ``v`` is ``b * n + v`` in one
``[B * n]`` label array, the edges are the stacked ``[B, m]`` arrays with
each graph's own ids, and a lane whose ``done`` word in the fleet's
``[B, 4]`` loop state (``converged.fleet_state``) is set takes no part.
Their plain versions do the same per-lane arithmetic and read nothing on
the host.  Both take one of two routes, chosen by shape
(``fleet.fleet_route``): the lane route (``csrc/fleet.cu``, each lane's
labels in shared memory) or the global route (this module's
``csrc/contour_mm.cu`` kernels), each counted in the wrapper's
``routes``; ``*_batched_on`` runs a given route.
:func:`scatter_min_batched` takes the lane route only for a stream laid
out as ``[B, run]`` segments (``run=``, ``fleet.stream_segments``).

Ids outside ``[0, n)`` (``n = len(L)``) raise ``IndexError`` on both
devices: the plain versions check before they gather, and the kernels
check every id before they follow it, skip it, and set an error word
that the wrapper reads after the launch.  That read waits for the kernel,
so the main path, whose ids are in range by construction (``Graph``
checks its endpoints, and every sweep keeps labels in ``[0, n)``),
passes ``check=False``: the kernel still never touches memory outside
``L``, and the host is not held up.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import _build
from repro_torch.kernels.contour_mm import fleet

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "contour_mm.cu",)
LIBRARY = "contour_mm"

# the kernels' constants (csrc/contour_mm.cu): items a lane a step, and the
# live lanes on one target that make a slot hot
FUSED_ITEMS_PER_LANE = 2
SCATTER_ITEMS_PER_LANE = 4
HOT_LANES = 8
# what ``counts=True`` returns, in this order: the updates before the test
# of the output label, the hot slots (steps times slots), the updates left
# after the test, and the reds issued to memory after the combine.  The
# first two depend only on the input; the replays count them too.
COUNTERS = ("reds_before_test", "hot_slots", "reds_after_test",
            "reds_to_memory")

_P = ctypes.c_void_p

_FUSED_IDS = "fused_relax: an edge endpoint or a label at one"
_SCATTER_IDS = "scatter_min: an update target"


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the API of a ``contour_mm`` library."""
    i64, i32 = ctypes.c_int64, ctypes.c_int
    lib.contour_fused_relax.argtypes = [_P, _P, _P, _P, i64, _P, _P, i64,
                                        _P, _P]
    lib.contour_fused_relax.restype = i32
    lib.contour_scatter_min.argtypes = [_P, _P, _P, _P, _P, i64, _P, _P,
                                        i64, _P, _P]
    lib.contour_scatter_min.restype = i32
    if hasattr(lib, "contour_fused_relax_batched"):
        lib.contour_fused_relax_batched.argtypes = [_P, _P, _P, _P, i64,
                                                    i64, i64, _P, _P]
        lib.contour_fused_relax_batched.restype = i32
        lib.contour_scatter_min_batched.argtypes = [_P, _P, _P, _P, i64,
                                                    i64, i64, _P, _P]
        lib.contour_scatter_min_batched.restype = i32
    return lib


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load ``libcontour_mm``; declare its API."""
    return declare(_build.load_library(LIBRARY, SOURCES))


def check_int32(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.int32 or t.dim() != 1:
        raise TypeError(f"{name} must be a 1-D int32 tensor, got "
                        f"{t.dtype} of shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, L on {device}")


def on_cuda(L: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if L.device.type == "cuda":
        return True
    if L.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {L.device}")


def check_done(done: Optional[torch.Tensor],
               device: torch.device) -> Optional[int]:
    """The address of the loop's done word (None: no word), after checking
    that it is one int32 element on ``device``."""
    if done is None:
        return None
    if done.dtype != torch.int32 or done.numel() != 1:
        raise TypeError(f"done must be one int32 element, got {done.dtype} "
                        f"of shape {tuple(done.shape)}")
    if done.device != device:
        raise ValueError(f"done is on {done.device}, L on {device}")
    return done.data_ptr()


def frozen(done: Optional[torch.Tensor]) -> bool:
    """Whether the done word is set: the plain versions' test, on CPU
    tensors, where reading it costs no wait."""
    return done is not None and bool(done.reshape(()))


def _check_ids(what: str, ids: torch.Tensor, n: int) -> None:
    """Raise IndexError if any id lies outside ``[0, n)``."""
    if ids.numel() and bool(((ids < 0) | (ids >= n)).any()):
        raise IndexError(f"{what} outside [0, {n})")


def launch(fn, *args, wrapper, check: bool, what: str,
           L: torch.Tensor) -> None:
    """Launch ``fn`` on the current stream and count it on ``wrapper``;
    with ``check``, wait for it and raise IndexError if the kernel met an
    id outside ``[0, len(L))``."""
    n = int(L.shape[0])
    err = torch.zeros(1, dtype=torch.int32, device=L.device) if check else None
    with trace.span("launch.", fn.__name__), torch.cuda.device(L.device):
        stream = torch.cuda.current_stream(L.device).cuda_stream
        rc = fn(*args, n, None if err is None else err.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    wrapper.launches += 1
    if err is not None:
        with trace.span("read.launch_check"):
            bad = int(err.item())
        if bad:
            raise IndexError(f"{what} outside [0, {n})")


def edge_count(m: int, edge_limit) -> int:
    if edge_limit is None:
        return m
    return max(0, min(m, int(edge_limit)))


def _counter(counts: bool, device: torch.device) -> Optional[torch.Tensor]:
    """The kernel's counter, zeroed, when ``counts`` asks for it."""
    if not counts:
        return None
    return torch.zeros(len(COUNTERS), dtype=torch.int64, device=device)


def _result(out: torch.Tensor, counter: Optional[torch.Tensor]):
    if counter is None:
        return out
    with trace.span("read.counts"):
        values = counter.tolist()
    return out, dict(zip(COUNTERS, values))


# ---------------------------------------------------------------------------
# fused_relax (K1)
# ---------------------------------------------------------------------------


def fused_relax_plain(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                      edge_limit=None, done=None) -> torch.Tensor:
    """Plain torch version of :func:`fused_relax` (the same function)."""
    if frozen(done):
        return L.clone()
    n = int(L.shape[0])
    m = edge_count(int(src.shape[0]), edge_limit)
    src, dst = src[:m], dst[:m]
    _check_ids(_FUSED_IDS, torch.cat([src, dst]), n)
    ls, ld = L[src], L[dst]
    _check_ids(_FUSED_IDS, torch.cat([ls, ld]), n)
    z = torch.minimum(L[ls], L[ld])
    idx = torch.cat([src, dst, ls, ld]).long()
    return L.scatter_reduce(0, idx, z.repeat(4), "amin", include_self=True)


def check_edges(L: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor) -> None:
    check_int32("L", L, L.device)
    check_int32("src", src, L.device)
    check_int32("dst", dst, L.device)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {tuple(src.shape)} vs "
                         f"{tuple(dst.shape)}")


def fused_relax_sweep(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                      edge_limit=None, *, check: bool = True,
                      counts: bool = False, done=None):
    """Launch the kernel once on CUDA tensors; returns the new labels, and
    with ``counts`` also the counts of :data:`COUNTERS` (which waits for
    the kernel).  :func:`fused_relax` is this at the defaults."""
    check_edges(L, src, dst)
    if not on_cuda(L):
        raise ValueError("fused_relax's kernel takes CUDA tensors; "
                         "fused_relax() runs the plain version on CPU "
                         "tensors")
    done_ptr = check_done(done, L.device)
    L, src, dst = L.contiguous(), src.contiguous(), dst.contiguous()
    m = edge_count(int(src.shape[0]), edge_limit)
    out = L.clone()
    counter = _counter(counts, L.device)
    if m > 0:
        launch(load_library().contour_fused_relax, L.data_ptr(),
               out.data_ptr(), src.data_ptr(), dst.data_ptr(), m,
               None if counter is None else counter.data_ptr(), done_ptr,
               wrapper=fused_relax, check=check, what=_FUSED_IDS, L=L)
    return _result(out, counter)


def fused_relax(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                edge_limit=None, *, check: bool = True,
                done=None) -> torch.Tensor:
    """One synchronous order-2 min-mapping sweep; returns new labels.

    Equals ``minmap.mm_relax(L, src, dst, 2)`` bit for bit.  Edges at
    positions ``>= edge_limit`` (a Python int or 0-d tensor) take no part.
    The TPU kernel masked them to ``(0, 0)`` self-loops instead; under the
    ``L[v] <= v`` labelling invariant (so ``L[0] == 0``) such a self-loop
    is a no-op, and the two agree.  An endpoint, or a label at one,
    outside ``[0, len(L))`` raises IndexError; on the card,
    ``check=False`` skips such an edge instead and does not wait for the
    kernel.  With ``done`` set it returns a copy of ``L``.
    """
    check_edges(L, src, dst)
    if not on_cuda(L):
        return fused_relax_plain(L, src, dst, edge_limit, done)
    return fused_relax_sweep(L, src, dst, edge_limit, check=check, done=done)


fused_relax.launches = 0


def fused_relax_work(n: int, m: int) -> Tuple[int, int]:
    """(bytes, operations) the least a :func:`fused_relax` sweep of
    ``m`` edges over ``n`` labels needs: L, src and dst read once and the
    output labels written once (4n + 8m + 4n), and per edge one min for
    z and four compares against the gathered labels (5m).  The bound of
    ``chip_smoke.py``'s kernels line and the dry-run's ``contour-cc``
    cell."""
    return 4 * n + 8 * m + 4 * n, 5 * m


def _hot_slots(slots: torch.Tensor, per_lane: int) -> int:
    """The hot slots of a kernel's steps.  ``slots`` is (items, w): item
    ``e``'s ``w`` update targets, -1 where it has none.  As the kernels map
    them, item ``e`` is lane ``e % 32`` of row ``(e // 32) % per_lane`` of
    step ``e // (32 * per_lane)``, and each (step, row, column) is one
    slot of the warp; a slot is hot where its first live lane's target is
    the target of :data:`HOT_LANES` live lanes."""
    items, w = slots.shape
    if items == 0:
        return 0
    chunk = 32 * per_lane
    t = torch.cat([slots, slots.new_full(((-items) % chunk, w), -1)])
    t = t.reshape(-1, per_lane, 32, w).permute(0, 1, 3, 2).reshape(-1, 32)
    live = t >= 0
    first = t.gather(1, live.to(torch.uint8).argmax(1, keepdim=True))
    same = ((t == first) & live).sum(1)
    return int((live.any(1) & (same >= HOT_LANES)).sum())


def _replay(L: torch.Tensor, slots: torch.Tensor, values: torch.Tensor,
            per_lane: int) -> Tuple[torch.Tensor, Dict[str, int]]:
    """The updates ``slots[e, j] >= 0`` with value ``values[e]`` applied to
    a copy of ``L``, and the counts that depend only on the input."""
    live = slots >= 0
    out = L.scatter_reduce(0, slots[live].long(),
                           values[:, None].expand_as(slots)[live], "amin",
                           include_self=True)
    return out, {"reds_before_test": int(live.sum()),
                 "hot_slots": _hot_slots(slots, per_lane)}


def fused_relax_combined_replay(L: torch.Tensor, src: torch.Tensor,
                                dst: torch.Tensor, edge_limit=None, *,
                                dedupe: bool = True,
                                items_per_lane: int = FUSED_ITEMS_PER_LANE
                                ) -> Tuple[torch.Tensor, Dict[str, int]]:
    """The fused kernel's updates, replayed in plain torch: the labels and
    the counts ``reds_before_test`` and ``hot_slots`` of :data:`COUNTERS`.

    Each edge's targets ``s, d, L[s], L[d]`` (its four slots) that can
    lower their input label become updates ``(target, z)``; a later copy
    of an earlier target of the edge is dropped (its label, so its
    condition, is the same).  ``dedupe=False`` is the control that keeps
    every copy; ``items_per_lane`` other than the kernel's maps the edges
    to other steps.  The kernel's counter holds the same numbers; the reds
    it then issues to memory depend on the order in which they land.
    """
    check_edges(L, src, dst)
    n = int(L.shape[0])
    m = edge_count(int(src.shape[0]), edge_limit)
    s, d = src[:m], dst[:m]
    _check_ids(_FUSED_IDS, torch.cat([s, d]), n)
    ls, ld = L[s], L[d]
    _check_ids(_FUSED_IDS, torch.cat([ls, ld]), n)
    l2s, l2d = L[ls], L[ld]
    z = torch.minimum(l2s, l2d)
    targets = (s, d, ls, ld)
    live = [z < ls, z < ld, z < l2s, z < l2d]
    if dedupe:
        for k in range(1, 4):
            for j in range(k):
                live[k] = live[k] & (targets[k] != targets[j])
    slots = torch.stack([torch.where(live[k], targets[k], -1)
                         for k in range(4)], dim=1)
    return _replay(L, slots, z, items_per_lane)


# ---------------------------------------------------------------------------
# scatter_min (K2)
# ---------------------------------------------------------------------------


def scatter_min_plain(L: torch.Tensor, targets: torch.Tensor,
                      values: torch.Tensor,
                      valid: Optional[torch.Tensor] = None,
                      done=None) -> torch.Tensor:
    """Plain torch version of :func:`scatter_min` (the same function)."""
    if frozen(done):
        return L.clone()
    if valid is not None:
        targets, values = targets[valid], values[valid]
    _check_ids(_SCATTER_IDS, targets, int(L.shape[0]))
    return L.scatter_reduce(0, targets.long(), values, "amin",
                            include_self=True)


def check_updates(L: torch.Tensor, targets: torch.Tensor,
                  values: torch.Tensor,
                  valid: Optional[torch.Tensor]) -> None:
    check_int32("L", L, L.device)
    check_int32("targets", targets, L.device)
    check_int32("values", values, L.device)
    if targets.shape != values.shape:
        raise ValueError(f"targets/values shape mismatch: "
                         f"{tuple(targets.shape)} vs {tuple(values.shape)}")
    if valid is not None:
        if valid.dtype != torch.bool or valid.shape != targets.shape:
            raise TypeError(f"valid must be bool of shape "
                            f"{tuple(targets.shape)}, got {valid.dtype} "
                            f"{tuple(valid.shape)}")
        if valid.device != L.device:
            raise ValueError(f"valid is on {valid.device}, L on {L.device}")


def scatter_min_sweep(L: torch.Tensor, targets: torch.Tensor,
                      values: torch.Tensor,
                      valid: Optional[torch.Tensor] = None, *,
                      check: bool = True, counts: bool = False, done=None):
    """Launch the kernel once on CUDA tensors; returns the new labels, and
    with ``counts`` also the counts of :data:`COUNTERS` (which waits for
    the kernel).  :func:`scatter_min` is this at the defaults."""
    check_updates(L, targets, values, valid)
    if not on_cuda(L):
        raise ValueError("scatter_min's kernel takes CUDA tensors; "
                         "scatter_min() runs the plain version on CPU "
                         "tensors")
    done_ptr = check_done(done, L.device)
    L, targets, values = L.contiguous(), targets.contiguous(), \
        values.contiguous()
    if valid is not None:
        valid = valid.contiguous()
    k = int(targets.shape[0])
    out = L.clone()
    counter = _counter(counts, L.device)
    if k > 0:
        launch(load_library().contour_scatter_min, L.data_ptr(),
               out.data_ptr(), targets.data_ptr(), values.data_ptr(),
               None if valid is None else valid.data_ptr(), k,
               None if counter is None else counter.data_ptr(), done_ptr,
               wrapper=scatter_min, check=check, what=_SCATTER_IDS, L=L)
    return _result(out, counter)


def scatter_min(L: torch.Tensor, targets: torch.Tensor, values: torch.Tensor,
                valid: Optional[torch.Tensor] = None, *,
                check: bool = True, done=None) -> torch.Tensor:
    """``L.at[targets].min(values)``, skipping updates where ``valid`` is
    False; returns new labels (``L`` is not modified).  A live target
    outside ``[0, len(L))`` raises IndexError; on the card,
    ``check=False`` skips such an update instead and does not wait for
    the kernel.  With ``done`` set it returns a copy of ``L``."""
    check_updates(L, targets, values, valid)
    if not on_cuda(L):
        return scatter_min_plain(L, targets, values, valid, done)
    return scatter_min_sweep(L, targets, values, valid, check=check,
                             done=done)


scatter_min.launches = 0


def scatter_min_combined_replay(L: torch.Tensor, targets: torch.Tensor,
                                values: torch.Tensor,
                                valid: Optional[torch.Tensor] = None, *,
                                items_per_lane: int = SCATTER_ITEMS_PER_LANE
                                ) -> Tuple[torch.Tensor, Dict[str, int]]:
    """The scatter kernel's updates, replayed in plain torch: the labels
    and the counts ``reds_before_test`` (the updates that ``valid`` keeps
    and whose value is below their target's input label) and
    ``hot_slots`` of :data:`COUNTERS`."""
    check_updates(L, targets, values, valid)
    keep = torch.ones(targets.shape, dtype=torch.bool, device=L.device) \
        if valid is None else valid
    _check_ids(_SCATTER_IDS, targets[keep], int(L.shape[0]))
    live = keep & (values < L[torch.where(keep, targets, 0)])
    return _replay(L, torch.where(live, targets, -1)[:, None], values,
                   items_per_lane)


# ---------------------------------------------------------------------------
# the fleet's sweeps (solve_batch): K1 and K2 over B lanes in one launch
# ---------------------------------------------------------------------------

# an update no label can take: how the plain versions drop a frozen lane's
# updates without reading which lanes are frozen on the host
_NO_UPDATE = torch.iinfo(torch.int32).max


def lane_offsets(lanes_b: int, n: int, device) -> torch.Tensor:
    """``[B, 1]`` int32 ids of each lane's vertex 0 (``b * n``)."""
    return (torch.arange(lanes_b, dtype=torch.int32, device=device)
            * n)[:, None]


def _frozen(lanes: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Each lane's done word as a bool ``[B]`` (None: no lane frozen)."""
    return None if lanes is None else lanes[:, 0] != 0


def check_fleet(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                n: int, lanes: Optional[torch.Tensor]) -> int:
    """Check a fleet's labels, edges and lane words; returns ``B``."""
    check_int32("L", L, L.device)
    for name, t in (("src", src), ("dst", dst)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise TypeError(f"{name} must be a [B, m] int32 tensor, got "
                            f"{t.dtype} of shape {tuple(t.shape)}")
        if t.device != L.device:
            raise ValueError(f"{name} is on {t.device}, L on {L.device}")
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {tuple(src.shape)} vs "
                         f"{tuple(dst.shape)}")
    lanes_b = int(src.shape[0])
    check_lane_words(L, n, lanes_b, lanes)
    return lanes_b


def check_lane_words(L: torch.Tensor, n: int, lanes_b: int,
                     lanes: Optional[torch.Tensor]) -> None:
    """``L`` holds ``B * n`` labels (fewer than 2**31) and ``lanes`` is
    None or the fleet's ``[B, 4]`` int32 words on ``L``'s device."""
    if lanes_b * n != int(L.shape[0]):
        raise ValueError(f"L has {int(L.shape[0])} labels, not B * n = "
                         f"{lanes_b} * {n}")
    if lanes_b * n >= 1 << 31:
        raise ValueError(f"B * n = {lanes_b * n} labels exceed the int32 "
                         "id space")
    if lanes is not None:
        if lanes.dtype != torch.int32 or tuple(lanes.shape) != (lanes_b, 4) \
                or not lanes.is_contiguous():
            raise TypeError(f"lanes must be [{lanes_b}, 4] contiguous "
                            f"int32, got {lanes.dtype} of shape "
                            f"{tuple(lanes.shape)}")
        if lanes.device != L.device:
            raise ValueError(f"lanes is on {lanes.device}, L on {L.device}")


def launch_counted(fn, *args, wrapper, device: torch.device) -> None:
    """Launch ``fn`` on the current stream and count it on ``wrapper``
    (the launchers that take no range flag: the fleet's sweeps and the
    loop's kernels, ``converged.py``)."""
    with trace.span("launch.", fn.__name__), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")
    wrapper.launches += 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fused_relax_batched_plain(L: torch.Tensor, src: torch.Tensor,
                              dst: torch.Tensor, n: int,
                              lanes: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version of :func:`fused_relax_batched`: each live lane's
    order-2 sweep, ``minmap.mm_relax(L_b, src[b], dst[b], 2)``."""
    lanes_b = int(src.shape[0])
    Lv = L.view(lanes_b, n)
    ls = Lv.gather(1, src.long())
    ld = Lv.gather(1, dst.long())
    z = torch.minimum(L[ls], L[ld])
    frozen = _frozen(lanes)
    if frozen is not None:
        z = torch.where(frozen[:, None], _NO_UPDATE, z)
    off = lane_offsets(lanes_b, n, L.device)
    idx = torch.cat([src + off, dst + off, ls, ld]).reshape(-1).long()
    return L.scatter_reduce(0, idx, z.repeat(4, 1).reshape(-1), "amin",
                            include_self=True)


def fused_relax_batched(L: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, n: int,
                        lanes: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """One synchronous order-2 sweep of every lane of a fleet not frozen
    in ``lanes``; returns new labels.  ``L`` is ``[B * n]`` with lane
    ``b``'s vertex ``v`` at ``b * n + v``; ``src``/``dst`` are ``[B, m]``
    with each graph's own ids.  One launch for the whole fleet, on the
    route :func:`fleet.fleet_route` picks."""
    lanes_b = check_fleet(L, src, dst, n, lanes)
    if not on_cuda(L):
        return fused_relax_batched_plain(L, src, dst, n, lanes)
    route = fleet.fleet_route(n, lanes_b, int(src.shape[1]), "relax",
                              fleet.fleet_device(L.device))
    return _relax_fleet(route, L, src, dst, n, lanes, lanes_b)


fused_relax_batched.launches = 0
# launches by route (fleet.FleetRoute.route)
fused_relax_batched.routes = {"lane": 0, "global": 0}


def fused_relax_batched_on(route: fleet.FleetRoute, L: torch.Tensor,
                           src: torch.Tensor, dst: torch.Tensor, n: int,
                           lanes: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """:func:`fused_relax_batched` on CUDA tensors on ``route``, counted on
    :func:`fused_relax_batched`: the wrapper passes
    :func:`fleet.fleet_route`'s choice, the card's tests and
    ``chip_smoke.py`` pass each route to hold it to the plain version."""
    lanes_b = check_fleet(L, src, dst, n, lanes)
    if not on_cuda(L):
        raise ValueError("the fleet's routes run on CUDA tensors")
    return _relax_fleet(route, L, src, dst, n, lanes, lanes_b)


def _relax_fleet(route, L, src, dst, n, lanes, lanes_b) -> torch.Tensor:
    """The launch on ``route`` of checked CUDA tensors."""
    L, src, dst = L.contiguous(), src.contiguous(), dst.contiguous()
    out = L.clone()
    m = int(src.shape[1])
    if m > 0 and lanes_b > 0:
        if route.route == "lane":
            launch_counted(fleet.load_library().contour_fleet_relax_lane,
                           L.data_ptr(), out.data_ptr(), src.data_ptr(),
                           dst.data_ptr(), m, lanes_b, n, _ptr(lanes),
                           route.blocks_per_lane,
                           wrapper=fused_relax_batched, device=L.device)
        else:
            launch_counted(load_library().contour_fused_relax_batched,
                           L.data_ptr(), out.data_ptr(), src.data_ptr(),
                           dst.data_ptr(), m, lanes_b, n, _ptr(lanes),
                           wrapper=fused_relax_batched, device=L.device)
        fused_relax_batched.routes[route.route] += 1
    return out


def scatter_min_batched_plain(L: torch.Tensor, targets: torch.Tensor,
                              values: torch.Tensor, n: int,
                              lanes: Optional[torch.Tensor] = None, *,
                              run: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`scatter_min_batched` (``run``, the stream's
    layout, changes nothing here)."""
    idx = targets.long()
    frozen = _frozen(lanes)
    if frozen is not None:
        values = torch.where(frozen[idx // n], _NO_UPDATE, values)
    return L.scatter_reduce(0, idx, values, "amin", include_self=True)


def _check_stream(L: torch.Tensor, targets: torch.Tensor,
                  values: torch.Tensor, n: int,
                  lanes: Optional[torch.Tensor], run: Optional[int]) -> int:
    """Check a fleet's update stream and lane words; returns ``B``."""
    check_updates(L, targets, values, None)
    lanes_b = int(L.shape[0]) // max(n, 1)
    check_lane_words(L, n, lanes_b, lanes)
    fleet.stream_segments(int(targets.shape[0]), lanes_b, run)
    return lanes_b


def scatter_min_batched(L: torch.Tensor, targets: torch.Tensor,
                        values: torch.Tensor, n: int,
                        lanes: Optional[torch.Tensor] = None, *,
                        run: Optional[int] = None) -> torch.Tensor:
    """``L.at[targets].min(values)`` over a fleet's update stream, whose
    targets are ids of the ``[B * n]`` label array (the lane of an update
    is its target // n); a lane frozen in ``lanes`` takes no update.
    ``run=m`` states that the stream is segments of ``[B, m]`` (lane
    ``b``'s updates of segment ``r`` at ``(r * B + b) * m``, as
    ``contour.mm_update_stream_batched`` emits them), which lets it take
    the lane route; ``run=None`` takes the global route."""
    lanes_b = _check_stream(L, targets, values, n, lanes, run)
    if not on_cuda(L):
        return scatter_min_batched_plain(L, targets, values, n, lanes,
                                         run=run)
    route = fleet.scatter_route(n, lanes_b, run,
                                fleet.fleet_device(L.device))
    return _scatter_fleet(route, L, targets, values, n, lanes, lanes_b, run)


scatter_min_batched.launches = 0
# launches by route (fleet.FleetRoute.route)
scatter_min_batched.routes = {"lane": 0, "global": 0}


def scatter_min_batched_on(route: fleet.FleetRoute, L: torch.Tensor,
                           targets: torch.Tensor, values: torch.Tensor,
                           n: int, lanes: Optional[torch.Tensor] = None, *,
                           run: Optional[int] = None) -> torch.Tensor:
    """:func:`scatter_min_batched` on CUDA tensors on ``route`` (the lane
    route needs ``run``), counted on :func:`scatter_min_batched`, as
    :func:`fused_relax_batched_on`."""
    lanes_b = _check_stream(L, targets, values, n, lanes, run)
    if not on_cuda(L):
        raise ValueError("the fleet's routes run on CUDA tensors")
    if route.route == "lane" and run is None:
        raise ValueError("the lane route takes a stream of [B, run] "
                         "segments: pass run")
    return _scatter_fleet(route, L, targets, values, n, lanes, lanes_b, run)


def _scatter_fleet(route, L, targets, values, n, lanes, lanes_b,
                   run) -> torch.Tensor:
    """The launch on ``route`` of checked CUDA tensors."""
    L, targets, values = L.contiguous(), targets.contiguous(), \
        values.contiguous()
    out = L.clone()
    k = int(targets.shape[0])
    if k > 0 and lanes_b > 0:
        if route.route == "lane":
            launch_counted(fleet.load_library().contour_fleet_scatter_lane,
                           L.data_ptr(), out.data_ptr(), targets.data_ptr(),
                           values.data_ptr(), int(run),
                           fleet.stream_segments(k, lanes_b, run), lanes_b,
                           n, _ptr(lanes), route.blocks_per_lane,
                           wrapper=scatter_min_batched, device=L.device)
        else:
            launch_counted(load_library().contour_scatter_min_batched,
                           L.data_ptr(), out.data_ptr(), targets.data_ptr(),
                           values.data_ptr(), k, int(L.shape[0]), n,
                           _ptr(lanes), wrapper=scatter_min_batched,
                           device=L.device)
        scatter_min_batched.routes[route.route] += 1
    return out
