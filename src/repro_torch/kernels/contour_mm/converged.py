"""The fixpoint loop on the device: the convergence tests, the loop's
state words and the pointer-jump round, with their plain versions.

The reference runs each fixpoint (Contour, FastSV, label propagation) in
one ``lax.while_loop``; its convergence test and pointer jump are XLA
inside that loop, outside any Pallas kernel.  Here they are hand-written
CUDA for Hopper in ``csrc/converged.cu`` (see its header for what bounds
them and how the design answers it):

* :func:`converged_early` — the paper's §III-B2 early-convergence
  predicate over the first ``edge_limit`` edges (K6);
* :func:`labels_unchanged` — ``all(a == b)``, the no-change test of
  C-Syn, FastSV and label propagation (K6's second entry point);
* :func:`pointer_jump` — one synchronous round ``min(L, L[L])``, out of
  place, that the loop can freeze (K7).

The loop keeps its state in four int32 words on the labels' device
(:func:`loop_state`): ``done``, ``it``, ``bad`` and a ticket.  Given the
state, a test does the loop's step itself (``if not done: it += 1; done =
test``) and the sweeps and jumps of the next iterations read ``done``
(:func:`done_word`) and do nothing once it is set; so the host enqueues
:data:`CHUNK` iterations and reads ``(done, it)`` once
(:func:`device_loop`).
Without a state a test returns its flag as a 0-d bool tensor, not read.

A fleet of ``B`` graphs (``solve_batch``'s dense loop: lane ``b``'s
vertex ``v`` at ``b * n + v`` of one ``[B * n]`` label array, the
stacked ``[B, m]`` edges with each graph's own ids) runs the same loop on
:func:`fleet_state`: four words a lane (``lanes``, ``[B, 4]``) and four
for the fleet (``fleet``: ``done`` once every lane is, ``it``, the
ticket).  :func:`converged_early_batched` and
:func:`labels_unchanged_batched` test each live lane over its own edges
or labels and do each lane's step; :func:`pointer_jump_batched` copies a
lane that is done, so a lane freezes at the iteration its test passes;
the host reads the fleet's ``(done, it)`` once per :data:`CHUNK`
iterations (:func:`device_loop` on ``fleet``), not once per lane.
:func:`batch_ops` gives a backend's fleet functions, those of
``blocked`` (K1, K2) included.  :func:`converged_early_batched` and
:func:`pointer_jump_batched` take the lane route (``csrc/fleet.cu``) or
the global route (``csrc/converged.cu``) by shape, as
``blocked.fused_relax_batched`` does (``*_batched_on`` runs a given
route).

Each wrapper runs its kernel on a CUDA tensor, or raises; its plain torch
version (``*_plain``, and :func:`loop_step_plain` for the step) runs when
the tensors lie on the CPU, with the same state words, so the CPU runs
the same chunked loop.  The plain versions read no word on the host, so
the ``"torch"`` backend runs them on the card too (:func:`loop_ops`): it
stays plain torch end to end, the reference the kernels are held to.
Each wrapper adds one to its ``launches`` count for every kernel launch.
Ids are not checked: the loops' ids lie in ``[0, n)`` by construction;
on the card an id outside is never read through, and the plain versions
raise IndexError.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.connectivity import minmap
from repro_torch.kernels import _build
from repro_torch.kernels.contour_mm import blocked, fleet
from repro_torch.kernels.contour_mm.blocked import (check_done, check_int32,
                                                    check_fleet,
                                                    check_lane_words,
                                                    edge_count,
                                                    launch_counted, on_cuda)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "converged.cu",)
LIBRARY = "contour_converged"

# the loop's state words, by index (csrc/converged.cu)
DONE, IT, BAD, TICKET = range(4)

# Iterations a loop enqueues between two reads of (done, it): a read costs
# a wait for the card to drain and the time to enqueue the next iteration;
# an iteration enqueued past the fixed point costs its launches and the
# jump's copy of the labels.  Chosen from the warm C-2 solves timed at
# each k on the card (PERF.md, section 5).
CHUNK = 4

_P = ctypes.c_void_p


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load ``libcontour_converged``; declare its
    API."""
    lib = _build.load_library(LIBRARY, SOURCES)
    i64, i32 = ctypes.c_int64, ctypes.c_int
    lib.contour_converged_early.argtypes = [_P, _P, _P, i64, i64, _P, i32,
                                            _P]
    lib.contour_converged_early.restype = i32
    lib.contour_labels_unchanged.argtypes = [_P, _P, i64, _P, i32, _P]
    lib.contour_labels_unchanged.restype = i32
    lib.contour_pointer_jump.argtypes = [_P, _P, i64, _P, _P]
    lib.contour_pointer_jump.restype = i32
    if hasattr(lib, "contour_converged_early_batched"):
        lib.contour_converged_early_batched.argtypes = [_P, _P, _P, i64, i64,
                                                        i64, _P, _P, _P]
        lib.contour_converged_early_batched.restype = i32
        lib.contour_labels_unchanged_batched.argtypes = [_P, _P, i64, i64,
                                                         _P, _P, _P]
        lib.contour_labels_unchanged_batched.restype = i32
        lib.contour_pointer_jump_batched.argtypes = [_P, _P, i64, i64, _P,
                                                     _P]
        lib.contour_pointer_jump_batched.restype = i32
    return lib


def loop_state(device) -> torch.Tensor:
    """A fresh loop state on ``device``: ``done``, ``it``, ``bad`` and the
    ticket, all 0."""
    return torch.zeros(4, dtype=torch.int32, device=device)


def done_word(state: torch.Tensor) -> torch.Tensor:
    """The state's ``done`` word, as the sweeps and jumps take it."""
    return state[DONE:DONE + 1]


def read_loop(state: torch.Tensor) -> Tuple[bool, int]:
    """``(done, it)`` on the host: one 8-byte copy, which waits for every
    iteration enqueued before it."""
    with trace.span("read.loop"):
        done, it = state[DONE:IT + 1].tolist()
    return bool(done), it


def loop_result(state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(iterations, converged)`` as 0-d tensors beside the state, not
    read: an int32 and a bool."""
    return state[IT].clone(), state[DONE].bool()


def device_loop(body, carry, state: torch.Tensor, max_iters: int):
    """``carry = body(it, carry)`` for ``it = 0, 1, ...``, at most
    ``max_iters`` times, reading ``(done, it)`` once every :data:`CHUNK`
    iterations and stopping at the first read that finds ``done``; returns
    the last carry.

    ``body`` ends with a test that does the loop's step on ``state``, and
    an iteration that finds ``done`` set leaves its carry as it was, so the
    result is that of the first converged iteration however many were
    enqueued past it.  ``it`` is the host's index, which equals the
    state's ``it`` up to that iteration.
    """
    launched = 0
    with trace.span("contour.loop"):
        while launched < max_iters:
            with trace.span("loop.chunk"):
                for it in range(launched, min(launched + CHUNK, max_iters)):
                    carry = body(it, carry)
            trace.count("loop.enqueued", min(CHUNK, max_iters - launched))
            launched = min(launched + CHUNK, max_iters)
            done, reached = read_loop(state)
            if done:
                break
        if launched:
            trace.count("loop.iterations", reached)
    return carry


def loop_step_plain(state: torch.Tensor, ok) -> None:
    """The loop's step on the state, in place: ``if not done: it += 1;
    done = ok``.  What the last block of a test does on the card; the
    plain tests take it, as tensor arithmetic that reads nothing on the
    host."""
    live = 1 - state[DONE]
    ok = torch.as_tensor(ok, device=state.device).to(torch.int32)
    state[IT] += live
    state[DONE] += live * ok


def _check_state(state: torch.Tensor, device: torch.device) -> None:
    if (state.dtype != torch.int32 or state.shape != (4,)
            or not state.is_contiguous()):
        raise TypeError("state must be loop_state()'s four int32 words, got "
                        f"{state.dtype} of shape {tuple(state.shape)}")
    if state.device != device:
        raise ValueError(f"state is on {state.device}, labels on {device}")


def _test(fn, items: int, args, state: Optional[torch.Tensor], *, wrapper,
          device: torch.device):
    """Launch a test: into ``state`` (with the loop's step), or into fresh
    words whose ``bad`` gives the flag."""
    step = state is not None
    words = state if step else loop_state(device)
    if items > 0 or step:
        launch_counted(fn, *args, words.data_ptr(), int(step),
                       wrapper=wrapper, device=device)
    return None if step else words[BAD] == 0


# ---------------------------------------------------------------------------
# converged_early (K6)
# ---------------------------------------------------------------------------


def _plain_test(ok: torch.Tensor, state: Optional[torch.Tensor]):
    """A plain test's result: the flag, or the loop's step on ``state``."""
    if state is None:
        return ok
    loop_step_plain(state, ok)
    return None


def converged_early_plain(L: torch.Tensor, src: torch.Tensor,
                          dst: torch.Tensor, edge_limit=None, *,
                          state: Optional[torch.Tensor] = None):
    """Plain version of :func:`converged_early`:
    ``minmap.converged_early`` over the first ``edge_limit`` edges."""
    m = edge_count(int(src.shape[0]), edge_limit)
    return _plain_test(minmap.converged_early(L, src[:m], dst[:m]), state)


def converged_early(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                    edge_limit=None, *,
                    state: Optional[torch.Tensor] = None):
    """The early-convergence predicate over the first ``edge_limit`` edges
    (every edge for None): converged iff for each edge (w, v)
    ``L[w] == L[v]``, ``L[w] == L[L[w]]`` and ``L[v] == L[L[v]]``.

    Without ``state`` it returns the flag as a 0-d bool tensor on ``L``'s
    device (no edge: True).  With a :func:`loop_state` it returns None
    and does the loop's step: nothing once ``done`` is set, else ``it +=
    1`` and ``done`` = the flag.  The kernel takes int32 arrays; the plain
    version, any integer type.
    """
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {tuple(src.shape)} vs "
                         f"{tuple(dst.shape)}")
    if state is not None:
        _check_state(state, L.device)
    if not on_cuda(L):
        return converged_early_plain(L, src, dst, edge_limit, state=state)
    check_int32("L", L, L.device)
    check_int32("src", src, L.device)
    check_int32("dst", dst, L.device)
    m = edge_count(int(src.shape[0]), edge_limit)
    src, dst = src.contiguous(), dst.contiguous()
    L = L.contiguous()
    return _test(load_library().contour_converged_early, m,
                 (L.data_ptr(), src.data_ptr(), dst.data_ptr(), m,
                  int(L.shape[0])), state, wrapper=converged_early,
                 device=L.device)


converged_early.launches = 0


def converged_early_work(n: int, m: int) -> Tuple[int, int]:
    """(bytes, operations) the least :func:`converged_early` over ``m``
    edges and ``n`` labels needs: src and dst read once and the labels
    once (8m + 4n), three compares an edge (3m).  The bound of
    ``chip_smoke.py``'s kernels line and the dry-run's ``contour-cc``
    cell."""
    return 8 * m + 4 * n, 3 * m


# ---------------------------------------------------------------------------
# labels_unchanged (K6's second entry point)
# ---------------------------------------------------------------------------


def labels_unchanged_plain(a: torch.Tensor, b: torch.Tensor, *,
                           state: Optional[torch.Tensor] = None):
    """Plain version of :func:`labels_unchanged`."""
    return _plain_test(torch.all(a == b), state)


def labels_unchanged(a: torch.Tensor, b: torch.Tensor, *,
                     state: Optional[torch.Tensor] = None):
    """``all(a == b)`` over two int32 arrays of one length: a 0-d bool
    tensor without ``state``; with it, None and the loop's step, as
    :func:`converged_early`."""
    if a.shape != b.shape:
        raise ValueError(f"a/b shape mismatch: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if state is not None:
        _check_state(state, a.device)
    if not on_cuda(a):
        return labels_unchanged_plain(a, b, state=state)
    check_int32("a", a, a.device)
    check_int32("b", b, a.device)
    n = int(a.shape[0])
    a, b = a.contiguous(), b.contiguous()
    return _test(load_library().contour_labels_unchanged, n,
                 (a.data_ptr(), b.data_ptr(), n), state,
                 wrapper=labels_unchanged, device=a.device)


labels_unchanged.launches = 0


def labels_unchanged_work(n: int) -> Tuple[int, int]:
    """(bytes, operations) the least :func:`labels_unchanged` of two
    arrays of ``n`` labels needs: both read once (8n), one compare an
    element (n)."""
    return 8 * n, n


# ---------------------------------------------------------------------------
# pointer_jump (K7)
# ---------------------------------------------------------------------------


def _jump_output(L: torch.Tensor, out: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The jump's output: ``out`` (a distinct int32 buffer of ``L``'s
    shape on its device, which the round overwrites) or a new one."""
    if out is None:
        return torch.empty_like(L)
    if out.dtype != L.dtype or out.shape != L.shape \
            or out.device != L.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {L.dtype} tensor of "
                         f"shape {tuple(L.shape)} on {L.device}")
    if L.numel() and out.data_ptr() == L.data_ptr():
        raise ValueError("out must not be L: the round is out of place")
    return out


def pointer_jump_plain(L: torch.Tensor, done=None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`pointer_jump` (the done word is read on the
    labels' device, not on the host)."""
    jumped = torch.minimum(L, L[L])
    if done is not None:
        jumped = torch.where(done.reshape(()) != 0, L, jumped)
    return jumped if out is None else _jump_output(L, out).copy_(jumped)


def pointer_jump(L: torch.Tensor, done=None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One pointer-jump round, ``out[v] = min(L[v], L[L[v]])``, out of
    place (every read sees the input, as the reference's round); a copy
    of ``L`` where the loop's ``done`` word is set.  ``out`` is a buffer
    the round may overwrite (not ``L``): a loop that owns a dead label
    array passes it, and so holds fewer label arrays at once."""
    if not on_cuda(L):
        return pointer_jump_plain(L, done, out)
    check_int32("L", L, L.device)
    done_ptr = check_done(done, L.device)
    L = L.contiguous()
    out = _jump_output(L, out)
    n = int(L.shape[0])
    if n > 0:
        launch_counted(load_library().contour_pointer_jump, L.data_ptr(),
                       out.data_ptr(), n, done_ptr, wrapper=pointer_jump,
                       device=L.device)
    return out


pointer_jump.launches = 0


def pointer_jump_work(n: int) -> Tuple[int, int]:
    """(bytes, operations) the least a :func:`pointer_jump` round of
    ``n`` labels needs: the labels read once and the output written once
    (8n), one min a label (n).  The bound of ``chip_smoke.py``'s kernels
    line and the dry-run's ``contour-cc`` cell."""
    return 8 * n, n


# ---------------------------------------------------------------------------
# the fleet's loop (solve_batch)
# ---------------------------------------------------------------------------


class FleetState(NamedTuple):
    """The loop state of a fleet: ``lanes`` ``[B, 4]`` (each lane's
    ``done``, ``it``, ``bad`` and an unused word) and ``fleet`` ``[4]``
    (``done`` once every lane is done, ``it``, unused, the ticket): the
    host reads ``fleet`` with :func:`read_loop`."""

    lanes: torch.Tensor
    fleet: torch.Tensor


def fleet_state(lanes_b: int, device) -> FleetState:
    """A fresh fleet state of ``lanes_b`` lanes on ``device``, all 0."""
    return FleetState(torch.zeros((lanes_b, 4), dtype=torch.int32,
                                  device=device), loop_state(device))


def fleet_step_plain(state: FleetState, ok: torch.Tensor) -> None:
    """Each lane's step (``if not done: it += 1; done = ok[b]``) and the
    fleet's words, in place; what the last block of a fleet test does on
    the card, as tensor arithmetic that reads nothing on the host."""
    lanes, fleet = state
    live = 1 - lanes[:, DONE]
    lanes[:, IT] += live
    lanes[:, DONE] += live * ok.to(torch.int32)
    fleet[IT] += live.amax()
    fleet[DONE] = lanes[:, DONE].amin()


def _check_fleet_state(state: FleetState, L: torch.Tensor, n: int,
                       lanes_b: int) -> None:
    check_lane_words(L, n, lanes_b, state.lanes)
    _check_state(state.fleet, L.device)


def converged_early_batched_plain(L: torch.Tensor, src: torch.Tensor,
                                  dst: torch.Tensor, n: int,
                                  state: FleetState) -> None:
    """Plain version of :func:`converged_early_batched`."""
    lanes_b = int(src.shape[0])
    Lv = L.view(lanes_b, n)
    lw = Lv.gather(1, src.long())
    lv = Lv.gather(1, dst.long())
    bad = (lw != lv) | (lw != L[lw]) | (lv != L[lv])
    fleet_step_plain(state, ~bad.any(1))


def converged_early_batched(L: torch.Tensor, src: torch.Tensor,
                            dst: torch.Tensor, n: int,
                            state: FleetState) -> None:
    """The early-convergence predicate of each live lane of a fleet over
    its own edges (``src``/``dst`` ``[B, m]``, each graph's own ids;
    ``L`` ``[B * n]``), and each lane's step on ``state``: nothing for a
    lane that is done, else ``it += 1`` and ``done`` = its predicate.
    The fleet's ``done`` is set once every lane is done."""
    lanes_b = check_fleet(L, src, dst, n, state.lanes)
    _check_fleet_state(state, L, n, lanes_b)
    if not on_cuda(L):
        return converged_early_batched_plain(L, src, dst, n, state)
    route = fleet.fleet_route(n, lanes_b, int(src.shape[1]), "converged",
                              fleet.fleet_device(L.device))
    return _early_fleet(route, L, src, dst, n, state, lanes_b)


converged_early_batched.launches = 0
# launches by route (fleet.FleetRoute.route)
converged_early_batched.routes = {"lane": 0, "global": 0}


def converged_early_batched_on(route: fleet.FleetRoute, L: torch.Tensor,
                               src: torch.Tensor, dst: torch.Tensor, n: int,
                               state: FleetState) -> None:
    """:func:`converged_early_batched` on CUDA tensors on ``route``,
    counted on :func:`converged_early_batched`, as
    :func:`blocked.fused_relax_batched_on`."""
    lanes_b = check_fleet(L, src, dst, n, state.lanes)
    _check_fleet_state(state, L, n, lanes_b)
    if not on_cuda(L):
        raise ValueError("the fleet's routes run on CUDA tensors")
    return _early_fleet(route, L, src, dst, n, state, lanes_b)


def _early_fleet(route, L, src, dst, n, state, lanes_b) -> None:
    """The launch on ``route`` of checked CUDA tensors."""
    L, src, dst = L.contiguous(), src.contiguous(), dst.contiguous()
    if lanes_b > 0:
        m = int(src.shape[1])
        if route.route == "lane":
            launch_counted(fleet.load_library().contour_fleet_converged_lane,
                           L.data_ptr(), src.data_ptr(), dst.data_ptr(), m,
                           lanes_b, n, state.lanes.data_ptr(),
                           state.fleet.data_ptr(), route.blocks_per_lane,
                           wrapper=converged_early_batched, device=L.device)
        else:
            launch_counted(load_library().contour_converged_early_batched,
                           L.data_ptr(), src.data_ptr(), dst.data_ptr(), m,
                           lanes_b, n, state.lanes.data_ptr(),
                           state.fleet.data_ptr(),
                           wrapper=converged_early_batched, device=L.device)
        converged_early_batched.routes[route.route] += 1
    return None


def labels_unchanged_batched_plain(a: torch.Tensor, b: torch.Tensor,
                                   n: int, state: FleetState) -> None:
    """Plain version of :func:`labels_unchanged_batched`."""
    lanes_b = int(state.lanes.shape[0])
    fleet_step_plain(state, (a.view(lanes_b, n) == b.view(lanes_b, n))
                     .all(1))


def labels_unchanged_batched(a: torch.Tensor, b: torch.Tensor, n: int,
                             state: FleetState) -> None:
    """``all(a == b)`` of each live lane of a fleet over its own ``n``
    labels, and each lane's step, as :func:`converged_early_batched`.
    One launch of ``unchanged_lanes_kernel`` (tiles of one lane, 16-byte
    loads where ``a`` and ``b`` share their 16-byte phase; its schedule
    is :func:`unchanged_batched_replay`)."""
    if a.shape != b.shape:
        raise ValueError(f"a/b shape mismatch: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    check_int32("a", a, a.device)
    check_int32("b", b, a.device)
    lanes_b = int(state.lanes.shape[0])
    _check_fleet_state(state, a, n, lanes_b)
    if not on_cuda(a):
        return labels_unchanged_batched_plain(a, b, n, state)
    a, b = a.contiguous(), b.contiguous()
    if lanes_b > 0:
        launch_counted(load_library().contour_labels_unchanged_batched,
                       a.data_ptr(), b.data_ptr(), lanes_b, n,
                       state.lanes.data_ptr(), state.fleet.data_ptr(),
                       wrapper=labels_unchanged_batched, device=a.device)
    return None


labels_unchanged_batched.launches = 0

# labels a tile of unchanged_lanes_kernel (csrc/converged.cu: kThreads *
# kUnchangedVecs * 4)
UNCHANGED_TILE = 1024


def unchanged_layout(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, int]:
    """``(width, phase)`` as the launcher picks them: items of 4 labels
    (16-byte loads) where ``a`` and ``b`` lie at one 16-byte phase, with
    ``phase`` the 4-byte slot of ``a``'s first label; else items of one
    label and phase 0."""
    pa, pb = a.data_ptr(), b.data_ptr()
    if (pa - pb) % 16 == 0:
        return 4, (pa // 4) % 4
    return 1, 0


def unchanged_lane_parts(n: int, lane: int, width: int,
                         phase: int) -> Tuple[int, int]:
    """``(head, items)`` of a lane: the labels before its first 16-byte
    boundary (compared as scalars, as are the ``n - head - items *
    width`` past its last whole item) and its whole items."""
    head = 0 if width == 1 else min((4 - (phase + lane * n) % 4) % 4, n)
    return head, (n - head) // width


def unchanged_batched_replay(a: torch.Tensor, b: torch.Tensor, n: int,
                             state: FleetState) -> torch.Tensor:
    """``unchanged_lanes_kernel``'s schedule on the fleet's words
    ``state``, in place: tile ``k`` is slice ``k // B`` of lane ``k % B``
    (a slice is :data:`UNCHANGED_TILE` labels, ``UNCHANGED_TILE //
    width`` items); a tile whose lane is done or witnessed reads nothing;
    else it compares its items, and the lane's first slice also its head
    and tail labels, and a difference sets the lane's ``bad``.  Then the
    fleet's step (the last block's pass).  Tiles run in order here, so a
    lane witnessed by its first slice reads no other.  Returns the labels
    each tile compared, ``[B, tiles a lane]``, each label of a live lane
    counted where it was read."""
    lanes_w, fleet_w = state
    lanes_b = int(lanes_w.shape[0])
    per = -(-n // UNCHANGED_TILE)
    reads = torch.zeros((lanes_b, per), dtype=torch.int64)
    if int(fleet_w[DONE]):
        return reads
    width, phase = unchanged_layout(a, b)
    step = UNCHANGED_TILE // width
    for k in range(lanes_b * per):
        part, lane = divmod(k, lanes_b)
        words = lanes_w[lane]
        if int(words[DONE]) or int(words[BAD]):
            continue
        first = lane * n
        head, items = unchanged_lane_parts(n, lane, width, phase)
        lo, hi = min(items, part * step), min(items, (part + 1) * step)
        ids = [torch.arange(first + head + lo * width,
                            first + head + hi * width)]
        if part == 0:
            ids += [torch.arange(first, first + head),
                    torch.arange(first + head + items * width, first + n)]
        ids = torch.cat(ids).to(a.device)
        reads[lane, part] = int(ids.shape[0])
        if bool((a[ids] != b[ids]).any()):
            words[BAD] = 1
    live = lanes_w[:, DONE] == 0
    lanes_w[live, IT] += 1
    lanes_w[live, DONE] = (lanes_w[live, BAD] == 0).to(lanes_w.dtype)
    lanes_w[:, BAD] = 0
    fleet_w[IT] += int(bool(live.any()))
    fleet_w[DONE] = int(bool((lanes_w[:, DONE] != 0).all()))
    fleet_w[TICKET] = 0
    return reads


def pointer_jump_batched_plain(L: torch.Tensor, n: int,
                               lanes: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain version of :func:`pointer_jump_batched`."""
    jumped = torch.minimum(L, L[L])
    if lanes is None:
        return jumped
    frozen = (lanes[:, DONE] != 0).repeat_interleave(n)
    return torch.where(frozen, L, jumped)


def pointer_jump_batched(L: torch.Tensor, n: int,
                         lanes: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One pointer-jump round of a fleet's ``[B * n]`` labels, out of
    place; a copy of each lane whose ``done`` word in ``lanes`` is set
    (None: every lane jumps).  One launch, on the route
    :func:`fleet.jump_route` picks."""
    lanes_b = _check_jump(L, n, lanes)
    if not on_cuda(L):
        return pointer_jump_batched_plain(L, n, lanes)
    route = fleet.jump_route(n, lanes_b, fleet.fleet_device(L.device))
    return _jump_fleet(route, L, n, lanes, lanes_b)


pointer_jump_batched.launches = 0
# launches by route (fleet.FleetRoute.route)
pointer_jump_batched.routes = {"lane": 0, "global": 0}


def pointer_jump_batched_on(route: fleet.FleetRoute, L: torch.Tensor, n: int,
                            lanes: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """:func:`pointer_jump_batched` on CUDA tensors on ``route``, counted
    on :func:`pointer_jump_batched`, as
    :func:`blocked.fused_relax_batched_on`."""
    lanes_b = _check_jump(L, n, lanes)
    if not on_cuda(L):
        raise ValueError("the fleet's routes run on CUDA tensors")
    return _jump_fleet(route, L, n, lanes, lanes_b)


def _check_jump(L: torch.Tensor, n: int,
                lanes: Optional[torch.Tensor]) -> int:
    check_int32("L", L, L.device)
    lanes_b = int(L.shape[0]) // max(n, 1)
    check_lane_words(L, n, lanes_b, lanes)
    return lanes_b


def _jump_fleet(route, L, n, lanes, lanes_b) -> torch.Tensor:
    """The launch on ``route`` of checked CUDA tensors."""
    L = L.contiguous()
    out = torch.empty_like(L)
    lanes_ptr = None if lanes is None else lanes.data_ptr()
    if int(L.shape[0]) > 0:
        if route.route == "lane":
            launch_counted(fleet.load_library().contour_fleet_jump_lane,
                           L.data_ptr(), out.data_ptr(), lanes_b, n,
                           lanes_ptr, route.blocks_per_lane,
                           wrapper=pointer_jump_batched, device=L.device)
        else:
            launch_counted(load_library().contour_pointer_jump_batched,
                           L.data_ptr(), out.data_ptr(), int(L.shape[0]), n,
                           lanes_ptr, wrapper=pointer_jump_batched,
                           device=L.device)
        pointer_jump_batched.routes[route.route] += 1
    return out


class FleetOps(NamedTuple):
    """The fleet loop's sweeps, tests and jump round, with the signatures
    of :func:`blocked.fused_relax_batched`,
    :func:`blocked.scatter_min_batched`, :func:`converged_early_batched`,
    :func:`labels_unchanged_batched` and :func:`pointer_jump_batched`."""

    fused_relax: Callable
    scatter_min: Callable
    converged_early: Callable
    labels_unchanged: Callable
    pointer_jump: Callable


def batch_ops(backend: str) -> FleetOps:
    """The plain versions for the ``"torch"`` backend, on any device; the
    kernels' wrappers for ``"cuda"``."""
    if backend == "torch":
        return FleetOps(blocked.fused_relax_batched_plain,
                        blocked.scatter_min_batched_plain,
                        converged_early_batched_plain,
                        labels_unchanged_batched_plain,
                        pointer_jump_batched_plain)
    return FleetOps(blocked.fused_relax_batched, blocked.scatter_min_batched,
                    converged_early_batched, labels_unchanged_batched,
                    pointer_jump_batched)


# ---------------------------------------------------------------------------
# the loop's functions for a sweep backend
# ---------------------------------------------------------------------------


class LoopOps(NamedTuple):
    """The fixpoint loop's tests and jump round, with the signatures of
    :func:`converged_early`, :func:`labels_unchanged` and
    :func:`pointer_jump`."""

    converged_early: Callable
    labels_unchanged: Callable
    pointer_jump: Callable


def loop_ops(backend: str) -> LoopOps:
    """The plain versions for the ``"torch"`` backend, on any device; the
    kernels' wrappers for the others."""
    if backend == "torch":
        return LoopOps(converged_early_plain, labels_unchanged_plain,
                       pointer_jump_plain)
    return LoopOps(converged_early, labels_unchanged, pointer_jump)
