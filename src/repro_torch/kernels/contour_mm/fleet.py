"""The fleet's lane-resident kernels: K1's order-2 sweep, K6's
early-convergence test, K2's scatter-min of an update stream and K7's
pointer-jump round with each lane's labels in shared memory, the route
that picks them by shape, and plain replays of their schedules.

The fleet's entry points, :func:`blocked.fused_relax_batched`,
:func:`converged.converged_early_batched`,
:func:`blocked.scatter_min_batched` and
:func:`converged.pointer_jump_batched`, run one of two routes on the
card, chosen by :func:`fleet_route` from ``n``, ``B``, the items a lane's
blocks share and the card (never after a failure: a launch that is
refused raises):

* ``"lane"`` (``csrc/fleet.cu``): a block holds one lane's ``n`` labels
  in dynamic shared memory (``8n`` bytes for K1's input and output, ``4n``
  for K6, K2 and K7) and streams the lane's contiguous edges (K2: its runs
  of updates, :func:`stream_segments`) through a ring of tiles in shared
  memory, filled by ``cp.async.bulk`` copies; K7 reads its lane's labels
  alone.  ``blocks_per_lane`` (``c``) splits a lane's edges (K2: each of
  its runs; K7: its labels) over ``c`` blocks where ``B`` alone does not
  fill the card;
* ``"global"``: the kernels of ``contour_mm.cu`` / ``converged.cu`` (an
  item a thread, every label gathered from L2), for lanes whose labels do
  not fit a block's shared memory, and for K2's streams of no stated
  layout (``run=None``).

This is the card's counterpart of the reference's choice of the
whole-L-in-VMEM tile for graphs of ``n <= 4096``
(``repro.connectivity.planner.heuristics.SINGLE_TILE_MAX_N``), which is
the size of a lane of the fleets ``solve_batch`` serves.

:func:`relax_lane_replay`, :func:`converged_lane_replay`,
:func:`scatter_lane_replay` and :func:`jump_lane_replay` replay the lane
route block by block in plain torch (each block's own copies of its
lane's labels, its slice of the edges or updates tile by tile, the merge
of what it lowered); the CPU tests hold them to the plain versions and to
the reference.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "fleet.cu",)
LIBRARY = "contour_fleet"



class KernelShape(NamedTuple):
    """A lane kernel's shape (``csrc/fleet.cu``'s ``RelaxCfg``,
    ``TestCfg``, ``ScatterCfg``, ``JumpCfg``): threads a block, items
    (edges, updates, labels) a tile, the ring's stages and its bytes (each
    stage a tile of src and of dst, or of targets and values, each in a
    16-byte window 4 ints wider; K7 has none), the blocks an SM its
    registers allow (``__launch_bounds__``), and the label arrays it holds
    in shared memory."""

    threads: int
    tile: int
    stages: int
    ring_bytes: int
    min_blocks: int
    label_arrays: int


def _shape(threads: int, edges: int, stages: int, min_blocks: int,
           label_arrays: int) -> KernelShape:
    tile = threads * edges
    return KernelShape(threads, tile, stages, stages * 2 * (tile + 4) * 4,
                       min_blocks, label_arrays)


# K1 ("relax": input and output labels), K6 ("converged"), K2
# ("scatter": one array, its input read again from L2 at the merge) and K7
# ("jump", no ring), as timed against other shapes by
# tools/fleet_variants.py (PERF.md), in csrc/fleet.cu's order
SHAPES = {"relax": _shape(512, 8, 2, 2, 2),
          "converged": _shape(256, 8, 2, 4, 1),
          "scatter": _shape(512, 8, 2, 2, 1),
          "jump": _shape(512, 8, 0, 4, 1)}
# room for the kernels' static shared memory (mbarriers and flags)
STATIC_BYTES = 128
# the fewest tiles of edges a slice of a lane is given when c > 1: a block
# that copies n labels should stream several times as many bytes of edges
MIN_SLICE_TILES = 4
DONE, IT, BAD, TICKET = range(4)

_P = ctypes.c_void_p


class FleetDevice(NamedTuple):
    """What the route needs of the card: a block's opt-in shared memory,
    an SM's shared memory, the shared memory the system reserves for each
    block, and the SM count (bytes, bytes, bytes, SMs)."""

    smem_block: int
    smem_sm: int
    smem_reserved: int
    sms: int


# NVIDIA H100 SXM (the hopper-kernels guide's table): 227 KB a block of
# the SM's 228 KB, 1 KB reserved a block, 132 SMs
H100 = FleetDevice(232_448, 233_472, 1_024, 132)


class FleetRoute(NamedTuple):
    """A route (``"lane"`` or ``"global"``) and the blocks per lane."""

    route: str
    blocks_per_lane: int = 1


GLOBAL = FleetRoute("global", 1)


def lane_smem_bytes(n: int, kind: str) -> int:
    """Shared memory a block of the lane route takes for lanes of ``n``
    labels: the ring, the label arrays of ``kind`` (``"relax"``,
    ``"converged"``) and room for the static part."""
    shape = SHAPES[kind]
    return shape.ring_bytes + 4 * shape.label_arrays * n + STATIC_BYTES


def lane_cap(kind: str, device: FleetDevice = H100) -> int:
    """The largest ``n`` the lane route takes for ``kind`` on ``device``."""
    shape = SHAPES[kind]
    return (device.smem_block - shape.ring_bytes - STATIC_BYTES) // (
        4 * shape.label_arrays)


def fleet_route(n: int, lanes_b: int, m: int, kind: str,
                device: Optional[FleetDevice] = None) -> FleetRoute:
    """The route of a fleet of ``lanes_b`` lanes of ``n`` labels for
    ``kind`` (``"relax"``: K1, ``"converged"``: K6, ``"scatter"``: K2,
    ``"jump"``: K7), whose blocks of a lane share ``m`` items (K1, K6: the
    lane's edges; K2: a run of its updates; K7: its ``n`` labels):
    ``"lane"`` where a lane's labels fit a block's shared memory, with
    ``c`` blocks a lane (1 where the lanes fill the card's block slots
    alone, else as many as fill them, no slice below
    :data:`MIN_SLICE_TILES` tiles); ``"global"`` above.  ``device``
    defaults to the current card's (:func:`fleet_device`)."""
    if kind not in SHAPES:
        raise ValueError(f"kind must be one of {sorted(SHAPES)}, got "
                         f"{kind!r}")
    if device is None:
        device = fleet_device()
    smem = lane_smem_bytes(n, kind)
    if smem > device.smem_block:
        return GLOBAL
    shape = SHAPES[kind]
    per_sm = min(shape.min_blocks,
                 device.smem_sm // (smem + device.smem_reserved))
    slots = per_sm * device.sms
    c = min(slots // max(lanes_b, 1), m // (MIN_SLICE_TILES * shape.tile))
    return FleetRoute("lane", max(1, c))


def stream_segments(k: int, lanes_b: int, run: Optional[int]) -> int:
    """The segments of a fleet's update stream of ``k`` updates laid out
    as ``[B, run]`` segments (lane ``b``'s run of segment ``r`` at
    ``(r * B + b) * run``; ``contour.mm_update_stream_batched`` emits
    ``2 * order`` of them, ``run = m``); 0 for ``run=None`` (no stated
    layout).  Raises ValueError where ``k`` is not a whole number of
    segments."""
    if run is None:
        return 0
    run = int(run)
    if run <= 0:
        raise ValueError(f"run must be a positive int, got {run}")
    seg = lanes_b * run
    if (seg == 0 and k) or (seg and k % seg):
        raise ValueError(f"the stream's {k} updates are not a whole number "
                         f"of [B, run] = [{lanes_b}, {run}] segments")
    return k // seg if seg else 0


def scatter_route(n: int, lanes_b: int, run: Optional[int],
                  device: Optional[FleetDevice] = None) -> FleetRoute:
    """K2 fleet's route: :data:`GLOBAL` for a stream of no stated layout
    (``run=None``), else :func:`fleet_route` with a run's updates as the
    items a lane's blocks share."""
    if run is None:
        return GLOBAL
    return fleet_route(n, lanes_b, int(run), "scatter", device)


def jump_route(n: int, lanes_b: int,
               device: Optional[FleetDevice] = None) -> FleetRoute:
    """K7 fleet's route: :func:`fleet_route` with the lane's labels as the
    items its blocks share."""
    return fleet_route(n, lanes_b, n, "jump", device)


def jump_bounds(n: int, c: int, part: int) -> Tuple[int, int]:
    """Labels ``[lo, hi)`` of a lane that K7's block ``part`` of ``c``
    writes: :func:`slice_bounds` over the lane's 16-byte vectors."""
    lo, hi = slice_bounds(-(-n // 4), c, part)
    return min(n, 4 * lo), min(n, 4 * hi)


def load_library() -> ctypes.CDLL:
    """Build (on first use) and load ``libcontour_fleet``; declare its
    API."""
    lib = _build.load_library(LIBRARY, SOURCES)
    i64, i32 = ctypes.c_int64, ctypes.c_int
    lib.contour_fleet_device.argtypes = [_P]
    lib.contour_fleet_device.restype = i32
    lib.contour_fleet_shapes.argtypes = [_P]
    lib.contour_fleet_shapes.restype = None
    lib.contour_fleet_relax_lane.argtypes = [_P, _P, _P, _P, i64, i64, i64,
                                             _P, i32, _P]
    lib.contour_fleet_relax_lane.restype = i32
    lib.contour_fleet_converged_lane.argtypes = [_P, _P, _P, i64, i64, i64,
                                                 _P, _P, i32, _P]
    lib.contour_fleet_converged_lane.restype = i32
    lib.contour_fleet_scatter_lane.argtypes = [_P, _P, _P, _P, i64, i64, i64,
                                               i64, _P, i32, _P]
    lib.contour_fleet_scatter_lane.restype = i32
    lib.contour_fleet_jump_lane.argtypes = [_P, _P, i64, i64, _P, i32, _P]
    lib.contour_fleet_jump_lane.restype = i32
    return lib


_DEVICES: Dict[int, FleetDevice] = {}


def fleet_device(device=None) -> FleetDevice:
    """The card's :class:`FleetDevice` (the current CUDA device unless
    named), queried once."""
    index = torch.device("cuda" if device is None else device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _DEVICES:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(index):
            rc = load_library().contour_fleet_device(out)
        if rc != 0:
            raise RuntimeError(f"the card's shared memory and SM count: "
                               f"CUDA error {rc}")
        _DEVICES[index] = FleetDevice(*out)
    return _DEVICES[index]


# ---------------------------------------------------------------------------
# plain replays of the lane route's schedule (the CPU tests)
# ---------------------------------------------------------------------------


def slice_bounds(m: int, c: int, part: int) -> Tuple[int, int]:
    """Edges ``[lo, hi)`` of a lane that block ``part`` of ``c`` takes."""
    q = -(-m // c)
    return min(m, part * q), min(m, (part + 1) * q)


def _inside(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >= 0) & (x < n)


def _labels(L: torch.Tensor, lane_in: torch.Tensor, base: int,
            ids: torch.Tensor) -> torch.Tensor:
    """``L[ids]`` as a block reads it: from its lane's copy where the id
    is the lane's, else from ``L`` (ids in ``[0, len(L))``)."""
    n = int(lane_in.shape[0])
    own = _inside(ids - base, n)
    return torch.where(own, lane_in[torch.where(own, ids - base, 0)],
                       L[ids])


def relax_lane_replay(L: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                      n: int, lanes: Optional[torch.Tensor] = None, *,
                      blocks_per_lane: int = 1) -> torch.Tensor:
    """K1 fleet's lane route, block by block: each block of a live lane
    copies the lane's labels into its input and output arrays, sweeps its
    slice of the edges into its output (an update to a label outside the
    lane into the global output at once), then mins the entries it
    lowered into the copy of ``L`` that the call returns.  An edge with an
    id or label out of range is skipped, as on the card."""
    lanes_b, m = (int(x) for x in src.shape)
    size = lanes_b * n
    out = L.clone()
    for b in range(lanes_b):
        if lanes is not None and int(lanes[b, DONE]):
            continue
        base = b * n
        lane_in = L[base:base + n]
        for part in range(blocks_per_lane):
            lo, hi = slice_bounds(m, blocks_per_lane, part)
            own = lane_in.clone()
            s, d = src[b, lo:hi].long(), dst[b, lo:hi].long()
            ok = _inside(s, n) & _inside(d, n)
            s, d = s[ok], d[ok]
            ls, ld = lane_in[s].long(), lane_in[d].long()
            ok = _inside(ls, size) & _inside(ld, size)
            s, d, ls, ld = s[ok] + base, d[ok] + base, ls[ok], ld[ok]
            l2s = _labels(L, lane_in, base, ls).long()
            l2d = _labels(L, lane_in, base, ld).long()
            z = torch.minimum(l2s, l2d)
            # each target with its input label, an edge's copies dropped
            keep = torch.stack([
                z < ls, (z < ld) & (d != s),
                (z < l2s) & (ls != s) & (ls != d),
                (z < l2d) & (ld != s) & (ld != d) & (ld != ls)])
            t = torch.stack([s, d, ls, ld])[keep]
            v = z.expand(4, -1)[keep].to(L.dtype)
            mine = _inside(t - base, n)
            own.scatter_reduce_(0, t[mine] - base, v[mine], "amin")
            out.scatter_reduce_(0, t[~mine], v[~mine], "amin")
            seg = out[base:base + n]
            out[base:base + n] = torch.where(own < lane_in,
                                             torch.minimum(seg, own), seg)
    return out


def _witnesses(L: torch.Tensor, lane_in: torch.Tensor, base: int, n: int,
               w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Which edges (w, v) of a lane are witnesses of non-convergence."""
    size = int(L.shape[0])
    w, v = w.long(), v.long()
    bad = ~(_inside(w, n) & _inside(v, n))
    lw = lane_in[torch.where(bad, 0, w)].long()
    lv = lane_in[torch.where(bad, 0, v)].long()
    out = ~_inside(lw, size)
    root = _labels(L, lane_in, base, torch.where(out, 0, lw)).long()
    return bad | (lw != lv) | out | (root != lw)


def converged_lane_replay(L: torch.Tensor, src: torch.Tensor,
                          dst: torch.Tensor, n: int, state, *,
                          blocks_per_lane: int = 1,
                          tile: int = SHAPES["converged"].tile
                          ) -> torch.Tensor:
    """K6 fleet's lane route, block by block, on the fleet's words
    ``state`` (``converged.FleetState``), in place: each block of a live
    lane streams its slice tile by tile and stops after the first tile
    with a witness; with one block a lane the block does the lane's step
    and marks the lane, with more a witness sets the lane's ``bad``; then
    the last block's pass over every lane.  Returns the tiles each block
    streamed, ``[B, c]`` (blocks run in order here, so a block whose lane
    another block already witnessed streams none)."""
    lanes_w, fleet_w = state
    lanes_b, m = (int(x) for x in src.shape)
    c = blocks_per_lane
    tiles = torch.zeros((lanes_b, c), dtype=torch.int64)
    if int(fleet_w[DONE]):
        return tiles
    for b in range(lanes_b):
        base = b * n
        lane_in = L[base:base + n]
        for part in range(c):
            w = lanes_w[b]
            live, witnessed = not int(w[DONE]), bool(int(w[BAD]))
            if live and not witnessed:
                lo, hi = slice_bounds(m, c, part)
                for e in range(lo, hi, tile):
                    tiles[b, part] += 1
                    if bool(_witnesses(L, lane_in, base, n,
                                       src[b, e:min(hi, e + tile)],
                                       dst[b, e:min(hi, e + tile)]).any()):
                        witnessed = True
                        break
            if c == 1:
                if live:
                    w[IT] += 1
                    w[DONE] = int(not witnessed)
                    w[BAD] = 1  # stepped
            elif live and witnessed:
                w[BAD] = 1
    done, bad = lanes_w[:, DONE] != 0, lanes_w[:, BAD] != 0
    if c == 1:
        stepped = bool(bad.any())
    else:
        stepped = bool((~done).any())
        lanes_w[~done, IT] += 1
        lanes_w[~done, DONE] = (~bad[~done]).to(lanes_w.dtype)
    lanes_w[:, BAD] = 0
    fleet_w[IT] += int(stepped)
    fleet_w[DONE] = int(bool((lanes_w[:, DONE] != 0).all()))
    fleet_w[TICKET] = 0
    return tiles


def scatter_lane_replay(L: torch.Tensor, targets: torch.Tensor,
                        values: torch.Tensor, n: int,
                        lanes: Optional[torch.Tensor] = None, *, run: int,
                        blocks_per_lane: int = 1) -> torch.Tensor:
    """K2 fleet's lane route, block by block: each block of lane ``b``
    (live or not) takes its slice of each of the lane's runs, tile by
    tile; a live lane's block mins an in-lane update into its copy of the
    lane's labels when it lowers the copy (a frozen lane's block drops
    them), and an update to another lane's target in ``[0, B * n)`` into
    the global output when that lane is live and the update lowers the
    target's input label; then a live lane's block mins the entries of its
    copy below their input into the copy of ``L`` that the call returns.
    A target outside ``[0, B * n)`` is skipped, as on the card."""
    lanes_b = int(L.shape[0]) // n
    size = lanes_b * n
    segs = stream_segments(int(targets.shape[0]), lanes_b, run)
    tile = SHAPES["scatter"].tile
    done = (torch.zeros(lanes_b, dtype=torch.bool) if lanes is None
            else lanes[:, DONE] != 0)
    out = L.clone()
    for b in range(lanes_b):
        base = b * n
        lane_in = L[base:base + n]
        live = not bool(done[b])
        for part in range(blocks_per_lane):
            lo, hi = slice_bounds(run, blocks_per_lane, part)
            own = lane_in.clone()
            for r in range(segs):
                first = (r * lanes_b + b) * run
                for e in range(first + lo, first + hi, tile):
                    t = targets[e:min(first + hi, e + tile)].long()
                    v = values[e:min(first + hi, e + tile)]
                    mine = _inside(t - base, n)
                    if live:
                        o = t[mine] - base
                        keep = v[mine] < own[o]
                        own.scatter_reduce_(0, o[keep], v[mine][keep],
                                            "amin")
                    t, v = t[~mine], v[~mine]
                    ok = _inside(t, size)
                    t, v = t[ok], v[ok]
                    keep = ~done[t // n] & (v < L[t])
                    out.scatter_reduce_(0, t[keep], v[keep], "amin")
            if live:
                seg = out[base:base + n]
                out[base:base + n] = torch.where(own < lane_in,
                                                 torch.minimum(seg, own),
                                                 seg)
    return out


def jump_lane_replay(L: torch.Tensor, n: int,
                     lanes: Optional[torch.Tensor] = None, *,
                     blocks_per_lane: int = 1) -> torch.Tensor:
    """K7 fleet's lane route, block by block: block ``part`` of a lane
    writes the lane's labels :func:`jump_bounds` gives it, each
    ``min(L[v], L[L[v]])`` with the second level from its copy of the lane
    (from ``L`` for a label of another lane), a label outside ``[0, B *
    n)`` copied; a frozen lane's blocks copy it."""
    lanes_b = int(L.shape[0]) // n
    size = lanes_b * n
    out = torch.empty_like(L)
    for b in range(lanes_b):
        base = b * n
        lane_in = L[base:base + n].clone()
        frozen = lanes is not None and bool(lanes[b, DONE])
        for part in range(blocks_per_lane):
            lo, hi = jump_bounds(n, blocks_per_lane, part)
            x = lane_in[lo:hi].long()
            if frozen:
                out[base + lo:base + hi] = lane_in[lo:hi]
                continue
            ok = _inside(x, size)
            second = _labels(L, lane_in, base, torch.where(ok, x, 0))
            out[base + lo:base + hi] = torch.where(
                ok, torch.minimum(x, second.long()), x).to(L.dtype)
    return out
