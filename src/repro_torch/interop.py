"""Carry state and inputs into the port from host arrays.

Connectivity has no weights: its state is the graph and the labels.
These helpers build the port's objects from numpy arrays — for example
the reference's outputs passed through ``np.asarray`` — and take nothing
else, so no object of another framework crosses into the port.
:func:`stream_from_state` carries a stream across: it rebuilds a
streaming engine from a stream's state dict.  :func:`tensor_from_numpy`
carries the float inputs of the attention and normalisation kernels.

The LM's weights are the other thing that crosses:
:func:`lm_params_from_numpy` takes the reference's parameter pytree
(nested dicts and lists of float32 numpy arrays) and returns the port's,
and :func:`lm_cache_from_numpy` a reference prefill's cache, so that a
decode can start from it.  :func:`train_state_from_numpy` carries a
training state (the parameters, AdamW's moments and its step), so that
both packages train from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.connectivity.result import ComponentResult
from repro_torch.connectivity.solve import make_result
from repro_torch.connectivity.streaming import StreamingConnectivity
from repro_torch.graphs.structs import DeviceLike, Graph, resolve_device
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SLSTMState, SSMState
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import check_tree, lm_param_specs
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import TrainState

_SCALARS = (np.ndarray, np.generic, bool, int, float)
# element types tensor_from_numpy makes, by name
FLOAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _require_numpy(name: str, x, scalar: bool = False) -> np.ndarray:
    ok = isinstance(x, _SCALARS) if scalar else isinstance(x, np.ndarray)
    if not ok:
        raise TypeError(f"{name} must be a numpy "
                        f"{'value' if scalar else 'array'}, got "
                        f"{type(x).__module__}.{type(x).__name__}; pass "
                        "np.asarray(...) of it")
    return np.array(x) if scalar else np.asarray(x)


def graph_from_arrays(src, dst, n_vertices: int,
                      device: DeviceLike = None) -> Graph:
    """The port's :class:`Graph` from numpy edge arrays."""
    return Graph.from_numpy(_require_numpy("src", src),
                            _require_numpy("dst", dst), n_vertices,
                            device=device)


def result_from_arrays(labels, iterations, converged, edges_visited=None,
                       device: DeviceLike = None) -> ComponentResult:
    """A :class:`ComponentResult` from numpy values (usable as a warm
    start)."""
    dev = resolve_device(device)
    labels = _require_numpy("labels", labels)
    return make_result(
        torch.as_tensor(labels.astype(np.int32), device=dev),
        _require_numpy("iterations", iterations, scalar=True),
        _require_numpy("converged", converged, scalar=True),
        None if edges_visited is None else
        _require_numpy("edges_visited", edges_visited, scalar=True))


def tensor_from_numpy(a, dtype: str = "float32",
                      device: DeviceLike = None) -> torch.Tensor:
    """A tensor of ``dtype`` (``"float32"`` or ``"bfloat16"``) from a
    float32 numpy array.

    numpy has no bfloat16, so inputs are made in float32 and rounded on
    each side; ``bfloat16`` rounds to nearest even, as
    ``jnp.asarray(a, jnp.bfloat16)`` does, so both packages get the same
    bits.
    """
    a = _require_numpy("a", a)
    if a.dtype != np.float32:
        raise TypeError(f"a must be a float32 array, got {a.dtype}")
    if dtype not in FLOAT_DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; one of "
                         f"{tuple(FLOAT_DTYPES)}")
    t = torch.from_numpy(np.ascontiguousarray(a)).to(FLOAT_DTYPES[dtype])
    return t.to(resolve_device(device))


def stream_from_state(state: dict,
                      device: DeviceLike = None) -> StreamingConnectivity:
    """A :class:`~repro_torch.connectivity.streaming.StreamingConnectivity`
    on ``device`` from a stream's ``state_dict()`` given as numpy values —
    for example the reference's, each value passed through
    ``np.asarray``.  Solver options are not part of a stream's state
    (nor of its checkpoints): the stream takes the default options."""
    if not isinstance(state, dict):
        raise TypeError(f"state must be a dict, got {type(state).__name__}")
    state = {key: _require_numpy(key, value, scalar=True)
             for key, value in state.items()}
    missing = set(StreamingConnectivity._STATE_KEYS) - set(state)
    if missing:
        raise ValueError(f"state is missing {sorted(missing)}")
    eng = StreamingConnectivity(int(state["n"]),
                                store_edges=bool(state["store_edges"]),
                                device=device)
    return eng.load_state_dict(state)


def _float_tensor(a, dtype: torch.dtype, device: torch.device,
                  path: str) -> torch.Tensor:
    # float32 -> bfloat16 rounds to nearest even, as tensor_from_numpy does
    a = _require_numpy(path, a)
    if a.dtype != np.float32:
        raise TypeError(f"{path} must be a float32 array, got {a.dtype}")
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _device(device: DeviceLike, mesh):
    return resolve_device(mesh.device if mesh is not None and device is None
                          else device)


def lm_params_from_numpy(tree, config: ModelConfig,
                         device: DeviceLike = None, mesh=None):
    """The port's parameter tree from the reference's, each leaf passed
    through ``np.asarray(p, np.float32)`` (exact for bfloat16), as
    tensors on ``device`` in ``config.param_dtype``.

    Each leaf's path and shape is checked against
    ``build_model(config).param_specs()`` (the decoder LM's tree, or the
    encoder-decoder's for the ``audio`` family); a missing, extra or
    misshapen leaf raises ``ValueError``.  The tree goes to the model's
    ``load_params`` or ``BatchedServer(config, params=...)``.  With a
    ``mesh`` (a ``repro_torch.runtime.Mesh``; ``device`` defaults to its
    own) each leaf is the calling rank's block as ``shardings_for``
    resolves it: the tree ``build_model(config, mesh)`` holds.
    """
    specs = lm_param_specs(config)
    check_tree(tree, specs)
    dev = _device(device, mesh)
    whole = cm.tree_map_with_path(
        lambda path, a: _float_tensor(a, config.param_dtype, dev, path),
        tree, lambda x: isinstance(x, np.ndarray))
    if mesh is None:
        return whole
    return cm.tree_blocks(whole, cm.shardings_for(specs, config, mesh))


def train_state_from_numpy(state, config: ModelConfig, opt_config: OptConfig,
                           device: DeviceLike = None,
                           mesh=None) -> TrainState:
    """The port's :class:`~repro_torch.train.step.TrainState` from the
    reference's, given as ``(params, opt)`` with every float leaf passed
    through ``np.asarray(x, np.float32)`` (exact for bfloat16 moments)
    and ``opt["step"]`` through ``np.asarray``: the parameters as
    :func:`lm_params_from_numpy` gives them, ``m`` and ``v`` in
    ``opt_config.moment_dtype`` (their trees checked as the parameters'
    are), ``step`` an int32 scalar, all on ``device``; with a ``mesh``
    every leaf the calling rank's block (``m`` and ``v`` laid out as
    their parameter)."""
    params, opt = state
    if not isinstance(opt, dict) or set(opt) != {"m", "v", "step"}:
        raise ValueError("opt must be a dict of m, v and step")
    dev = _device(device, mesh)
    specs = lm_param_specs(config)

    def moments(tree, name):
        check_tree(tree, specs)
        whole = cm.tree_map_with_path(
            lambda path, a: _float_tensor(a, opt_config.moment_dtype, dev,
                                          f"{name}.{path}"),
            tree, lambda x: isinstance(x, np.ndarray))
        if mesh is None:
            return whole
        return cm.tree_blocks(whole, cm.shardings_for(specs, config, mesh))

    step = _require_numpy("step", opt["step"], scalar=True)
    if step.shape != () or not np.issubdtype(step.dtype, np.integer):
        raise TypeError(f"step must be an integer scalar, got {step.dtype} "
                        f"{step.shape}")
    return TrainState(
        params=lm_params_from_numpy(params, config, device=dev, mesh=mesh),
        opt={"m": moments(opt["m"], "m"), "v": moments(opt["v"], "v"),
             "step": torch.tensor(int(step), dtype=torch.int32, device=dev)})


# a cache's float32 states (the rest of a cache is in config.dtype)
_FLOAT32_STATES = {"ssd", "h", "c", "n", "m"}


def lm_cache_from_numpy(cache, config: ModelConfig,
                        device: DeviceLike = None, mesh=None):
    """The port's cache from a reference prefill's, its float leaves
    passed through ``np.asarray(c, np.float32)`` and its lengths through
    ``np.asarray``: ``{"prefix": [...], "unit": [...]}`` and, for a
    shared block, ``"shared"``, each entry a ``KVCache``, an
    ``SSMState(conv, ssd)``, an ``SLSTMState(h, c, n, m)`` or the decoder
    block's ``{"self": KVCache, "cross_k", "cross_v"}`` (the reference's
    named tuples are read by their fields).  ``ssd`` and the sLSTM states
    become float32, every other tensor ``config.dtype``, on ``device``;
    each stacked ``length`` (one per layer, all equal) becomes the
    port's one Python int.  With a ``mesh`` each tensor is the calling
    rank's block as ``transformer.cache_shardings`` resolves it (on the
    decoder's plan for the ``audio`` family)."""
    dev = _device(device, mesh)

    def carry(c, what: str):
        fields = getattr(c, "_fields", None)
        if fields == KVCache._fields:
            k, v, length = c
            lengths = np.unique(_require_numpy(f"{what}.length", length,
                                               scalar=True))
            if lengths.size != 1:
                raise ValueError(f"{what}: the layers' lengths differ: "
                                 f"{lengths.tolist()}")
            return KVCache(k=carry(k, f"{what}.k"), v=carry(v, f"{what}.v"),
                           length=int(lengths[0]))
        if fields in (SSMState._fields, SLSTMState._fields):
            kind = SSMState if fields == SSMState._fields else SLSTMState
            return kind(*(carry(x, f"{what}.{name}")
                          for name, x in zip(fields, c)))
        if isinstance(c, dict):
            return {key: carry(x, f"{what}.{key}") for key, x in c.items()}
        if isinstance(c, (list, tuple)):
            return [carry(x, f"{what}.{i}") for i, x in enumerate(c)]
        name = what.rsplit(".", 1)[-1]
        dtype = torch.float32 if name in _FLOAT32_STATES else config.dtype
        return _float_tensor(c, dtype, dev, what)

    whole = {key: carry(value, key) for key, value in cache.items()}
    if mesh is None:
        return whole
    plan = (tfm.seq2seq_plans(config)[1] if config.family == "audio"
            else tfm.layer_plan(config))
    return cm.tree_blocks(whole, tfm.resolve_cache_shardings(
        tfm.cache_shardings(config, mesh, plan), whole))
