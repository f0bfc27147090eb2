"""Shared model machinery: configs, sharding rules, norms, RoPE, init.

The port's counterpart of ``repro.models.common``.  Parameters are
nested dicts (and lists) of tensors, the reference's pytree layout.
Every parameter leaf has a parallel *logical-axes* annotation (a tuple of
logical axis names, one per dim) produced by the same constructor code
path (:class:`ParamSpec`), so abstract (``meta``-device) and concrete
initialisation can never diverge.  Logical axes map to mesh axes through
per-config rules (MaxText-style), with divisibility-aware fallback to
replication: :func:`resolve_spec` works on a :class:`repro_torch.runtime.Mesh`
or an :class:`~repro_torch.runtime.mesh.AbstractMesh` (its ``shape`` is
the name -> size map) and returns a tuple where the reference returns a
``PartitionSpec``; :func:`shardings_for` returns a tree of
:class:`Sharding` (mesh and spec) where the reference returns
``NamedSharding`` objects.

On a mesh the port runs SPMD: one process a rank, each holding exactly
its block of every parameter, moment and cache leaf, with the
``torch.distributed`` collectives of ``repro_torch.runtime.mesh``.
:func:`constrain` brings an activation to a named layout (gathering or
taking its block).  Inside a block :class:`Placement` applies one rule,
derived from ``resolve_spec``:

* computed in place (tensor parallel): a weight dim sharded over a mesh
  axis that the activation's ``batch`` does not use (``heads``,
  ``kv_heads``, ``ffn``, ``vocab`` on ``model``) stays the rank's slice;
  the rank computes its heads, its ``ffn`` slice or its ``vocab`` slice,
  and an all-reduce over that axis ends the product that contracts it
  (a reduce-scatter over ``seq`` where the residual stream is
  sequence-parallel, ``tp_sp``).  The experts of a MoE layer are the
  same kind: each rank runs its own on its slice of the dispatch buffer;
* gathered on use (storage sharding): every other sharded weight dim is
  all-gathered before its use; its gradient is reduce-scattered back to
  the block where the ranks of that axis saw different activations, and
  cut to the block where they computed the same;
* the gradient of every use is summed over the axes on which the
  activations (or, in place, the computation) differ and which do not
  shard the leaf: a replicated norm scale over the batch axes, a
  replicated ``wk`` inside a tensor-parallel attention over ``model``
  too.

Each of these is an autograd function, so ``torch.autograd.grad`` of the
loss gives every rank its block of the global gradient.  Axes of size 1
are ignored, so a mesh of one rank computes op for op what a single rank
computes; a model without a mesh runs the same code under
:meth:`Placement.single` (every layout empty, every collective the
identity).

Trees are walked in the reference's leaf order (``jax.tree_util``): dict
keys sorted, list and NamedTuple entries in order.  A leaf's path is its
keys joined by dots (``backbone.unit.0.attn.wq``), which is also its
``state_dict()`` key in :class:`repro_torch.models.model.LM`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

# Sharding profiles: logical axis -> candidate mesh axes (applied left to
# right, each used at most once per array, only if it divides the dim).
#
#   tp      — Megatron tensor parallelism: batch over (pod, data); heads /
#             ffn / vocab / experts over model; weights otherwise replicated.
#   tp_sp   — tp + sequence-parallel residual stream (seq -> model).
#   fsdp    — flat batch over (pod, data, model); every weight is *storage*
#             sharded (embed->data, ffn/heads->model) and gathered per layer.
#   ep      — MoE expert parallelism: experts->model, expert FFN inner dim
#             storage-sharded over data, attention as tp + embed->data.
#   ep_fsdp — ep + flat batch for activation relief (arctic-480b).
def _profile(batch, *, seq=(), embed=(), expert_inner=()):
    return {
        "batch": batch,
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ffn": ("model",),
        "experts": ("model",),
        "expert_inner": expert_inner,
        "embed": embed,
        "seq": seq,
        "kv_seq": (),            # overridden when shard_cache_seq is set
        "moe_group": ("pod", "data"),
        "conv": ("model",),
        "state": (),
        "qkv": (),
    }


PROFILES: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "tp": _profile(("pod", "data")),
    "tp_sp": _profile(("pod", "data"), seq=("model",)),
    "fsdp": _profile(("pod", "data", "model"), embed=("data",),
                     expert_inner=("data",)),
    "ep": _profile(("pod", "data"), embed=("data",), expert_inner=()),
    "ep_fsdp": _profile(("pod", "data", "model"), embed=("data",),
                        expert_inner=("data",)),
}

DEFAULT_RULES = PROFILES["tp"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    # block flavour
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm | nonparametric
    act: str = "silu"
    mlp_gated: bool = True           # SwiGLU-style (gate ⊙ up) if True
    rotary_pct: float = 1.0
    rope_theta: float = 10_000.0
    use_qkv_bias: bool = False
    tie_embeddings: bool = False
    # MoE
    moe_style: Optional[str] = None  # None | deepseek | arctic
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0              # dense-layer/residual-FFN width
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0              # zamba2: shared attn block period
    slstm_every: int = 0             # xlstm: sLSTM block period (rest mLSTM)
    # enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # modality frontend stub
    frontend: str = "none"           # none | patch_stub | audio_stub
    n_frontend_tokens: int = 0       # e.g. image patches prepended
    # numerics / memory
    param_dtype: Any = torch.float32
    dtype: Any = torch.bfloat16
    remat: str = "full"              # none | dots | full
    vocab_pad_multiple: int = 256
    max_seq_len: int = 131_072
    # distribution (see PROFILES above)
    sharding_profile: str = "tp"     # training profile
    serve_profile: str = "tp"        # serving profile (no optimizer state)
    shard_cache_seq: bool = False    # shard KV-cache seq dim over model axis
    repeat_kv_math: bool = False     # repeat K/V to full heads in train/
                                     # prefill attention
    moe_groups: int = 1              # local-dispatch groups (= data shards)
    # attention impl
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    flash_block_threshold: int = 4096  # use chunked attn when seq >= this
    # which schedule shapes are valid (assignment skip rules)
    supports_decode: bool = True
    supports_long_context: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def seq_parallel(self) -> bool:
        return self.sharding_profile == "tp_sp"

    def for_serving(self) -> "ModelConfig":
        """Serving view: bf16 params, no remat, serve sharding profile."""
        return self.replace(
            sharding_profile=self.serve_profile,
            param_dtype=torch.bfloat16,
            remat="none",
        )

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Trees: nested dicts / lists / NamedTuples, walked in the reference's order
# ---------------------------------------------------------------------------

def _children(tree):
    """``(key, subtree)`` pairs of a container in the reference's order, or
    None for a leaf."""
    if isinstance(tree, dict):
        return sorted(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _join(prefix: str, key) -> str:
    return f"{prefix}.{key}" if prefix else str(key)


def tree_leaves_with_path(tree, is_leaf: Callable[[Any], bool],
                          prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order: dict keys
    sorted, lists and NamedTuples in order; ``None`` and empty containers
    hold no leaf."""
    if tree is None:
        return []
    children = None if is_leaf(tree) else _children(tree)
    if children is None:
        return [(prefix, tree)]
    out = []
    for key, sub in children:
        out += tree_leaves_with_path(sub, is_leaf, _join(prefix, key))
    return out


def tree_map_with_path(fn, tree, is_leaf: Callable[[Any], bool],
                       prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping its
    containers (``None`` stays ``None``)."""
    if tree is None:
        return None
    if is_leaf(tree) or _children(tree) is None:
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, is_leaf, _join(prefix, k))
                for k, v in tree.items()}
    subs = [tree_map_with_path(fn, v, is_leaf, _join(prefix, k))
            for k, v in _children(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*subs)
    return type(tree)(subs)


def tree_map(fn, tree, is_leaf: Callable[[Any], bool]):
    """``fn`` over the leaves of ``tree``, keeping its containers."""
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree, is_leaf)


# ---------------------------------------------------------------------------
# Param construction: shapes + logical axes + init, in one spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones | scaled
    scale: float = 1.0


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def make_dense_spec(d_in: int, d_out: int, axes, scale=None) -> ParamSpec:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return ParamSpec((d_in, d_out), axes, "normal", scale)


def init_param(generator: torch.Generator, spec: ParamSpec, dtype,
               device=None, stacked: bool = False,
               sharding: Optional["Sharding"] = None) -> torch.Tensor:
    """One leaf: zeros, ones, or a float32 standard normal times
    ``spec.scale`` cast to ``dtype``, drawn from ``generator`` (on its
    device) in one draw, or one draw per slice of the leading axis where
    the leaf is ``stacked`` over layers, and per expert where the next
    axis is ``experts`` (so no float32 copy of a whole stacked leaf, or
    of a layer's experts, is ever made).  With a ``sharding`` (on a
    ``Mesh``) the draws are the same and only the calling rank's block
    of each is kept."""
    device = generator.device if device is None else torch.device(device)
    layout = (sharding.layout(len(spec.shape)) if sharding is not None
              else ((),) * len(spec.shape))
    mesh = sharding.mesh if sharding is not None else None
    shape = sharding.shard_shape(spec.shape) if sharding is not None \
        else spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)

    def draw(lead):
        whole = (torch.randn(spec.shape[len(lead):], generator=generator,
                             dtype=torch.float32, device=device)
                 * spec.scale).to(dtype)
        return block_of(whole, mesh, layout[len(lead):]) if mesh else whole

    split = int(stacked)
    if spec.logical_axes[split:split + 1] == ("experts",):
        split += 1
    if not split:
        return draw(()).contiguous()
    out = torch.empty(shape, dtype=dtype, device=device)
    # the rank's rows of the leading dims, as ranges of whole indices
    kept = [range(n) if mesh is None or not layout[d] else
            range(mesh.shard_index(layout[d]) * shape[d],
                  (mesh.shard_index(layout[d]) + 1) * shape[d])
            for d, n in enumerate(spec.shape[:split])]
    for index in np.ndindex(*spec.shape[:split]):
        value = draw(index)
        if all(i in r for i, r in zip(index, kept)):
            out[tuple(i - r.start for i, r in zip(index, kept))] = value
    return out


def init_tree(generator: torch.Generator, specs, dtype, device=None,
              stacked: Sequence[str] = (), shardings=None):
    """Initialise a pytree of ParamSpec into tensors, one draw a leaf in
    the reference's leaf order; leaves whose path starts with one of
    ``stacked`` are drawn one slice of their leading (layer) axis at a
    time.  With ``shardings`` (:func:`shardings_for` on a ``Mesh``) each
    rank draws every leaf whole, as without, and keeps its block.  The
    bits are not the reference's (JAX's RNG does not carry over);
    ``repro_torch.interop.lm_params_from_numpy`` carries its values
    across instead."""
    sh = dict(tree_leaves_with_path(shardings, lambda x: isinstance(
        x, Sharding))) if shardings is not None else {}
    made = {path: init_param(generator, spec, dtype, device,
                             stacked=path.startswith(tuple(stacked)),
                             sharding=sh.get(path))
            for path, spec in tree_leaves_with_path(specs, is_spec)}
    return tree_map_with_path(lambda path, _: made[path], specs, is_spec)


def abstract_tree(specs, dtype):
    """The tree of ``specs`` as tensors on the ``meta`` device."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), specs, is_spec)


def logical_axes_tree(specs):
    return tree_map(lambda s: s.logical_axes, specs, is_spec)


# ---------------------------------------------------------------------------
# Logical-axis -> mesh resolution
# ---------------------------------------------------------------------------

def resolve_spec(
    shape: Sequence[int],
    logical_axes: Sequence[Optional[str]],
    mesh,
    rules: Dict[str, Tuple[str, ...]],
) -> tuple:
    """Map logical axes to a partition tuple, respecting divisibility.

    ``mesh.shape`` maps axis names to sizes (a
    :class:`repro_torch.runtime.Mesh`); each entry of the result is None,
    one mesh axis, or a tuple of them, trailing Nones trimmed — the
    entries of the reference's ``PartitionSpec``."""
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} and logical axes "
                         f"{tuple(logical_axes)} differ in rank")
    used: set = set()
    out = []
    for dim, lname in zip(shape, logical_axes):
        assigned = []
        if lname is not None:
            for ax in rules.get(lname, ()):  # candidates in priority order
                if ax in used or ax not in mesh.shape:
                    continue
                size = mesh.shape[ax]
                prod = int(np.prod([mesh.shape[a] for a in assigned])) \
                    if assigned else 1
                if dim % (prod * size) == 0:
                    assigned.append(ax)
                    used.add(ax)
        if not assigned:
            out.append(None)
        elif len(assigned) == 1:
            out.append(assigned[0])
        else:
            out.append(tuple(assigned))
    # trim trailing Nones for tidier specs
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def make_rules(config: ModelConfig, mesh) -> Dict[str, Tuple[str, ...]]:
    rules = dict(PROFILES[config.sharding_profile])
    if config.shard_cache_seq:
        # used-axis bookkeeping in resolve_spec guarantees kv_seq and
        # kv_heads never both take the model axis on one array
        rules["kv_seq"] = ("model",)
    return rules


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------

def norm_params(config: ModelConfig, d: int) -> Dict[str, ParamSpec]:
    if config.norm_type == "nonparametric":
        return {}
    p = {"scale": ParamSpec((d,), ("embed",), "ones")}
    if config.norm_type == "layernorm":
        p["bias"] = ParamSpec((d,), ("embed",), "zeros")
    return p


def apply_norm(x: torch.Tensor, params, config: ModelConfig,
               eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm, LayerNorm or non-parametric LayerNorm over the last dim,
    computed in float32 and cast back to ``x``'s type (inline, as the
    reference computes it)."""
    dt = x.dtype
    x = x.float()
    if config.norm_type == "rmsnorm":
        x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
        x = x * params["scale"].float()
    else:
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + eps)
        if config.norm_type == "layernorm":
            x = x * params["scale"].float() + params["bias"].float()
        # nonparametric (OLMo): no affine
    return x.to(dt)


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    """SiLU, or GELU's tanh approximation (``jax.nn.gelu``'s default),
    written op by op in ``x``'s type as the reference's are, so that each
    step rounds where it does (``F.silu``/``F.gelu`` round once, which
    differs in a third of bfloat16 outputs)."""
    if act == "silu":
        one = torch.ones((), dtype=x.dtype, device=x.device)
        return x * (one / (one + torch.exp(-x)))
    if act == "gelu":
        c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype,
                         device=x.device)
        k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))
    raise ValueError(act)


def rope_angles(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions: int[...]; returns (cos, sin) with trailing dim rot_dim/2."""
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=positions.device) / rot_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exponent)
    ang = positions.float()[..., None] * freqs  # (..., rot_dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, hd); cos/sin: (T, rot/2) or (B, T, rot/2)."""
    rot = cos.shape[-1] * 2
    if rot > x.shape[-1]:
        raise ValueError(f"rotary dim {rot} > head dim {x.shape[-1]}")
    if cos.dim() == 2:      # (T, r/2) -> (1, T, 1, r/2)
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:                   # (B, T, r/2) -> (B, T, 1, r/2)
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr.chunk(2, dim=-1)
    out1 = x1.float() * c - x2.float() * s
    out2 = x2.float() * c + x1.float() * s
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), xp], dim=-1)



# ---------------------------------------------------------------------------
# Placement on a mesh: shardings, layouts, collectives with their gradients
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """``NamedSharding``'s counterpart: a mesh (a ``Mesh`` or an
    ``AbstractMesh``) and a resolved spec, one entry per leading dim
    (None, an axis name or a tuple of them; trailing Nones trimmed)."""
    mesh: Any
    spec: tuple

    def layout(self, ndim: int) -> tuple:
        """The spec as a tuple of axis tuples, one per dim, axes of size
        1 dropped."""
        return normalize(self.spec, ndim, self.mesh)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one rank's block of an array of ``shape``."""
        return tuple(n // _n_shards(self.mesh, axes) for n, axes in
                     zip(shape, self.layout(len(shape))))


def _entry(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def normalize(spec, ndim: int, mesh) -> tuple:
    """A spec (entries None / name / tuple) as ``ndim`` tuples of the
    axes of size above 1."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return tuple(tuple(a for a in _entry(e) if mesh.shape[a] > 1)
                 for e in entries)


def _n_shards(mesh, axes: Sequence[str]) -> int:
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def shardings_for(specs, config: ModelConfig, mesh):
    """Tree of :class:`Sharding` for a ParamSpec tree, leaf for leaf."""
    rules = make_rules(config, mesh)
    return tree_map(
        lambda s: Sharding(mesh, resolve_spec(s.shape, s.logical_axes,
                                              mesh, rules)), specs, is_spec)


def global_shape(x: torch.Tensor, mesh, layout: tuple) -> Tuple[int, ...]:
    """The whole array's shape of the block ``x`` laid out as
    ``layout``."""
    return tuple(n * _n_shards(mesh, axes)
                 for n, axes in zip(x.shape, layout))


def block_of(x: torch.Tensor, mesh, layout: tuple) -> torch.Tensor:
    """The calling rank's block of the whole array ``x`` (a view)."""
    from repro_torch.runtime import mesh as rt
    for dim, axes in enumerate(layout):
        if axes:
            x = rt.block_of(x, mesh, axes, dim)
    return x


def tree_blocks(tree, shardings):
    """The calling rank's block (contiguous) of each whole tensor of
    ``tree``, as ``shardings`` (a tree of :class:`Sharding` with the same
    paths) lays them out; other leaves as they are."""
    sh = dict(tree_leaves_with_path(shardings,
                                    lambda x: isinstance(x, Sharding)))
    return tree_map_with_path(
        lambda path, t: block_of(t, sh[path].mesh, sh[path].layout(
            t.dim())).contiguous() if isinstance(t, torch.Tensor) else t,
        tree, lambda x: isinstance(x, (torch.Tensor, int)))


def _relayout(x: torch.Tensor, mesh, src: tuple, dst: tuple) -> torch.Tensor:
    """The block ``x`` of an array laid out as ``src``, as the rank's
    block of the same array laid out as ``dst``: every dim whose axes
    differ is all-gathered over ``src``'s axes, and only then cut to
    ``dst``'s block (a cut before a gather over the same axis would mix
    the ranks' blocks)."""
    from repro_torch.runtime import mesh as rt
    moved = [dim for dim, (a, b) in enumerate(zip(src, dst)) if a != b]
    for dim in moved:
        if src[dim]:
            x = rt.all_gather(x, mesh, src[dim], dim)
    for dim in moved:
        if dst[dim]:
            x = rt.block_of(x, mesh, dst[dim], dim)
    return x


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, src, dst):
        ctx.args = (mesh, src, dst)
        return _relayout(x, mesh, src, dst)

    @staticmethod
    def backward(ctx, g):
        mesh, src, dst = ctx.args
        return _relayout(g, mesh, dst, src).contiguous(), None, None, None


def relayout(x: torch.Tensor, mesh, src: tuple, dst: tuple) -> torch.Tensor:
    """The block ``x`` of an array laid out as ``src`` (a layout: one
    axis tuple a dim), as the rank's block of the same array laid out as
    ``dst``.  Its gradient goes the way back (a gather's is the block, a
    block's is the gather): the ranks that share a dim after a gather
    compute the same from it."""
    if src == dst:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _Relayout.apply(x, mesh, src, dst)
    return _relayout(x, mesh, src, dst)


class _CopyTo(torch.autograd.Function):
    """Identity; the gradient is summed over ``axes`` (a replicated value
    entering a computation split over them)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.runtime import mesh as rt
        return rt.all_reduce(g, *ctx.args), None, None


class _ReduceFrom(torch.autograd.Function):
    """Sum over ``axes`` (partial products leaving a split computation);
    the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        from repro_torch.runtime import mesh as rt
        return rt.all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherSum(torch.autograd.Function):
    """All-gather along ``dim`` over ``axes``; the gradient is
    reduce-scattered (the ranks used the gathered value differently)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        from repro_torch.runtime import mesh as rt
        ctx.args = (mesh, axes, dim)
        return rt.all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.runtime import mesh as rt
        return rt.reduce_scatter(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over ``axes`` and keep the block along ``dim``; the gradient is
    all-gathered."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        from repro_torch.runtime import mesh as rt
        ctx.args = (mesh, axes, dim)
        return rt.reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.runtime import mesh as rt
        return rt.all_gather(g, *ctx.args), None, None, None


def copy_to(x, mesh, axes):
    return _CopyTo.apply(x, mesh, tuple(axes)) if axes else x


def reduce_from(x, mesh, axes):
    return _ReduceFrom.apply(x, mesh, tuple(axes)) if axes else x


def constrain(x: torch.Tensor, mesh, config: ModelConfig, *logical_axes,
              layout: Optional[tuple] = None) -> torch.Tensor:
    """``x`` brought to the layout ``logical_axes`` resolve to (gathered,
    or cut to the rank's block), the reference's
    ``with_sharding_constraint``.  ``x`` is the rank's block of an array
    laid out as ``layout`` (a spec made by :func:`normalize`; default: the
    whole array on every rank).  The gradient goes the way back."""
    layout = layout or ((),) * x.dim()
    shape = global_shape(x, mesh, layout)
    dst = normalize(resolve_spec(shape, logical_axes, mesh,
                                 make_rules(config, mesh)), x.dim(), mesh)
    return relayout(x, mesh, layout, dst)


class Placement:
    """The rule above for one model on one mesh: layouts of activations,
    the weights a block computes with, and the way into and out of a
    block.

    A layout is a tuple of axis tuples, one per dim (:func:`normalize`).
    The residual stream between blocks is laid out as ``("batch", "seq",
    "embed")`` resolve (``("batch", None, "embed")`` in decode); a block
    computes on the rank's batch block with the whole sequence and
    width.  A block is tensor parallel over ``tp`` (a tuple of axes, ()
    for none) where its main weight dim is in place."""

    def __init__(self, mesh, config: ModelConfig):
        self.mesh, self.config = mesh, config
        self.rules = make_rules(config, mesh)
        self._memo: Dict[Any, Any] = {}
        # one rank: every layout is empty and every helper below the
        # identity, which they return at once (a decode step calls them
        # some twenty times a layer)
        self.one_rank = all(n == 1 for n in mesh.shape.values())

    @classmethod
    def single(cls, config: ModelConfig) -> "Placement":
        """The placement of a model on no mesh: one rank, whose layouts
        are all empty, so that every collective and relayout is the
        identity."""
        from repro_torch.runtime.mesh import AbstractMesh
        return cls(AbstractMesh((1, 1), ("data", "model")), config)

    def memo(self, key, make: Callable[[], Any]):
        """``make()``, made once per ``key`` on this placement."""
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def layout(self, shape: Sequence[int], *logical_axes) -> tuple:
        if self.one_rank:
            return ((),) * len(shape)
        shape = tuple(shape)
        return self.memo(("layout", shape, logical_axes), lambda: normalize(
            resolve_spec(shape, logical_axes, self.mesh, self.rules),
            len(shape), self.mesh))

    def residual(self, shape: Sequence[int], decode: bool = False) -> tuple:
        return self.layout(shape, "batch", None if decode else "seq",
                           "embed")

    @staticmethod
    def block(res: tuple) -> tuple:
        return (res[0],) + ((),) * (len(res) - 1)

    def n(self, axes: Sequence[str]) -> int:
        return _n_shards(self.mesh, axes)

    def index(self, axes: Sequence[str]) -> int:
        """The rank's block index over ``axes`` (0 for none)."""
        return self.mesh.shard_index(axes) if axes else 0

    # -- weights ----------------------------------------------------------
    def weight_layout(self, spec: ParamSpec) -> tuple:
        return self.layout(spec.shape, *spec.logical_axes)

    def split(self, spec: ParamSpec, logical: str, act: tuple) -> tuple:
        """The axes a block whose main weight is ``spec`` splits its
        computation over: those of the ``logical`` dim where they are
        disjoint from the activation's ``act`` axes, else ()."""
        if self.one_rank:
            return ()
        layout = self.weight_layout(spec)
        axes = layout[spec.logical_axes.index(logical)]
        return axes if axes and not set(axes) & set(act) else ()

    def weight(self, w: torch.Tensor, spec: ParamSpec, act: tuple,
               split: tuple = (), inplace: Sequence[str] = ()):
        """The tensor a use computes with, from the rank's block ``w`` of
        a leaf of ``spec``: the dims named in ``inplace`` whose axes are
        ``split``'s stay the rank's slice, every other sharded dim is
        gathered.  ``act``: the axes the use's activations differ over;
        with ``split``, those the use's result differs over."""
        if self.one_rank:
            return w
        reduce, steps = self.memo(
            ("weight", spec, tuple(act), tuple(split), tuple(inplace)),
            lambda: self._weight_plan(spec, act, split, inplace))
        w = copy_to(w, self.mesh, reduce)
        for gather, dim, axes, src, dst in steps:
            w = (_GatherSum.apply(w, self.mesh, axes, dim) if gather
                 else relayout(w, self.mesh, src, dst))
        return w

    def _weight_plan(self, spec: ParamSpec, act: tuple, split: tuple,
                     inplace: Sequence[str]):
        """(the axes a use's gradient is summed over, the steps from the
        block to the tensor used: ``(gather, dim, axes, src, dst)``)."""
        layout = self.weight_layout(spec)
        differ = set(act) | set(split)
        held = {a for axes in layout for a in axes}
        reduce = tuple(a for a in self.mesh.axis_names
                       if a in differ and a not in held)
        steps, cur = [], list(layout)
        for dim, axes in enumerate(layout):
            if not axes or (spec.logical_axes[dim] in inplace
                            and axes == tuple(split)):
                continue
            src = tuple(cur)
            cur[dim] = ()
            if set(axes) <= differ:
                steps.append((True, dim, axes, src, tuple(cur)))
            elif not set(axes) & differ:
                steps.append((False, dim, axes, src, tuple(cur)))
            else:
                raise NotImplementedError(
                    f"dim {dim} of {spec} is sharded over {axes}, of which "
                    f"only some carry different activations {act}")
        return reduce, tuple(steps)

    def weights(self, params, specs, act: tuple, split: tuple = (),
                inplace: Sequence[str] = ()):
        """:meth:`weight` over a dict of leaves and its ParamSpecs."""
        if self.one_rank:
            return params
        return {k: (self.weights(v, specs[k], act, split, inplace)
                    if isinstance(v, dict)
                    else self.weight(v, specs[k], act, split, inplace))
                for k, v in params.items()}

    # -- into and out of a block -----------------------------------------
    def _fused(self, res: tuple, tp: tuple) -> bool:
        return bool(tp) and res[1] == tuple(tp) and not res[2]

    def enter(self, x: torch.Tensor, res: tuple, tp: tuple = ()):
        """The residual ``x`` (laid out as ``res``) as a block's input:
        the rank's batch block, whole sequence and width; into a tensor
        parallel block the gradient is summed over ``tp`` (a
        reduce-scatter where ``tp`` shards the sequence)."""
        if self.one_rank:
            return x
        if self._fused(res, tp):
            return _GatherSum.apply(x, self.mesh, tuple(tp), 1)
        return copy_to(relayout(x, self.mesh, res, self.block(res)),
                       self.mesh, tp)

    def exit(self, y: torch.Tensor, res: tuple, tp: tuple = ()):
        """A block's output back to the residual layout ``res``; out of a
        tensor parallel block the partial sums are added over ``tp``."""
        if self.one_rank:
            return y
        if self._fused(res, tp):
            return _ReduceScatter.apply(y, self.mesh, tuple(tp), 1)
        return relayout(reduce_from(y, self.mesh, tp), self.mesh,
                        self.block(res), res)

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str],
                   op: str = "sum") -> torch.Tensor:
        """No gradient: ``x`` summed (or ``op="max"``) over ``axes``."""
        import torch.distributed as dist
        from repro_torch.runtime import mesh as rt
        if not axes:
            return x.detach()
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        return rt.all_reduce(x.detach(), self.mesh, axes, red)
