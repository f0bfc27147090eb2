"""Shared model machinery: configs, sharding rules, norms, RoPE, init.

The port's counterpart of ``repro.models.common``.  Parameters are
nested dicts (and lists) of tensors, the reference's pytree layout.
Every parameter leaf has a parallel *logical-axes* annotation (a tuple of
logical axis names, one per dim) produced by the same constructor code
path (:class:`ParamSpec`), so abstract (``meta``-device) and concrete
initialisation can never diverge.  Logical axes map to mesh axes through
per-config rules (MaxText-style), with divisibility-aware fallback to
replication: :func:`resolve_spec` works on a :class:`repro_torch.runtime.Mesh`
(its ``shape`` is the name -> size map) and returns a tuple where the
reference returns a ``PartitionSpec``.  Placing arrays on a mesh
(``shardings_for``, ``constrain``) waits for the launch slice (ROADMAP
Queue A).

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
               device=None, stacked: bool = False) -> torch.Tensor:
    """One leaf: zeros, ones, or a float32 standard normal times
    ``spec.scale`` cast to ``dtype``, drawn from ``generator`` (on its
    device) in one draw, or one draw per slice of the leading axis where
    the leaf is ``stacked`` over layers, and per expert where the next
    axis is ``experts`` (so no float32 copy of a whole stacked leaf, or
    of a layer's experts, is ever made)."""
    device = generator.device if device is None else torch.device(device)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)

    def draw(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * spec.scale).to(dtype)

    split = int(stacked)
    if spec.logical_axes[split:split + 1] == ("experts",):
        split += 1
    if not split:
        return draw(spec.shape)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    for index in np.ndindex(*spec.shape[:split]):
        out[index] = draw(spec.shape[split:])
    return out


def init_tree(generator: torch.Generator, specs, dtype, device=None,
              stacked: Sequence[str] = ()):
    """Initialise a pytree of ParamSpec into tensors, one draw a leaf in
    the reference's leaf order; leaves whose path starts with one of
    ``stacked`` are drawn one slice of their leading (layer) axis at a
    time.  The bits are not the reference's (JAX's RNG does not carry
    over); ``repro_torch.interop.lm_params_from_numpy`` carries its
    values across instead."""
    made = {path: init_param(generator, spec, dtype, device,
                             stacked=path.startswith(tuple(stacked)))
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
