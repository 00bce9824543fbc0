"""Path-regex sharding rule engine (port of ``repro.launch.sharding``).

``param_shardings(cfg, mesh, model)`` maps every parameter leaf of the
model's reference-layout tree (``models.param_tree``) to a
:class:`NamedSharding` by matching its "/"-joined path against ordered
rules. Rules give the spec of the *trailing* dims; leading stacked-layer
axes are padded with None. Every sharded dim is checked for divisibility
by its mesh axes; a dim that does not divide degrades to replicated and is
collected in :class:`ShardingReport`.

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dim, each None, an axis name or a tuple of names. ``placements``
turns it into DTensor placements; ``distribute_model`` swaps a model's
parameters and buffers for DTensors, the counterpart of ``jax.jit``'s
``in_shardings``.

The reference stacks each stack's layers along a leading axis; the port
keeps one tensor per layer. Specs are computed on the stacked shape
(L, ...), divisibility check included, and each layer's tensor takes the
spec without its leading entry.

Scheme (DESIGN.md §4): vocab/embed + attention heads + FFN hidden + MoE
expert axis + SSM/RG-LRU channel axis on "model"; batch on ("pod",
"data"); decode KV caches context-sharded (sequence dim on "model").
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from .mesh import axis_names, axis_sizes, dp_axes

# (path regex, trailing-dims spec). First match wins; matched right-to-left
# against the "/"-joined tree path.
_RULES: list[tuple[str, tuple]] = [
    # norms & scalar-ish leaves — replicated
    (r"(ln1|ln2|ln|final_norm|kv_norm|q_norm|k_norm|dt_norm|b_norm|c_norm)"
     r"(/[wb])?$", ()),
    (r"(dt_bias|conv_b|b_a|b_x|lam|D)$", ()),
    # embeddings / output heads
    (r"embed$", ("model", None)),
    (r"lm_head$", (None, "model")),
    (r"heads$", (None, "model")),
    # attention (GQA)
    (r"attn/w[qkv]$", (None, "model")),
    (r"attn/b[qkv]$", ("model",)),
    (r"attn/wo$", ("model", None)),
    # attention (MLA)
    (r"attn/w_dkv$", (None, None)),
    (r"attn/w_uk$", (None, "model", None)),
    (r"attn/w_uv$", (None, "model", None)),
    (r"attn/w_q$", (None, "model")),
    (r"attn/w_o$", ("model", None)),
    # MoE: expert-parallel stacks, replicated router
    (r"ffn/router$", (None, None)),
    (r"ffn/w[13]$", ("model", None, None)),
    (r"ffn/w2$", ("model", None, None)),
    # dense FFN / shared experts / hybrid MLP (incl. PIM-quantized forms)
    (r"w[13]/(w|w_int)$", (None, "model")),
    (r"w[13]/scales$", ("model",)),
    (r"w[13]/b$", ("model",)),
    (r"w2/(w|w_int)$", ("model", None)),
    (r"w2/scales$", ()),
    (r"w2/b$", ()),
    # mamba
    (r"mix/in_proj$", (None, "model")),
    (r"mix/conv_w$", (None, "model")),
    (r"mix/x_proj$", ("model", None)),
    (r"mix/dt_proj$", (None, "model")),
    (r"mix/A_log$", ("model", None)),
    (r"mix/out_proj$", ("model", None)),
    # attention living inside hybrid blocks (…/mix/ instead of …/attn/)
    (r"mix/w[qkv]$", (None, "model")),
    (r"mix/b[qkv]$", ("model",)),
    (r"mix/wo$", ("model", None)),
    # rg-lru
    (r"mix/w_in$", (None, "model")),
    (r"mix/w_gate_branch$", (None, "model")),
    (r"mix/w_[ax]$", (None, "model")),
    (r"mix/w_out$", ("model", None)),
    # attention inside hybrid blocks reuses attn/* names via sub paths
]


@dataclasses.dataclass
class ShardingReport:
    matched: int = 0
    fallback_replicated: list = dataclasses.field(default_factory=list)
    degraded_dims: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the reference's ``jax.sharding.NamedSharding``).
    ``spec`` is the stacked leaf's where the leaf is a list of layers."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        return int(np.prod([sizes[a] for a in axis]))
    return sizes[axis]


def spec_for(path: str, ndim: int, mesh, report: ShardingReport,
             shape=None) -> tuple:
    for pattern, trailing in _RULES:
        if re.search(pattern, path):
            report.matched += 1
            spec = [None] * (ndim - len(trailing)) + list(trailing)
            if shape is not None:
                for i, ax in enumerate(spec):
                    if ax is not None and shape[i] % _axis_size(mesh, ax):
                        report.degraded_dims.append((path, i, ax, shape[i]))
                        spec[i] = None
            return tuple(spec)
    report.fallback_replicated.append(path)
    return (None,) * ndim


def placements(spec, mesh) -> tuple:
    """DTensor placements of a spec: mesh dim ``d`` shards tensor dim ``i``
    where ``spec[i]`` names ``d`` (a tuple entry such as ``("pod",
    "data")`` shards one tensor dim over both, in mesh order, as the
    reference's ``PartitionSpec`` does), else replicates."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        axes = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {ax}: the axes must be in the "
                             f"mesh's order {names}")
        for d in dims:
            out[d] = Shard(i)
    return tuple(out)


_SP_ATTN_RE = re.compile(r"attn/(w[qkvo]|b[qkv]|w_o|w_q|w_uk|w_uv|w_dkv)$")


def _leaves(tree: dict, prefix: str = ""):
    """(path, leaf) in ``jax.tree.leaves`` order (dict keys sorted)."""
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, path + "/")
        else:
            yield path, v


def _set(tree: dict, path: str, value) -> None:
    *parents, name = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[name] = value


def leaf_shape(leaf) -> tuple:
    """A leaf's reference shape: a list of per-layer tensors is stacked
    (L, ...); a tensor or ``(shape, dtype)`` record is its own."""
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def param_shardings(cfg, mesh, model):
    """→ (shardings tree of NamedSharding, ShardingReport) for every leaf
    of ``models.param_tree(model)``, stacked leaves on their (L, ...)
    shape."""
    from ..models.transformer import param_tree
    sp_attn = bool(getattr(cfg, "sp_attn", False))
    report = ShardingReport()
    out: dict = {}
    for path, leaf in _leaves(param_tree(model)):
        shape = leaf_shape(leaf)
        if sp_attn and _SP_ATTN_RE.search(path):
            report.matched += 1
            spec = (None,) * len(shape)
        else:
            spec = spec_for(path, len(shape), mesh, report, shape=shape)
        _set(out, path, NamedSharding(mesh, spec))
    return out, report


def serving_shardings(model, p_shard: dict) -> dict:
    """The port's float32 serving buffers (not parameters of the
    reference): ``head_f32`` (V, D) takes its source's vocab sharding
    (``embed``'s, or ``lm_head``'s transposed); ``heads_f32`` takes
    ``heads``'."""
    if model.heads is not None:
        return {"heads_f32": p_shard["heads"]}
    src = p_shard["embed"] if model.lm_head is None else NamedSharding(
        p_shard["lm_head"].mesh, tuple(reversed(p_shard["lm_head"].spec)))
    return {"head_f32": src}


def _entry(axes: tuple):
    """A spec entry of mesh axes as ``PartitionSpec`` keeps it: one axis by
    its name, none as None."""
    return axes[0] if len(axes) == 1 else (axes or None)


def batch_shardings(mesh, batch_tree: dict, global_batch: int) -> dict:
    """Input batches: shard the batch dim over ("pod","data")."""
    dp = dp_axes(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if shape and shape[0] == global_batch \
                and shape[0] % _axis_size(mesh, dp) == 0:
            spec[0] = _entry(dp)
        return NamedSharding(mesh, tuple(spec))

    return _map(one, batch_tree)


def cache_shardings(mesh, cache_tree: dict, batch: int) -> dict:
    """Decode caches (stacked (L, B, ...)): batch dim on ("pod","data"),
    then the largest divisible remaining dim on "model" — for attention
    caches that is the sequence dim (context parallelism), for SSM states
    the channel dim."""
    dp = dp_axes(mesh)
    model_size = axis_sizes(mesh)["model"]
    dp_size = _axis_size(mesh, dp)

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        b_idx = next((i for i, s in enumerate(shape[:2]) if s == batch), None)
        if b_idx is not None and batch % dp_size == 0:
            spec[b_idx] = _entry(dp)
        rest = [(s, i) for i, s in enumerate(shape)
                if spec[i] is None and i != 0 and s % model_size == 0
                and s >= model_size]
        if rest:
            _, i = max(rest)
            spec[i] = "model"
        return NamedSharding(mesh, tuple(spec))

    return _map(one, cache_tree)


def opt_shardings(mesh, opt_tree: dict, param_shardings_tree: dict,
                  zero1: bool = True) -> dict:
    """Optimizer moments follow their parameter's spec; with zero1=True the
    leading (stacked-layer) dim additionally shards over "data" when
    divisible (ZeRO-1-style state partitioning). ``opt_tree`` is the
    reference's ``{"mu": tree, "nu": tree[, "residual": tree], "step"}``
    with stacked (L, ...) leaves (``train.step.init_sharded_train_state``
    keeps the moments so)."""
    flat_ps = dict(_leaves(param_shardings_tree))
    data = axis_sizes(mesh)["data"]
    out: dict = {}
    for ps, leaf in _leaves(opt_tree):
        shape = leaf_shape(leaf)
        sh = NamedSharding(mesh, ())                 # step counter etc.
        for prefix in ("mu/", "nu/", "residual/"):
            if ps.startswith(prefix):
                base = flat_ps.get(ps[len(prefix):])
                if base is None:
                    break
                spec = list(base.spec) + [None] * (len(shape)
                                                   - len(base.spec))
                if zero1 and spec and spec[0] is None and len(shape) \
                        and shape[0] % data == 0:
                    spec[0] = "data"
                sh = NamedSharding(mesh, tuple(spec))
                break
        _set(out, ps, sh)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def sharded_bytes_per_device(tree: dict, shardings: dict, mesh) -> float:
    """Analytic per-device bytes of a tree's leaves (tensors, lists of
    per-layer tensors, or anything with ``shape`` and ``dtype``) under
    their specs (the reference's ``_sharded_bytes_per_device``)."""
    flat_sh = dict(_leaves(shardings))
    total = 0.0
    for path, leaf in _leaves(tree):
        dtype = (leaf[0] if isinstance(leaf, list) else leaf).dtype
        itemsize = torch.empty((), dtype=dtype).element_size() \
            if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize
        n_shards = 1
        for ax in flat_sh[path].spec:
            n_shards *= _axis_size(mesh, ax)
        total += np.prod(leaf_shape(leaf)) * itemsize / n_shards
    return total


# ---------------------------------------------------------------------------
# Placing a model on a mesh
# ---------------------------------------------------------------------------

def _owners(model):
    """{id(tensor): (module, attribute name, is parameter)} of every
    parameter and buffer of ``model``."""
    out = {}
    for m in model.modules():
        for name, p in m._parameters.items():
            if p is not None:
                out[id(p)] = (m, name, True)
        for name, b in m._buffers.items():
            if b is not None:
                out[id(b)] = (m, name, False)
    return out


def distribute_model(model, mesh, shardings: dict,
                     serving: dict | None = None):
    """Swap ``model``'s parameters and buffers for DTensors on ``mesh``, in
    place: each leaf of ``param_tree(model)`` takes its
    :class:`NamedSharding` (a per-layer tensor the stacked spec without
    its leading entry), the float32 serving buffers ``serving``'s
    (``serving_shardings``). ``distribute_tensor`` with ``src_data_rank=
    None`` keeps each rank's slice of its own tensor: no communication (the
    random weights differ from rank to rank). Returns the model."""
    from torch.distributed.tensor import distribute_tensor
    from ..models.transformer import param_tree

    owners = _owners(model)
    flat_sh = dict(_leaves(shardings))

    def place(t, spec):
        m, name, is_param = owners[id(t)]
        dt = distribute_tensor(t.detach(), mesh, placements(spec, mesh),
                               src_data_rank=None)
        if is_param:
            m._parameters[name] = torch.nn.Parameter(
                dt, requires_grad=t.requires_grad)
        else:
            m._buffers[name] = dt

    for path, leaf in _leaves(param_tree(model)):
        spec = flat_sh[path].spec
        if isinstance(leaf, list):
            for t in leaf:
                place(t, spec[1:])
        else:
            place(leaf, spec)
    for name, sh in (serving or {}).items():
        place(getattr(model, name), sh.spec)
    model.generate_graphs.clear()
    return model
