"""Logical-axis sharding rules: parameter/activation/cache -> partition spec.

Ports the reference's ``sharding/rules.py`` (and the two expert-spec
functions of its ``models/moe_manual.py``).  Its spec half holds the
rules that decide how every tensor of the LM face is laid out on a
production mesh, as pure shape logic over a
:class:`~repro_torch.launch.mesh.MeshShape`; its mesh half (below) runs
the LM face on a process mesh.

* **batch**   -> ("pod", "data")   (data parallel across pods and rows)
* **fsdp**    -> "data"            (weights fully sharded *within* a pod;
                                    replicated across pods so that the only
                                    cross-pod traffic is the once-per-step
                                    gradient all-reduce)
* **tensor**  -> "model"           (TP: heads / ffn-hidden / vocab)
* **expert**  -> "model"           (EP: MoE expert dim)

Parameters are matched by path suffix (first rule wins).  A path is the
tree's keys joined by ``/``, a dotted parameter name split at its dots,
so the port's ``layers.3.attn.wq.w`` reads ``layers/3/attn/wq/w``.  The
reference stacks each period slot's layers ``(n_periods, ...)``; the port
keeps each layer a leaf of its own, and since the rules address the
*trailing* dims (leading extra dims replicated) a layer's leaf gets the
reference's spec less its leading ``None``.

Divisibility fallback: any dim whose size does not divide the assigned mesh
axes is replicated instead (e.g. kv_heads=2 on a 16-wide "model" axis) - the
rule engine checks real shapes, so specs are always valid.

A spec is a :class:`PartitionSpec`, a tuple with one entry per leading
dim: ``None`` (replicated), a mesh axis name, or a tuple of names;
:func:`shard_shape` gives the shape one device holds.

The mesh half - :func:`use_mesh`, :func:`current_mesh`, :func:`shard_act`,
:func:`gather_params_once`, :func:`named_sharding` - runs the LM face on
a :class:`~repro_torch.launch.mesh.ProcessMesh` in the local view: each
process holds its own blocks (its batch rows, its experts) and the model
code calls the collectives of :mod:`repro_torch.sharding.collectives`
itself, where the reference leaves the placement to XLA's partitioner.
So ``shard_act`` places nothing.  The port's mesh keeps the dense
parameters whole on every process (the reference shards them FSDP over
``data`` and TP over ``model``: the same numbers, more memory; ROADMAP
Queue 1); only the expert stacks are cut, by :func:`expert_param_spec`
(:func:`local_specs`).
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Any

import torch
from torch import nn

__all__ = ["PartitionSpec", "P", "MeshCtx", "PARAM_RULES", "ACT_KINDS",
           "use_mesh", "current_mesh", "shard_act", "gather_params_once",
           "named_sharding", "NamedSharding", "local_specs",
           "param_specs", "cache_specs", "batch_spec", "act_spec",
           "expert_axes_for", "expert_param_spec", "shard_shape",
           "tree_map_with_path"]

#: the mesh contexts entered, innermost last: a module global where the
#: reference keeps a ``contextvars.ContextVar``, since the autograd
#: engine recomputes a checkpointed layer on its own device thread, which
#: sees no context variable of the thread that entered the mesh
_STACK: list = []


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s shape: one entry per leading dim,
    trailing replicated dims dropped; an entry of one axis is its name, as
    jax canonicalises it."""

    def __new__(cls, *dims):
        return super().__new__(cls, (d[0] if isinstance(d, tuple)
                                     and len(d) == 1 else d for d in dims))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# (path-regex, logical axes per dim) - first match wins; None = replicated.
# Logical names: "batch", "fsdp", "tensor", "expert", None.
PARAM_RULES: list[tuple[str, tuple[Any, ...]]] = [
    (r"embed/table$",          ("tensor", "fsdp")),
    (r"unembed/w$",            ("fsdp", "tensor")),
    (r"router/w$",             (None, None)),
    # expert tensors are expert-RESIDENT (manual EP dispatch): the expert
    # dim takes as many mesh axes as divide it, nothing else is sharded
    (r"moe/wi_gate$",          ("expert_all", None, None)),
    (r"moe/wi_up$",            ("expert_all", None, None)),
    (r"moe/wo$",               ("expert_all", None, None)),
    (r"(wq|wk|wv|wi|wi_gate|wi_up|cm_k)/w$", ("fsdp", "tensor")),
    (r"(wo|cm_v)/w$",          ("tensor", "fsdp")),
    (r"(wq|wk|wv)/b$",         ("tensor",)),
    (r"wq_a/w$",               ("fsdp", None)),
    (r"wq_b/w$",               (None, "tensor")),
    (r"wkv_a/w$",              ("fsdp", None)),
    (r"wkv_b/w$",              (None, "tensor")),
    (r"in_proj/w$",            ("fsdp", "tensor")),
    (r"out_proj/w$",           ("tensor", "fsdp")),
    (r"x_proj/w$",             ("tensor", None)),
    (r"dt_proj/w$",            (None, "tensor")),
    (r"dt_proj/b$",            ("tensor",)),
    (r"conv_w$",               (None, "tensor")),
    (r"conv_b$",               ("tensor",)),
    (r"a_log$",                ("tensor", None)),
    (r"d_skip$",               ("tensor",)),
    (r"dt_bias_init$",         ("tensor",)),
    (r"(wr|wg)/w$",            ("fsdp", "tensor")),
    (r"(decay_base|bonus_u|gn_scale|gn_bias|mix_base|cm_mix)", (None,)),
    (r"(mix_lora|decay_lora)/(a|b)/w$", (None, None)),
    (r"(norm|scale|bias)",     (None,)),
]

_COMPILED_RULES = [(re.compile(pat), logical) for pat, logical in PARAM_RULES]
_EXPERT = re.compile(r"moe/(wi_gate|wi_up|wo)$")

ACT_KINDS = {
    "btd": ("batch", None, None),
    "btv": ("batch", None, "tensor"),
    "bthd": ("batch", None, "tensor", None),
    # MoE dispatch: flat tokens (T, d) stay batch-sharded; expert buffers
    # (E, C, d) shard experts over "model" and capacity over "data"
    "td": ("batch", None),
    "ecd": ("expert", "fsdp", None),
}


class MeshCtx:
    """The logical axes of a mesh: a :class:`~repro_torch.launch.mesh.
    MeshShape` (specs only) or a ``ProcessMesh`` (a program runs on it).
    ``replicated_batch``: every process holds the whole batch (the
    reference's global batch that does not split over ``(pod, data)``,
    as at B = 1 decode) rather than its block of it."""

    def __init__(self, mesh, *, replicated_batch: bool = False):
        self.mesh = mesh
        self.replicated_batch = replicated_batch
        names = mesh.axis_names
        self.logical = {
            "batch": tuple(a for a in ("pod", "data") if a in names) or None,
            "fsdp": "data" if "data" in names else None,
            "tensor": "model" if "model" in names else None,
            "expert": "model" if "model" in names else None,
            # expert-resident EP: model-major, falls back to prefixes via
            # the divisibility logic in _resolve
            "expert_all": tuple(a for a in ("model", "data")
                                if a in names) or None,
        }

    def axis_size(self, logical) -> int:
        ax = self.logical.get(logical)
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            return math.prod(self.mesh.shape[a] for a in ax)
        return int(self.mesh.shape[ax])


def _resolve(ctx: MeshCtx, logical_dims, shape) -> P:
    """Logical dims -> mesh axes, dropping non-divisible assignments."""
    out = []
    for dim, logical in enumerate(logical_dims):
        if logical is None or dim >= len(shape):
            out.append(None)
            continue
        ax = ctx.logical.get(logical)
        if ax is None:
            out.append(None)
            continue
        size = ctx.axis_size(logical)
        if shape[dim] % size != 0:
            # try a prefix of the axis tuple, else replicate
            if isinstance(ax, tuple):
                for k in range(len(ax) - 1, 0, -1):
                    sz = math.prod(ctx.mesh.shape[a] for a in ax[:k])
                    if shape[dim] % sz == 0:
                        out.append(ax[:k])
                        break
                else:
                    out.append(None)
            else:
                out.append(None)
            continue
        out.append(ax)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


@contextlib.contextmanager
def use_mesh(mesh, *, replicated_batch: bool = False):
    """Run the LM face on ``mesh`` inside the block (a ``ProcessMesh``;
    the MoE layers take ``models.moe_manual``'s dispatch, the train step
    reduces over it).  In the local view each process's inputs are its
    own block of the global batch over ``(pod, data)``; with
    ``replicated_batch`` every process holds the same whole batch."""
    ctx = MeshCtx(mesh, replicated_batch=replicated_batch)
    _STACK.append(ctx)
    try:
        yield
    finally:
        _STACK.remove(ctx)


def current_mesh() -> MeshCtx | None:
    return _STACK[-1] if _STACK else None


def shard_act(x, kind: str):
    """The reference annotates an activation with its logical layout for
    XLA (a no-op without a mesh).  In the port's local view each process
    already holds its own block of every activation, so this returns
    ``x`` with or without a mesh; ``kind`` is checked."""
    if kind not in ACT_KINDS:
        raise KeyError(f"unknown activation kind {kind!r}")
    return x


def gather_params_once(params) -> Any:
    """fp32 leaves cast to bf16, every other leaf as it is: the copy a
    train step with ``TrainConfig.gather_once`` differentiates through
    once for all its microbatches.  The reference also drops the copy's
    FSDP sharding under a mesh (one all-gather a step); the port's mesh
    keeps dense parameters whole, so the cast is all there is, with a
    mesh or without."""
    return tree_map_with_path(
        lambda _, p: p.to(torch.bfloat16) if p.dtype == torch.float32
        else p, params)


class NamedSharding:
    """A spec on a mesh: :meth:`shard` cuts a global tensor (or numpy
    array) into this process's block, :meth:`gather` puts the blocks back
    together (a collective over each sharded dim's axes)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh.dims}, {self.spec!r})"

    def shard_shape(self, shape) -> tuple[int, ...]:
        return shard_shape(shape, self.spec, self.mesh)

    def shard(self, x):
        self.shard_shape(x.shape)           # raises if a dim does not split
        idx = []
        for i, entry in enumerate(self.spec):
            axes = _axes(entry)
            n = math.prod(self.mesh.shape[a] for a in axes)
            m = x.shape[i] // n
            k = self.mesh.axis_index(axes) if axes else 0
            idx.append(slice(k * m, (k + 1) * m))
        return x[tuple(idx)]

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        from repro_torch.sharding import collectives
        out = block
        for i, entry in enumerate(self.spec):
            axes = _axes(entry)
            if not axes:
                continue
            moved = out.movedim(i, 0).contiguous()
            parts = collectives.gather_rows(moved, self.mesh, axes)
            out = parts.reshape((-1,) + tuple(moved.shape[1:])).movedim(0, i)
        return out.contiguous()


def named_sharding(mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, spec)


_STACKED = re.compile(r"(^|/)period/\d+/")


def local_specs(mesh, tree, n_experts: int) -> Any:
    """The port's mesh layout of a parameter tree, or of an optimizer
    state keyed by parameter names: an expert stack (``moe/wi_gate``,
    ``wi_up``, ``wo``) is cut over :func:`expert_axes_for` on its expert
    dim (dim 0 of a layer's leaf, dim 1 of a stacked slot's
    ``period/{j}`` leaf, after the period), everything else is whole.
    ``tree`` holds the global shapes or the local ones; only the paths
    are read."""
    ax = expert_axes_for(mesh, n_experts) if n_experts > 0 else ()

    def one(path, _):
        if not ax or not _EXPERT.search(path):
            return P()
        lead = 1 if _STACKED.search(path) else 0
        return P(*([None] * lead), ax if len(ax) > 1 else ax[0])

    return tree_map_with_path(one, tree)


def act_spec(mesh, kind: str, shape) -> P:
    return _resolve(MeshCtx(mesh), ACT_KINDS[kind], shape)


def batch_spec(mesh) -> P:
    """Spec for (global_batch, ...) input arrays: batch over (pod, data)."""
    ctx = MeshCtx(mesh)
    ax = ctx.logical["batch"]
    return P(ax)


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (an
    ``nn.Module`` reads as its named parameters, a spec is a leaf),
    rebuilt with the same structure; ``path`` joins the keys by ``/``,
    dotted keys split."""
    if isinstance(tree, PartitionSpec):
        return fn(path, tree)
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, _join(path, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, _join(path, i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _join(path: str, key) -> str:
    key = str(key).replace(".", "/")
    return f"{path}/{key}" if path else key


def expert_axes_for(mesh, n_experts: int) -> tuple[str, ...]:
    """Model-major mesh axes owning the expert dim (must divide E).

    Ordering is significant: the same tuple keys both the parameter
    spec and the all_to_all axis, so the device flattening is consistent
    by construction.
    """
    names = mesh.axis_names
    if ("data" in names and "model" in names
            and n_experts % (mesh.shape["data"] * mesh.shape["model"]) == 0):
        return ("model", "data")
    if "model" in names and n_experts % mesh.shape["model"] == 0:
        return ("model",)
    if "data" in names and n_experts % mesh.shape["data"] == 0:
        return ("data",)
    return ()


def expert_param_spec(mesh, n_experts: int, which: str = "wi",
                      lead_dims: int = 0) -> P:
    """Spec for an expert tensor: E over the expert axes, everything else
    replicated (expert-RESIDENT weights)."""
    ax = expert_axes_for(mesh, n_experts)
    dims = [None] * (lead_dims + 3)
    if ax:
        dims[lead_dims] = ax if len(ax) > 1 else ax[0]
    while dims and dims[-1] is None:
        dims.pop()
    return P(*dims)


def param_specs(mesh, params) -> Any:
    """Tree of specs for a params (or grads/opt-state) tree.

    Leading extra dims are replicated: rules address the *trailing*
    dims."""
    ctx = MeshCtx(mesh)

    def one(pstr, leaf):
        shape = tuple(leaf.shape)
        # expert tensors: specs must match the manual EP dispatch exactly
        m_moe = _EXPERT.search(pstr)
        if m_moe and len(shape) >= 3:
            which = "wo" if m_moe.group(1) == "wo" else "wi"
            lead = len(shape) - 3
            return expert_param_spec(mesh, shape[lead], which,
                                     lead_dims=lead)
        for pat, logical in _COMPILED_RULES:
            if pat.search(pstr):
                nlead = len(shape) - len(logical)
                if nlead < 0:
                    return P()
                return _resolve(ctx, (None,) * nlead + tuple(logical), shape)
        return P()

    return tree_map_with_path(one, params)


def cache_specs(mesh, cache, *, seq_shard: bool = False) -> Any:
    """KV/state cache specs.

    Layout policy (per leaf, after stripping stacked-depth leading dims):

    * k/v ``(B, T, Hk, dh)``: batch over ("pod","data"); kv-heads over
      "model" when divisible, otherwise the SEQUENCE dim shards over "model"
      (GQA kv-head counts rarely divide a 16-wide TP axis).  With
      ``seq_shard=True`` (the batch=1 ``long_*`` cells) the sequence
      additionally shards over "data" (flash-decoding layout).
    * MLA ``c_kv/k_rope (B, T, r)``: batch over ("pod","data"), seq over
      "model" (no head dim by construction).
    * SSM / RWKV states: batch + channel/head dims over "model" if divisible.
    """
    ctx = MeshCtx(mesh)

    def seq_axes(shape, t_dim, head_dim_idx=None):
        """Pick (seq_axis, head_axis) respecting divisibility."""
        head_ax = None
        if head_dim_idx is not None:
            spec = _resolve(ctx, ("tensor",), (shape[head_dim_idx],))
            head_ax = spec[0] if len(spec) else None
        seq_ax = []
        if seq_shard and "data" in ctx.mesh.axis_names \
                and shape[t_dim] % ctx.mesh.shape["data"] == 0:
            seq_ax.append("data")
        if head_ax is None and "model" in ctx.mesh.axis_names:
            div = math.prod(ctx.mesh.shape[a] for a in seq_ax) \
                * ctx.mesh.shape["model"]
            if shape[t_dim] % div == 0:
                seq_ax.append("model")
        return (tuple(seq_ax) if seq_ax else None), head_ax

    def one(pstr, leaf):
        shape = tuple(leaf.shape)
        if re.search(r"(^|/)(k|v)$", pstr) and len(shape) >= 4:
            nlead = len(shape) - 4
            s_ax, h_ax = seq_axes(shape, nlead + 1, nlead + 2)
            dims = (None,) * nlead + ("batch", ("raw", s_ax), ("raw", h_ax),
                                      None)
        elif re.search(r"(c_kv|k_rope)$", pstr):
            nlead = len(shape) - 3
            s_ax, _ = seq_axes(shape, nlead + 1)
            dims = (None,) * nlead + ("batch", ("raw", s_ax), None)
        elif re.search(r"(^|/)h$", pstr):      # mamba ssm state
            dims = (None,) * (len(shape) - 3) + ("batch", "tensor", None)
        elif re.search(r"(^|/)s$", pstr):      # rwkv state
            dims = (None,) * (len(shape) - 4) + ("batch", "tensor", None,
                                                 None)
        elif re.search(r"conv$", pstr):
            dims = (None,) * (len(shape) - 3) + ("batch", None, "tensor")
        elif re.search(r"(x_tm|x_cm)$", pstr):
            dims = (None,) * (len(shape) - 3) + ("batch", None, None)
        else:
            dims = (None,) * (len(shape) - 1) + ("batch",)
        return _resolve_cache(ctx, dims, shape)

    return tree_map_with_path(one, cache)


def _resolve_cache(ctx: MeshCtx, dims, shape) -> P:
    out = []
    for i, d in enumerate(dims):
        if d is None:
            out.append(None)
        elif isinstance(d, tuple) and d[0] == "raw":
            out.append(d[1])  # pre-validated raw mesh axes (or None)
        elif d in ("batch", "fsdp", "tensor", "expert"):
            spec = _resolve(ctx, (d,), (shape[i],))
            out.append(spec[0] if len(spec) else None)
        else:  # raw mesh axis name
            if d in ctx.mesh.axis_names and shape[i] % ctx.mesh.shape[d] == 0:
                out.append(d)
            else:
                out.append(None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape one device holds of a ``shape`` array laid out by
    ``spec`` on ``mesh``."""
    out = list(shape)
    for i, entry in enumerate(spec):
        ways = math.prod(mesh.shape[a] for a in _axes(entry))
        if out[i] % ways:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{ways} ways ({spec})")
        out[i] //= ways
    return tuple(out)
