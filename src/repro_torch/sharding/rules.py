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
:func:`gather_params_once`, :func:`named_sharding`, :func:`local_specs`,
:func:`allocate_blocks` - runs the LM face on a
:class:`~repro_torch.launch.mesh.ProcessMesh` in the local view: each
process holds its own blocks and the model code calls the collectives of
:mod:`repro_torch.sharding.collectives` itself, where the reference
leaves their placement to XLA's partitioner.  So ``shard_act`` places
nothing.  The mesh's layout is :func:`local_specs`:

* on a ``ProcessMesh`` every model (:func:`shards_dense`: whatever its
  mixers, GQA ``attn``, ``mla``, ``mamba``, ``rwkv``, or the
  encoder-decoder's ``encdec``) holds every leaf as its block under
  :func:`param_specs`, the reference's layout: FSDP over ``data``,
  tensor parallelism over ``model`` (attention and MLA heads, the
  encoder's and decoder's attention and cross-attention heads, Mamba's
  ``d_inner`` channels, RWKV-6's heads, the MLP's hidden units, the
  vocab), the expert stacks over the expert axes;
* on a :class:`~repro_torch.launch.mesh.MeshShape`, which runs nothing,
  every dense leaf is whole and only the expert stacks are cut, by
  :func:`expert_param_spec`.

A parameter of a model built on a process mesh (:func:`allocate_blocks`)
carries its spec as the tensor attribute ``spec`` (:func:`spec_of`) and
its global shape as ``global_shape``; the model code reads them where
it uses the parameter.  So does a serving cache allocated on the mesh
(``transformer.init_cache``): each leaf is this process's
:func:`cache_blocks` block under :func:`cache_specs` (GQA's kv heads over
``model`` where they divide it, else its sequence; MLA's sequence over
``model``; with ``seq_shard``, at global batch 1, the sequence also over
``data``), and the attention reads which axes cut its sequence
(:func:`seq_cut`) and where its rows start (:func:`block_start`).
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Any, NamedTuple

import torch
from torch import nn

__all__ = ["PartitionSpec", "P", "MeshCtx", "PARAM_RULES", "ACT_KINDS",
           "use_mesh", "current_mesh", "shard_act", "gather_params_once",
           "named_sharding", "NamedSharding", "local_specs",
           "allocate_blocks", "spec_of", "global_shape", "process_mesh",
           "gather_fsdp", "shards_dense", "MIXERS", "model_blocks",
           "tp_mesh", "CacheBlock", "cache_blocks", "check_spec",
           "cache_global_batch", "seq_cut", "block_start", "check_block",
           "check_cache_blocks",
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
    once for all its microbatches.  Under a process mesh each copy's
    ``data`` (FSDP) dims are also gathered, as the reference drops them:
    one all-gather a leaf and step, whose backward is one reduce-scatter
    a leaf (:func:`gather_fsdp`); the copy carries the spec that is left
    (the ``model`` and expert cuts)."""
    def one(_, p):
        out, spec = gather_fsdp(p, torch.bfloat16 if p.dtype == torch.float32
                                else None)
        if hasattr(p, "spec"):
            out.spec, out.global_shape = spec, p.global_shape
        return out

    return tree_map_with_path(one, params)


_WHOLE = PartitionSpec()


def spec_of(t) -> P:
    """The spec a parameter of a model built on a process mesh carries;
    ``P()`` (whole) for any other tensor."""
    return getattr(t, "spec", _WHOLE)


def global_shape(t) -> tuple[int, ...]:
    """The shape of the whole leaf of which ``t`` is a block."""
    return tuple(getattr(t, "global_shape", t.shape))


def process_mesh():
    """The ``ProcessMesh`` of the innermost :func:`use_mesh`: where a
    parameter cut into blocks is used."""
    ctx = current_mesh()
    if ctx is None or not hasattr(ctx.mesh, "members"):
        raise RuntimeError("a parameter cut into blocks is used outside "
                           "rules.use_mesh of its process mesh")
    return ctx.mesh


def gather_fsdp(t, dtype=None):
    """``(t whole over data, its spec less the data cuts)``: ``t`` cast
    to ``dtype`` first (the gather moves the compute dtype's bytes), then
    each dim its spec cuts over ``data`` gathered
    (``collectives.gather_blocks``: the backward sums the cotangents over
    ``data`` into each block's owner)."""
    spec = spec_of(t)
    if dtype is not None:
        t = t.to(dtype)
    dims = [i for i, e in enumerate(spec) if e == "data"]
    if not dims:
        return t, spec
    from repro_torch.sharding import collectives
    mesh = process_mesh()
    for i in dims:
        t = collectives.gather_blocks(t, mesh, ("data",), i)
    return t, P(*(None if e == "data" else e for e in spec))


#: the layers' mixers: ``transformer.layer_kinds``' and the
#: encoder-decoder's (``encdec``, whose encoder attention, decoder
#: self-attention and cross-attention are GQA layers)
MIXERS = ("attn", "mla", "mamba", "rwkv", "encdec")


def shards_dense(mixers) -> bool:
    """The rule: a process mesh cuts a model's dense leaves by
    :func:`param_specs` whatever its layers' mixers (:data:`MIXERS`); a
    mixer this module does not know raises."""
    unknown = set(mixers) - set(MIXERS)
    if unknown:
        raise ValueError(f"no sharding rule for the mixers {unknown}")
    return True


def _tp_leaves(cfg, mixer: str):
    """A decoder mixer's leaves whose cut over ``model`` cuts its heads or
    channels: ``(path, global shape, dim)`` each, and the count of those
    heads or channels (None: GQA, whose cuts may fall inside a head).
    The ``attn`` rule also serves the encoder-decoder's encoder
    attention, decoder self-attention and cross-attention: GQA layers of
    the same shapes, whose ``wo`` the same rule cuts."""
    d = cfg.d_model
    if mixer == "attn":
        return [("attn/wo/w", (cfg.n_heads * cfg.resolved_head_dim, d),
                 0)], None
    if mixer == "mla":
        m = cfg.mla
        return [("attn/wo/w", (cfg.n_heads * m.v_head_dim, d), 0),
                ("attn/wq_b/w", (m.q_lora_rank, cfg.n_heads * (
                    m.qk_nope_dim + m.qk_rope_dim)), 1),
                ("attn/wkv_b/w", (m.kv_lora_rank, cfg.n_heads * (
                    m.qk_nope_dim + m.v_head_dim)), 1)], cfg.n_heads
    if mixer == "mamba":
        di = cfg.mamba.expand * d
        return [("mamba/conv_w", (cfg.mamba.d_conv, di), 1),
                ("mamba/in_proj/w", (d, 2 * di), 1)], di
    if mixer == "rwkv":
        return ([(f"rwkv/{n}/w", (d, d), 1) for n in ("wr", "wk", "wv", "wg")]
                + [("rwkv/wo/w", (d, d), 0)]), d // cfg.rwkv.head_dim
    raise ValueError(f"no tensor-parallel rule for the mixer {mixer!r}")


#: the ROADMAP item that keeps each mixer's unported cut inside a head
_HEAD_CUT_ITEM = {"mla": "ROADMAP Queue 1, 'Left from done items': MLA "
                         "heads not a multiple of model",
                  "mamba": "ROADMAP Queue 1, 'Left from done items': "
                           "Mamba's d_inner not a multiple of model"}


def _model_ways(cfg, mixer: str, mesh) -> int:
    """How many ways ``model`` cuts a ``mixer`` layer's leaves on a
    process ``mesh`` (1 where it cuts none); a layout that cuts some of
    them and not the others raises."""
    if "model" not in mesh.axis_names:
        return 1
    leaves, _ = _tp_leaves(cfg, mixer)
    cuts = {"model" in _axes(spec[dim]) if dim < len(spec) else False
            for spec, dim in ((_leaf_spec(mesh, path, shape), dim)
                              for path, shape, dim in leaves)}
    if len(cuts) > 1:
        raise ValueError(f"{mixer}: model cuts some of {leaves} and not "
                         "the others; such a layout is not ported")
    return mesh.shape["model"] if cuts.pop() else 1


def model_blocks(cfg, mixer: str, mesh=None) -> int:
    """How many blocks over ``model`` a ``mixer`` layer's heads (``attn``,
    ``mla``, ``rwkv``) or channels (``mamba``) are cut into on ``mesh``
    (default: the current process mesh; 1 off one, or where ``model``
    does not cut them): the one rule that a layer built on the mesh
    (:func:`tp_mesh`) and its cache (``transformer.init_cache``) both
    follow.  Where :func:`param_specs` cuts RWKV-6's leaves inside a head
    (rwkv6-3b's 40 heads on a 16-wide ``model``) it is 1: the layer runs
    every head on every process (``rwkv._time_mix_core``), as GQA's
    ``attention.head_split`` does where ``n_heads`` does not split.  A
    cut inside an MLA head, or of Mamba's ``d_inner``, is not ported and
    raises, naming the ROADMAP item that keeps it."""
    if mesh is None:
        ctx = current_mesh()
        if ctx is None or not hasattr(ctx.mesh, "members"):
            return 1
        mesh = ctx.mesh
    n = _model_ways(cfg, mixer, mesh)
    units = _tp_leaves(cfg, mixer)[1]
    if units is not None and units % n:
        if mixer == "rwkv":
            return 1
        raise ValueError(f"{mixer}: {units} heads or channels on a {n}-wide "
                         "model axis: a cut inside a head is not ported "
                         f"({_HEAD_CUT_ITEM[mixer]})")
    return n


def tp_mesh(leaf, cfg, mixer: str):
    """The process mesh whose ``model`` axis cuts the leaves of the
    ``mixer`` layer that holds ``leaf`` (its heads or channels
    :func:`model_blocks` ways, or, for RWKV-6, inside a head), else None
    (a layer built whole, or one ``model`` does not cut)."""
    if not hasattr(leaf, "spec"):
        return None
    mesh = process_mesh()
    model_blocks(cfg, mixer, mesh)
    return mesh if _model_ways(cfg, mixer, mesh) > 1 else None


class NamedSharding:
    """A spec on a mesh: :meth:`shard` cuts a global tensor (or numpy
    array) into this process's block, :meth:`gather` puts the blocks back
    together on one process (a collective over the spec's axes)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh.dims}, {self.spec!r})"

    def shard_shape(self, shape) -> tuple[int, ...]:
        return shard_shape(shape, self.spec, self.mesh)

    def _index(self, coords) -> tuple[int, ...]:
        """The block index, on each dim the spec names, of the process at
        ``coords`` (axis -> coordinate)."""
        idx = []
        for entry in self.spec:
            k = 0
            for a in _axes(entry):
                k = k * self.mesh.shape[a] + coords[a]
            idx.append(k)
        return tuple(idx)

    def shard(self, x):
        self.shard_shape(x.shape)           # raises if a dim does not split
        idx = []
        for i, k in enumerate(self._index(self.mesh.coords)):
            m = x.shape[i] // math.prod(
                self.mesh.shape[a] for a in _axes(self.spec[i]))
            idx.append(slice(k * m, (k + 1) * m))
        return x[tuple(idx)]

    def gather(self, block: torch.Tensor, root: int):
        """The whole tensor on process ``root``, from every process's
        ``block`` (one gather over the spec's axes, called by every
        process); None elsewhere.  A process whose group over those axes
        does not hold ``root`` holds copies of its blocks, and sends
        nothing."""
        from repro_torch.sharding import collectives
        axes = tuple(a for entry in self.spec for a in _axes(entry))
        if root not in self.mesh.members(axes):
            return None
        parts = collectives.gather_to(block, self.mesh, axes, root)
        if parts is None:
            return None
        shape = [n * math.prod(self.mesh.shape[a] for a in _axes(e))
                 for n, e in zip(block.shape, self.spec)]
        out = block.new_empty(shape + list(block.shape[len(self.spec):]))
        mine = dict(self.mesh.coords)
        for k, part in enumerate(parts):
            coords = dict(mine)
            for a in reversed(axes):
                k, coords[a] = divmod(k, self.mesh.shape[a])
            out[tuple(slice(i * n, (i + 1) * n) for i, n in zip(
                self._index(coords), block.shape))] = part
        return out


def named_sharding(mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, spec)


#: a stacked slot's name in an optimizer state: a decoder's period slot
#: (``period/{j}/<leaf>``, ``DecoderLM.period_slots``) or one of the
#: encoder-decoder's two stacks (``encoder/<leaf>``, ``decoder/<leaf>``,
#: ``EncDecLM.period_slots``; its layers' own leaves are
#: ``encoder/{i}/<leaf>``), the reference's stacked leaves
_STACKED = re.compile(r"(^|/)(period/\d+|encoder|decoder)/(?!\d+/)")


#: the optimizer state's parts keyed by parameter name
_STATE_PARTS = ("m", "v", "master", "v_row", "v_col")


def _state_name(path: str) -> tuple[str, str]:
    """``(state part or "", parameter name)`` of a leaf's path in a
    parameter tree, an optimizer state, or a ``(params, state)`` pair."""
    parts = path.split("/")
    if parts and parts[0].isdigit():
        parts = parts[1:]
    if parts and parts[0] in _STATE_PARTS:
        return parts[0], "/".join(parts[1:])
    return "", "/".join(parts)


def local_specs(mesh, tree, n_experts: int) -> Any:
    """The mesh's layout of a parameter tree, of an optimizer state keyed
    by parameter names, or of a ``(params, state)`` pair (module
    docstring):

    * an expert stack (``moe/wi_gate``, ``wi_up``, ``wo``; every state
      leaf of it) is cut over :func:`expert_axes_for` on its expert dim
      (dim 0 of a layer's leaf, dim 1 of a stacked slot's ``period/{j}``
      leaf, after the period);
    * on a ``ProcessMesh`` (:func:`shards_dense`) every other leaf
      has its parameter's :func:`param_specs` spec, save Adafactor's
      factored moments (``v_col``, and ``v_row`` of a leaf of two dims or
      more, or of a stacked slot: ``period/{j}/``, or the
      encoder-decoder's ``encoder/`` and ``decoder/``), which every
      process holds whole;
    * else every other leaf is whole.

    A parameter's spec is the one its tensor carries (a model built on
    the mesh, whose leaves are blocks; the state's leaves are then found
    by name), or else the rule's on its own shape (a tree of global
    leaves)."""
    ax = expert_axes_for(mesh, n_experts) if n_experts > 0 else ()
    carried = {}

    def scan(path, leaf):
        part, name = _state_name(path)
        if not part and hasattr(leaf, "spec"):
            carried[name] = (leaf.spec, leaf.dim())

    tree_map_with_path(scan, tree)
    sharded = hasattr(mesh, "members")

    def one(path, leaf):
        if ax and _EXPERT.search(path):
            lead = 1 if _STACKED.search(path) else 0
            return P(*([None] * lead), ax if len(ax) > 1 else ax[0])
        if not sharded:
            return P()
        part, name = _state_name(path)
        if part == "v_col" or (part == "v_row" and _STACKED.search(path)):
            return P()
        if name in carried:
            spec, ndim = carried[name]
        elif carried:
            raise KeyError(f"{path}: no parameter {name!r} in the tree")
        else:
            spec = _leaf_spec(mesh, name, tuple(leaf.shape))
            ndim = _rule_dims(name, leaf.dim())
        if part == "v_row" and leaf.dim() < ndim:
            return P()
        return spec

    return tree_map_with_path(one, tree)


def allocate_blocks(module: nn.Module, mesh, device, n_experts: int) -> None:
    """Allocate (uninitialised, on ``device``) each parameter of
    ``module``, built on ``meta`` at the global shapes, as this process's
    block under :func:`local_specs`; each carries its ``spec`` and
    ``global_shape``."""
    specs = local_specs(mesh, dict(module.named_parameters()), n_experts)
    for mod_name, mod in module.named_modules():
        for key, p in list(mod._parameters.items()):
            if p is None:
                continue
            spec = specs[f"{mod_name}.{key}" if mod_name else key]
            block = nn.Parameter(torch.empty(
                shard_shape(p.shape, spec, mesh), dtype=p.dtype,
                device=device), requires_grad=False)
            block.spec, block.global_shape = spec, tuple(p.shape)
            mod._parameters[key] = block


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
    return tree_map_with_path(
        lambda pstr, leaf: _leaf_spec(mesh, pstr, tuple(leaf.shape)), params)


def _leaf_spec(mesh, pstr: str, shape) -> P:
    """The spec of the leaf at path ``pstr`` of global ``shape``."""
    # expert tensors: specs must match the manual EP dispatch exactly
    m_moe = _EXPERT.search(pstr)
    if m_moe and len(shape) >= 3:
        which = "wo" if m_moe.group(1) == "wo" else "wi"
        lead = len(shape) - 3
        return expert_param_spec(mesh, shape[lead], which, lead_dims=lead)
    for pat, logical in _COMPILED_RULES:
        if pat.search(pstr):
            nlead = len(shape) - len(logical)
            if nlead < 0:
                return P()
            return _resolve(MeshCtx(mesh), (None,) * nlead + tuple(logical),
                            shape)
    return P()


def _rule_dims(pstr: str, default: int) -> int:
    """The dims of the first rule that matches ``pstr`` (a parameter's
    own; a factored moment has fewer)."""
    for pat, logical in _COMPILED_RULES:
        if pat.search(pstr):
            return len(logical)
    return default


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


class CacheBlock(NamedTuple):
    """One process's block of a cache leaf under :func:`cache_specs`: the
    spec, the block's shape, and its first global index on each dim."""
    spec: PartitionSpec
    shape: tuple[int, ...]
    start: tuple[int, ...]


def check_spec(spec) -> None:
    """Raise where ``spec`` maps a mesh axis more than once, as JAX
    refuses such a spec (``DuplicateSpecError``): the reference's
    ``cache_specs`` gives one at global batch 1 on a mesh whose ``data``
    is 1 wide (batch and sequence both over ``data``)."""
    seen = [a for entry in spec for a in _axes(entry)]
    dup = sorted({a for a in seen if seen.count(a) > 1})
    if dup:
        raise ValueError(f"{spec!r} maps the mesh axis {dup[0]!r} more than "
                         "once: no layout, as JAX refuses such a spec")


def cache_blocks(mesh, cache, *, seq_shard: bool = False) -> Any:
    """The :class:`CacheBlock` of every leaf of ``cache`` (a tree of
    global leaves; on ``meta`` will do) that this process of ``mesh``
    holds under :func:`cache_specs`; on a :class:`~repro_torch.launch.
    mesh.MeshShape`, which runs nothing, device 0's.  A spec that maps an
    axis twice, or a dim that does not split, raises."""
    specs = {}
    tree_map_with_path(lambda path, sp: specs.__setitem__(path, sp),
                       cache_specs(mesh, cache, seq_shard=seq_shard))
    coords = getattr(mesh, "coords", None)

    def one(path, leaf):
        spec = specs[path]
        check_spec(spec)
        shape = shard_shape(tuple(leaf.shape), spec, mesh)
        idx = (NamedSharding(mesh, spec)._index(coords) if coords
               else (0,) * len(spec))
        start = tuple(i * n for i, n in zip(idx, shape)) \
            + (0,) * (len(shape) - len(spec))
        return CacheBlock(spec, shape, start)

    return tree_map_with_path(one, cache)


def cache_global_batch(batch: int) -> int:
    """The global batch of ``batch`` rows a process serves: on the
    process mesh of the innermost :func:`use_mesh` its block's rows times
    the batch axes' size, or ``batch`` itself with ``replicated_batch``
    (every process the whole batch) or off a process mesh.  The cache's
    ``seq_shard`` is this being 1, as the reference's dry run sets it."""
    ctx = current_mesh()
    if ctx is None or not hasattr(ctx.mesh, "members") \
            or ctx.replicated_batch:
        return batch
    return batch * ctx.axis_size("batch")


def seq_cut(t) -> tuple[str, ...]:
    """The mesh axes that cut the sequence (dim 1) of a cache leaf
    carrying its spec: ``()``, ``("model",)``, ``("data",)`` or
    ``("data", "model")``."""
    spec = spec_of(t)
    return _axes(spec[1]) if len(spec) > 1 else ()


def block_start(t, dim: int) -> int:
    """The first global index on ``dim`` of the block ``t`` (a cache leaf
    carrying its spec; 0 for a whole one) of the current process mesh."""
    spec = spec_of(t)
    if dim >= len(spec) or spec[dim] is None:
        return 0
    return process_mesh().axis_index(_axes(spec[dim])) * t.shape[dim]


def check_block(t, name: str) -> None:
    """Raise unless ``t`` (a leaf carrying its spec) is the block of its
    global shape that its spec gives a process of the current mesh."""
    want = shard_shape(global_shape(t), t.spec, process_mesh())
    if tuple(t.shape) != want:
        raise ValueError(f"{name}: the {tuple(t.shape)} block is not the "
                         f"{want} block its spec {t.spec!r} gives")


def check_cache_blocks(cache, batch: int) -> None:
    """Raise, with the reason, unless every leaf of ``cache`` is laid out
    as :func:`cache_blocks` lays it out for a global batch of
    :func:`cache_global_batch` (``batch``) rows: on a process mesh each
    leaf carries its spec and is its block, off one no leaf carries a
    spec."""
    leaves = {}
    tree_map_with_path(lambda path, t: leaves.__setitem__(path, t), cache)
    ctx = current_mesh()
    if ctx is None or not hasattr(ctx.mesh, "members"):
        for path, t in leaves.items():
            if spec_of(t) != _WHOLE:
                raise ValueError(f"cache leaf {path} is a block ({spec_of(t)!r}"
                                 ") of a process mesh, used off the mesh")
        return
    gb = cache_global_batch(batch)
    for path, t in leaves.items():
        if not hasattr(t, "spec"):
            raise ValueError(
                f"cache leaf {path} {tuple(t.shape)} carries no layout: a "
                "process mesh serves a cache built by init_cache inside "
                "rules.use_mesh of that mesh")
        if global_shape(t)[0] != gb:
            raise ValueError(f"cache leaf {path} was built for a global batch"
                             f" of {global_shape(t)[0]}, the mesh serves {gb}")
    whole = {p: torch.empty(global_shape(t), dtype=t.dtype, device="meta")
             for p, t in leaves.items()}
    want = cache_blocks(ctx.mesh, whole, seq_shard=gb == 1)
    for path, t in leaves.items():
        if spec_of(t) != want[path].spec:
            raise ValueError(
                f"cache leaf {path} is laid out by {spec_of(t)!r}; "
                f"cache_specs gives {want[path].spec!r} at global batch {gb}")
        check_block(t, f"cache leaf {path}")


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
