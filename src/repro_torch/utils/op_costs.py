"""Per-op FLOPs and bytes of a PyTorch run: the port's counterpart of the
reference package's ``utils/hlo_analysis.py`` for an eager step.

The reference reads its roofline quantities off the partitioned HLO; here
the same model is applied to the ops a call dispatches, counted under a
``TorchDispatchMode`` (so it works on the ``meta`` device, where nothing
is allocated, and counts the same ops there as on the card):

* traffic: per op, operand bytes + output bytes (each op one pass over
  memory, as the reference counts each fused kernel);
* FLOPs: ``2 * M * N * K`` for a matrix product (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, and the fp32-output ``mm`` / ``bmm`` overloads),
  else 1 per output element;
* views (``expand``, ``reshape`` of a contiguous tensor, slicing,
  ``_unsafe_view``, which has no alias annotation but never copies) and
  uninitialised allocations move nothing and are not counted;
* ops that touch part of a buffer are charged what they move
  (:data:`OP_COSTS`): ``copy_`` the source read and the destination
  written; ``index`` (an embedding lookup, a gather) the indices read,
  the source read once or only its gathered elements if fewer, and the
  output written; ``index_put_`` (a KV
  cache's row write) the values and indices read and the indexed rows
  written (and read, when it accumulates), not the whole buffer;
* a hand-written kernel registered as an op is charged its own work
  (:data:`OP_COSTS`): ``repro_torch::flash_attention`` (K8) each input
  read once and the output written once, and both products over the
  unmasked pairs (:func:`flash_work`).

Collectives are not aten ops in one process; their bytes are counted where
they are issued (``distributed.StandInExchange.gathered_bytes``) or from
the sharding specs (``launch.dryrun``).
"""

from __future__ import annotations

import collections
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCounter", "MetaOpCounter", "flash_work", "OP_COSTS",
           "DOT_OPS"]

_aten = torch.ops.aten
#: allocations that write nothing, and a view that aliases
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten._unsafe_view.default}
_MM = (_aten.mm.default, _aten.addmm.default, _aten.mm.dtype)
_BMM = (_aten.bmm.default, _aten.baddbmm.default, _aten.bmm.dtype)
#: names of the ops whose FLOPs are products (the reference's dot FLOPs)
DOT_OPS = frozenset({"aten::mm", "aten::mm.dtype", "aten::addmm",
                     "aten::bmm", "aten::bmm.dtype", "aten::baddbmm",
                     "repro_torch::flash_attention"})


def _causal_pairs(s: int, t: int) -> int:
    """The (query, key) pairs a causal attention from position 0 on both
    sides keeps: ``sum(min(i + 1, t) for i in range(s))``."""
    m = min(s, t)
    return m * (m + 1) // 2 + (s - m) * t


def flash_work(b, s, t, h, hk, dh, dv, causal: bool,
               itemsize: int) -> tuple[int, int]:
    """(bytes, operations) of one K8 call on q (b, s, h, dh) and k / v (b,
    t, hk, dh | dv) of ``itemsize`` bytes: each input read once and the
    (b, s, h * dv) output written once; both products over the unmasked
    pairs."""
    nbytes = itemsize * (b * s * h * dh + b * t * hk * (dh + dv)
                         + b * s * h * dv)
    pairs = _causal_pairs(s, t) if causal else s * t
    return nbytes, 2 * b * h * pairs * (dh + dv)


def _arg(args, kwargs, i: int, name: str):
    return args[i] if len(args) > i else kwargs[name]


def _flash_cost(args, kwargs, out) -> tuple[int, int]:
    q, k, v = (_arg(args, kwargs, i, n) for i, n in enumerate("qkv"))
    b, s, h, dh = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    nbytes, ops = flash_work(b, s, t, h, hk, dh, dv,
                             bool(_arg(args, kwargs, 3, "causal")),
                             q.element_size())
    return ops, nbytes


def _copy_cost(args, kwargs, out) -> tuple[int, int]:
    dst, src = args[0], args[1]
    return dst.numel(), _bytes(src) + _bytes(dst)


def _index_put_cost(args, kwargs, out) -> tuple[int, int]:
    self, indices, values = args[0], args[1], args[2]
    accumulate = bool(_arg(args, kwargs, 3, "accumulate")) \
        if len(args) > 3 or "accumulate" in kwargs else False
    given = [i for i in indices if i is not None]
    rows = math.prod(torch.broadcast_shapes(*(i.shape for i in given)))
    # dims a None index keeps, and the trailing dims past the indices
    kept = [self.shape[d] for d, i in enumerate(indices) if i is None]
    kept += list(self.shape[len(indices):])
    written = rows * math.prod(kept)
    nbytes = (_bytes(values) + _bytes(given)
              + written * self.element_size() * (2 if accumulate else 1))
    return written, nbytes


def _index_cost(args, kwargs, out) -> tuple[int, int]:
    # the source read once, or only the gathered part of it if smaller
    read = min(_bytes(args[0]), _bytes(out))
    return out.numel(), read + _bytes(args[1]) + _bytes(out)


#: op name -> ``cost(args, kwargs, out) -> (flops, bytes)``: ops charged
#: what they move rather than their operands and outputs, and the
#: hand-written kernels registered as ops
OP_COSTS = {"aten::copy_": _copy_cost,
            "aten::index.Tensor": _index_cost,
            "aten::index_put_": _index_put_cost,
            "repro_torch::flash_attention": _flash_cost}


def _bytes(tree) -> int:
    """The bytes of the tensors in nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(_bytes(x) for x in tree.values())
    return 0


def _flops(func, args, out) -> int:
    if func in _MM or func in _BMM:
        # the two factors are the last tensor arguments (``addmm`` and
        # ``baddbmm`` take the addend first, the ``dtype`` overloads the
        # output dtype last)
        a, b = [x for x in args if isinstance(x, torch.Tensor)][-2:]
        if func in _MM:
            return 2 * a.shape[0] * a.shape[1] * b.shape[1]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return sum(x.numel() for x in outs if isinstance(x, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside ``with OpCounter() as c:``:
    ``c.flops``, ``c.traffic_bytes`` and ``c.by_op`` (op name ->
    ``[calls, flops, bytes]``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.traffic_bytes = 0
        self.by_op: dict[str, list] = collections.defaultdict(
            lambda: [0, 0, 0])

    def _call(self, func, args, kwargs):
        return func(*args, **kwargs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._call(func, args, kwargs)
        if func.is_view or func in _FREE:
            return out
        name = func.name()
        if name in OP_COSTS:
            flops, nbytes = OP_COSTS[name](args, kwargs, out)
        else:
            nbytes = _bytes((args, kwargs)) + _bytes(out)
            flops = _flops(func, args, out)
        self.flops += flops
        self.traffic_bytes += nbytes
        rec = self.by_op[name]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        return out


def _meta_key(x):
    """A hashable key of an argument's metadata: a tensor's shape, strides,
    offset, dtype and device; a number with its type (2 and 2.0 promote
    otherwise)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.storage_offset(), x.dtype,
                x.device)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_meta_key(v) for v in x))
    if isinstance(x, dict):
        return tuple((k, _meta_key(v)) for k, v in sorted(x.items()))
    return (type(x), x)


class MetaOpCounter(OpCounter):
    """:class:`OpCounter` for a run on ``meta``, counting the same ops.
    Many ``meta`` kernels are Python reference implementations that take
    hundreds of microseconds a call; an op that neither mutates nor
    aliases its inputs has outputs whose shapes, strides and dtypes follow
    from its inputs' alone, so after its first call with given input
    metadata its outputs are made empty from a cache of theirs.  A
    recurrence stepped in a Python loop repeats the same calls once per
    time step."""

    def __init__(self):
        super().__init__()
        self._outs: dict = {}

    def _call(self, func, args, kwargs):
        schema = func._schema
        if func.is_view or schema.is_mutable or any(
                r.alias_info is not None for r in schema.returns):
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
            hit = self._outs.get(key)
        except TypeError:            # an argument that does not hash
            return func(*args, **kwargs)
        if hit is not None:
            single, metas = hit
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in metas]
            return outs[0] if single else tuple(outs)
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = [out] if single else out
        if isinstance(outs, (tuple, list)) and all(
                isinstance(o, torch.Tensor) and o.device.type == "meta"
                for o in outs):
            self._outs[key] = (single, [(tuple(o.shape), o.stride(),
                                         o.dtype) for o in outs])
        return out
