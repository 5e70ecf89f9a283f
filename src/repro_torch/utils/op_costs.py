"""Per-op FLOPs and bytes of a PyTorch run: the port's counterpart of the
reference package's ``utils/hlo_analysis.py`` for an eager step.

The reference reads its roofline quantities off the partitioned HLO; here
the same model is applied to the aten ops a call dispatches, counted under
a ``TorchDispatchMode`` (so it works on the ``meta`` device, where nothing
is allocated):

* traffic: per op, operand bytes + output bytes (each op one pass over
  memory, as the reference counts each fused kernel);
* FLOPs: ``2 * M * N * K`` for a matrix product (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``), else 1 per output element;
* views (``expand``, ``reshape`` of a contiguous tensor, slicing) and
  uninitialised allocations move nothing and are not counted.

Collectives are not aten ops in one process; their bytes are counted where
they are issued (``distributed.StandInExchange.gathered_bytes``).
"""

from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OpCounter"]

_aten = torch.ops.aten
#: allocations that write nothing
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default}


def _bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(x.numel() * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))


def _flops(func, args, out) -> int:
    if func in (_aten.mm.default, _aten.addmm.default):
        a, b = args[-2], args[-1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if func in (_aten.bmm.default, _aten.baddbmm.default):
        a, b = args[-2], args[-1]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    leaves, _ = tree_flatten(out)
    return sum(x.numel() for x in leaves if isinstance(x, torch.Tensor))


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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _FREE:
            return out
        nbytes = _bytes((args, kwargs)) + _bytes(out)
        flops = _flops(func, args, out)
        self.flops += flops
        self.traffic_bytes += nbytes
        rec = self.by_op[func.name()]
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        return out
