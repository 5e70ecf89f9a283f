"""SpikeWire codec registry: the spike-exchange wire encodings, in PyTorch.

The port of the reference package's ``core/wire.py``.  Spikes are 1-bit
events, so the exchange payload is the one stream the distributed engine
fully controls (CORTEX's Spikes Broadcast ships neuron IDs, not dense
state).  A codec owns

    encode(bits)            {0,1} bits (..., n) -> payload (..., W)
    decode(payload, n)      payload (..., W) -> bits (..., n)
    payload_struct(n)       (shape, dtype) of one payload, from n alone
    bytes_per_step(n)       payload bytes for an n-bit exchange
    saturated(payload)      per payload: 1 where a lossy wire dropped ids
    overflow_count(payload) the saturated payloads of a batch, summed

Shipped codecs: ``f32`` (naive bitmap words), ``u8`` (byte bitmap),
``packed`` (1 bit per neuron, little-endian within a byte, padded to a
multiple of 8) and ``sparse`` (a fixed-capacity ``[count, ids[K]]`` int32
payload; a step firing more than K ships the first K ids in index order and
the TRUE count in slot 0, and :meth:`SpikeWire.overflow_count` surfaces the
saturation).  ``"sparse:<rate>"`` provisions the sparse wire for that
per-step firing fraction.

Every payload has a static shape, and no codec reads a device value on the
host: the sparse encode compacts the firing ids with a ``cumsum`` and one
scatter instead of ``torch.nonzero``, whose data-dependent length would
synchronise the host every step.  Unlike the reference, ``encode`` takes
any leading batch dims too, so that one call encodes every stacked shard.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SpikeWire", "F32Wire", "U8Wire", "PackedWire", "SparseWire",
           "register_wire", "get_wire", "available_wires",
           "sparse_packed_crossover_fraction"]


class SpikeWire:
    """One spike-exchange wire encoding.

    ``encode`` consumes {0,1} bits (any dtype) with any leading batch dims;
    ``decode`` accepts any leading batch dims and returns bits in the
    requested dtype.  ``payload_struct`` must be computable from ``n``
    alone: traffic models use it without a graph.
    """

    name: str = "?"
    #: True if encoding can drop spikes when a step fires above capacity;
    #: the distributed step then accumulates ``saturated`` into telemetry
    lossy: bool = False

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, payload: torch.Tensor, n: int,
               dtype=torch.float32) -> torch.Tensor:
        raise NotImplementedError

    def payload_struct(self, n: int) -> tuple[tuple[int, ...], torch.dtype]:
        """``(shape, dtype)`` of one n-bit payload."""
        raise NotImplementedError

    def bytes_per_step(self, n: int) -> int:
        """Wire bytes for one n-bit exchange (one payload)."""
        shape, dtype = self.payload_struct(n)
        itemsize = torch.empty((), dtype=dtype).element_size()
        return int(np.prod(shape, dtype=np.int64)) * itemsize

    def saturated(self, payload: torch.Tensor) -> torch.Tensor:
        """(batch,) int32: 1 for each payload that dropped ids, else 0
        (always 0 on lossless wires)."""
        return torch.zeros(payload.shape[:-1], dtype=torch.int32,
                           device=payload.device)

    def overflow_count(self, payload: torch.Tensor) -> torch.Tensor:
        """Number of saturated payloads in a (batched) payload, a () int32
        tensor; 0 for lossless wires."""
        return self.saturated(payload).sum(dtype=torch.int32)


class F32Wire(SpikeWire):
    """Bitmap in f32 words - the naive dense baseline."""

    name = "f32"

    def encode(self, bits):
        return bits.to(torch.float32)

    def decode(self, payload, n, dtype=torch.float32):
        return payload.to(dtype)

    def payload_struct(self, n):
        return (n,), torch.float32


class U8Wire(SpikeWire):
    """Byte bitmap - 4x less traffic than f32."""

    name = "u8"

    def encode(self, bits):
        return bits.to(torch.uint8)

    def decode(self, payload, n, dtype=torch.float32):
        return payload.to(dtype)

    def payload_struct(self, n):
        return (n,), torch.uint8


class PackedWire(SpikeWire):
    """1 bit/neuron bitmap, little-endian within a byte - 32x less traffic
    than f32."""

    name = "packed"

    def encode(self, bits):
        n = bits.shape[-1]
        b = torch.nn.functional.pad(bits.to(torch.uint8), (0, (-n) % 8))
        b = b.reshape(*bits.shape[:-1], -1, 8)
        shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
        return (b << shifts).sum(dim=-1, dtype=torch.uint8)

    def decode(self, payload, n, dtype=torch.float32):
        shifts = torch.arange(8, dtype=torch.uint8, device=payload.device)
        bits = (payload[..., :, None] >> shifts) & 1
        bits = bits.reshape(*payload.shape[:-1], -1)
        return bits[..., :n].to(dtype)

    def payload_struct(self, n):
        return ((n + 7) // 8,), torch.uint8


@dataclasses.dataclass(frozen=True)
class SparseWire(SpikeWire):
    """Fixed-capacity ``[count, ids[K]]`` int32 payload - ship who fired,
    not everyone's bit.

    ``K = capacity(n)`` is provisioned from ``max_rate`` (per-step firing
    fraction headroom), floored at ``min_capacity`` and capped at ``n`` (a
    full-capacity wire is lossless).  A step firing more than K ships the
    first K ids in index order and the TRUE count in slot 0, so decode
    saturates deterministically and :meth:`saturated` exposes the event.
    Unused id slots hold the fill id ``n``, which decode drops.
    """

    max_rate: float = 0.02
    min_capacity: int = 8
    name: str = "sparse"
    lossy: bool = dataclasses.field(default=True, init=False)

    def capacity(self, n: int) -> int:
        k = max(int(np.ceil(n * self.max_rate)), self.min_capacity)
        return min(k, n)

    def encode(self, bits):
        n = bits.shape[-1]
        k = self.capacity(n)
        fired = bits != 0
        # each firing neuron's position among the firing ones; the first K
        # go to their position in a (K + 1)-buffer prefilled with the fill
        # id n, every other neuron to the dump slot K
        pos = torch.cumsum(fired, dim=-1) - 1
        slot = torch.where(fired & (pos < k), pos, k)
        ids = torch.arange(n, dtype=torch.int32, device=bits.device)
        buf = torch.full((*bits.shape[:-1], k + 1), n, dtype=torch.int32,
                         device=bits.device)
        buf.scatter_(-1, slot, ids.expand(bits.shape))
        count = fired.sum(dim=-1, dtype=torch.int32)
        return torch.cat([count[..., None], buf[..., :k]], dim=-1)

    def decode(self, payload, n, dtype=torch.float32):
        k = payload.shape[-1] - 1
        batch = payload.shape[:-1]
        count = torch.clamp(payload[..., :1], max=k)                # (..., 1)
        ids = payload[..., 1:]
        valid = ((torch.arange(k, device=payload.device) < count)
                 & (ids >= 0) & (ids < n))
        # invalid slots, the fill id among them, land in column n, dropped
        col = torch.where(valid, ids, n).long().reshape(-1, k)
        out = torch.zeros((col.shape[0], n + 1), dtype=dtype,
                          device=payload.device)
        out.scatter_(1, col, 1)
        return out[:, :n].reshape(*batch, n)

    def payload_struct(self, n):
        return (self.capacity(n) + 1,), torch.int32

    def saturated(self, payload):
        k = payload.shape[-1] - 1
        return (payload[..., 0] > k).to(torch.int32)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, SpikeWire] = {}

# parameterized variants ("sparse:<rate>") resolve through this RATE-keyed
# cache, never the public registry: available_wires() stays stable however
# many specs are resolved, and numerically-equal spellings ("sparse:0.05"
# vs "sparse:5e-2") share one instance
_SPARSE_CACHE: dict[float, SpikeWire] = {}


def register_wire(name: str, wire: SpikeWire,
                  *, overwrite: bool = False) -> SpikeWire:
    """Register a codec under a ``DistributedConfig.spike_wire`` name."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"spike wire {name!r} already registered")
    _REGISTRY[name] = wire
    return wire


def get_wire(spec) -> SpikeWire:
    """Resolve a codec: an instance passes through; a name hits the
    registry; ``"sparse:<max_rate>"`` constructs (and caches, keyed by the
    parsed rate) a sparse wire provisioned for that per-step firing
    fraction without touching the public registry."""
    if isinstance(spec, SpikeWire):
        return spec
    if spec in _REGISTRY:
        return _REGISTRY[spec]
    if isinstance(spec, str) and spec.startswith("sparse:"):
        try:
            rate = float(spec.split(":", 1)[1])
        except ValueError:
            raise ValueError(
                f"bad spike wire spec {spec!r}: expected "
                "'sparse:<max_rate>' with a float per-step firing "
                "fraction, e.g. 'sparse:0.05'") from None
        if not 0.0 <= rate <= 1.0:
            raise ValueError(
                f"bad spike wire spec {spec!r}: max_rate is a per-step "
                "firing fraction and must be in [0, 1]")
        wire = _SPARSE_CACHE.get(rate)
        if wire is None:
            wire = _SPARSE_CACHE[rate] = SparseWire(
                max_rate=rate, name=f"sparse:{rate:g}")
        return wire
    raise ValueError(f"unknown spike wire {spec!r}; available: "
                     f"{sorted(_REGISTRY)}")


def available_wires() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_wire("f32", F32Wire())
register_wire("u8", U8Wire())
register_wire("packed", PackedWire())
register_wire("sparse", SparseWire())


# --------------------------------------------------------------------------
# traffic-model helpers
# --------------------------------------------------------------------------

def sparse_packed_crossover_fraction(n: int) -> float:
    """Per-step firing fraction at which a capacity-provisioned sparse
    wire's payload bytes equal the packed bitmap's for an n-bit exchange.

    4*(K+1) = ceil(n/8)  =>  K*/n ~= 1/32 - 1/n.  Provision the sparse
    wire below this fraction and it beats packed; above it, packed wins.
    """
    packed = get_wire("packed").bytes_per_step(n)
    ids_itemsize = np.dtype(np.int32).itemsize
    return max((packed / ids_itemsize - 1.0) / n, 0.0)
