"""Port spike-wire codecs vs the reference's (``repro.core.wire``).

Each codec's encode, batched decode, ``bytes_per_step`` and
``overflow_count`` equal the reference's, bit for bit, on seeded bits of
n in {1, 7, 8, 4099} neurons at firing fractions 0, 0.01, 0.5 and 1; the
port's encode also takes a batch of payloads at once (the stacked
exchange encodes every shard in one call) and reads no value on the host.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as ref_wire
from repro_torch.core import wire

WIRES = ("f32", "u8", "packed", "sparse", "sparse:0.5", "starved")
SIZES = (1, 7, 8, 4099)
RATES = (0.0, 0.01, 0.5, 1.0)
BATCH = 3


def _pair(name):
    """The reference's and the port's codec of one name; ``starved`` is a
    sparse wire of capacity 1, which saturates on any two spikes."""
    if name == "starved":
        return (ref_wire.SparseWire(max_rate=0.0, min_capacity=1,
                                    name="starved"),
                wire.SparseWire(max_rate=0.0, min_capacity=1,
                                name="starved"))
    return ref_wire.get_wire(name), wire.get_wire(name)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", WIRES)
def test_codec_matches_reference(name, n):
    ref, port = _pair(name)
    rng = np.random.default_rng(n)
    shape, dtype = port.payload_struct(n)
    ref_sds = ref.payload_struct(n)
    assert shape == tuple(ref_sds.shape)
    assert torch.empty((), dtype=dtype).numpy().dtype == ref_sds.dtype
    assert port.bytes_per_step(n) == ref.bytes_per_step(n)
    assert port.lossy == ref.lossy
    saturated = 0
    for rate in RATES:
        bits = (rng.uniform(size=(BATCH, n)) < rate).astype(np.float32)
        want = np.stack([np.asarray(ref.encode(jnp.asarray(b)))
                         for b in bits])
        got = port.encode(torch.from_numpy(bits))      # batched encode
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
        # one payload at a time too, and bool bits encode the same
        np.testing.assert_array_equal(
            port.encode(torch.from_numpy(bits[0] > 0)).numpy(), want[0])
        dec_want = np.asarray(ref.decode(jnp.asarray(want), n))
        dec = port.decode(got, n)
        assert dec.dtype == torch.float32
        np.testing.assert_array_equal(dec.numpy(), dec_want)
        np.testing.assert_array_equal(
            port.decode(got[None], n, torch.bool).numpy()[0],
            dec_want > 0)                               # two batch dims
        ovf = port.overflow_count(got)
        assert ovf.dtype == torch.int32
        assert int(ovf) == int(ref.overflow_count(jnp.asarray(want)))
        assert port.saturated(got).shape == (BATCH,)
        saturated += int(ovf)
        if not port.lossy or port.capacity(n) >= n:
            # lossless: decode gives the bits back
            np.testing.assert_array_equal(dec.numpy(), bits)
    if name == "starved" and n > 1:
        assert saturated > 0, "a capacity-1 wire never saturated"


def test_registry_matches_reference():
    assert wire.available_wires() == ref_wire.available_wires()
    a, b = wire.get_wire("sparse:0.05"), wire.get_wire("sparse:5e-2")
    assert a is b and a.name == "sparse:0.05"
    assert a.capacity(1000) == ref_wire.get_wire("sparse:0.05").capacity(1000)
    assert wire.available_wires() == ref_wire.available_wires()
    inst = wire.SparseWire(max_rate=0.1)
    assert wire.get_wire(inst) is inst
    for bad in ("nope", "sparse:x", "sparse:1.5"):
        with pytest.raises(ValueError):
            wire.get_wire(bad)
    with pytest.raises(ValueError, match="already registered"):
        wire.register_wire("packed", wire.PackedWire())
    for n in (7, 4096, 11250):
        assert wire.sparse_packed_crossover_fraction(n) == \
            ref_wire.sparse_packed_crossover_fraction(n)


def test_sparse_encode_saturates_in_index_order():
    """A step firing above capacity ships the FIRST K ids in index order
    and the true count in slot 0; decode keeps exactly those K."""
    w = wire.SparseWire(max_rate=0.0, min_capacity=3)
    bits = torch.zeros(2, 20)
    bits[0, [2, 5, 9, 11, 19]] = 1
    bits[1, [4]] = 1
    p = w.encode(bits)
    assert p.tolist() == [[5, 2, 5, 9], [1, 4, 20, 20]]
    assert w.saturated(p).tolist() == [1, 0]
    dec = w.decode(p, 20)
    assert dec[0].nonzero().flatten().tolist() == [2, 5, 9]
    assert dec[1].nonzero().flatten().tolist() == [4]
