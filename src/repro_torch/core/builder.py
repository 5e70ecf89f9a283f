"""Biological network builder: spec -> decomposition -> per-shard ShardGraph.

Mirrors CORTEX's build pipeline (paper Fig. 6a-c): connectome-level spec
(areas, populations, projections) -> two-level domain decomposition ->
per-device indegree sub-graph data instances.

A numpy copy of the reference package's ``core/builder.py`` that imports
the port's own ``ShardGraph`` and ``LIFParams``; it emits the same arrays
bit for bit (``tests/test_torch_build.py``).

Determinism: every projection's edge set is a pure function of the spec
(independent of the decomposition), so the SAME network is produced for any
device count - the property that makes elastic re-sharding and the
1-shard-vs-N-shard equivalence tests meaningful.  Two generator disciplines
exist behind ``NetworkSpec.connectivity``:

- ``"materialized"`` (default, the original pipeline): one sequential RNG
  stream per projection generates the FULL global edge list, which is then
  routed to owner shards.  Build time and peak host memory scale with the
  global synapse count.
- ``"procedural"`` (DESIGN.md §14): every post row's ``indegree`` sources,
  weights and delays are drawn counter-style from a Philox stream keyed by
  ``(spec.seed, projection, global_post_id)``, so any shard can generate
  exactly its owned rows without ever holding a global edge array - build
  becomes O(owned rows) per process and embarrassingly parallel.  The
  materialize-then-route pipeline is kept as the ORACLE for this mode
  (``force_materialized=True`` feeds the same per-row draws through the
  legacy routing path); tests pin that both emit bit-identical shards.

The fixed-indegree convention follows NEST's ``fixed_indegree`` rule (and the
paper's "number of incoming synaptic interactions per neuron is fixed"): each
post neuron draws exactly ``indegree`` pre partners from the source
population.  This is also what makes the indegree sub-graph load balance
reduce to post-neuron count balance (paper §III.A.4), and what makes the
procedural generator a one-row pure function.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.decomposition import (AreaSpec, Decomposition,
                                            area_process_mapping,
                                            random_equivalent_mapping)
from repro_torch.core.engine import ShardGraph
from repro_torch.core.layout import (blocked_eb, blocked_layout,
                                     blocked_layout_streamed)
from repro_torch.core.snn import LIFParams

__all__ = ["Population", "Projection", "NetworkSpec", "build_shards",
           "decompose", "shard_edge_counts", "shard_row_degrees",
           "procedural_shard_raw", "finalize_shards", "spec_to_dict",
           "spec_from_dict"]

# distinct from the materialized pipeline's per-projection salt (7919) so the
# two stream families can never collide
_ROW_SALT = 104729
# rows generated per chunk of the streaming build (bounds temp memory to
# O(row_chunk * indegree) while amortizing the per-row RNG setup)
DEFAULT_ROW_CHUNK = 4096


@dataclasses.dataclass(frozen=True)
class Population:
    """A homogeneous neuron population inside one area."""

    name: str
    area: int          # area index
    group: int         # index into NetworkSpec.groups (LIF parameter set)
    n: int
    # external Poisson drive per neuron of this population
    ext_rate_hz: float = 0.0
    ext_weight: float = 0.0


@dataclasses.dataclass(frozen=True)
class Projection:
    """Fixed-indegree connection rule between two populations."""

    src_pop: int
    dst_pop: int
    indegree: int
    weight_mean: float          # signed (current model) or magnitude (cond)
    weight_std: float = 0.0
    delay_min: int = 1          # integer steps, inclusive
    delay_max: int = 1
    channel: int = 0            # 0 excitatory, 1 inhibitory
    plastic: bool = False
    allow_autapse: bool = False
    # fraction of the source population acting as projection neurons
    # (inter-areal axons originate from a subset - this is what keeps
    # remote mirror tables small under Area-Processes Mapping)
    src_frac: float = 1.0


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    areas: Sequence[AreaSpec]
    # per-group neuron parameters - the ``neuron_model``'s parameter class
    # (snn.LIFParams for "lif", IzhikevichParams for "izhikevich", ...);
    # a "<base>+poisson" composite mixes base params with PoissonParams
    groups: Sequence[LIFParams]
    populations: Sequence[Population]
    projections: Sequence[Projection]
    max_delay: int
    seed: int = 0
    # which NeuronModel registry entry (DESIGN.md §12) interprets
    # ``groups``; threaded into EngineConfig.neuron_model by the drivers.
    # The builder itself never reads it - decomposition is model-agnostic.
    neuron_model: str = "lif"
    # edge-generator discipline (DESIGN.md §14): "materialized" keeps the
    # original one-stream-per-projection global edge list; "procedural"
    # derives each post row's edges from (seed, projection, global_post_id)
    # so shards build O(owned rows).  Part of the network's identity: the
    # two modes draw from different streams and describe different graphs.
    connectivity: str = "materialized"

    def pop_offsets(self) -> np.ndarray:
        """Global-ID offset of each population (populations must be ordered
        by area so that area ID ranges are contiguous)."""
        areas_seen = [p.area for p in self.populations]
        if areas_seen != sorted(areas_seen):
            raise ValueError("populations must be sorted by area")
        sizes = np.asarray([p.n for p in self.populations], dtype=np.int64)
        return np.concatenate([[0], np.cumsum(sizes)])

    @property
    def n_neurons(self) -> int:
        return int(sum(p.n for p in self.populations))

    def area_sizes(self) -> list[int]:
        sizes = [0] * len(self.areas)
        for p in self.populations:
            sizes[p.area] += p.n
        return sizes

    def group_of(self) -> np.ndarray:
        out = np.empty(self.n_neurons, dtype=np.int32)
        off = self.pop_offsets()
        for i, p in enumerate(self.populations):
            out[off[i]:off[i + 1]] = p.group
        return out

    def ext_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        rate = np.zeros(self.n_neurons, dtype=np.float32)
        wt = np.zeros(self.n_neurons, dtype=np.float32)
        off = self.pop_offsets()
        for i, p in enumerate(self.populations):
            rate[off[i]:off[i + 1]] = p.ext_rate_hz
            wt[off[i]:off[i + 1]] = p.ext_weight
        return rate, wt


def decompose(spec: NetworkSpec, n_devices: int, *,
              method: str = "area") -> Decomposition:
    """Two-level decomposition of the spec's neuron set."""
    if method == "area":
        # mem_per_neuron estimate = expected indegree of the area's neurons.
        sizes = spec.area_sizes()
        edges_per_area = [0.0] * len(spec.areas)
        off = spec.pop_offsets()
        for pr in spec.projections:
            dst = spec.populations[pr.dst_pop]
            edges_per_area[dst.area] += pr.indegree * dst.n
        areas = []
        for i, a in enumerate(spec.areas):
            if a.n_neurons != sizes[i]:
                raise ValueError(
                    f"area {a.name}: n_neurons={a.n_neurons} != population "
                    f"total {sizes[i]}")
            areas.append(dataclasses.replace(
                a, mem_per_neuron=max(edges_per_area[i] / max(sizes[i], 1),
                                      1.0)))
        return area_process_mapping(areas, n_devices, seed=spec.seed)
    if method == "random":
        return random_equivalent_mapping(spec.n_neurons, n_devices,
                                         seed=spec.seed)
    raise ValueError(f"unknown decomposition method {method!r}")


def _generate_projection_edges(spec: NetworkSpec, pi: int,
                               rng: np.random.Generator):
    """Full dst-major edge list of one projection: (pre_gid, post_gid, w, d)."""
    pr = spec.projections[pi]
    off = spec.pop_offsets()
    src, dst = spec.populations[pr.src_pop], spec.populations[pr.dst_pop]
    k = pr.indegree
    if k <= 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z.astype(np.float64), z.astype(np.int64)
    if not pr.allow_autapse and pr.src_pop == pr.dst_pop and k >= src.n:
        raise ValueError("indegree >= population size without autapses")

    post = np.repeat(np.arange(dst.n, dtype=np.int64), k) + off[pr.dst_pop]
    n_src = max(1, int(round(src.n * pr.src_frac)))
    pre_local = rng.integers(0, n_src, size=dst.n * k)
    if not pr.allow_autapse and pr.src_pop == pr.dst_pop:
        # resample self-connections (cheap rejection; k << n)
        self_mask = pre_local == (post - off[pr.dst_pop])
        while np.any(self_mask):
            pre_local[self_mask] = rng.integers(0, src.n,
                                                size=int(self_mask.sum()))
            self_mask = pre_local == (post - off[pr.dst_pop])
    pre = pre_local + off[pr.src_pop]
    w = rng.normal(pr.weight_mean, pr.weight_std, size=post.size)
    if pr.weight_std > 0.0:
        # keep the sign of the mean (biological weights do not flip sign)
        if pr.weight_mean >= 0:
            w = np.maximum(w, 0.0)
        else:
            w = np.minimum(w, 0.0)
    d = rng.integers(pr.delay_min, pr.delay_max + 1, size=post.size)
    if pr.delay_max > spec.max_delay:
        raise ValueError("projection delay exceeds spec.max_delay")
    return pre, post, w, d


# --- procedural per-row generator (DESIGN.md §14) ---------------------------

@dataclasses.dataclass(frozen=True)
class _ProjInfo:
    """Validated, offset-resolved view of one projection."""

    pi: int
    pr: Projection
    k: int
    src_n: int
    n_src: int        # projection-neuron subset size (src_frac)
    src_off: int
    dst_off: int
    dst_n: int
    reject: bool      # autapse rejection active


def _projection_info(spec: NetworkSpec, pi: int) -> _ProjInfo:
    pr = spec.projections[pi]
    off = spec.pop_offsets()
    src, dst = spec.populations[pr.src_pop], spec.populations[pr.dst_pop]
    k = pr.indegree
    if k > 0:
        if not pr.allow_autapse and pr.src_pop == pr.dst_pop and k >= src.n:
            raise ValueError("indegree >= population size without autapses")
        if pr.delay_max > spec.max_delay:
            raise ValueError("projection delay exceeds spec.max_delay")
    return _ProjInfo(
        pi=pi, pr=pr, k=k, src_n=src.n,
        n_src=max(1, int(round(src.n * pr.src_frac))),
        src_off=int(off[pr.src_pop]), dst_off=int(off[pr.dst_pop]),
        dst_n=dst.n,
        reject=(not pr.allow_autapse and pr.src_pop == pr.dst_pop))


def _row_rng(seed: int, pi: int, gid: int) -> np.random.Generator:
    """The counter-style per-row stream: a Philox generator keyed by
    (spec seed, projection, GLOBAL post id).  Any process can regenerate
    any row independently - the whole point of procedural connectivity."""
    return np.random.Generator(np.random.Philox(
        np.random.SeedSequence([seed, _ROW_SALT, pi, int(gid)])))


def _procedural_rows(spec: NetworkSpec, info: _ProjInfo, gids: np.ndarray):
    """Edges of one projection for a block of post rows (row-major,
    slot-minor): (pre_gid int64, w float64, d int64), each ``gids.size * k``.

    The canonical per-row draw order is the contract pinned by tests:
    sources from the src_frac subset, autapse rejection resampling (full
    population, matching the materialized rule), weights, then delays.
    """
    pr, k = info.pr, info.k
    n = gids.size * k
    pre = np.empty(n, np.int64)
    w = np.empty(n, np.float64)
    d = np.empty(n, np.int64)
    for j in range(gids.size):
        gid = int(gids[j])
        rng = _row_rng(spec.seed, info.pi, gid)
        sl = slice(j * k, j * k + k)
        p = rng.integers(0, info.n_src, size=k)
        if info.reject:
            row = gid - info.dst_off
            m = p == row
            while np.any(m):
                p[m] = rng.integers(0, info.src_n, size=int(m.sum()))
                m = p == row
        pre[sl] = p
        w[sl] = rng.normal(pr.weight_mean, pr.weight_std, size=k)
        d[sl] = rng.integers(pr.delay_min, pr.delay_max + 1, size=k)
    pre += info.src_off
    if pr.weight_std > 0.0:
        # keep the sign of the mean (biological weights do not flip sign)
        w = np.maximum(w, 0.0) if pr.weight_mean >= 0 else np.minimum(w, 0.0)
    return pre, w, d


def _generate_projection_edges_procedural(spec: NetworkSpec, pi: int,
                                          row_chunk: int = DEFAULT_ROW_CHUNK):
    """Full dst-major edge list from the per-row streams - the ORACLE for
    the shard-local build (same signature as the materialized generator)."""
    info = _projection_info(spec, pi)
    if info.k <= 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z.astype(np.float64), z.astype(np.int64)
    k = info.k
    post = np.repeat(np.arange(info.dst_n, dtype=np.int64), k) + info.dst_off
    pre = np.empty(post.size, np.int64)
    w = np.empty(post.size, np.float64)
    d = np.empty(post.size, np.int64)
    gids = np.arange(info.dst_off, info.dst_off + info.dst_n, dtype=np.int64)
    for i0 in range(0, info.dst_n, row_chunk):
        i1 = min(i0 + row_chunk, info.dst_n)
        (pre[i0 * k:i1 * k], w[i0 * k:i1 * k],
         d[i0 * k:i1 * k]) = _procedural_rows(spec, info, gids[i0:i1])
    return pre, post, w, d


def _edges_for_projection(spec: NetworkSpec, pi: int):
    """Dispatch on the spec's connectivity discipline (full edge list)."""
    if spec.connectivity == "procedural":
        return _generate_projection_edges_procedural(spec, pi)
    rng = np.random.default_rng(
        np.random.SeedSequence([spec.seed, 7919, pi]))
    return _generate_projection_edges(spec, pi, rng)


def shard_edge_counts(spec: NetworkSpec, dec: Decomposition) -> np.ndarray:
    """Analytic per-shard flat edge count - zero RNG draws.

    Fixed indegree makes this exact: ``edges(dev) = sum_pi indegree_pi *
    |owned(dev) ∩ dst_range(pi)|``.  The multihost build uses it to agree
    on the stacked E_pad without exchanging anything.
    """
    counts = np.zeros(dec.n_devices, np.int64)
    off = spec.pop_offsets()
    for pr in spec.projections:
        if pr.indegree <= 0:
            continue
        lo = int(off[pr.dst_pop])
        hi = lo + spec.populations[pr.dst_pop].n
        for dev, part in enumerate(dec.parts):
            a = np.searchsorted(part, lo)
            b = np.searchsorted(part, hi)
            counts[dev] += pr.indegree * int(b - a)
    return counts


def shard_row_degrees(spec: NetworkSpec, dec: Decomposition,
                      dev: int) -> np.ndarray:
    """Analytic per-owned-row total indegree - zero RNG draws.

    The fixed-indegree rule makes a row's edge count a pure function of
    which projection dst ranges cover its gid, so every process can compute
    EVERY shard's degree profile (and from it the shared blocked (PB, EB)
    shape) without generating a single edge - the communication-free half
    of the multihost procedural build.
    """
    owned = dec.parts[dev]
    deg = np.zeros(owned.size, np.int64)
    off = spec.pop_offsets()
    for pr in spec.projections:
        if pr.indegree <= 0:
            continue
        lo = int(off[pr.dst_pop])
        hi = lo + spec.populations[pr.dst_pop].n
        a = np.searchsorted(owned, lo)
        b = np.searchsorted(owned, hi)
        deg[a:b] += pr.indegree
    return deg


def procedural_shard_raw(spec: NetworkSpec, dec: Decomposition, dev: int, *,
                         row_chunk: int = DEFAULT_ROW_CHUNK) -> dict:
    """Shard-local O(owned rows) build of ONE device's raw edge arrays.

    Never touches another shard's rows and never materializes a global edge
    list.  Emits the same ``raw`` dict as the materialize-then-route
    pipeline, in the same canonical (delay, post) order, bit-identically -
    via two streaming passes:

    - pass A regenerates the owned rows keeping only per-(delay, row) edge
      COUNTS and the sorted set of remote pre gids (the mirror table);
    - pass B regenerates them again and scatter-writes each edge straight
      into its final slot, computed from the pass-A prefix sums - no O(E)
      lexsort, no 64-bit staging copies.
    """
    if spec.connectivity != "procedural":
        raise ValueError("procedural_shard_raw needs a spec with "
                         "connectivity='procedural'")
    owned = dec.parts[dev]
    n_loc = owned.size
    n_delay = spec.max_delay
    infos, spans = [], []
    for pi in range(len(spec.projections)):
        info = _projection_info(spec, pi)
        a = int(np.searchsorted(owned, info.dst_off))
        b = int(np.searchsorted(owned, info.dst_off + info.dst_n))
        infos.append(info)
        spans.append((a, b))

    # --- pass A: counts + mirror table -------------------------------------
    counts = np.zeros((n_delay + 1) * max(n_loc, 1), dtype=np.int64)
    remotes = np.zeros(0, np.int64)
    for info, (a, b) in zip(infos, spans):
        if info.k <= 0 or a == b:
            continue
        for i0 in range(a, b, row_chunk):
            i1 = min(i0 + row_chunk, b)
            pre, _, d = _procedural_rows(spec, info, owned[i0:i1])
            rows = np.repeat(np.arange(i0, i1, dtype=np.int64), info.k)
            key = d * n_loc + rows
            if counts.size <= 4 * key.size:
                counts += np.bincount(key, minlength=counts.size)
            else:
                np.add.at(counts, key, 1)
            rm = pre[dec.owner[pre] != dev]
            if rm.size:
                remotes = np.union1d(remotes, rm)
    mirror_gids = np.concatenate([owned, remotes])

    # final slot of each (delay, row) group = prefix sum in delay-major
    # row-minor order == the lexsort((post, delay)) the oracle applies
    cum = np.concatenate([[0], np.cumsum(counts)])
    e = int(cum[-1])
    nxt = cum[:-1].copy()        # running next-free-slot per (delay, row)
    pre_m = np.empty(e, np.int32)
    post_l = np.empty(e, np.int32)
    wf = np.empty(e, np.float32)
    df = np.empty(e, np.int32)
    chf = np.empty(e, np.int32)
    plf = np.empty(e, bool)

    # --- pass B: regenerate + place ----------------------------------------
    for info, (a, b) in zip(infos, spans):
        if info.k <= 0 or a == b:
            continue
        for i0 in range(a, b, row_chunk):
            i1 = min(i0 + row_chunk, b)
            pre, w, d = _procedural_rows(spec, info, owned[i0:i1])
            rows = np.repeat(np.arange(i0, i1, dtype=np.int64), info.k)
            key = d * n_loc + rows
            # within-chunk rank per (delay, row) group, generation order
            # preserved inside each group (matches the oracle's stable sort)
            order = np.argsort(key, kind="stable")
            ks = key[order]
            uq, first, cnt = np.unique(ks, return_index=True,
                                       return_counts=True)
            slots = np.empty(key.size, np.int64)
            slots[order] = (np.repeat(nxt[uq], cnt)
                            + np.arange(key.size, dtype=np.int64)
                            - np.repeat(first, cnt))
            nxt[uq] += cnt
            is_owned = dec.owner[pre] == dev
            pm = np.where(is_owned, np.searchsorted(owned, pre),
                          n_loc + np.searchsorted(remotes, pre))
            pre_m[slots] = pm
            post_l[slots] = rows
            wf[slots] = w
            df[slots] = d
            chf[slots] = info.pr.channel
            plf[slots] = info.pr.plastic
    return dict(owned=owned, mirror_gids=mirror_gids, pre_m=pre_m,
                post_l=post_l, w=wf, d=df, ch=chf, pl=plf)


def _route_materialized(spec: NetworkSpec, dec: Decomposition) -> list[dict]:
    """The original materialize-then-route pipeline -> per-shard raw dicts.

    For ``connectivity="procedural"`` specs this is the ORACLE: the same
    per-row draws, but assembled through the global edge array.
    """
    n_dev = dec.n_devices

    # --- generate & route edges --------------------------------------------
    per_dev = [[] for _ in range(n_dev)]  # lists of (pre, post, w, d, ch, pl)
    for pi, pr in enumerate(spec.projections):
        pre, post, w, d = _edges_for_projection(spec, pi)
        owners = dec.owner[post]
        order = np.argsort(owners, kind="stable")
        pre, post, w, d, owners = (pre[order], post[order], w[order],
                                   d[order], owners[order])
        bounds = np.searchsorted(owners, np.arange(n_dev + 1))
        for dev in range(n_dev):
            lo, hi = bounds[dev], bounds[dev + 1]
            if lo == hi:
                continue
            per_dev[dev].append((pre[lo:hi], post[lo:hi], w[lo:hi], d[lo:hi],
                                 pr.channel, pr.plastic))

    # --- assemble raw shards ------------------------------------------------
    raw = []
    for dev in range(n_dev):
        owned = dec.parts[dev]
        if per_dev[dev]:
            pre = np.concatenate([x[0] for x in per_dev[dev]])
            post = np.concatenate([x[1] for x in per_dev[dev]])
            w = np.concatenate([x[2] for x in per_dev[dev]])
            d = np.concatenate([x[3] for x in per_dev[dev]])
            ch = np.concatenate([np.full(x[0].size, x[4], np.int32)
                                 for x in per_dev[dev]])
            pl = np.concatenate([np.full(x[0].size, x[5], bool)
                                 for x in per_dev[dev]])
        else:
            pre = post = np.zeros(0, np.int64)
            w = np.zeros(0, np.float64)
            d = np.zeros(0, np.int64)
            ch = np.zeros(0, np.int32)
            pl = np.zeros(0, bool)

        # mirror table: local neurons first (identity block), then remotes.
        remote = np.setdiff1d(np.unique(pre), owned)
        mirror_gids = np.concatenate([owned, remote])
        # vectorized gid -> mirror-row lookup via sorted permutation
        perm = np.argsort(mirror_gids, kind="stable")
        sorted_gids = mirror_gids[perm]
        pre_m = perm[np.searchsorted(sorted_gids, pre)] if pre.size else \
            np.zeros(0, np.int64)
        post_l = np.searchsorted(owned, post)

        # delay-major, then post (paper Fig. 12b ordering)
        order = np.lexsort((post_l, d))
        raw.append(dict(owned=owned, mirror_gids=mirror_gids,
                        pre_m=pre_m[order], post_l=post_l[order],
                        w=w[order], d=d[order], ch=ch[order], pl=pl[order]))
    return raw


def _pad_up(n, m):
    return ((n + m - 1) // m) * m


def finalize_shards(spec: NetworkSpec, dec: Decomposition, raw: list, *,
                    pad_to_multiple: int = 8,
                    uniform_pad: bool = True,
                    with_blocked: bool = True,
                    streamed: bool = False) -> list[ShardGraph]:
    """Pad raw per-shard edge dicts into ShardGraphs (+ blocked twins).

    ``streamed`` selects :func:`repro_torch.core.layout.blocked_layout_streamed`
    (bit-identical, O(owned rows) peak) for builder-ordered shards.
    """
    group_of = spec.group_of()
    ext_rate, ext_weight = spec.ext_arrays()

    if uniform_pad:
        e_pad = max(_pad_up(max(r["pre_m"].size for r in raw), pad_to_multiple), pad_to_multiple)
        n_local_pad = max(_pad_up(max(r["owned"].size for r in raw), pad_to_multiple), pad_to_multiple)
        n_mirror_pad = max(_pad_up(max(r["mirror_gids"].size for r in raw), pad_to_multiple), pad_to_multiple)
    shards = []
    for i, r in enumerate(raw):
        e = r["pre_m"].size
        if not uniform_pad:
            e_pad = max(_pad_up(e, pad_to_multiple), pad_to_multiple)
            n_local_pad = max(_pad_up(r["owned"].size, pad_to_multiple), pad_to_multiple)
            n_mirror_pad = max(_pad_up(r["mirror_gids"].size, pad_to_multiple), pad_to_multiple)

        def pad(a, size, fill=0):
            out = np.full(size, fill, dtype=a.dtype)
            out[:a.size] = a
            return out

        d = pad(r["d"], e_pad)                 # padding delay = 0 => masked
        pre_m = pad(r["pre_m"], e_pad)
        post_l = pad(r["post_l"], e_pad)
        w = pad(r["w"], e_pad).astype(np.float32)
        ch = pad(r["ch"], e_pad)
        pl = pad(r["pl"], e_pad, fill=False)

        # bucket_ptr[d]..bucket_ptr[d+1] = edge range of delay d; padding
        # edges sit at the tail and are outside every bucket.
        bucket_ptr = np.searchsorted(d[:e], np.arange(spec.max_delay + 2))

        n_loc = r["owned"].size
        mirror_gids = r["mirror_gids"]
        msrc_shard = dec.owner[mirror_gids]
        # local index of each mirror within its source shard
        msrc_idx = np.empty(mirror_gids.size, dtype=np.int64)
        for s in np.unique(msrc_shard):
            m = msrc_shard == s
            msrc_idx[m] = np.searchsorted(dec.parts[int(s)], mirror_gids[m])
        msrc_shard = pad(msrc_shard.astype(np.int32), n_mirror_pad)
        msrc_idx = pad(msrc_idx, n_mirror_pad)

        shards.append(ShardGraph(
            n_local=n_local_pad,
            n_mirror=n_mirror_pad,
            max_delay=spec.max_delay,
            pre_idx=pre_m.astype(np.int32),
            post_idx=post_l.astype(np.int32),
            delay=d.astype(np.int32),
            channel=ch.astype(np.int32),
            plastic=pl,
            weight_init=w,
            bucket_ptr=bucket_ptr.astype(np.int64),
            mirror_src_shard=msrc_shard,
            mirror_src_idx=msrc_idx.astype(np.int32),
            group_id=pad(group_of[r["owned"]].astype(np.int32), n_local_pad),
            ext_rate=pad(ext_rate[r["owned"]], n_local_pad),
            ext_weight=pad(ext_weight[r["owned"]], n_local_pad),
            # GLOBAL neuron ids of the owned rows (-1 on padding): the
            # decomposition-invariant key for stochastic per-neuron draws
            global_id=pad(r["owned"].astype(np.int32), n_local_pad, fill=-1),
        ))
        raw[i] = None  # free the compact arrays as we go

    if with_blocked:
        # one (NB, EB) shape across shards so the shards can be stacked on a
        # leading device axis; the widest shard is found with a counts-only
        # pass so each shard converts once
        fill = blocked_layout_streamed if streamed else blocked_layout
        eb_min = max(blocked_eb(g) for g in shards) if uniform_pad else 0
        shards = [dataclasses.replace(g, blocked=fill(g, eb_min=eb_min))
                  for g in shards]
    return shards


def build_shards(spec: NetworkSpec, dec: Decomposition, *,
                 pad_to_multiple: int = 8,
                 uniform_pad: bool = True,
                 with_blocked: bool = True,
                 block_shapes=None,
                 force_materialized: bool = False,
                 row_chunk: int = DEFAULT_ROW_CHUNK) -> list[ShardGraph]:
    """Build one delay-sorted padded ShardGraph per device.

    ``spec.connectivity`` picks the pipeline: ``"materialized"`` generates
    every projection's full edge list and routes it to owner shards;
    ``"procedural"`` generates each shard's owned rows directly from the
    per-row streams - O(owned rows) peak memory, no global edge array
    (DESIGN.md §14).  ``force_materialized=True`` pushes a procedural
    spec's (identical) per-row edges through the materialized routing
    pipeline anyway - the oracle the bit-exactness tests compare against.

    With ``uniform_pad`` all shards are padded to identical (E_pad, n_mirror,
    n_local) so they can be stacked into leading-device-axis arrays.

    With ``with_blocked`` each shard also carries the post-block ELL twin of
    its flat edge arrays (``ShardGraph.blocked``) so the cuda execution
    backend is selectable without a separate conversion pass.  Shards built
    for stacking share one blocked shape: a first pass finds the widest
    per-block edge count, the second pads every shard to it.
    ``block_shapes`` other than None (the fixed defaults) raises
    ``NotImplementedError``: the reference's autotuner sizes (PB, EB)
    against TPU VMEM, and the port has no Hopper resource model yet.
    """
    if block_shapes is not None:
        raise NotImplementedError(
            "block_shapes needs an autotuner with a Hopper resource model, "
            "which the port does not have yet; build with the fixed "
            "defaults (block_shapes=None)")
    if spec.connectivity not in ("materialized", "procedural"):
        raise ValueError(
            f"unknown connectivity {spec.connectivity!r} "
            "(expected 'materialized' or 'procedural')")
    if spec.connectivity == "procedural" and not force_materialized:
        raw = [procedural_shard_raw(spec, dec, dev, row_chunk=row_chunk)
               for dev in range(dec.n_devices)]
        streamed = True
    else:
        raw = _route_materialized(spec, dec)
        streamed = False
    return finalize_shards(spec, dec, raw,
                           pad_to_multiple=pad_to_multiple,
                           uniform_pad=uniform_pad,
                           with_blocked=with_blocked,
                           streamed=streamed)


# --- spec (de)serialization: a procedural checkpoint is spec + seed + state

def spec_to_dict(spec: NetworkSpec) -> dict:
    """JSON-able dict capturing the FULL network identity.

    For procedural connectivity this (plus the engine state) IS the
    checkpoint - topology is regenerated, never stored.  Group parameter
    dataclasses are tagged with their class name; area positions (if
    explicit) are inlined as lists.
    """
    def _area(a: AreaSpec) -> dict:
        return dict(name=a.name, n_neurons=a.n_neurons,
                    positions=None if a.positions is None
                    else np.asarray(a.positions).tolist(),
                    mem_per_neuron=a.mem_per_neuron)

    def _group(g) -> dict:
        return {"__class__": type(g).__name__, **dataclasses.asdict(g)}

    return dict(
        version=1,
        areas=[_area(a) for a in spec.areas],
        groups=[_group(g) for g in spec.groups],
        populations=[dataclasses.asdict(p) for p in spec.populations],
        projections=[dataclasses.asdict(p) for p in spec.projections],
        max_delay=spec.max_delay,
        seed=spec.seed,
        neuron_model=spec.neuron_model,
        connectivity=spec.connectivity,
    )


def _resolve_param_class(name: str):
    if name == LIFParams.__name__:
        return LIFParams
    raise ValueError(f"unknown group parameter class {name!r} (the port "
                     "has the LIF model only)")


def spec_from_dict(d: dict) -> NetworkSpec:
    """Inverse of :func:`spec_to_dict`."""
    areas = tuple(AreaSpec(
        name=a["name"], n_neurons=a["n_neurons"],
        positions=None if a["positions"] is None
        else np.asarray(a["positions"], dtype=np.float64),
        mem_per_neuron=a["mem_per_neuron"]) for a in d["areas"])
    groups = tuple(
        _resolve_param_class(g["__class__"])(
            **{k: v for k, v in g.items() if k != "__class__"})
        for g in d["groups"])
    populations = tuple(Population(**p) for p in d["populations"])
    projections = tuple(Projection(**p) for p in d["projections"])
    return NetworkSpec(areas=areas, groups=groups, populations=populations,
                       projections=projections, max_delay=d["max_delay"],
                       seed=d["seed"], neuron_model=d["neuron_model"],
                       connectivity=d.get("connectivity", "materialized"))
