"""Post-block ELL edge layout - the backend-portable form of a shard graph.

``ShardGraph`` stores edges flat and owner-sorted by (delay, post); that is
the natural input for the ``index_add_`` sweep of the flat backend.  The
CUDA kernel path instead wants the Fig. 12 "data instance" shape: edges
re-sorted by (post_block, delay, post) and padded so every post-neuron block
owns the same edge count (ELL-of-blocks) - the rows ``[i*PB, (i+1)*PB)``
of block ``i`` own exactly that block's slots, so race-freedom is
structural (DESIGN.md §2/§9).

This module is build-time numpy, a copy of the reference package's
``core/layout.py``.  ``BlockedGraph`` carries, besides the blocked static
edge arrays, ``edge_perm``: for every (block, slot) the index of that edge
in the FLAT owner-sorted arrays.  The blocked layout is the RESIDENT
hot-path representation for blocked backends (DESIGN.md §9): run-time
weights live in ELL slot order inside engine state and ``edge_perm`` is
used only at the build / checkpoint / telemetry boundaries
(``repro_torch.core.backends.to_native_weights`` / ``to_flat_weights``),
never per step.

Block shapes (PB, EB) are the fixed constants below.

The fill is a single vectorized scatter (no per-block Python loop): edges
are lexsorted by (block, delay, post), their within-block rank is computed
from the cumulative block counts, and one fancy-index assignment places
every field into its (NB, EB) slot.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["BlockedGraph", "blocked_layout", "blocked_layout_streamed",
           "blocked_eb", "DEFAULT_PB", "DEFAULT_EB_MULTIPLE"]

DEFAULT_PB = 256          # post neurons per block (grid-cell ownership range)
DEFAULT_EB_MULTIPLE = 128  # pad per-block edge count to a lane multiple


@dataclasses.dataclass(frozen=True)
class BlockedGraph:
    """Post-block ELL edge layout; all edge arrays (NB, EB).

    Arrays are numpy at build time; the distributed engine re-materializes
    the same structure around shard_map-traced arrays (the static ints stay
    host-side either way).  ``delay == 0`` marks padding slots everywhere.
    """

    nb: int               # number of post blocks
    eb: int               # edges per block (padded)
    pb: int               # post neurons per block
    n_local: int          # nb * pb (>= ShardGraph.n_local)
    pre_idx: Any          # (NB, EB) int32 mirror index
    post_rel: Any         # (NB, EB) int32 within-block row, [0, PB)
    delay: Any            # (NB, EB) int32; 0 marks padding
    channel: Any          # (NB, EB) int32: 0 ex, 1 in
    weight: Any = None    # (NB, EB) f32 initial weights (build-time only)
    plastic: Any = None   # (NB, EB) bool
    edge_perm: Any = None  # (NB, EB) int32 -> flat edge index (0 on padding)

    def flat(self, name: str) -> np.ndarray:
        """Flat (NB*EB,) view of a field, same slot order."""
        return np.asarray(getattr(self, name)).reshape(-1)


def blocked_eb(g, *, pb: int = DEFAULT_PB,
               eb_multiple: int = DEFAULT_EB_MULTIPLE) -> int:
    """Padded per-block edge count a shard needs, WITHOUT building the
    layout - a counts-only pass so multi-shard builds can find the widest
    shard first and convert each shard exactly once (``eb_min``)."""
    post = np.asarray(g.post_idx)
    d = np.asarray(g.delay)
    nb = max(-(-int(g.n_local) // pb), 1)
    counts = np.bincount(post[d > 0] // pb, minlength=nb)
    eb = int(max(counts.max() if counts.size else 1, 1))
    return ((eb + eb_multiple - 1) // eb_multiple) * eb_multiple


def blocked_layout(g, *, pb: int = DEFAULT_PB,
                   eb_multiple: int = DEFAULT_EB_MULTIPLE,
                   eb_min: int = 0) -> BlockedGraph:
    """Convert a :class:`repro_torch.core.engine.ShardGraph` to the blocked layout.

    ``eb_min`` forces a minimum padded edge count per block so shards built
    separately can share one (NB, EB) shape for device-axis stacking.
    """
    pre = np.asarray(g.pre_idx)
    post = np.asarray(g.post_idx)
    w = np.asarray(g.weight_init)
    d = np.asarray(g.delay)
    ch = np.asarray(g.channel)
    pl_ = np.asarray(g.plastic)

    real = np.nonzero(d > 0)[0]           # flat indices of non-padding edges
    nb = max(-(-int(g.n_local) // pb), 1)
    block = post[real] // pb
    # (post_block, delay, post) order; `order` holds FLAT edge indices
    order = real[np.lexsort((post[real], d[real], block))]
    rows = post[order] // pb

    counts = np.bincount(rows, minlength=nb)
    eb = int(max(counts.max() if counts.size else 1, 1, eb_min))
    eb = ((eb + eb_multiple - 1) // eb_multiple) * eb_multiple

    # within-block rank of every sorted edge; rows is nondecreasing, so the
    # rank is position minus the block's start - one subtract, no loop.
    starts = np.concatenate([[0], np.cumsum(counts)])
    cols = np.arange(order.size, dtype=np.int64) - starts[rows]

    def scatter(vals, dtype, fill=0):
        out = np.full((nb, eb), fill, dtype=dtype)
        out[rows, cols] = vals
        return out

    return BlockedGraph(
        nb=nb, eb=eb, pb=pb, n_local=nb * pb,
        pre_idx=scatter(pre[order], np.int32),
        post_rel=scatter(post[order] % pb, np.int32),
        delay=scatter(d[order], np.int32),
        channel=scatter(ch[order], np.int32),
        weight=scatter(w[order], np.float32),
        plastic=scatter(pl_[order], bool, fill=False),
        edge_perm=scatter(order, np.int32),
    )


def blocked_layout_streamed(g, *, pb: int = DEFAULT_PB,
                            eb_multiple: int = DEFAULT_EB_MULTIPLE,
                            eb_min: int = 0,
                            chunk_blocks: int = 512) -> BlockedGraph:
    """Row-streamed blocked fill for shards already in canonical flat order.

    :func:`blocked_layout` lexsorts the whole edge set, which allocates
    several O(E) int64 temporaries - fine for the materialized oracle, but
    it defeats the procedural build's purpose of keeping peak RSS at
    O(owned rows).  A builder-produced ShardGraph is already sorted by
    (delay, post) with ``bucket_ptr`` delimiting the delay buckets, so
    inside each bucket every post block's edges form one CONTIGUOUS run
    locatable by binary search.  A block's (block, delay, post) order is
    then just the concatenation of its per-delay runs, and the fill can
    stream ``chunk_blocks`` blocks at a time into the preallocated
    (NB, EB) arrays.  Output is bit-identical to :func:`blocked_layout`
    (pinned by tests); only the peak memory differs.
    """
    post = np.asarray(g.post_idx)
    d = np.asarray(g.delay)
    bp = np.asarray(g.bucket_ptr)
    nb = max(-(-int(g.n_local) // pb), 1)
    n_delay = int(g.max_delay)

    # per-(delay, block) segment bounds inside the flat arrays; D*(NB+1)
    # int64 - O(owned rows), not O(edges)
    block_edges = np.arange(nb + 1, dtype=np.int64) * pb
    bounds = np.empty((n_delay, nb + 1), dtype=np.int64)
    for di in range(n_delay):
        lo, hi = int(bp[di + 1]), int(bp[di + 2])
        bounds[di] = lo + np.searchsorted(post[lo:hi], block_edges)
    seg_len = bounds[:, 1:] - bounds[:, :-1]         # (D, NB)
    counts = seg_len.sum(axis=0)                     # edges per block
    eb = int(max(counts.max() if counts.size else 1, 1, eb_min))
    eb = ((eb + eb_multiple - 1) // eb_multiple) * eb_multiple
    # column offset of each delay's run within its block row
    col0 = np.concatenate([np.zeros((1, nb), np.int64),
                           np.cumsum(seg_len, axis=0)])[:-1]

    out = BlockedGraph(
        nb=nb, eb=eb, pb=pb, n_local=nb * pb,
        pre_idx=np.zeros((nb, eb), np.int32),
        post_rel=np.zeros((nb, eb), np.int32),
        delay=np.zeros((nb, eb), np.int32),
        channel=np.zeros((nb, eb), np.int32),
        weight=np.zeros((nb, eb), np.float32),
        plastic=np.full((nb, eb), False, bool),
        edge_perm=np.zeros((nb, eb), np.int32),
    )
    pre = np.asarray(g.pre_idx)
    w = np.asarray(g.weight_init)
    ch = np.asarray(g.channel)
    pl_ = np.asarray(g.plastic)

    for b0 in range(0, nb, chunk_blocks):
        b1 = min(b0 + chunk_blocks, nb)
        ls = seg_len[:, b0:b1].ravel()               # (D * cb,) d-major
        tot = int(ls.sum())
        if tot == 0:
            continue
        starts = bounds[:, b0:b1].ravel()            # flat src start per seg
        seg_first = np.concatenate([[0], np.cumsum(ls)[:-1]])
        within = np.arange(tot, dtype=np.int64) - np.repeat(seg_first, ls)
        src = np.repeat(starts, ls) + within
        rows = np.repeat(np.tile(np.arange(b0, b1, dtype=np.int64),
                                 n_delay), ls)
        cols = np.repeat(col0[:, b0:b1].ravel(), ls) + within
        out.pre_idx[rows, cols] = pre[src]
        out.post_rel[rows, cols] = post[src] - rows * pb
        out.delay[rows, cols] = d[src]
        out.channel[rows, cols] = ch[src]
        out.weight[rows, cols] = w[src]
        out.plastic[rows, cols] = pl_[src]
        out.edge_perm[rows, cols] = src
    return out
