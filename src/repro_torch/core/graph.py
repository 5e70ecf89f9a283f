"""Directed-graph and indegree/outdegree sub-graph algebra (paper eqs. 4-16).

This module is the build-time (numpy) formalization of CORTEX's graph
abstraction of spiking neural networks.  Vertices are neurons, directed edges
are synapses (pre -> post).  The two sub-graph *formats* of a graph G are

    inS(V~)  = (inV~pre,  V~,        inE~)   edges whose POST vertex is in V~
    outS(V~) = (V~,       outV~post, outE~)  edges whose PRE  vertex is in V~

together with meet / join operations and the homomorphism

    *S(Va) (*) *S(Vb) = *S(Va (.) Vb)        (eq. 8)

which is what lets CORTEX transfer graph decomposition to a plain partition of
the vertex set.  The decisive property (eq. 14) is that the meet of two
indegree sub-graphs on disjoint vertex sets has EMPTY post-vertex and edge
sets - i.e. synaptic writes are conflict-free across partitions - whereas the
outdegree meet (eq. 15) shares post vertices and would require synchronization.

Everything here is exact and deliberately simple: it exists so the rest of the
system (decomposition, shard builders, ownership checks, property tests) can
be expressed - and verified - in the paper's own algebra.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Tuple

import numpy as np

__all__ = [
    "DirectedGraph",
    "SubGraph",
    "indegree_subgraph",
    "outdegree_subgraph",
    "meet",
    "join",
    "partition_vertices",
    "ownership_conflicts",
]


def _as_edge_array(edges: np.ndarray | Sequence[Tuple[int, int]]) -> np.ndarray:
    e = np.asarray(edges, dtype=np.int64)
    if e.size == 0:
        return e.reshape(0, 2)
    if e.ndim != 2 or e.shape[1] != 2:
        raise ValueError(f"edges must be (E, 2) int array, got {e.shape}")
    return e


def _canonical(e: np.ndarray) -> np.ndarray:
    """Sort edges lexicographically by (pre, post) and drop duplicates."""
    if e.shape[0] == 0:
        return e
    order = np.lexsort((e[:, 1], e[:, 0]))
    e = e[order]
    keep = np.ones(e.shape[0], dtype=bool)
    keep[1:] = np.any(e[1:] != e[:-1], axis=1)
    return e[keep]


@dataclasses.dataclass(frozen=True)
class DirectedGraph:
    """G = (V, E): V = {0..n_vertices-1}, E as an (E, 2) array of (pre, post)."""

    n_vertices: int
    edges: np.ndarray  # (E, 2) int64, canonical order

    @staticmethod
    def from_edges(n_vertices: int, edges) -> "DirectedGraph":
        e = _canonical(_as_edge_array(edges))
        if e.shape[0] and (e.min() < 0 or e.max() >= n_vertices):
            raise ValueError("edge endpoint out of range")
        return DirectedGraph(n_vertices=n_vertices, edges=e)

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    def indegree(self) -> np.ndarray:
        deg = np.zeros(self.n_vertices, dtype=np.int64)
        np.add.at(deg, self.edges[:, 1], 1)
        return deg

    def outdegree(self) -> np.ndarray:
        deg = np.zeros(self.n_vertices, dtype=np.int64)
        np.add.at(deg, self.edges[:, 0], 1)
        return deg


@dataclasses.dataclass(frozen=True)
class SubGraph:
    """A triplet *S = (*Vpre, *Vpost, *E) in indegree or outdegree format."""

    pre_vertices: np.ndarray   # sorted unique int64
    post_vertices: np.ndarray  # sorted unique int64
    edges: np.ndarray          # (E, 2) canonical

    @staticmethod
    def make(pre, post, edges) -> "SubGraph":
        return SubGraph(
            pre_vertices=np.unique(np.asarray(pre, dtype=np.int64)),
            post_vertices=np.unique(np.asarray(post, dtype=np.int64)),
            edges=_canonical(_as_edge_array(edges)),
        )

    def __eq__(self, other: object) -> bool:  # value equality for tests
        if not isinstance(other, SubGraph):
            return NotImplemented
        return (
            np.array_equal(self.pre_vertices, other.pre_vertices)
            and np.array_equal(self.post_vertices, other.post_vertices)
            and np.array_equal(self.edges, other.edges)
        )

    @property
    def is_empty(self) -> bool:
        return (
            self.pre_vertices.size == 0
            and self.post_vertices.size == 0
            and self.edges.shape[0] == 0
        )


def indegree_subgraph(g: DirectedGraph, vertices) -> SubGraph:
    """inS(V~) = (inV~pre, V~, inE~): edges whose post endpoint is in V~ (eq. 5)."""
    v = np.unique(np.asarray(vertices, dtype=np.int64))
    mask = np.isin(g.edges[:, 1], v)
    e = g.edges[mask]
    return SubGraph(pre_vertices=np.unique(e[:, 0]), post_vertices=v, edges=e)


def outdegree_subgraph(g: DirectedGraph, vertices) -> SubGraph:
    """outS(V~) = (V~, outV~post, outE~): edges whose pre endpoint is in V~ (eq. 6)."""
    v = np.unique(np.asarray(vertices, dtype=np.int64))
    mask = np.isin(g.edges[:, 0], v)
    e = g.edges[mask]
    return SubGraph(pre_vertices=v, post_vertices=np.unique(e[:, 1]), edges=e)


def _edge_intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if a.shape[0] == 0 or b.shape[0] == 0:
        return a[:0]
    av = a[:, 0] * (1 << 32) + a[:, 1]
    bv = b[:, 0] * (1 << 32) + b[:, 1]
    keep = np.isin(av, bv)
    return a[keep]


def meet(a: SubGraph, b: SubGraph) -> SubGraph:
    """*Sa /\\ *Sb: component-wise intersection (eq. 7 with (meet, cap))."""
    return SubGraph(
        pre_vertices=np.intersect1d(a.pre_vertices, b.pre_vertices),
        post_vertices=np.intersect1d(a.post_vertices, b.post_vertices),
        edges=_edge_intersect(a.edges, b.edges),
    )


def join(a: SubGraph, b: SubGraph) -> SubGraph:
    """*Sa \\/ *Sb: component-wise union (eq. 7 with (join, cup))."""
    return SubGraph(
        pre_vertices=np.union1d(a.pre_vertices, b.pre_vertices),
        post_vertices=np.union1d(a.post_vertices, b.post_vertices),
        edges=_canonical(np.concatenate([a.edges, b.edges], axis=0)),
    )


def partition_vertices(n_vertices: int, n_parts: int,
                       sizes: Iterable[int] | None = None) -> list[np.ndarray]:
    """A well-partition {V_1..V_n} of V (eq. 9): disjoint, covering, contiguous.

    If ``sizes`` is given it must sum to ``n_vertices``; otherwise the split is
    as even as possible.  Contiguity is a convention, not a requirement of the
    algebra - callers that decompose spatially re-index first.
    """
    if sizes is None:
        base, rem = divmod(n_vertices, n_parts)
        sizes = [base + (1 if i < rem else 0) for i in range(n_parts)]
    sizes = list(sizes)
    if sum(sizes) != n_vertices:
        raise ValueError("partition sizes must sum to n_vertices")
    out, start = [], 0
    for s in sizes:
        out.append(np.arange(start, start + s, dtype=np.int64))
        start += s
    return out


def ownership_conflicts(g: DirectedGraph, parts: Sequence[np.ndarray],
                        fmt: str = "in") -> int:
    """Count write-conflicting (edge or post-vertex) elements between partitions.

    This is the executable form of eqs. 14/15 - and of CORTEX's runtime
    "Abort if a foreign thread touches my element" check.  For ``fmt='in'``
    the result is provably 0 for any disjoint partition; for ``fmt='out'``
    it counts shared post vertices (each needing synchronization).
    """
    sub = indegree_subgraph if fmt == "in" else outdegree_subgraph
    subs = [sub(g, p) for p in parts]
    conflicts = 0
    for i in range(len(subs)):
        for j in range(i + 1, len(subs)):
            m = meet(subs[i], subs[j])
            conflicts += int(m.post_vertices.size) + int(m.edges.shape[0])
    return conflicts
