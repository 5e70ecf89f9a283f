"""Mesh descriptors, the process mesh, and the SNN engine's host grid.

The reference package's ``launch/mesh.py`` builds ``jax.make_mesh`` meshes
over 256 or 512 TPU chips.  The port has no device mesh that size: its
production meshes are plain descriptors (:class:`MeshShape`) carrying what
their readers use - the axis names, the shape, ``size`` and
``shape[axis]`` - for the SNN dry run (:mod:`repro_torch.launch.dryrun_snn`
steps one shard of such a grid) and the cross-pod gradient reduce
(:func:`repro_torch.train.grad_compress.make_cross_pod_reduce`).

A :class:`ProcessMesh` is such a grid bound to the ``torch.distributed``
world, one process a grid point: the LM face's mesh programs
(``sharding.rules.use_mesh``, ``models.moe_manual``, the mesh train step)
run in the local view, each process holding its own blocks and calling
the collectives of :mod:`repro_torch.sharding.collectives` where the
reference's partitioner would place them.

Axis semantics, as the reference's:
    pod    - data parallel across pods; only the gradient reduce crosses it
    data   - batch sharding within a pod
    model  - tensor parallelism
For the SNN engine the same axes carry the paper's decomposition:
(pod, data) rows = Area-Processes groups, model = multisection cells.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os

import numpy as np

__all__ = ["MeshShape", "ProcessMesh", "StandInMesh", "make_production_mesh",
           "make_test_mesh", "make_snn_host_mesh", "join_process_mesh",
           "parse_mesh", "POD_SHAPE", "SINGLE_POD_SHAPE"]

SINGLE_POD_SHAPE = (16, 16)              # 256 devices
POD_SHAPE = (2, 16, 16)                  # 2 pods = 512 devices


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A named device grid with no devices behind it: ``axis_names`` and
    ``dims`` (one size per axis)."""

    axis_names: tuple[str, ...]
    dims: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.dims)} dims")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        """The number of devices the grid spans."""
        return math.prod(self.dims)


class ProcessMesh(MeshShape):
    """A :class:`MeshShape` bound to the ``torch.distributed`` world.

    Process ``r`` is the grid point ``np.unravel_index(r, dims)`` (row
    major, as ``jax.make_mesh`` lays out devices).  For each set of axes
    the mesh holds one process group, of the processes that share this
    one's coordinates on the other axes; a tuple of axes orders that
    group's members as the reference's collectives do: the first axis
    major (:meth:`members`, :meth:`axis_index`).  A group of one process
    (and the mesh of one process) has no process group: its collectives
    are the identity.  ``backend`` is the world's (``"gloo"`` or
    ``"nccl"``, :func:`repro_torch.core.multihost.default_backend`), None
    at one process."""

    def __init__(self, axis_names, dims):
        super().__init__(tuple(axis_names), tuple(int(d) for d in dims))
        import torch.distributed as tdist
        world = tdist.get_world_size() if tdist.is_initialized() else 1
        if world != self.size:
            raise ValueError(f"a {self.dims} mesh needs {self.size} "
                             f"processes, the world has {world}")
        rank = tdist.get_rank() if world > 1 else 0
        object.__setattr__(self, "rank", rank)
        object.__setattr__(self, "coords", dict(zip(
            self.axis_names, (int(c) for c in np.unravel_index(
                rank, self.dims)))))
        object.__setattr__(self, "backend",
                           tdist.get_backend() if world > 1 else None)
        groups = {}
        # every process creates every group, in the same order
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                mine = None
                for ranks in self._partition(axes):
                    pg = tdist.new_group(ranks)
                    if rank in ranks:
                        mine = pg
                groups[frozenset(axes)] = mine
        object.__setattr__(self, "_groups", groups)

    def _partition(self, axes) -> list[list[int]]:
        """The processes grouped by their coordinates off ``axes``, each
        group's ranks sorted."""
        grid = np.arange(self.size).reshape(self.dims)
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.dims)) if i not in keep]
        blocks = np.transpose(grid, rest + keep).reshape(
            -1, math.prod(self.shape[a] for a in axes))
        return [sorted(int(r) for r in b) for b in blocks]

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _tuple(axes))

    def axis_index(self, axes) -> int:
        """This process's index along ``axes`` (first axis major): the
        reference's ``axis_index`` over an axis tuple."""
        idx = 0
        for a in _tuple(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def members(self, axes) -> list[int]:
        """The ranks of this process's group over ``axes``, in the order
        of :meth:`axis_index`."""
        axes = _tuple(axes)
        out = []
        for pos in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(self.coords, **dict(zip(axes, pos)))
            out.append(int(np.ravel_multi_index(
                [c[a] for a in self.axis_names], self.dims)))
        return out

    def group(self, axes):
        """The process group over ``axes`` (None for a group of one)."""
        return self._groups.get(frozenset(_tuple(axes)))


class StandInMesh(ProcessMesh):
    """Device 0 of a :class:`MeshShape` for a mesh program run on
    ``meta``: ``coords``, ``members``, ``axis_index``, ``group`` and
    ``shape`` as a :class:`ProcessMesh` gives them to process 0, bound to
    no world.  The collectives of :mod:`repro_torch.sharding.collectives`
    on it only tally (``collectives.tally``) and return ``meta`` tensors
    of their outputs' shapes, so nothing reaches ``torch.distributed``:
    the LM dry run counts one device's share of a step on it, as the SNN
    dry run's ``StandInExchange`` stands in for the spike exchange."""

    stand_in = True

    def __init__(self, axis_names, dims):
        MeshShape.__init__(self, tuple(axis_names),
                           tuple(int(d) for d in dims))
        object.__setattr__(self, "rank", 0)
        object.__setattr__(self, "coords", {a: 0 for a in self.axis_names})
        object.__setattr__(self, "backend", None)

    def group(self, axes):
        """A token for the group over ``axes`` (None for a group of one,
        as :meth:`ProcessMesh.group`)."""
        axes = _tuple(axes)
        return None if self.axis_size(axes) == 1 else axes


def _tuple(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def parse_mesh(s: str | None):
    """``"2x2"`` -> ``(dims, axis names)``, as the reference's launcher
    parses ``--mesh``: one dim ``("data",)``, two ``("data", "model")``,
    three ``("pod", "data", "model")``; None for no mesh."""
    if not s:
        return None
    dims = tuple(int(x) for x in s.split("x"))
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(dims)]
    return dims, axes


def join_process_mesh(dims, axis_names, *, device) -> ProcessMesh:
    """Join the world of ``prod(dims)`` processes (through
    :func:`repro_torch.core.multihost.initialize`, its launch parameters
    from the environment, on :func:`~repro_torch.core.multihost.
    default_backend` for ``device``: gloo on the CPU or where processes
    share a card, nccl where each has its own: ``LOCAL_WORLD_SIZE``
    processes on this host, every process by default) and bind the mesh
    to it.  At one process nothing is joined."""
    from repro_torch.core import multihost
    import torch.distributed as tdist
    size = math.prod(dims)
    if size > 1 and not tdist.is_initialized():
        local = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        backend = multihost.default_backend(device, local)
        if multihost.initialize(backend=backend) is None:
            raise RuntimeError(
                f"a {tuple(dims)} mesh needs {size} processes, and the "
                "environment names no launch (REPRO_COORD_ADDR, "
                "REPRO_NUM_PROC, REPRO_PROC_ID or SLURM)")
    return ProcessMesh(axis_names, dims)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """One pod (16 x 16, ``("data", "model")``) or two
    (2 x 16 x 16, ``("pod", "data", "model")``), as the reference's."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), POD_SHAPE)
    return MeshShape(("data", "model"), SINGLE_POD_SHAPE)


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> MeshShape:
    """A small grid for tests, as the reference's."""
    return MeshShape(tuple(axes), tuple(int(d) for d in shape))


def make_snn_host_mesh(n_rows: int, row_width: int, *, device="cuda"):
    """Host-aligned (rows, row_width) shard grid for the multi-host SNN
    engine: Area-Processes rows land on single processes, so the intra-row
    spike tier never leaves a process
    (:func:`repro_torch.core.multihost.make_host_mesh`, which validates
    the alignment)."""
    from repro_torch.core.multihost import make_host_mesh
    return make_host_mesh(n_rows, row_width, device=device)
