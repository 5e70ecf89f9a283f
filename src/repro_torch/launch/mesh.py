"""Mesh descriptors and the SNN engine's host grid.

The reference package's ``launch/mesh.py`` builds ``jax.make_mesh`` meshes
over 256 or 512 TPU chips.  The port has no device mesh that size: its
production meshes are plain descriptors (:class:`MeshShape`) carrying what
their readers use - the axis names, the shape, ``size`` and
``shape[axis]`` - for the SNN dry run (:mod:`repro_torch.launch.dryrun_snn`
steps one shard of such a grid) and the cross-pod gradient reduce
(:func:`repro_torch.train.grad_compress.make_cross_pod_reduce`).

Axis semantics, as the reference's:
    pod    - data parallel across pods; only the gradient reduce crosses it
    data   - batch sharding within a pod
    model  - tensor parallelism
For the SNN engine the same axes carry the paper's decomposition:
(pod, data) rows = Area-Processes groups, model = multisection cells.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["MeshShape", "make_production_mesh", "make_test_mesh",
           "make_snn_host_mesh", "POD_SHAPE", "SINGLE_POD_SHAPE"]

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
