"""The SNN engine's host grid (the reference package's ``launch/mesh.py``
builds jax meshes; only its SNN builder has a counterpart here)."""

from __future__ import annotations

__all__ = ["make_snn_host_mesh"]


def make_snn_host_mesh(n_rows: int, row_width: int, *, device="cuda"):
    """Host-aligned (rows, row_width) shard grid for the multi-host SNN
    engine: Area-Processes rows land on single processes, so the intra-row
    spike tier never leaves a process
    (:func:`repro_torch.core.multihost.make_host_mesh`, which validates
    the alignment)."""
    from repro_torch.core.multihost import make_host_mesh
    return make_host_mesh(n_rows, row_width, device=device)
