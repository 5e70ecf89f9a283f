"""Launchers of the port: the multi-host SNN launcher and worker
(:mod:`repro_torch.launch.multihost`) and its host grid
(:mod:`repro_torch.launch.mesh`)."""
