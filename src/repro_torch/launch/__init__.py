"""Launchers of the port: the multi-host SNN launcher and worker
(:mod:`repro_torch.launch.multihost`), the SNN dry run
(:mod:`repro_torch.launch.dryrun_snn`) and the mesh descriptors and host
grid (:mod:`repro_torch.launch.mesh`)."""
