"""Launchers of the port: the LM training launcher
(:mod:`repro_torch.launch.train`), the LM dry run and its roofline
(:mod:`repro_torch.launch.dryrun`, :mod:`repro_torch.launch.roofline`),
the multi-host SNN launcher and worker (:mod:`repro_torch.launch.
multihost`), the SNN dry run (:mod:`repro_torch.launch.dryrun_snn`) and
the mesh descriptors and host grid (:mod:`repro_torch.launch.mesh`)."""
