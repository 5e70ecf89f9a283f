"""The port's data pipelines (:mod:`repro_torch.data.pipeline`)."""
