"""Sharding rules of the LM face: which mesh axes each tensor's dims
shard over (:mod:`repro_torch.sharding.rules`)."""
