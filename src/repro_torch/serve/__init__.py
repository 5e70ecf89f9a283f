"""Serving: the LM face's batched prefill + greedy-decode engine
(:mod:`.engine`) and the multi-tenant SNN sessions - the session engine
(:mod:`.snn`) over its jax-free bookkeeping (:mod:`.sessions`)."""
