"""Fault-tolerant runtime of the port: restart policy and backoff
(:mod:`.fault`), deterministic fault injection (:mod:`.inject`), the
supervised simulation loop (:mod:`.supervisor`) and elastic re-meshing
(:mod:`.elastic`)."""
