"""Utilities of the port: per-op cost counting (:mod:`.op_costs`)."""
