"""Checkpointing of the port (:mod:`.manager`): atomic async saves in the
reference package's on-disk format."""
