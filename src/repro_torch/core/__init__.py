"""Network build (numpy) and the single-shard simulation engine (torch)."""
