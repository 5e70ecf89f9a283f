"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its
plain-torch twin; see each module for the Pallas kernel it replaces."""
