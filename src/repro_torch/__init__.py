"""PyTorch/CUDA port of the CORTEX reproduction (``src/repro`` is the JAX
reference it is held against).

``core/`` holds the network build and the single-shard engine; ``kernels/``
the hand-written CUDA kernels for Hopper, each with its plain-torch twin.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
