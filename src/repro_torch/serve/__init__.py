"""Serving of the LM face: the batched prefill + greedy-decode engine."""
