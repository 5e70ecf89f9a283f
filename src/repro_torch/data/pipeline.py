"""Deterministic, resumable data pipelines.

A copy of the reference package's ``data/pipeline.py`` (numpy only, so
the port keeps its own).  Both pipelines are *index-based*: batch ``i`` is
a pure function of ``(seed, i)`` (counter-based RNG), so

* resuming from a checkpoint needs only the step number - no iterator
  state, no file offsets;
* every data-parallel worker can materialize exactly its shard of batch
  ``i`` independently (``worker_slice``) - the property that makes the
  pipeline trivially correct under elastic re-scaling.

``TokenPipeline`` synthesizes LM token streams with a Zipfian unigram mix
and document boundaries (EOS resets) - structured enough that losses move,
deterministic enough for bitwise-reproducible restarts.
``SpikeStimulusPipeline`` produces per-step Poisson drive seeds for the SNN
engine's examples.  Both give the reference's arrays bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenPipeline", "SpikeStimulusPipeline"]


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 256

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, 0xDA7A, step]))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Full global batch for ``step``: tokens (B, S+1) int32."""
        rng = self._rng(step)
        b, s = self.global_batch, self.seq_len + 1
        # Zipfian unigrams (bounded to vocab)
        toks = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        toks = (toks - 1) % (self.vocab_size - 1) + 1
        # document boundaries
        n_bounds = max(1, s // self.mean_doc_len)
        pos = rng.integers(0, s, size=(b, n_bounds))
        rows = np.repeat(np.arange(b), n_bounds)
        toks[rows, pos.reshape(-1)] = self.eos_id
        return {"tokens": toks.astype(np.int32)}

    def worker_slice(self, step: int, worker: int, n_workers: int):
        """Only this worker's rows of batch ``step`` (cheap: full gen then
        slice here; a production loader would seed per-row)."""
        full = self.batch(step)
        per = self.global_batch // n_workers
        lo = worker * per
        return {k: v[lo:lo + per] for k, v in full.items()}

    def state_dict(self, step: int) -> dict:
        return {"seed": self.seed, "step": int(step)}


@dataclasses.dataclass(frozen=True)
class SpikeStimulusPipeline:
    """Per-step stimulus seeds + optional rate modulation envelope for the
    SNN engine (e.g. a step current onset at t0 for evoked-response demos).
    """

    seed: int = 0
    rate_scale: float = 1.0
    onset_step: int = 0
    onset_gain: float = 1.0

    def gain(self, step: int) -> float:
        return self.rate_scale * (self.onset_gain if step >= self.onset_step
                                  else 1.0)

    def key_data(self, step: int) -> np.ndarray:
        ss = np.random.SeedSequence([self.seed, 0x51, step])
        return ss.generate_state(2, dtype=np.uint32)
