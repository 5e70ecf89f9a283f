"""The port's data pipelines (``repro_torch.data.pipeline``) against the
reference's: ``TokenPipeline``'s batches and ``SpikeStimulusPipeline``'s
drive seeds and gains bitwise, for several seeds and steps, and
``worker_slice`` partitioning a batch among workers."""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import numpy as np
import pytest

from repro.data import pipeline as ref_pipeline
from repro_torch.data import pipeline


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("vocab,seq,batch,doc", [(512, 16, 4, 256),
                                                 (151_936, 64, 3, 8)])
def test_token_batches_match_reference(seed, vocab, seq, batch, doc):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed,
              mean_doc_len=doc)
    ours, ref = pipeline.TokenPipeline(**kw), ref_pipeline.TokenPipeline(**kw)
    for step in (0, 1, 5, 1000):
        got, want = ours.batch(step), ref.batch(step)
        assert got.keys() == want.keys() == {"tokens"}
        assert got["tokens"].dtype == np.int32
        assert got["tokens"].shape == (batch, seq + 1)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert ours.state_dict(step) == ref.state_dict(step)
    # structured enough to learn from: EOS boundaries, ids inside the vocab
    toks = ours.batch(3)["tokens"]
    assert (toks == 0).any() and toks.max() < vocab and toks.min() >= 0


@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_worker_slices_partition_the_batch(n_workers):
    pipe = pipeline.TokenPipeline(vocab_size=100, seq_len=8, global_batch=8,
                                  seed=3)
    ref = ref_pipeline.TokenPipeline(vocab_size=100, seq_len=8,
                                     global_batch=8, seed=3)
    for step in (0, 9):
        parts = [pipe.worker_slice(step, w, n_workers)["tokens"]
                 for w in range(n_workers)]
        assert all(p.shape == (8 // n_workers, 9) for p in parts)
        np.testing.assert_array_equal(np.concatenate(parts),
                                      pipe.batch(step)["tokens"])
        for w, p in enumerate(parts):
            np.testing.assert_array_equal(
                p, ref.worker_slice(step, w, n_workers)["tokens"])


@pytest.mark.parametrize("seed", [0, 5])
def test_spike_stimulus_matches_reference(seed):
    kw = dict(seed=seed, rate_scale=1.5, onset_step=10, onset_gain=2.0)
    ours = pipeline.SpikeStimulusPipeline(**kw)
    ref = ref_pipeline.SpikeStimulusPipeline(**kw)
    for step in (0, 9, 10, 123):
        got, want = ours.key_data(step), ref.key_data(step)
        assert got.dtype == np.uint32 and got.shape == (2,)
        np.testing.assert_array_equal(got, want)
        assert ours.gain(step) == ref.gain(step)
    assert not np.array_equal(ours.key_data(1), ours.key_data(2))
