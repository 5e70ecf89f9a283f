"""Port LM training vs the reference for the MoE, MLA, recurrent and
encoder-decoder smoke archs, on the CPU: the loss, ``ce`` and
``load_balance_loss`` and every gradient leaf by name, as
``test_torch_lm_train.py`` holds the dense ones (its tolerances and
parameters; a file of its own so that the two share the run's time).

The MoE archs run at their smoke capacity factors, so tokens are dropped
in both packages alike: a dropped row's spare buffer row takes no
gradient, and the load-balance loss carries its gradient to the router.
Mamba's and RWKV-6's recurrences run step by step under autograd.
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import pytest

from test_torch_lm_train import check_grads, check_loss, reference_and_port

FAMILY_ARCHS = ("deepseek-v3-671b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
                "rwkv6-3b", "whisper-tiny")


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def family_pair(request):
    return reference_and_port(request.param)


def test_loss_matches_reference(family_pair):
    check_loss(*family_pair)


def test_grads_match_reference(family_pair):
    check_grads(*family_pair)
