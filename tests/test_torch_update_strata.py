"""The PPO+VAE update of the torch port against the JAX package: the
cases with 4 shuffle strata, and the shuffle layout's rules.

The tests of tests/test_torch_update.py (its recipe, tolerances and
reasons) on its cases with shuffle_strata 4 (fused at G=1, sequential at
G=8); that file runs the cases with one stratum.  The net's init is
shared through tests/xdist_once.py, each case's JAX update is jitted in
the one file that runs it.
"""
import pytest

from deep_tracking_control_tpu.env.config import AlgorithmCfg
from deep_tracking_control_tpu_torch.agent import ppo as tppo
from tests.test_torch_update import (  # noqa: F401  (fixtures and tests)
    _one_thread, base, run_case, test_minibatch_gradients_match,
    test_second_update_matches, test_update_stats_match)


@pytest.fixture(scope="module", params=["fused_s4_g1", "seq_s4_g8"])
def case(request, base):
    return run_case(base, request.param)


def test_shuffle_layout_matches_jax_rules():
    """S and G resolution (ppo.py:287-300): auto S=1 on one device, the
    strata shrunk until each splits into whole minibatches, G capped at
    gcd(granule, minibatch rows per stratum)."""
    for strata, granule, t, n_env, want in ((0, 16, 8, 8, (1, 16)),
                                            (4, 16, 8, 8, (4, 4)),
                                            (3, 5, 8, 6, (3, 1)),
                                            (8, 16, 8, 12, (4, 2)),
                                            (6, 1, 3, 6, (1, 1))):
        alg = AlgorithmCfg(shuffle_strata=strata,
                           minibatch_perm_granule=granule)
        S, rows_s, mb_s, G = tppo.shuffle_layout(alg, t, n_env)
        assert (S, G) == want
        assert rows_s == t * n_env // S and mb_s == rows_s // 4
