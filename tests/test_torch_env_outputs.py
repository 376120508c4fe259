"""The rollout slice of the torch port against the JAX package: the
step's outputs.

The recipe, budget and reasons of tests/test_torch_env.py, whose
`slice_run` this file shares (the JAX slice is computed once a test
session, tests/xdist_once.py): obs, privileged obs, obs history, base
velocity and reward of both steps at atol/rtol 1e-4.
"""
import numpy as np
import pytest

from tests.test_torch_env import OBS, slice_run  # noqa: F401  (fixture)


@pytest.mark.parametrize("t", [0, 1])
@pytest.mark.parametrize("field", ["obs", "privileged_obs", "obs_history",
                                   "base_vel", "rew"])
def test_slice_outputs(slice_run, t, field):
    jo, to = slice_run["jouts"][t], slice_run["touts"][t]
    np.testing.assert_allclose(to[field].numpy(), jo[field], **OBS,
                               err_msg=field)

