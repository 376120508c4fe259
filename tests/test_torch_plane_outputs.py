"""The port's plane task against the JAX package: the step's outputs.

The recipe and budgets of tests/test_torch_plane.py, whose `run` this
file shares (the two steps are computed once a test session,
tests/xdist_once.py): each output field of both steps, checked as
tests/test_torch_tasks.py checks them.
"""
import pytest

from tests.test_torch_plane import _one_thread, run  # noqa: F401  (fixtures)
from tests.test_torch_tasks import FIELDS, check_output


@pytest.mark.parametrize("t", [0, 1])
@pytest.mark.parametrize("field", FIELDS)
def test_plane_outputs(run, t, field):
    check_output(run, t, field)

