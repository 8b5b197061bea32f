"""The contract-ray case of tests/test_torch_quality_trajectory.py: the
port's training trajectory against the JAX package's through every event of
the `quality_run` recipe, in float64.
A file of its own so that the test workers run it beside the ndc case.
"""

import pytest

from test_torch_quality_trajectory import (  # noqa: F401  (the test)
    test_trajectory_through_every_event_matches_jax,
)


@pytest.fixture(params=["contract"])
def ray_type(request):
    return request.param
