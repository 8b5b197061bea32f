"""Accumulation of 4 micro-batches: the A = 4 case of
tests/test_torch_grad_accum.py's accumulation tests (metrics to 1e-5
relative; float64 gradients to 1e-6 of scale of the JAX x64 run; float32
gradients under test_torch_step.py's bounds). A file of its own so that the
test workers run it beside the A = 2 case.
"""

import pytest

from test_torch_grad_accum import (  # noqa: F401  (the tests and the autouse fixture)
    one_torch_thread,
    test_accumulated_gradients_match_jax,
    test_accumulated_metrics_match_jax,
)


@pytest.fixture(params=[4])
def A(request):
    return request.param
