"""The `app_frac` case of tests/test_torch_compact_train.py: the compacted
step with appearance compaction on the flat bucket (--app_frac 0.25
--app_start 0, the split {"db", "app"} packs) against the JAX package's,
under that file's f32 bounds. The same three tests, on this case of the
`masked` fixture; a file of its own so that the test workers run it beside
the f32 and bf16 cases.
"""

import pytest

from test_torch_compact_train import (  # noqa: F401  (the tests and the autouse fixture)
    _masked,
    one_torch_thread,
    test_compacted_step_gradients_match_jax,
    test_compacted_step_losses_match_jax,
    test_update_alpha_mask_gives_the_jax_mask_and_buckets,
)


@pytest.fixture(scope="module", params=["app_frac"])
def masked(request):
    return _masked(request.param)
