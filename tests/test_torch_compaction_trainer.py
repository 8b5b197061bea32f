"""Appearance compaction through the port's trainer (--app_frac with
--app_start): the split packs take the JAX package's layouts, beside the
evaluation-level parity of tests/test_torch_compaction.py (a file of its
own so that the test workers run it beside that one).
"""

import jax
import numpy as np

from rodynrf_tpu_torch.train.convert import params_from_numpy


def test_trainer_app_compaction_takes_the_jax_layouts():
    """--app_frac 0.25 --app_start 1 through the trainer (bf16 auto, the
    default recipe, TINY 32³ so that K = 8 < 16 samples): iteration 0 runs
    dense and its end turns compaction on and rebuilds the step; the split
    packs then take the JAX package's layouts, pack by pack, at the JAX
    package's weights. (The compacted evaluations themselves are held to
    the JAX package's above.)"""
    from rodynrf_tpu.fields import dynamic as jdyn
    from rodynrf_tpu.fields import static as jstat
    from rodynrf_tpu_torch.testing import tiny_cmd
    from test_torch_step_merged import _trainers

    jtr, ttr = _trainers(tiny_cmd("ndc", 1) + " --bf16 1 --N_voxel_init 32768 "
                         "--N_voxel_final 32768 --app_frac 0.25 --app_start 1")
    assert ttr.static_cfg.app_frac == 0.0 and ttr.step_fn.S.static_cfg.app_frac == 0.0
    m = ttr.run_step()
    assert all(np.isfinite(float(v)) for v in m.values())
    assert ttr.static_cfg.app_frac == ttr.step_fn.S.dynamic_cfg.app_frac == 0.25
    assert ttr.step_fn.S.dynamic_cfg.app_topk(ttr.n_samples) == 8 < ttr.n_samples
    jtr.iteration = 1
    assert jtr._refresh_app_frac()
    ttr.set_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, jtr.params), "cpu"))
    jl = {"static": {k: v.meta["layout"] for k, v in
                     jstat.pack_tables(jtr.params["static"], jtr.static_cfg).items()},
          "dynamic": {k: v.meta["layout"] for k, v in
                      jdyn.pack_tables(jtr.params["dynamic"], jtr.dynamic_cfg).items()}}
    assert ttr.table_layouts() == jl
    print(f"split-pack layouts: {jl}")
    m = ttr.run_step()  # the compacted step
    assert all(np.isfinite(float(v)) for v in m.values())
