"""The port's counterparts of the repository's `scripts/` that drive the
package end to end, each runnable as a module:

    python -m rodynrf_tpu_torch.tools.quality_run [n_iters] [--ray_type ndc|contract|both]
    python -m rodynrf_tpu_torch.tools.quality_full [n_iters] [which] [--resume] ...
    python -m rodynrf_tpu_torch.tools.export_alpha ckpt [out.npz] [max_dim] [thres]

Each `main(argv, device="cuda")` runs on the card and refuses without one
unless the caller passes device="cpu". They write only under their own
output paths (by default `build/`), never into `QUALITY.md`, `scripts/` or
`golden/`.
"""
