"""`python -m rodynrf_tpu_torch --config ...`: the port's command line on the
card (rodynrf_tpu_torch/cli.py)."""

from .cli import main

if __name__ == "__main__":
    main()
