"""`python -m rodynrf_tpu_torch.preprocess {flow,depth,mask} ...`: the
preprocessing commands on the card (rodynrf_tpu_torch/preprocess/)."""

import sys

from . import main

if __name__ == "__main__":
    main(sys.argv[1:])
