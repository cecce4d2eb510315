"""``python -m grayscott_jl_tpu_torch.serve [--backend CUDA|CPU]
[--role frontdoor|worker]``."""

import sys

from .server import main

if __name__ == "__main__":
    sys.exit(main())
