"""`python -m throttlecrab_tpu_torch.harness perf-test ...`."""

import sys

from .loadgen import main

if __name__ == "__main__":
    sys.exit(main())
