"""``python -m ttsx_torch.cli.bench``: ``main_bench``, the port's
counterpart of the reference's ``ttsx-bench`` command (the CI latency
gate)."""
import sys

from ttsx_torch.cli.main import main_bench

if __name__ == "__main__":
    sys.exit(main_bench())
