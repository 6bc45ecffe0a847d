"""``python -m ttsx_torch.cli.observer``: ``main_observer``, the port's
counterpart of the reference's ``ttsx-observer`` command."""
import sys

from ttsx_torch.cli.main import main_observer

if __name__ == "__main__":
    sys.exit(main_observer())
