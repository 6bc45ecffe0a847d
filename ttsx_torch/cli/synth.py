"""``python -m ttsx_torch.cli.synth``: ``main_synth``, the port's
counterpart of the reference's ``ttsx-synth`` command."""
import sys

from ttsx_torch.cli.main import main_synth

if __name__ == "__main__":
    sys.exit(main_synth())
