"""``python -m ttsx_torch.cli.diarize``: ``main_diarize``, the port's
counterpart of the reference's ``ttsx-diarize`` command."""
import sys

from ttsx_torch.cli.main import main_diarize

if __name__ == "__main__":
    sys.exit(main_diarize())
