"""Build the native host loaders: ``python -m ttsx_torch.native.build``."""
import sys

from ttsx_torch.native import NativeBuildError, build_all

if __name__ == "__main__":
    try:
        for name, path in build_all().items():
            print(f"{name}: {path}")
    except NativeBuildError as e:
        print(f"BUILD FAILED: {e}", file=sys.stderr)
        sys.exit(1)
