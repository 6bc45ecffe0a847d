"""Structural lint gate of the port (``ttsx/utils/check_file_sizes.py``):
non-blank lines per file, limited per directory of ``ttsx_torch``.

    python -m ttsx_torch.utils.check_file_sizes

prints each violation and exits 1 if there is one.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List, Tuple

DEFAULT_LIMITS: Dict[str, int] = {
    "ttsx_torch/train": 450,
    "ttsx_torch/nn": 300,
    "ttsx_torch/core": 400,
    "ttsx_torch/dsp": 250,
    "ttsx_torch/models": 450,
    "ttsx_torch/eval": 250,
    "ttsx_torch/parallel": 200,
    "ttsx_torch/utils": 200,
    "ttsx_torch/ops": 250,
    "ttsx_torch/data": 400,
    "ttsx_torch/pipeline": 450,
    "ttsx_torch/cli": 400,
}


def count_loc(path: Path) -> int:
    """Non-blank lines."""
    return sum(1 for line in path.read_text().splitlines() if line.strip())


def check_file_sizes(root: str | Path = ".",
                     limits: Dict[str, int] | None = None
                     ) -> List[Tuple[str, int, int]]:
    """[(file, lines, limit)] of the ``*.py`` files under each directory
    of ``limits`` (relative to ``root``) with more lines than its limit."""
    root = Path(root)
    limits = limits or DEFAULT_LIMITS
    violations = []
    for rel, limit in limits.items():
        d = root / rel
        if not d.exists():
            continue
        for py in sorted(d.rglob("*.py")):
            loc = count_loc(py)
            if loc > limit:
                violations.append((str(py.relative_to(root)), loc, limit))
    return violations


def main(argv=None) -> int:
    violations = check_file_sizes(Path(__file__).resolve().parents[2])
    for f, loc, limit in violations:
        print(f"LOC VIOLATION: {f}: {loc} > {limit}")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
