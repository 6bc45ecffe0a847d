#!/usr/bin/env python3
"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared with its limit (also the last lines of standard error).
Without a CUDA card, or with fewer cards than the cell asks for, it
exits 2 and prints no result; it exits 3 and prints no result if the JAX
stack or the JAX package was loaded.

Every compile cache lives at a fixed path inside the checkout: the
port's kernels in ``ttsx_torch/_build/`` (the port fixes it) and
PyTorch's and Triton's caches in ``.perfbench_cache/``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser("perfbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import harness
    man = harness.manifest(ROOT)
    cell = harness.load_cell(args.workload, ROOT, man)
    import torch
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T0, ROOT)
    line = harness.run_cell(ctx, man)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad} in the result's process",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
