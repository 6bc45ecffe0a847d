"""The readings that a cell's correctness limits are set from.

    python3 -m perfbench.tests.readings --workload <cell> --seeds 1 2 3 ...

From the root of a checkout, on the card. For each seed, in one process,
the cell's set-up and timed path as a run takes them (serving: a one
second window; training: the checked steps, no window), then the
reference and the control (the reference with TF32 products, the next
precision down from the configuration's float32) on what the program
produced. Prints one JSON line a seed: the program's gaps and the
control's, each beside the cell's limit. With ``--fault`` a fault of
``test_perfbench_faults.FAULTS`` is planted in the program first.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from perfbench import harness


def readings(cell_name: str, seeds, device: str = "cuda", root=harness.ROOT,
             seconds: float = 1.0):
    man = harness.manifest(root)
    cell = harness.load_cell(cell_name, root, man)
    drv = harness.driver(cell.spec["driver"], root)
    for seed in seeds:
        ctx = harness.Context(cell, seed, seconds, False, device,
                              time.perf_counter(), root, control=True)
        out = drv.run(ctx)
        yield {"seed": seed,
               "program": {k: v for k, (v, _) in out["checks"].items()},
               "control": out["control"], "limits": cell.limits,
               "detail": out.get("detail")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("perfbench-readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--detail", help="a directory for each seed's per-leaf "
                   "readings (training), one JSON file a seed")
    p.add_argument("--fault", help="plant one of test_perfbench_faults's "
                   "FAULTS in the program first")
    args = p.parse_args(argv)
    if args.fault:
        import pytest
        from perfbench.tests.test_perfbench_faults import FAULTS
        FAULTS[args.fault](pytest.MonkeyPatch())
    for line in readings(args.workload, args.seeds):
        detail = line.pop("detail")
        if args.detail and detail:
            path = Path(args.detail) / f"{args.workload}.{line['seed']}.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(detail))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
