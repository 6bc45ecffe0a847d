"""The benchmark's manifest, its data files and the result line.

Everything a cell needs is found by name:

* ``BENCHMARK.json`` at the checkout's root: the configurations, cells
  and metrics;
* ``perfbench/configs/<config>.json``: a configuration as it is run
  (``config``, the port's config tree) with its source and its changes;
* ``perfbench/workloads/<cell>.json``: the driver, the traffic mix, the
  correctness limits and the cell's ``why``;
* ``perfbench/traffic/<traffic>.json``: the traffic's parameters, read by
  the driver's generator;
* ``perfbench/drivers/<driver>.py``: one module per kind of entry point,
  with ``run(ctx) -> dict``;
* ``perfbench/metrics/<metric>.py``: one module per per-layer metric, with
  ``read(record) -> float | None``.

A later cell, configuration or metric is a new file and a new entry: no
file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import math
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("host_clock", "device_trace")
# the JAX package and JAX itself, compared by whole top-level module names
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ttsx")


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no module {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = ROOT):
    return _load_module(root / "perfbench" / "drivers" / f"{name}.py",
                        f"perfbench_driver_{name}")


def metric_reader(name: str, root: Path = ROOT):
    return _load_module(root / "perfbench" / "metrics" / f"{name}.py",
                        "perfbench_metric_" + re.sub(r"\W", "_", name))


def cell_metrics(man: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports: those
    that list it under ``workloads``, and those without the key (an
    end-to-end metric in every cell; a per-layer metric in every cell that
    reports the end-to-end metric it moves)."""
    if kind == "end_to_end":
        return [m for m in man["end_to_end"]
                if cell in m.get("workloads", [c["name"] for c in
                                               man["workloads"]])]
    e2e = {m["name"] for m in cell_metrics(man, cell, "end_to_end")}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


@dataclass
class Cell:
    name: str
    entry: dict        # the cell's entry in BENCHMARK.json
    spec: dict         # workloads/<cell>.json
    config: dict       # configs/<config>.json
    traffic: dict      # traffic/<traffic>.json

    @property
    def limits(self) -> Dict[str, float]:
        return self.spec["limits"]


def load_cell(name: str, root: Path = ROOT, man: Optional[dict] = None
              ) -> Cell:
    man = man or manifest(root)
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in man["configs"]}
    spec = load_json(root / "perfbench" / "workloads" / f"{name}.json")
    return Cell(name, entry, spec,
                load_json(root / configs[entry["config"]]["file"]),
                load_json(root / "perfbench" / "traffic"
                          / f"{entry['traffic']}.json"))


def validate(man: dict, root: Path = ROOT) -> List[str]:
    """Every fault of the manifest and of the files it names, as text."""
    errors = []
    top = {"command", "paths", "run_seconds", "configs", "workloads",
           "end_to_end", "per_layer"}
    if set(man) != top:
        errors.append(f"top-level keys {sorted(man)}")
    names = [c["name"] for c in man["configs"]]
    cells = [w["name"] for w in man["workloads"]]
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    for kind, group in (("config", names), ("cell", cells),
                        ("metric", metrics)):
        for n in group:
            if not NAME.match(n):
                errors.append(f"{kind} name {n!r}")
        if len(set(group)) != len(group):
            errors.append(f"{kind} names repeat")
    for c in man["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            errors.append(f"config {c['name']} keys {sorted(c)}")
        if not (root / c["file"]).is_file():
            errors.append(f"config file {c['file']} missing")
        elif not any(c["file"].startswith(p.rstrip("/") + "/")
                     for p in man["paths"]):
            errors.append(f"config file {c['file']} outside paths")
        if c["name"] not in [w["config"] for w in man["workloads"]]:
            errors.append(f"config {c['name']} used by no cell")
    pairs = set()
    for w in man["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            errors.append(f"cell {w['name']} keys {sorted(w)}")
        if w["config"] not in names:
            errors.append(f"cell {w['name']}: unknown config")
        if w["chips"] not in (1, 4):
            errors.append(f"cell {w['name']}: chips {w['chips']}")
        if not NAME.match(w["traffic"]):
            errors.append(f"cell {w['name']}: traffic name")
        if (w["config"], w["traffic"]) in pairs:
            errors.append(f"cell {w['name']}: config and traffic repeat")
        pairs.add((w["config"], w["traffic"]))
        if not 1 <= len(w["why"]) <= 200 or "\n" in w["why"]:
            errors.append(f"cell {w['name']}: why")
        try:
            cell = load_cell(w["name"], root, man)
            driver(cell.spec["driver"], root)
        except (OSError, KeyError, ValueError) as e:
            errors.append(f"cell {w['name']}: {e}")
            continue
        for k in ("config", "traffic", "chips"):
            if cell.spec.get(k) != w[k]:
                errors.append(f"cell {w['name']}: {k} differs from its file")
        e2e = cell_metrics(man, w["name"], "end_to_end")
        if "setup_s" not in [m["name"] for m in e2e] or len(e2e) < 2:
            errors.append(f"cell {w['name']}: needs setup_s and another "
                          "end-to-end metric")
        if not cell_metrics(man, w["name"], "per_layer"):
            errors.append(f"cell {w['name']}: no per-layer metric")
    e2e_names = {m["name"] for m in man["end_to_end"]}
    for m in man["end_to_end"]:
        if m["source"] not in E2E_SOURCES:
            errors.append(f"{m['name']}: source {m['source']}")
        if not 0 < m["bound"] <= 0.25:
            errors.append(f"{m['name']}: bound {m['bound']}")
    for m in man["per_layer"]:
        if m["source"] not in SOURCES:
            errors.append(f"{m['name']}: source {m['source']}")
        if m["moves"] not in e2e_names:
            errors.append(f"{m['name']}: moves {m['moves']}")
        for c in m.get("workloads", []):
            if c not in cells:
                errors.append(f"{m['name']}: unknown cell {c}")
            elif m["moves"] not in [x["name"] for x in
                                    cell_metrics(man, c, "end_to_end")]:
                errors.append(f"{m['name']}: {c} does not report "
                              f"{m['moves']}")
        if not (root / "perfbench" / "metrics" / f"{m['name']}.py").is_file():
            errors.append(f"{m['name']}: no reader")
        if not 1 <= len(m["layer"]) <= 200 or "\n" in m["layer"]:
            errors.append(f"{m['name']}: layer")
    for m in man["end_to_end"] + man["per_layer"]:
        allowed = {"name", "unit", "better", "source", "bound", "workloads",
                   "layer", "moves"}
        if set(m) - allowed:
            errors.append(f"{m['name']}: keys {sorted(set(m) - allowed)}")
        if not UNIT.match(m["unit"]):
            errors.append(f"{m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errors.append(f"{m['name']}: better {m['better']!r}")
    return errors


def forbidden_modules() -> List[str]:
    """The JAX stack or the JAX package among the loaded modules, by whole
    top-level name (the port's own name begins with the package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile (0 < q < 1) by linear interpolation between the
    order statistics (numpy's default), over every value."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = q * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)



@dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device and
    the process's start on the host clock."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    root: Path = ROOT
    # the readings for the limits: also run the control (the reference in
    # the next precision down) and report its gaps; a training run then
    # takes no window
    control: bool = False

    def note(self, **fields) -> None:
        """A line on standard error now, kept for nothing else."""
        print(json.dumps(fields), file=sys.stderr, flush=True)


def checks_line(checks: Dict[str, tuple]) -> Dict[str, dict]:
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


def device_info(device: str, count: int) -> dict:
    import torch
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count}
    return {"platform": "cpu", "kind": "cpu", "count": count}


def run_cell(ctx: Context, man: dict) -> dict:
    """Drive the cell once through its driver and build the result line:
    the cell's end-to-end metrics (``trace`` off) or the per-layer metrics
    its readers find in the traced run's record (``trace`` on)."""
    out = driver(ctx.cell.spec["driver"], ctx.root).run(ctx)
    dev = device_info(ctx.device, ctx.cell.entry["chips"])
    dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    metrics = {}
    if ctx.trace:
        dev["busy_s"] = out["busy_s"]
        dev["window_s"] = out["window_s"]
        for m in cell_metrics(man, ctx.cell.name, "per_layer"):
            value = metric_reader(m["name"], ctx.root).read(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(man, ctx.cell.name, "end_to_end"):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if ctx.trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks_line(out["checks"])
    return line
