"""CPU tests of the benchmark: its manifest, the addition of a cell by
files alone, the roofline counts, the frozen reference against the
port's plain path, the result line, the imports, and the faults the
correctness check must catch.

    python -m pytest perfbench/tests -q          # here, on the CPU
    python -m pytest perfbench/tests -q -m gpu   # on the card
"""
from __future__ import annotations

import ast
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import tiny_config, tiny_root

ROOT = harness.ROOT
SERVE, TRAIN = "flagship-serve-b8", "tts-train-b16"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def run_tiny(root, cell, trace=False, seconds=0.0, seed=2**31 + 5):
    man = harness.manifest(root)
    ctx = harness.Context(harness.load_cell(cell, root, man), seed, seconds,
                          trace, "cpu", time.perf_counter(), root)
    return harness.run_cell(ctx, man)


# ------------------------------------------------------------- manifest
def test_manifest_is_valid():
    man = harness.manifest()
    assert harness.validate(man) == []
    assert man["command"] == ["python3", "perfbench/run.py"]
    assert man["paths"] == ["perfbench"]
    assert {c["name"] for c in man["configs"]} == {"flagship", "tts"}
    assert {w["name"] for w in man["workloads"]} == {SERVE, TRAIN}
    assert {m["name"] for m in man["end_to_end"]} == {
        "serve_audio_rate", "serve_p95_ms", "train_step_ms", "setup_s"}
    assert len(man["per_layer"]) == 15
    assert len(json.dumps(man)) < 64 * 1024


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_names_units_and_moves(kind):
    man = harness.manifest()
    for m in man[kind]:
        assert harness.NAME.match(m["name"]), m["name"]
        assert harness.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if kind == "per_layer":
            for cell in m["workloads"]:
                reported = [e["name"] for e in
                            harness.cell_metrics(man, cell, "end_to_end")]
                assert m["moves"] in reported, (m["name"], cell)


def test_config_files_hold_the_run_config():
    from ttsx_torch.core.config import TTSXConfig, from_dict, to_dict
    man = harness.manifest()
    for c in man["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []
        cfg = from_dict(TTSXConfig, data["config"])
        assert to_dict(cfg) == data["config"]
    flag = json.loads((ROOT / "perfbench/configs/flagship.json").read_text())
    assert flag["config"]["refiner"]["s4"]["kernel_mode"] == "pallas"
    assert flag["config"]["vocoder"]["use_pallas_upsample"]
    assert flag["config"]["vocoder"]["use_pallas_resblock_stack"]


def _digest(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    root = tiny_root(tmp_path)
    before = _digest(root / "perfbench")
    pb = root / "perfbench"
    (pb / "traffic" / "bucket4x432.json").write_text(json.dumps(dict(
        json.loads((pb / "traffic/bucket8x864_lognormal4s.json").read_text()),
        batch=4, frames=432)))
    spec = json.loads((pb / "workloads" / f"{SERVE}.json").read_text())
    spec.update(traffic="bucket4x432")
    (pb / "workloads" / "flagship-serve-b4.json").write_text(json.dumps(spec))
    (pb / "metrics" / "calls_per_s.serve.py").write_text(
        "def read(record):\n    return None\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append(dict(name="flagship-serve-b4", config="flagship",
                                 traffic="bucket4x432", chips=1,
                                 why="half buckets"))
    for m in man["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("flagship-serve-b4")
    man["per_layer"].append(dict(
        name="calls_per_s.serve", unit="1/s", better="higher",
        source="host_clock", layer="server (serve.py)",
        moves="serve_audio_rate", workloads=[SERVE, "flagship-serve-b4"]))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert harness.validate(man, root) == []
    cell = harness.load_cell("flagship-serve-b4", root, man)
    assert cell.traffic["batch"] == 4
    names = [m["name"] for m in
             harness.cell_metrics(man, "flagship-serve-b4", "per_layer")]
    assert names == ["calls_per_s.serve"]
    assert harness.metric_reader("calls_per_s.serve", root).read({}) is None
    after = _digest(root / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("fault", ["unknown_config", "bad_unit", "moves",
                                   "no_reader"])
def test_validate_refuses(tmp_path, fault):
    root = tiny_root(tmp_path)
    man = json.loads((root / "BENCHMARK.json").read_text())
    if fault == "unknown_config":
        man["workloads"][0]["config"] = "nope"
    elif fault == "bad_unit":
        man["end_to_end"][0]["unit"] = "audio s per s"
    elif fault == "moves":
        man["per_layer"][0]["moves"] = "train_step_ms"
    else:
        (root / "perfbench/metrics/k1_roofline_pct.py").unlink()
    assert harness.validate(man, root)


# ------------------------------------------------------------- rooflines
def test_k1_cost_by_hand():
    k1 = harness.metric_reader("k1_roofline_pct")
    voc = dict(hidden_dim=8, num_bands=2, upsample_factors=[2])
    (flops, nbytes), = k1.stage_costs(voc, batch=1, frames=3)
    # rows 2, T 3, f 2: 12 output rows x 4 channels, each 2 taps x 8 in
    assert flops == 12 * 4 * 2 * 2 * 8
    assert nbytes == 4 * (2 * 3 * 8 + 4 * 8 * 4 + 4 + 12 * 4)


def test_k2_cost_by_hand():
    k2 = harness.metric_reader("k2_roofline_pct")
    voc = dict(hidden_dim=8, num_bands=2, upsample_factors=[2],
               res_dilations=[1, 3])
    (flops, nbytes), = k2.stage_costs(voc, batch=1, frames=3)
    # 12 rows at C = 4, 2 blocks: conv C->2C and C->C, 3 taps, 2 per MAC
    assert flops == 12 * 2 * (2 * 3 * 4 * 8 + 2 * 3 * 4 * 4)
    assert nbytes == 4 * (2 * 12 * 4 + 3 * 2 * 2 * 4
                          + 2 * (3 * 4 * 8 + 3 * 4 * 4 + 8 + 4))


def test_k3_cost_by_hand():
    k3 = harness.metric_reader("k3_roofline_pct")
    audio = dict(n_fft=16, hop_length=4, n_mels=2)
    flops, nbytes = k3.cost(B=1, N=8, audio=audio, nnz=5)
    frames = 3
    assert flops == frames * (16 + 2.5 * 16 * 4 + 4 * 9 + 2 * 5 + 2)
    assert nbytes == 4 * (8 + frames * 2 + 3 * 16 + 9 * 2)


def test_k4_cost_by_hand():
    k4 = harness.metric_reader("k4_roofline_pct")
    flops, nbytes = k4.cost(B=2, T=4, C=8, H=2, d=4)
    n = 8
    fft = (2 * 2 * 4 * 4 + 2 * 4 * 8 * 4 + 6 * 2 * 8 * (n // 2 + 1)
           + 5 * 8 * 2.5 * n * 3)
    assert flops == min(4 * 2 * 4 * 8 * 4, fft)
    assert nbytes == 4 * (2 * 2 * 4 * 8 + 2 * 2 * 4 + 2 * 4 * 4)


def test_roofline_share_of_a_trace():
    from perfbench.peaks import least_s
    k1 = harness.metric_reader("k1_roofline_pct")
    voc = dict(hidden_dim=256, num_bands=4, upsample_factors=[8, 8, 2, 2])
    least = sum(least_s(f, b) for f, b in k1.stage_costs(voc, 8, 864))
    record = dict(kind="serve", vocoder=voc, batch=8, frames=864,
                  trace={"kernels": {"upsample_mma<64, 2>": dict(
                      s=4 * least, n=8)}})
    assert math.isclose(k1.read(record), 50.0)
    record["trace"]["kernels"] = {}
    assert k1.read(record) is None


def test_idle_and_stage_readers():
    rec = dict(kind="serve", stretch_s=2.0, calls=4,
               trace=dict(busy_s=1.5, ranges={"stage.gst": 0.01,
                                              "stage.generator": 0.03}))
    idle = harness.metric_reader("device_idle_pct.serve")
    assert math.isclose(idle.read(rec), 25.0)
    assert harness.metric_reader("device_idle_pct.train").read(rec) is None
    gen = harness.metric_reader("stage_ms.generator")
    assert math.isclose(gen.read(rec), 10.0)
    assert harness.metric_reader("stage_ms.acoustic").read(rec) is None
    rec["trace"]["busy_s"] = 0.0
    assert idle.read(rec) is None


def test_reduce_trace():
    from perfbench.trace import reduce_trace
    ev = [dict(ph="X", cat="user_annotation", name="stage.a", ts=0, dur=45),
          dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=10,
               dur=1, args=dict(correlation=1)),
          dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=60,
               dur=1, args=dict(correlation=2)),
          dict(ph="X", cat="cpu_op", name="aten::mm", ts=45, dur=30),
          dict(ph="X", cat="kernel", name="k", ts=20, dur=10,
               args=dict(correlation=1)),
          dict(ph="X", cat="kernel", name="k", ts=70, dur=20,
               args=dict(correlation=2))]
    r = reduce_trace(ev)
    assert math.isclose(r["busy_s"], 30e-6)
    assert r["kernels"]["k"]["n"] == 2
    assert math.isclose(r["ranges"]["stage.a"], 10e-6)
    assert r["idle_gaps"][0][0] == "aten::mm"
    assert math.isclose(r["idle_gaps"][0][1], 40e-6)


# ------------------------------------------------------ the reference
def _weights(model, seed=3):
    from perfbench.weights import draw_weights, load_weights
    load_weights(model, draw_weights(model, seed, "cpu"))
    return model


def test_reference_pipeline_matches_the_port_plain_path():
    from ttsx_torch.core.config import to_dict
    from ttsx_torch.models.pipeline import TTSPipeline as Port
    from perfbench.reference.core.config import TTSXConfig, from_dict
    from perfbench.reference.models.pipeline import TTSPipeline as Ref
    cfg = tiny_config(kernels=False)
    port = _weights(Port(cfg))
    ref = _weights(Ref(from_dict(TTSXConfig, to_dict(cfg))))
    g = torch.Generator().manual_seed(0)
    B, T = 2, 10
    args = (torch.randn(B, T, 16, generator=g), torch.randn(B, T, 18,
                                                            generator=g),
            torch.softmax(torch.randn(B, 6, generator=g), -1),
            torch.randn(B, 8, generator=g), torch.tensor([1, 7]))
    a, b = port.synthesize(*args), ref.synthesize(*args)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_reference_log_mel_matches_the_port_plain_version():
    from ttsx_torch.core.config import AudioConfig, to_dict
    from ttsx_torch.ops.mel_frontend import log_mel_plain
    from perfbench.reference.mel import log_mel_f64
    cfg = AudioConfig()
    wav = torch.randn(2, 8192, generator=torch.Generator().manual_seed(1))
    got = log_mel_plain(wav, cfg).double()
    torch.testing.assert_close(got, log_mel_f64(wav, to_dict(cfg)),
                               rtol=0, atol=1e-4)


def test_weights_are_the_same_by_name_and_seed():
    from ttsx_torch.core.config import to_dict
    from ttsx_torch.models.vocoder import Generator as Port
    from perfbench.reference.core.config import VocoderConfig, from_dict
    from perfbench.reference.models.vocoder import Generator as Ref
    from perfbench.weights import draw_weights
    vc = tiny_config(kernels=True).vocoder
    a = draw_weights(Port(vc), 9, "cpu")
    b = draw_weights(Ref(from_dict(VocoderConfig, to_dict(vc))), 9, "cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert a[k].abs().sum() > 0, k     # nothing left at zero
    c = draw_weights(Port(vc), 10, "cpu")
    assert not torch.equal(a["Dense_0.weight"], c["Dense_0.weight"])


# ------------------------------------------------------ the result line
@pytest.mark.parametrize("cell,trace", [(SERVE, False), (SERVE, True),
                                        (TRAIN, False)])
def test_result_line(tiny, cell, trace):
    line = run_tiny(tiny, cell, trace=trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    assert "memory_peak_bytes" in line["device"]
    man = harness.manifest()
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        allowed = {m["name"] for m in
                   harness.cell_metrics(man, cell, "per_layer")}
        assert set(line["metrics"]) <= allowed
    else:
        want = {m["name"] for m in
                harness.cell_metrics(man, cell, "end_to_end")}
        assert set(line["metrics"]) == want
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name
    json.dumps(line)


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                        "--workload", SERVE, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 2 and r.stdout.strip() == ""


def test_run_fails_beside_only_its_own_files(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        SERVE, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], capture_output=True, text=True, cwd=tmp_path,
                       timeout=120, env={"PATH": "/usr/bin:/bin",
                                         "HOME": str(tmp_path)})
    assert r.returncode != 0 and r.stdout.strip() == ""


# ------------------------------------------------------------- imports
def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "perfbench").rglob("*.py"))
    assert files
    for f in files:
        bad = set(_imports(f)) & set(harness.FORBIDDEN)
        assert not bad, (f, bad)
        if f != Path(__file__):   # the JAX package's bench.py is not read
            assert "bench.py" not in f.read_text().replace(
                "perfbench", ""), f


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((ROOT / "perfbench" / "reference").rglob("*.py")):
        assert "ttsx_torch" not in set(_imports(f)), f


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ttsx_torch_like", sys)
    assert "ttsx" not in harness.forbidden_modules() or "ttsx" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()
