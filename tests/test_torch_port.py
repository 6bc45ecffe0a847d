"""The port as a package: it imports nothing of JAX or ``ttsx``, loads the
checked-in zoo whole with numpy alone, refuses partial weights, and
serves requests in fixed buckets."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity_helpers import randn

from ttsx_torch.core.config import zoo_cfg
from ttsx_torch.weights import WeightMismatch, from_flax, load_slim_npz

REPO = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys
BLOCK = {"jax", "jaxlib", "flax", "optax", "orbax", "ttsx"}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
import ttsx_torch
names = [m.name for m in pkgutil.walk_packages(ttsx_torch.__path__,
                                               "ttsx_torch.")]
assert {"ttsx_torch.pipeline.diarizer.controller",
        "ttsx_torch.pipeline.orchestrator", "ttsx_torch.pipeline.asr",
        "ttsx_torch.cli.observer", "ttsx_torch.cli.refenc",
        "ttsx_torch.cli.bench", "ttsx_torch.eval.benchmarks",
        "ttsx_torch.eval.export", "ttsx_torch.eval.acoustic_eval",
        "ttsx_torch.data.prefetch", "ttsx_torch.data.formantcorpus",
        "ttsx_torch.train.observer",
        "ttsx_torch.utils.check_file_sizes", "ttsx_torch.core.mesh",
        "ttsx_torch.parallel", "ttsx_torch.parallel.data_parallel",
        "ttsx_torch.parallel.dryrun", "ttsx_torch.parallel.spawn",
        "ttsx_torch.native",
        "ttsx_torch.native.build", "ttsx_torch.train.slim_export"} | {
        f"ttsx_torch.eval.{m}" for m in (
            "parity_common", "parity", "parity_aux", "parity_refenc",
            "parity_prosody", "parity_vocoder", "parity_e2e", "parity_diar",
            "record_baseline", "rule_calibration")} <= set(names)
for n in names:
    importlib.import_module(n)
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in BLOCK]
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax_or_ttsx():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20


def test_zoo_loads_whole_into_port():
    """All three synthesis exports at the zoo config: no unused key, no
    unfilled parameter, every shape equal (numpy only, no JAX)."""
    from ttsx_torch.models.pipeline import TTSPipeline
    from ttsx_torch.zoo import load_zoo_trees
    trees = load_zoo_trees()
    pipe = TTSPipeline(zoo_cfg())
    for name in ("acoustic", "refiner", "generator", "gst"):
        module = getattr(pipe, name)
        state = from_flax(module, trees[name])
        want = module.state_dict()
        assert set(state) == set(want)
        assert all(state[k].shape == want[k].shape for k in want)
    assert trees["vocoder_meta"]["mel_scale_mean"].shape == (160,)
    n_vq = sum(1 for k in pipe.refiner.state_dict() if k.startswith("vq."))
    assert n_vq == 6  # 3 stages x (embed_sum, cluster_size) from vq_stats


def _conv_tree():
    return {"params": {"Conv_0": {"kernel": randn(0, 3, 4, 2),
                                  "bias": randn(1, 2)}}}


def test_from_flax_refuses_unused_and_missing_keys():
    from ttsx_torch.nn.conv import Conv1d
    m = Conv1d(4, 2, 3)
    assert set(from_flax(m, _conv_tree())) == {"weight", "bias"}
    extra = _conv_tree()
    extra["params"]["Conv_0"]["stray"] = randn(2, 2)
    extra["params"]["Dense_9"] = {"kernel": randn(3, 2, 2)}
    with pytest.raises(WeightMismatch, match="stray.*Dense_9|Dense_9.*stray"):
        from_flax(m, extra)
    short = _conv_tree()
    del short["params"]["Conv_0"]["bias"]
    with pytest.raises(WeightMismatch, match="bias"):
        from_flax(m, short)
    wrong = _conv_tree()
    wrong["params"]["Conv_0"]["kernel"] = randn(0, 5, 4, 2)
    with pytest.raises(ValueError, match="weight"):
        from_flax(m, wrong)


def test_load_slim_npz_reads_reference_exports(tmp_path):
    """The port's own parser of ``save_slim`` files: nested keys, f16
    leaves back as f32, ``_meta`` entries."""
    from ttsx.train.slim_export import save_slim
    big = randn(3, 40, 40)
    path = str(tmp_path / "x.npz")
    save_slim(path, {"gen": {"params": {"a": {"kernel": big},
                                        "b": np.float32(2.5)}},
                     "_meta": {"steps": np.int64(7)}})
    got = load_slim_npz(path)
    assert got["gen"]["params"]["a"]["kernel"].dtype == np.float32
    np.testing.assert_allclose(got["gen"]["params"]["a"]["kernel"], big,
                               atol=2e-3)
    assert float(got["gen"]["params"]["b"]) == 2.5
    assert int(got["_meta"]["steps"]) == 7


# ------------------------------------------------------------------ serving
def _tiny_pipe():
    from ttsx_torch.core import config as tc
    from ttsx_torch.models.pipeline import TTSPipeline
    torch.manual_seed(0)
    cfg = tc.TTSXConfig(
        acoustic=tc.AcousticConfig(text_emb_dim=12, speaker_dim=4,
                                   hidden_channels=16, conformer_layers=1,
                                   attention_heads=2, transformer_dim=24,
                                   num_layers=1),
        refiner=tc.RefinerConfig(
            levels=1, cond_dim=16, beta_hidden=8, hsf_hidden=16,
            hsf_layers=3, hsf_kernel=3, style_dim=8, num_styles=5,
            vq_dims=(80,), vq_codes=(8,),
            s4=tc.S4Config(heads=2, l_max=16, causal=True, norm_groups=4)),
        vocoder=tc.VocoderConfig(hidden_dim=32, cond_dim=16, style_dim=8,
                                 upsample_factors=(4, 2, 2, 2),
                                 hop_length=32, scale_cond=True,
                                 use_pallas_upsample=True,
                                 use_pallas_resblock_stack=True))
    return TTSPipeline(cfg)


def _requests(lens, cfg):
    from ttsx_torch.serve import SynthesisRequest
    ac = cfg.acoustic
    return [SynthesisRequest(randn(10 + i, n, ac.text_emb_dim),
                             randn(20 + i, n, ac.cond_dim),
                             np.eye(ac.emotion_dim, dtype=np.float32)[i],
                             randn(30 + i, ac.speaker_dim), i)
            for i, n in enumerate(lens)]


def test_server_buckets_splits_and_trims():
    """3 requests into buckets of 2 x 16 frames: split in two batches,
    each output trimmed to len * hop and equal to running its padded
    bucket through the pipeline."""
    from ttsx_torch.serve import SynthesisServer
    pipe = _tiny_pipe()
    stats = randn(5, 160)
    srv = SynthesisServer(pipe, device="cpu", max_batch=2, frames=16,
                          scale_stats=stats)
    reqs = _requests([16, 10, 5], pipe.cfg)
    outs = srv.serve_batch(reqs)
    assert [len(o) for o in outs] == [16 * 32, 10 * 32, 5 * 32]
    assert all(np.isfinite(o).all() for o in outs)
    *arrays, lens = srv.pad_batch(reqs[2:])
    assert list(lens) == [5, 0]
    wav = srv.run(*(torch.as_tensor(a) for a in arrays))
    np.testing.assert_array_equal(outs[2], wav[0, :5 * 32, 0].numpy())
    peak = SynthesisServer(pipe, device="cpu", max_batch=2, frames=16,
                           scale_stats=stats, loudness_peak=0.5)
    for o in peak.serve_batch(reqs[:2]):
        assert abs(float(np.abs(o).max()) - 0.5) < 1e-6


def test_server_refuses_what_it_cannot_do():
    from ttsx_torch.serve import SynthesisServer
    pipe = _tiny_pipe()
    with pytest.raises(ValueError, match="scale_stats"):
        SynthesisServer(pipe, device="cpu")
    # bf16 serving is ported: the server builds and serves a request
    srv = SynthesisServer(pipe, device="cpu", bf16=True, max_batch=1,
                          frames=8, scale_stats=randn(0, 160))
    (wav,) = srv.serve_batch(_requests([8], pipe.cfg))
    assert wav.dtype == np.float32 and wav.shape == (8 * 32,)
    assert np.isfinite(wav).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SynthesisServer(pipe, scale_stats=randn(0, 160))
        from ttsx_torch.zoo import serve_from_zoo
        with pytest.raises(RuntimeError, match="cuda"):
            serve_from_zoo()
