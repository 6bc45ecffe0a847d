"""A copy of the benchmark's tree at a tiny size, for the CPU tests.

``tiny_root(tmp)`` writes under ``tmp`` the manifest, the drivers, the
metric readers and the cells' files as they are, with each configuration
and traffic file replaced by a tiny one of the same name: the kernels'
flags and the S4 route as the real configurations set them, every width
small, a bucket of 2 x 12 frames and a wav tree of 8 short utterances at
16 kHz. The limits are the cells' own, but K3's: on the CPU the collator
runs K3's plain float32 version (``CPU_K3_GAP``).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.harness import ROOT

CPU_K3_GAP = 1e-3


def tiny_config(kernels: bool):
    from ttsx_torch.core import config as tc
    s4 = tc.S4Config(heads=2, norm_groups=2, causal=True, dropout=0.1,
                     kernel_mode="pallas" if kernels else "auto")
    return tc.TTSXConfig(
        audio=tc.AudioConfig(sample_rate=16000, n_fft=256, win_length=256,
                             hop_length=64, n_mels=80),
        acoustic=tc.AcousticConfig(text_emb_dim=16, hidden_channels=16,
                                   conformer_layers=1, transformer_dim=32,
                                   num_layers=2, attention_heads=2,
                                   speaker_dim=8),
        refiner=tc.RefinerConfig(levels=1, cond_dim=16, hidden_channels=16,
                                 hsf_hidden=8, style_dim=8, beta_hidden=8,
                                 s4=s4, sde_steps=2, vq_dims=(80,),
                                 vq_codes=(16,)),
        vocoder=tc.VocoderConfig(hidden_dim=16, cond_dim=8, style_dim=16,
                                 disc_ch_growth=2, disc_periods=(2, 3),
                                 disc_kernel_sizes=(15,), stft_sizes=(512,),
                                 use_pallas_upsample=kernels,
                                 use_pallas_resblock_stack=kernels,
                                 hop_length=64, sr=16000,
                                 upsample_factors=(4, 4, 2, 2)),
        train=tc.TrainConfig(warmup_steps=1, max_steps=100, val_freq=0,
                             checkpoint_freq=0, lr=1e-3, grad_accum_steps=2,
                             batch_size=4))


def tiny_root(tmp: Path) -> Path:
    from ttsx_torch.core.config import to_dict
    root = Path(tmp)
    (root / "perfbench").mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for d in ("drivers", "metrics", "workloads", "traffic", "configs"):
        shutil.copytree(ROOT / "perfbench" / d, root / "perfbench" / d,
                        dirs_exist_ok=True)
    man = json.loads((root / "BENCHMARK.json").read_text())
    for c in man["configs"]:
        path = root / c["file"]
        data = json.loads(path.read_text())
        kernels = data["config"]["vocoder"]["use_pallas_upsample"]
        data["config"] = to_dict(tiny_config(kernels))
        path.write_text(json.dumps(data))
    for w in man["workloads"]:
        path = root / "perfbench" / "traffic" / f"{w['traffic']}.json"
        tr = json.loads(path.read_text())
        if "frames" in tr:
            tr.update(batch=2, frames=12, pool=8, median_frames=6,
                      min_frames=3, max_frames=12, warmup_calls=1,
                      trace_from=1, trace_calls=2)
        else:
            tr.update(speakers=2, domains=["studio"], per_folder=2,
                      sample_rate=16000, min_s=0.3, max_s=0.6,
                      checked_steps=3, min_window_steps=2, trace_from=1,
                      trace_steps=1)
        path.write_text(json.dumps(tr))
        spec_path = root / "perfbench" / "workloads" / f"{w['name']}.json"
        spec = json.loads(spec_path.read_text())
        if "k3_gap" in spec["limits"]:
            # the CPU runs K3's plain float32 version, not the kernel's
            # float64 FFT: 1.4e-4 from the float64 log-mel at this size
            spec["limits"]["k3_gap"] = max(spec["limits"]["k3_gap"],
                                           CPU_K3_GAP)
            spec_path.write_text(json.dumps(spec))
    return root


def replace_config(root: Path, name: str, **changes) -> None:
    """Set ``changes`` (dotted keys into ``config``) in a tiny config."""
    man = json.loads((root / "BENCHMARK.json").read_text())
    path = root / {c["name"]: c["file"] for c in man["configs"]}[name]
    data = json.loads(path.read_text())
    for key, value in changes.items():
        node = data["config"]
        *parts, last = key.split(".")
        for p in parts:
            node = node[p]
        node[last] = value
    path.write_text(json.dumps(data))


