"""Configuration dataclasses of the synthesis chain and its trainer.

A stdlib-only copy of the part of ``ttsx.core.config`` that synthesis and
the trainers read: ``AudioConfig``, ``S4Config``, ``RefEncConfig`` (the
speaker encoder), ``ProsodyConfig`` (the prosody predictor),
``AcousticConfig``, ``RefinerConfig``, ``VocoderConfig``, ``NovelConfig``,
``TrainConfig``, ``DiarizerConfig`` (the speaker diarizer),
``PipelineConfig`` (the observer pipeline), ``MeshConfig`` (the dp x tp
grid of ``ttsx_torch.core.mesh``) and a ``TTSXConfig`` root holding them
all. Field
names and defaults are the reference's, so a dict written by
``ttsx.core.config.to_dict`` loads here through ``from_dict`` (keys this
tree does not carry are ignored) and back; ``save_config`` and
``load_config`` write and read such a dict as YAML or JSON.

In this package ``VocoderConfig.use_pallas_upsample`` and
``use_pallas_resblock_stack`` select the hand-written CUDA kernels
(``ttsx_torch/ops``) in place of the plain PyTorch path; the names are
kept so configs stay interchangeable.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class AudioConfig:
    sample_rate: int = 22050
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    f_min: float = 0.0
    f_max: Optional[float] = 8000.0
    log_eps: float = 1e-5
    mel_normalize: bool = True  # per-bin mean/std over time


@dataclass(frozen=True)
class S4Config:
    heads: int = 4
    l_max: int = 1024
    rank: int = 1
    dropout: float = 0.1
    norm_groups: int = 8
    causal: bool = False
    # 'auto' and 'fft' run the rFFT long convolution; 'scan' the causal
    # recurrence in plain PyTorch, 'pallas' the same through kernel K4.
    kernel_mode: str = "auto"


@dataclass(frozen=True)
class RefEncConfig:
    """The speaker-embedding encoder and its trainer."""
    audio: AudioConfig = field(default_factory=AudioConfig)
    speaker_dim: int = 256
    backbone: str = "ecapa_tdnn"  # res2net | conformer | ecapa_tdnn | ssl_host
    pooling: str = "multi_head_attentive"  # self_attentive | stats
    pooling_heads: int = 4
    loss: str = "arcface"  # arcface | ge2e
    arcface_margin: float = 0.3
    # linear 0 -> arcface_margin over this many steps (0: fixed margin)
    arcface_margin_warmup: int = 0
    arcface_scale: float = 30.0
    ge2e_init_w: float = 10.0
    ge2e_init_b: float = -5.0
    num_speakers: int = 256
    ecapa_channels: int = 512
    conformer_layers: int = 4
    conformer_heads: int = 4
    conformer_ff: int = 256
    dropout: float = 0.1
    micro_batch: int = 8
    grad_accum: int = 16
    warmup_steps: int = 5000
    total_steps: int = 200_000
    lr: float = 1e-4
    grad_clip: float = 3.0
    checkpoint_every: int = 5000
    eval_every: int = 5000
    augment: bool = True


@dataclass(frozen=True)
class ProsodyConfig:
    """The S4 prosody predictor and its loss weights."""
    audio: AudioConfig = field(default_factory=AudioConfig)
    mel_dim: int = 80
    cond_dim: int = 256
    n_layers: int = 4
    n_freq: int = 80
    n_mfcc: int = 13
    dropout: float = 0.1
    s4: S4Config = field(default_factory=S4Config)
    f0_weight: float = 1.0
    energy_weight: float = 1.0
    pitch_var_weight: float = 1.0
    speech_rate_weight: float = 1.0
    pause_dur_weight: float = 1.0
    mfcc_weight: float = 1.0


@dataclass(frozen=True)
class AcousticConfig:
    text_emb_dim: int = 384
    cond_dim: int = 18          # 5 prosody scalars + 13 mfcc
    speaker_dim: int = 16
    emotion_dim: int = 6
    hidden_channels: int = 256
    mel_dim: int = 80
    conformer_layers: int = 6
    attention_heads: int = 4
    transformer_dim: int = 512  # conformer ffn width
    kernel_size: int = 5
    num_layers: int = 4         # FiLM residual conv blocks
    dropout: float = 0.1
    diffusion_steps: int = 10
    base_sd_prob: float = 0.1
    layer_scale_init: float = 1e-4
    prune_ratio: float = 0.2
    ci_latency_factor: float = 20.0
    profile: bool = False
    w_mel: float = 1.0
    w_mse: float = 1.0
    w_disc: float = 0.5
    w_diff: float = 1.0
    w_emo: float = 0.1


@dataclass(frozen=True)
class RefinerConfig:
    bands: Tuple[int, ...] = (24, 28, 28)
    levels: int = 2
    flows: int = 3
    cond_dim: int = 256
    time_dim: int = 256
    beta_hidden: int = 64
    hidden_channels: int = 512
    hsf_hidden: int = 256
    hsf_layers: int = 4
    hsf_kernel: int = 5
    style_dim: int = 128
    num_styles: int = 100
    vq_dims: Tuple[int, ...] = (80, 80, 80)
    vq_codes: Tuple[int, ...] = (512, 512, 512)
    cnf_dim: int = 80
    s4: S4Config = field(default_factory=lambda: S4Config(
        heads=4, l_max=1024, dropout=0.1, causal=True, norm_groups=4))
    sde_steps: int = 8
    sde_sigma: float = 0.5
    max_avg_time: float = 0.5
    benchmark_runs: int = 5
    profile: bool = False

    def __post_init__(self):
        if sum(self.bands) != self.cnf_dim:
            raise ValueError(
                f"Sum of bands {sum(self.bands)} != cnf_dim {self.cnf_dim}")
        if self.benchmark_runs < 1:
            raise ValueError("benchmark_runs must be >= 1")
        if len(self.vq_dims) != len(self.vq_codes):
            raise ValueError("vq_dims and vq_codes length must match")


@dataclass(frozen=True)
class VocoderConfig:
    channels: int = 80
    cond_dim: int = 128
    style_dim: int = 128
    hidden_dim: int = 256
    num_bands: int = 4
    upsample_factors: Tuple[int, ...] = (8, 8, 2, 2)
    res_dilations: Tuple[int, ...] = (1, 3, 5)
    disc_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    disc_kernel_sizes: Tuple[int, ...] = (15, 41, 41)
    disc_ch_growth: int = 4
    sr: int = 22050
    hop_length: int = 256
    stft_sizes: Tuple[int, ...] = (512, 1024, 2048)
    stft_log_mag: bool = True
    num_style_tokens: int = 10
    dropout_prob: float = 0.1
    r1_gamma: float = 10.0
    r1_interval: int = 16
    lambda_stft: float = 2.0
    lambda_pitch: float = 1.0
    lambda_dur: float = 1.0
    lambda_fm: float = 2.0
    lambda_energy: float = 0.0
    # absolute-scale conditioning: the generator takes per-utterance mel
    # stats [mean || std] ([B, 2*channels]) through a `scale_proj` Dense
    scale_cond: bool = False
    ema_decay: float = 0.999
    # True: the ConvT upsample runs the CUDA kernel K1 (ops/upsample.py)
    use_pallas_upsample: bool = False
    # True: each stage's FiLM resblocks run as one CUDA kernel K2
    # (ops/resblock_stack.py)
    use_pallas_resblock_stack: bool = False
    # True: under an active mesh with tp > 1, tp rank t runs bands
    # [t*nb/tp, (t+1)*nb/tp) through the shared tower (models/vocoder.py)
    band_tp: bool = False
    remat: bool = False


@dataclass(frozen=True)
class NovelConfig:
    """The trainer's toggles (``sde_noise_annealing``: the refiner's noise
    scale and L1 weight follow the validation L1; ``ema_swap_validate``:
    validate on EMA weights where a block keeps them; ``dynamic_gan``: the
    vocoder's discriminator steps follow the ratio of its loss EMAs)."""
    sde_noise_annealing: bool = True
    dynamic_gan: bool = True
    ema_swap_validate: bool = True


@dataclass(frozen=True)
class TrainConfig:
    max_steps: int = 200_000
    grad_accum_steps: int = 2
    batch_size: int = 16
    lr: float = 2e-4
    weight_decay: float = 1e-2
    warmup_steps: int = 1000
    grad_clip: float = 1.0
    val_freq: int = 1000
    checkpoint_freq: int = 5000
    refiner_update_freq: int = 2
    vocoder_freeze_until: int = 0
    gan_d_steps: int = 1
    seed: int = 42
    bf16: bool = True      # carried for interchange: the reference
    remat: bool = True     # trainer reads neither; the port trains in f32
    novel: NovelConfig = field(default_factory=NovelConfig)
    log_tensorboard: bool = True
    log_csv: bool = True
    log_wandb: bool = False


@dataclass(frozen=True)
class DiarizerConfig:
    """The speaker diarizer (``ttsx.core.config.DiarizerConfig``)."""
    min_slice_dur: float = 1.5
    max_slice_dur: float = 6.0
    prob_thresh: float = 0.5
    merge_gap: float = 0.2
    pad: float = 0.1
    snr_db: float = 5.0
    overlap_sim_thresh: float = 0.5
    voiceprint_thresh: float = 0.6     # ReID match threshold
    memory_size: int = 10
    chunk_s: float = 60.0
    long_audio_s: float = 3600.0
    certainty_floor: float = 0.7
    cluster_method: str = "modularity"  # modularity | kmeans | spectral
    # post-cluster prototype-cosine merge threshold (<= 0 disables)
    cluster_merge_thresh: float = 0.75
    embed_dim: int = 192
    batch_size: int = 1
    dtype: str = "float32"


@dataclass(frozen=True)
class PipelineConfig:
    """The observer pipeline's settings
    (``ttsx.core.config.PipelineConfig``)."""
    diarizer: DiarizerConfig = field(default_factory=DiarizerConfig)
    drift_window: int = 50
    drift_k_sigma: float = 2.0
    beats_per_arc: int = 3
    arc_seconds_per_cluster: float = 300.0
    validation_frac: float = 0.05
    validation_cap: int = 500
    rule_ema_alpha: float = 0.9
    accuracy_drop_alert: float = 0.05
    git_push_retries: int = 3
    chunk_bytes: int = 1_000_000_000   # >1 GB wavs get chunk-processed
    transcription_chunk_s: float = 600.0


@dataclass(frozen=True)
class MeshConfig:
    """The (dp, tp) grid of ranks (``ttsx_torch.core.mesh.make_mesh``):
    dp -1 takes every rank that tp does not."""
    dp: int = -1
    tp: int = 1
    axis_names: Tuple[str, ...] = ("dp", "tp")


@dataclass(frozen=True)
class TTSXConfig:
    audio: AudioConfig = field(default_factory=AudioConfig)
    ref_enc: RefEncConfig = field(default_factory=RefEncConfig)
    prosody: ProsodyConfig = field(default_factory=ProsodyConfig)
    acoustic: AcousticConfig = field(default_factory=AcousticConfig)
    refiner: RefinerConfig = field(default_factory=RefinerConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)


def to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def from_dict(cls, data: dict):
    kwargs = {}
    for f in fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        if is_dataclass(default):
            kwargs[f.name] = from_dict(type(default), v)
        elif isinstance(default, tuple) and isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def save_config(cfg: Any, path: str | Path) -> None:
    """``to_dict(cfg)`` as YAML for a ``.yaml`` / ``.yml`` path (``yaml``
    imported here, its ``ImportError`` raised where it is missing), else
    as JSON."""
    path = Path(path)
    data = to_dict(cfg)
    if path.suffix in (".yaml", ".yml"):
        import yaml
        path.write_text(yaml.safe_dump(data, sort_keys=False))
    else:
        path.write_text(json.dumps(data, indent=2))


def load_config(path: str | Path, cls=TTSXConfig):
    """``from_dict(cls, ...)`` of a YAML (by suffix, as ``save_config``)
    or JSON file."""
    path = Path(path)
    text = path.read_text()
    if path.suffix in (".yaml", ".yml"):
        import yaml
        data = yaml.safe_load(text)
    else:
        data = json.loads(text)
    return from_dict(cls, data)


def tts_cfg(levels: int = 2) -> TTSXConfig:
    """The chain the zoo was trained with, and its trainer settings
    (``ttsx.eval.parity._tts_cfg``)."""
    return TTSXConfig(
        acoustic=AcousticConfig(text_emb_dim=256, speaker_dim=16),
        refiner=RefinerConfig(
            levels=levels,
            s4=S4Config(heads=4, l_max=1024, causal=True, norm_groups=4,
                        dropout=0.1)),
        vocoder=VocoderConfig(),
        train=TrainConfig(warmup_steps=100, max_steps=100_000, lr=2e-4),
    )


def zoo_cfg(kernels: bool = True, vocoder_overrides: dict | None = None
            ) -> TTSXConfig:
    """``tts_cfg()`` plus a zoo.json's vocoder overrides, by default the
    checked-in zoo's (``scale_cond``, ``lambda_energy``), with both CUDA
    kernel flags set to ``kernels``.

    The flags change no parameter, so the zoo weights load either way."""
    cfg = tts_cfg()
    if vocoder_overrides is None:
        vocoder_overrides = {"scale_cond": True, "lambda_energy": 1.0}
    known = {f.name for f in fields(VocoderConfig)}
    ov = {k: v for k, v in vocoder_overrides.items() if k in known}
    ov.update(use_pallas_upsample=kernels, use_pallas_resblock_stack=kernels)
    return dataclasses.replace(
        cfg, vocoder=dataclasses.replace(cfg.vocoder, **ov))
