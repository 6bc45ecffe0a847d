"""Text -> mel0 -> refined mel -> style -> waveform (``ttsx/models/pipeline.py``)."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from ttsx_torch.core.config import TTSXConfig
from ttsx_torch.models.acoustic import AcousticModel
from ttsx_torch.models.refiner import ScoreSDERefiner
from ttsx_torch.models.vocoder import Generator
from ttsx_torch.nn.gst import GlobalStyleTokens


class SynthesisOutput(NamedTuple):
    wav: torch.Tensor       # [B, T*hop, 1]
    mel0: torch.Tensor      # [B, T, 80] coarse
    mel_ref: torch.Tensor   # [B, T, 80] refined
    duration: torch.Tensor  # [B, T]
    pitch: torch.Tensor     # [B, T]


class TTSPipeline(nn.Module):
    """The four synthesis modules under one config tree."""

    def __init__(self, cfg: TTSXConfig | None = None, *, acoustic=None,
                 refiner=None, gst=None, generator=None):
        super().__init__()
        self.cfg = cfg or TTSXConfig()
        c = self.cfg
        self.acoustic = acoustic or AcousticModel(c.acoustic)
        self.refiner = refiner or ScoreSDERefiner(
            c.refiner, c.acoustic.text_emb_dim, c.acoustic.cond_dim)
        self.gst = gst or GlobalStyleTokens(
            c.vocoder.channels, c.vocoder.style_dim, c.vocoder.num_style_tokens)
        self.generator = generator or Generator(
            c.vocoder, c.acoustic.cond_dim, c.acoustic.emotion_dim)
        self.eval()

    @torch.inference_mode()
    def synthesize(self, text_emb, prosody, emotion_probs, speaker, style_id,
                   use_sde: bool = False,
                   scale: Optional[torch.Tensor] = None) -> SynthesisOutput:
        """Single-pass synthesis; ``scale`` is the [B, 2*channels]
        conditioning of scale_cond generators."""
        if use_sde:
            raise NotImplementedError("sde_sample is not ported yet")
        ac = self.acoustic(text_emb, prosody, emotion_probs, speaker=speaker)
        mel_ref = self.refiner(ac.mel, prosody, style_id, text_emb).mel_ref
        style = self.gst(mel_ref)
        wav = self.generator(mel_ref, prosody, style, emotion_probs,
                             scale=scale)
        return SynthesisOutput(wav, ac.mel, mel_ref, ac.duration, ac.pitch)

    def with_vocoder_kernels(self, on: bool) -> "TTSPipeline":
        """A pipeline sharing this one's acoustic, refiner and GST modules,
        with a copy of the generator whose CUDA-kernel flags are ``on``
        (the flags change no parameter)."""
        vc = dataclasses.replace(self.cfg.vocoder, use_pallas_upsample=on,
                                 use_pallas_resblock_stack=on)
        c = self.cfg
        gen = Generator(vc, c.acoustic.cond_dim, c.acoustic.emotion_dim)
        gen.load_state_dict(self.generator.state_dict())
        dev = next(self.generator.parameters()).device
        return TTSPipeline(dataclasses.replace(c, vocoder=vc),
                           acoustic=self.acoustic, refiner=self.refiner,
                           gst=self.gst, generator=gen.to(dev))
