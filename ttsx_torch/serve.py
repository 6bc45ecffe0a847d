"""Fixed-bucket batched synthesis serving and the voice transform
(``ttsx/serve.py``).

Requests are padded into a (max_batch, frames) bucket, run through the
pipeline's ``synthesize`` (acoustic -> refiner -> GST + generator) on
the device, and trimmed back to ``len * hop`` samples each; batches above
``max_batch`` are split. On the card the server states full f32 numerics
(no TF32, bf16 products reduced in f32).

``bf16`` (the default, as in the reference) serves a copy of the
pipeline whose float32 parameters and VQ statistics are cast to bfloat16
(``weights.cast_float32``) and casts the float inputs to bfloat16. As in
the reference this is not bfloat16 compute: every layer promotes its
input and parameters as JAX does, so the graph returns to float32 at its
first float32 operand (the rotary tables, the refiner's mel, a norm's
statistics) and the stage outputs ``mel0``, ``mel_ref`` and the waveform
are float32.

``mesh`` (a ``ttsx_torch.core.mesh.Mesh`` on the server's device) serves
SPMD, one process per rank, as the reference shards its bucket over dp:
every rank holds the pipeline (broadcast from rank 0), pads the same
bucket, runs its rows of the dp axis inside ``with mesh:`` (where a
``band_tp`` generator also splits its bands over tp) and all-gathers the
waveforms, so ``serve_batch`` returns every request's waveform on every
rank; ``max_batch`` must split over dp. ``chain`` is accepted with the
reference's default: there it compiles the pipeline as three programs
instead of one, and eager PyTorch has no program to split, so both
values run the same calls and give the same waveforms.

Each bucket is one call: a ``serve.call`` span (its id the server's
call number) around ``serve.pad``, ``serve.upload``, ``serve.run``,
``serve.fetch`` (the device-to-host copy, which waits for the device)
and ``serve.trim``, with the counters ``serve.frames_requested`` (the
requests' frames) and ``serve.frames_run`` (``max_batch x frames``)
(``ttsx_torch.utils.spans``; recorded only while a recorder is on).

``make_voice_transform`` re-voices a mel: the refiner on zero text, the
target's style id, the generator with uniform emotion and the GST style
of the target's reference mel.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ttsx_torch.core.device import resolve_device, set_f32_numerics
from ttsx_torch.core.mesh import dp_rows
from ttsx_torch.models.pipeline import SynthesisOutput, TTSPipeline
from ttsx_torch.utils.spans import count, span
from ttsx_torch.weights import cast_float32


@dataclass
class SynthesisRequest:
    text_emb: np.ndarray       # [T, D]
    prosody: np.ndarray        # [T, 18]
    emotion_probs: np.ndarray  # [6]
    speaker: np.ndarray        # [Ds]
    style_id: int


class SynthesisServer:
    def __init__(self, pipe: TTSPipeline, device="cuda", max_batch: int = 8,
                 frames: int = 512, bf16: bool = True,
                 loudness_peak: Optional[float] = None,
                 scale_stats: Optional[np.ndarray] = None, mesh=None,
                 chain: bool = True):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_numerics()
        self.cfg = pipe.cfg
        self.mesh, self.chain = mesh, chain
        pipe = pipe.to(self.device)
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh is on {mesh.device}, the server "
                                 f"on {self.device}")
            if max_batch % mesh.dp:
                raise ValueError(f"max_batch {max_batch} does not split "
                                 f"over dp={mesh.dp}")
            from ttsx_torch.parallel import replicate
            replicate(pipe, mesh)
        # the caller's pipeline keeps its dtypes; the server casts a copy
        self.pipe = (cast_float32(copy.deepcopy(pipe), torch.bfloat16)
                     if bf16 else pipe)
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        # a scale_cond generator needs [mean || std] mel stats; a text->wav
        # request has no target utterance, so the train-corpus mean vector
        # (the export meta's `mel_scale_mean`) is required
        if self.cfg.vocoder.scale_cond:
            if scale_stats is None:
                raise ValueError(
                    "cfg.vocoder.scale_cond is on: pass scale_stats "
                    "([2*channels] train-corpus mean mel [mean||std], e.g. "
                    "the vocoder export's `mel_scale_mean` meta)")
            scale_stats = torch.as_tensor(
                np.asarray(scale_stats, np.float32).reshape(-1),
                device=self.device)
        self.scale_stats = scale_stats
        self.max_batch = max_batch
        self.frames = frames
        self.loudness_peak = loudness_peak
        self.calls = 0          # buckets served: the id of a call's spans

    def pad_batch(self, reqs: Sequence[SynthesisRequest]):
        """Numpy (text, prosody, emotion, speaker, style_id, lens) of the
        first ``max_batch`` requests, zero-padded to ``frames``."""
        B, T = self.max_batch, self.frames
        ac = self.cfg.acoustic
        text = np.zeros((B, T, ac.text_emb_dim), np.float32)
        pros = np.zeros((B, T, ac.cond_dim), np.float32)
        emo = np.full((B, ac.emotion_dim), 1 / ac.emotion_dim, np.float32)
        spk = np.zeros((B, ac.speaker_dim), np.float32)
        sid = np.zeros((B,), np.int64)
        lens = np.zeros(B, np.int64)
        for i, r in enumerate(reqs[:B]):
            t = min(len(r.text_emb), T)
            text[i, :t] = r.text_emb[:t]
            pros[i, :t] = r.prosody[:t]
            emo[i] = r.emotion_probs
            spk[i] = r.speaker
            sid[i] = r.style_id
            lens[i] = t
        return text, pros, emo, spk, sid, lens

    @torch.inference_mode()
    def stages(self, text, pros, emo, spk, sid) -> SynthesisOutput:
        """The padded batch, its float inputs cast to the server's dtype,
        through ``TTSPipeline.synthesize``, each output in the dtype the
        stage gives."""
        scale = (None if self.scale_stats is None
                 else self.scale_stats.expand(text.shape[0], -1))
        return self.pipe.synthesize(
            *(a.to(self.dtype) for a in (text, pros, emo, spk)), sid,
            scale=scale)

    def run(self, text, pros, emo, spk, sid) -> torch.Tensor:
        """The padded batch through ``stages`` -> float32 wav
        [B, T*hop, 1]; under a mesh, this rank's rows through ``stages``
        and the whole batch's wav gathered over dp."""
        arrays = (text, pros, emo, spk, sid)
        if self.mesh is None:
            return self.stages(*arrays).wav.float()
        with self.mesh:
            wav = self.stages(*(dp_rows(a, self.mesh) for a in arrays))
            return self.mesh.all_gather(wav.wav.float(), "dp")

    def serve_batch(self, reqs: Sequence[SynthesisRequest]) -> List[np.ndarray]:
        if len(reqs) > self.max_batch:
            out: List[np.ndarray] = []
            for i in range(0, len(reqs), self.max_batch):
                out.extend(self.serve_batch(reqs[i:i + self.max_batch]))
            return out
        with span("serve.call", id=self.calls):
            self.calls += 1
            with span("serve.pad"):
                *arrays, lens = self.pad_batch(reqs)
            count("serve.frames_requested", int(lens.sum()))
            count("serve.frames_run", self.max_batch * self.frames)
            with span("serve.upload"):
                tensors = [torch.as_tensor(a, device=self.device)
                           for a in arrays]
            with span("serve.run"):
                wav = self.run(*tensors)
            with span("serve.fetch"):
                wav = wav.cpu().numpy()
            with span("serve.trim"):
                hop = self.cfg.vocoder.hop_length
                outs = [wav[i, :int(lens[i]) * hop, 0]
                        for i in range(len(reqs))]
                if self.loudness_peak is not None:
                    outs = [w * (self.loudness_peak
                                 / max(float(np.abs(w).max()), 1e-8))
                            for w in outs]
        return outs


def make_voice_transform(pipe: TTSPipeline, prosody_model=None,
                         prosody_params=None):
    """``fn(mel_src [B, T, C], prosody_src [B, T, P], style_id_tgt [B],
    ref_mel_tgt [B, T', C]) -> wav [B, T*hop, 1]``: re-voices the source
    mel with the target's style embedding (``style_id_tgt``) and the
    timbre the GST takes from ``ref_mel_tgt``. The refiner runs on zero
    text embeddings, the generator on uniform emotion and without scale
    conditioning (zeros for a scale_cond generator), as in the reference.
    Tensors on the pipeline's device; it computes with the pipeline's
    parameters as they are (a bf16 server's ``pipe`` for bf16).
    ``prosody_model`` and ``prosody_params`` are accepted and unused, as
    there."""
    ac = pipe.cfg.acoustic

    @torch.inference_mode()
    def fn(mel_src, prosody_src, style_id_tgt, ref_mel_tgt):
        B, T, _ = mel_src.shape
        ref = pipe.refiner(mel_src, prosody_src, style_id_tgt,
                           mel_src.new_zeros(B, T, ac.text_emb_dim))
        style = pipe.gst(ref_mel_tgt)
        emo = mel_src.new_full((B, ac.emotion_dim), 1.0 / ac.emotion_dim)
        return pipe.generator(ref.mel_ref, prosody_src, style, emo)

    return fn
