"""Training losses (``ttsx/train/losses.py``): the speaker encoder's
ArcFace and GE2E, the prosody predictor's weighted smooth L1, the
acoustic block's ``composite_acoustic_loss``, the refiner's
``refiner_loss`` and the vocoder GAN's hinge, feature-matching, warmup,
energy and R1 terms.

A masked mean divides by ``core.mesh.masked_denominator`` of its mask
sum: under a mesh of dp > 1 the global batch's, so that the ranks' mean
loss and gradient are the global batch's with masks of any lengths."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.core.mesh import masked_denominator


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-8)


def arcface_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                 weight: torch.Tensor, margin: float = 0.3,
                 scale: float = 30.0) -> torch.Tensor:
    """Cross entropy of ``scale`` x (cosine to each class's row of
    ``weight`` [num_classes, D], less ``margin`` on the target class)."""
    cos = _unit(embeddings) @ _unit(weight).T
    one_hot = F.one_hot(labels, cos.shape[-1]).to(cos.dtype)
    return F.cross_entropy((cos - one_hot * margin) * scale, labels)


def ge2e_loss(embeddings: torch.Tensor, labels: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Generalized end-to-end loss of a batch grouped by speaker (its
    groups read from ``labels`` by ``speaker_groups``): the cross entropy
    of |w| x cosine + b of each utterance against every speaker's
    centroid, its own speaker's centroid taken without itself. (The
    reference takes the group count from its caller, whose trainer ties
    it to the configured micro-batch.)"""
    n_speakers, m_utts = speaker_groups(labels)
    e = embeddings.reshape(n_speakers, m_utts, -1)
    own_centroid = (e.sum(dim=1, keepdim=True) - e) / (m_utts - 1)
    e_n, c_n = _unit(e), _unit(own_centroid)
    sim = torch.einsum("imd,kd->imk", e_n, _unit(e.mean(dim=1)))
    own = (e_n * c_n).sum(dim=-1)
    same = torch.eye(n_speakers, dtype=torch.bool, device=e.device)
    sim = torch.where(same[:, None, :], own[:, :, None], sim)
    logits = (w.abs() * sim + b).reshape(n_speakers * m_utts, n_speakers)
    labels = torch.arange(n_speakers, device=e.device).repeat_interleave(
        m_utts)
    return F.cross_entropy(logits, labels)


def speaker_groups(labels: torch.Tensor) -> Tuple[int, int]:
    """(speakers, utterances each) of a batch grouped by speaker: equal
    runs of at least two consecutive equal labels, each speaker in one
    run. Raises ``ValueError`` on any other batch."""
    lab = labels.detach().cpu().tolist()
    runs = []
    for x in lab:
        if runs and runs[-1][0] == x:
            runs[-1][1] += 1
        else:
            runs.append([x, 1])
    sizes = {n for _, n in runs}
    if (len(sizes) != 1 or sizes == {1} or len(runs) < 2
            or len({x for x, _ in runs}) != len(runs)):
        raise ValueError(f"GE2E needs a batch grouped by speaker (equal "
                         f"runs of two or more utterances, one run a "
                         f"speaker, two speakers or more); labels {lab}")
    return len(runs), sizes.pop()


def _smooth_l1(pred: torch.Tensor, target: torch.Tensor,
               beta: float = 1.0) -> torch.Tensor:
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)


def prosody_loss(pred: Dict[str, torch.Tensor],
                 target: Dict[str, torch.Tensor],
                 weights: Optional[Dict[str, float]] = None,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted smooth L1 (beta 1) over the six prosody outputs; the
    per-frame ones over the frames of ``mask`` [B, T] when given."""
    weights = weights or {}
    total = 0.0
    for key in ("f0", "energy", "pitch_var"):
        l = _smooth_l1(pred[key], target[key])
        if mask is not None:
            m = mask.to(l.dtype)
            l = (l * m).sum() / masked_denominator(m.sum())
        else:
            l = l.mean()
        total = total + weights.get(key, 1.0) * l
    for key in ("speech_rate", "pause_dur", "mfcc"):
        total = total + weights.get(key, 1.0) * _smooth_l1(
            pred[key], target[key]).mean()
    return total


def composite_acoustic_loss(out, target_mel: torch.Tensor, w_mel=1.0,
                            w_mse=1.0, w_disc=0.5, w_diff=1.0, w_emo=0.1,
                            emotion_pred=None, emotion_target=None,
                            mask: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, Dict]:
    """Mel L1 + MSE (over the frames of ``mask`` [B, T] when given) +
    LSGAN fake-as-real on the mel discriminator's logits + the
    noise-prediction energy + the optional emotion MSE."""
    if mask is not None:
        m = mask[..., None].to(target_mel.dtype)
        denom = masked_denominator(m.sum()) * target_mel.shape[-1]
        mel_l1 = ((out.mel - target_mel).abs() * m).sum() / denom
        mel_mse = (((out.mel - target_mel) ** 2) * m).sum() / denom
    else:
        mel_l1 = (out.mel - target_mel).abs().mean()
        mel_mse = ((out.mel - target_mel) ** 2).mean()
    adv = 0.0
    for fl in out.fake_logits:
        adv = adv + ((fl - 1.0) ** 2).mean()
    adv = adv / max(len(out.fake_logits), 1)
    diff = (out.noise_pred ** 2).mean()
    parts = {"mel_l1": mel_l1, "mel_mse": mel_mse, "adv": adv, "diff": diff}
    loss = w_mel * mel_l1 + w_mse * mel_mse + w_disc * adv + w_diff * diff
    if emotion_pred is not None and emotion_target is not None:
        emo = ((emotion_pred - emotion_target) ** 2).mean()
        parts["emo"] = emo
        loss = loss + w_emo * emo
    return loss, parts


def refiner_loss(mel_ref: torch.Tensor, mel_target: torch.Tensor,
                 vq_loss: torch.Tensor, l1_weight: float = 1.0,
                 sde_weight: float = 0.0, score=None, noise=None):
    """l1_weight * L1 + VQ commitment + sde_weight * mean((score + noise)^2)
    (score matching against the injected noise)."""
    l1 = (mel_ref - mel_target).abs().mean()
    loss = l1_weight * l1 + vq_loss
    parts = {"l1": l1, "vq": vq_loss}
    if score is not None and noise is not None:
        sde = ((score + noise) ** 2).mean()
        parts["sde"] = sde
        loss = loss + sde_weight * sde
    return loss, parts


# ------------------------------------------------------------------ the GAN
def hinge_d_loss(real_logits: Sequence[torch.Tensor],
                 fake_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean over the sub-discriminators of relu(1 - real) + relu(1 + fake)."""
    d = 0.0
    for r, f in zip(real_logits, fake_logits):
        d = d + torch.relu(1.0 - r).mean() + torch.relu(1.0 + f).mean()
    return d / max(len(real_logits), 1)


def hinge_g_loss(fake_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    g = 0.0
    for f in fake_logits:
        g = g - f.mean()
    return g / max(len(fake_logits), 1)


def log_rms_energy_loss(wav_fake: torch.Tensor, wav_real: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """L1 between the per-utterance log-RMS of [B, N, 1] waveforms."""
    rms_f = torch.sqrt(wav_fake.square().mean(dim=(1, 2)) + eps)
    rms_r = torch.sqrt(wav_real.square().mean(dim=(1, 2)) + eps)
    return (torch.log(rms_f) - torch.log(rms_r)).abs().mean()


def feature_matching_loss(fake_features, real_features) -> torch.Tensor:
    """Mean over every feature map of L1 between the fake map and the
    *detached* real one."""
    fm, n = 0.0, 0
    for ff, rf in zip(fake_features, real_features):
        for f, r in zip(ff, rf):
            fm = fm + (f - r.detach()).abs().mean()
            n += 1
    return fm / max(n, 1)


def adversarial_warmup(step: int, r1_interval: int) -> float:
    """min(1, step / (10 * r1_interval)): 0 at the generator's first step."""
    return min(1.0, step / (r1_interval * 10.0))


def r1_penalty(disc, wav_real: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of ||d(sum of ``disc``'s logits)/d wav||^2 on
    real waveforms, by double backward (the result carries a gradient to
    ``disc``'s parameters)."""
    w = wav_real.detach().requires_grad_()
    logits, _ = disc(w)
    return r1_from_scores(sum(l.sum() for l in logits), w)


def r1_from_scores(score: torch.Tensor, wav: torch.Tensor) -> torch.Tensor:
    """R1 of a scalar ``score`` computed from ``wav`` (requires grad)."""
    (g,) = torch.autograd.grad(score, wav, create_graph=True)
    return g.square().sum(dim=tuple(range(1, g.ndim))).mean()
