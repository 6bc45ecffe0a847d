"""Training losses of the acoustic and refiner blocks
(``ttsx/train/losses.py``: ``composite_acoustic_loss``, ``refiner_loss``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


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
        denom = torch.clamp_min(m.sum(), 1.0) * target_mel.shape[-1]
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
