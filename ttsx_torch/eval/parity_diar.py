"""Hard diarization benchmark (``ttsx/eval/parity_diar.py``): many
speakers, noise and overlapped turns (6 speakers, 12 dB SNR, 30 %
overlapped onsets, 48 turns), where the learned parts (the trained slice
encoder, the learned overlap screen) can matter; trained against
untrained DER, the screened stack, a merge-threshold sweep, and the
overlap screens' interval precision / recall against the true overlap
regions (learned OverlapNet against the flux + energy heuristic).

Run: ``python -m ttsx_torch.eval.parity_aux --exp diarizer_hard``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ttsx_torch.eval.parity_common import (AUDIO, experiment_device,
                                           make_corpus)


def _interval_pr(dets: List[Tuple[float, float]],
                 truth: List[Tuple[float, float]]) -> Dict:
    """Interval-level precision/recall: a detection scores if it
    intersects any true overlap region, a truth region is recalled if
    any detection intersects it."""
    hit = lambda a, b: min(a[1], b[1]) > max(a[0], b[0])
    tp_d = sum(any(hit(d, t) for t in truth) for d in dets)
    tp_t = sum(any(hit(d, t) for d in dets) for t in truth)
    return {"precision": tp_d / max(len(dets), 1),
            "recall": tp_t / max(len(truth), 1),
            "n_detected": len(dets), "n_true": len(truth)}


def _train_slice_encoder(corpus, frames: int = 128, utts: int = 12,
                         steps: int = 400, batch: int = 16, seed: int = 0,
                         noise_db: Optional[float] = None,
                         export_slim: str = "", device="cuda"):
    """Train a diarizer-sized speaker encoder (ECAPA 256, 192-d) on the
    corpus speakers; returns (cfg, the encoder's flax variables tree) for
    ``SliceEmbedder``. With ``noise_db``, each utterance gets additive
    noise at a random SNR in [noise_db - 4, noise_db + 8] dB, matching a
    noisy target stream."""
    from ttsx_torch.core.config import RefEncConfig
    from ttsx_torch.train.refenc_trainer import RefEncTrainer
    from ttsx_torch.train.slim_export import save_slim
    from ttsx_torch.weights import to_flax

    dev = experiment_device(device)
    cfg = RefEncConfig(audio=AUDIO, speaker_dim=192, ecapa_channels=256,
                       num_speakers=corpus.n_speakers, warmup_steps=50,
                       total_steps=steps, eval_every=0)
    us = corpus.utterances(utts, frames, seed=seed)
    if noise_db is not None:
        rng_n = np.random.default_rng(seed + 17)
        noisy = []
        for u in us:
            snr = 10.0 ** (rng_n.uniform(noise_db - 4, noise_db + 8) / 20.0)
            w = u.wav + rng_n.normal(size=len(u.wav)).astype(np.float32) \
                * (np.std(u.wav) / snr)
            noisy.append(dataclasses.replace(u, wav=w.astype(np.float32)))
        us = noisy
    feats = corpus.features(us, device=dev)
    trainer = RefEncTrainer(cfg, dev, seed)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = rng.integers(0, len(feats["mel"]), batch)
        trainer.train_step(feats["mel"][idx], feats["speaker_id"][idx])
    if export_slim:
        # the meta records the non-default config the parameters need
        save_slim(export_slim, {
            "refenc": trainer.model,
            "_meta": {"speaker_dim": 192, "ecapa_channels": 256,
                      "num_speakers": corpus.n_speakers,
                      "steps": steps,
                      "noise_db": -1.0 if noise_db is None
                      else float(noise_db)}})
    return cfg, to_flax(trainer.model)


def diarizer_hard(n_speakers: int = 6, n_turns: int = 48,
                  noise_db: float = 12.0, overlap_prob: float = 0.3,
                  train_steps: int = 800, screen_steps: int = 300,
                  seed: int = 0, out_dir: Optional[str] = None,
                  corpus: str = "tone", export_slim: str = "",
                  device="cuda") -> Dict:
    """Trained-vs-untrained DER on the hard stream + overlap screen
    precision/recall (learned vs heuristic)."""
    import tempfile

    from ttsx_torch.data.dataset import write_wav
    from ttsx_torch.eval.metrics import diarization_error_rate
    from ttsx_torch.pipeline.diarizer.controller import DiarizerController
    from ttsx_torch.pipeline.diarizer.embedding import SliceEmbedder
    from ttsx_torch.pipeline.diarizer.overlap_net import (OverlapScreen,
                                                          train_overlap_net)

    dev = experiment_device(device)
    corpus_kind = corpus
    corpus = make_corpus(corpus, n_speakers=max(n_speakers, 4),
                         audio=AUDIO, seed=seed)
    wav, truth, ov_truth = corpus.dialogue_hard(
        list(range(n_speakers)), n_turns, noise_db=noise_db,
        overlap_prob=overlap_prob, seed=seed)
    out = Path(out_dir or tempfile.mkdtemp())
    wav_path = out / "dialogue_hard.wav"
    write_wav(wav_path, wav.astype(np.float32), AUDIO.sample_rate)

    def run(embedder, screen, tag, merge_thresh=0.75):
        # the production first pass: 1 s uniform windows + spectral
        # clustering with the eigengap count
        ctl = DiarizerController(AUDIO, embedder=embedder,
                                 min_dur=0.8, max_dur=3.0,
                                 overlap_screen=screen,
                                 cluster_merge_thresh=merge_thresh,
                                 cluster_method="spectral",
                                 subsegment_s=1.0, device=dev)
        res = ctl.diarize_single(str(wav_path), str(out / f"diar_{tag}"))
        hyp = [(s, e, spk) for (s, e), spk in
               zip(res.get("slices", []), res.get("speakers", []))]
        # overlap regions are multi-label: both detected speakers enter
        # the hypothesis
        hyp += [(s, e, spk) for s, e, sa, sb, _c in
                res.get("overlap_speakers", []) for spk in (sa, sb)]
        return res, {
            "der": float(diarization_error_rate(truth, hyp)),
            "der_collar_250ms": float(diarization_error_rate(
                truth, hyp, collar=0.25)),
            "n_hyp_speakers": len(set(res.get("speakers", []))),
            "n_slices": len(res.get("slices", []))}

    res_u, der_u = run(None, None, "untrained")
    cfg, params = _train_slice_encoder(corpus, steps=train_steps,
                                       seed=seed, noise_db=noise_db,
                                       export_slim=export_slim, device=dev)
    emb = SliceEmbedder(AUDIO, cfg=cfg, params=params, device=dev)
    res_t, der_t = run(emb, None, "trained")

    # the learned overlap screen: its own held-out window accuracy, then
    # stream-level precision/recall against the heuristic's
    net = train_overlap_net(corpus, AUDIO, steps=screen_steps, seed=seed,
                            device=dev)
    screen = OverlapScreen(AUDIO, net["params"], device=dev)
    res_s, der_s = run(emb, screen, "screened")

    # prototype-merge threshold sweep on the trained + screened stack
    merge_sweep = {}
    for th in (0.0, 0.65, 0.85):
        _, d = run(emb, screen, f"screened_m{int(th * 100)}",
                   merge_thresh=th)
        merge_sweep[f"{th:.2f}"] = d

    ov = lambda res: [(s, e) for (s, e, *_rest) in res.get("overlaps", [])]
    return {"exp": "diarizer_hard", "corpus": corpus_kind,
            "n_true_speakers": n_speakers, "n_turns": n_turns,
            "noise_db_snr": noise_db, "overlap_prob": overlap_prob,
            "n_true_overlaps": len(ov_truth),
            "untrained": der_u, "trained": der_t,
            "trained_screened": der_s,
            "merge_thresh_sweep": merge_sweep,
            "train_steps": train_steps,
            "overlap_window_eval": net["eval"],
            "overlap_stream_heuristic": _interval_pr(ov(res_t), ov_truth),
            "overlap_stream_learned": _interval_pr(ov(res_s), ov_truth)}
