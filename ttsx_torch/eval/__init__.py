"""Evaluation of the port (``ttsx/eval``): the EER, MCD, DER, purity and
silhouette metrics; host-clock timers and the CI gates; the acoustic
model's evaluation and microbenchmarks; ``torch.export`` programs in
place of the reference's StableHLO (``export_pt2`` and ``load_pt2`` take
the places of ``export_stablehlo`` and ``load_stablehlo``)."""
from ttsx_torch.eval.metrics import (
    compute_eer, all_pairs_eer, mel_cepstral_distortion,
    diarization_error_rate, cluster_purity, silhouette_score)
from ttsx_torch.eval.benchmarks import (
    time_fn, rtf, ci_latency_gate, time_budget_gate, CIGateError)
from ttsx_torch.eval.acoustic_eval import (
    evaluate_acoustic, microbenchmarks, MOS_PLACEHOLDER)
from ttsx_torch.eval.export import (
    export_pt2, load_pt2, aot_compile, export_reference_encoder)
