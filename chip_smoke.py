#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``ttsx_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Phases, one JSON line each:

1. env: torch/CUDA versions, the card, ``nvidia-smi`` name and power limit,
   and its clocks, power draw, temperature and throttle reasons
   (``gpu_state``, read again before and after the train and timing
   phases).
2. build: nvcc of every ``ttsx_torch/ops/csrc/*.cu`` (in parallel) and the
   ptxas register / shared-memory / spill lines of each kernel.
3. kernels: K1 (ConvT upsample) and K2 (FiLM resblock stack) against
   their plain PyTorch versions on the card, at the four generator stage
   shapes of one 10 s request (864 mel frames, 4 bands folded into the
   batch: B*4 = 4) and of the serving bucket (4 requests: B*4 = 16),
   within stated tolerances. On the zoo's own weights (the pipeline
   loaded with the refiner's S4 layers in ``kernel_mode="pallas"``): K4
   (the S4 recurrence) against ``scan_dw_conv`` at the refiner's 15 S4
   layer shapes, T = 864, batch 1 and 4, on LayerNorm-scale noise; K5
   (one FiLM resblock) against its plain version at the 12 generator
   block shapes of batch 1 and 4; per stage, three K5 launches against
   one K2 launch on the same input and weights.
3b. mel_frontend: K3 (the collator's log-mel, a float64 FFT) on a batch
   of 16 wavs of 1.5-4.4 s (tones and noise, zero-padded to the
   trainer's largest bucket, 98,304 samples) and on one 10 s clip, held
   to a four-part gate (``k3_check``): (1) every value within a stated
   tolerance of the float64 log-mel computed on the host; (2) K3's worst
   |error| from it no larger than the plain version's, on the tone rows,
   the noise rows and the clip each; (3) K3 against its plain version
   within the same tolerance on the noise rows and the clip, where plain
   is itself within 1e-5 of float64 (not on tone rows: there plain's
   dense f32 sums are up to 5e-2 from the exact log-mel on near-silent
   bands); (4) on the frames that read only zeros (reflect padding
   included) K3 against plain within 1e-5. Both routes' distances from
   float64 are printed.
4. serve: ``serve_from_zoo(device="cuda", bf16=False, max_batch=4,
   frames=864)`` on the checked-in zoo model serves 3 requests (864, 600,
   300 frames, made from ``--seed``): finite, non-silent waveforms of
   ``len * 256`` samples; the launch counters, zeroed just before, show
   K1 and K2 ran 4 times each; the same requests through the generator
   with both kernel flags off (plain PyTorch on the card) give the same
   waveforms within a stated tolerance.
4b. sde: the zoo loaded with the refiner's S4 layers in ``pallas`` (K4)
   and in ``fft`` mode synthesizes with ``use_sde=True`` on the same
   noise one 864-frame request and the 3-request bucket: finite,
   non-silent waveforms of ``len * 256`` samples; per synthesize call K4
   launches 8 passes x 15 layers = 120 times, K1 and K2 4, K3 and K5 0,
   and the fft pipeline no K4; the two routes agree on ``mel_ref`` and
   the waveform within stated tolerances. The generator's per-block route
   (every block on K5: 12 launches, no K2) on the request's refined mel
   agrees with the K2 route. ``main_synth --zoo --sde --frames 864
   --device cuda`` writes one wav and prints its JSON line.
4c. serve_bf16: the same requests through ``serve_from_zoo(device="cuda",
   bf16=True, ...)`` (the reference's default: float32 parameters and VQ
   statistics cast to bfloat16, float inputs cast, every layer promoting
   as JAX does): finite, non-silent waveforms of ``len * 256`` samples;
   K1 and K2 launched 4 times each; mel0, mel_ref and the waveform
   float32, as in the reference; the same bf16 server with both kernel
   flags off within phase 4's tolerance; and each request's distance from
   phase 4's f32 waveform at most 1.5 times and at least 0.5 times the
   reference's own |bf16 - f32| on that request (``BF16_REF_DIST``, ttsx
   on the CPU): a server that left its products in float32 reads 0.
4d. voice: ``make_voice_transform`` on the bf16 server's pipeline, request
   1's refined mel (864 frames) re-voiced with style id 1 and the GST
   style of request 2's refined mel: a finite, non-silent waveform of
   864 * 256 samples, K1 and K2 4 launches each, and the plain route
   within phase 4's tolerance.
4e. stream: ``StreamingSynthesizer`` (chunks of 256 frames, overlap 16) on
   phase 4's f32 pipeline with a 30 s request (2,592 frames, 11 chunks):
   a finite, non-silent waveform of 2,592 * 256 samples, K1 and K2 4
   launches per chunk; one 256-frame request through the streamer equals
   a direct ``synthesize`` call within ``STREAM_DIRECT_TOL``.
5. train: a seeded wav tree (32 utterances of 1.5-4 s: 4 speakers x 2
   domains x 2 styles, with transcripts) through the trainer's path at
   the full width of ``tts_cfg()`` (batch 16, 2 micro-batches a step,
   refiner every 2nd step, the vocoder GAN every step on the step's first
   micro-batch, its wav cut to whole generator hops by the length rule):
   ``data_streams`` (dataset -> collator with K3 and f0 / energy on the
   card -> trainer batches) -> ``UnifiedTrainer`` with its default three
   blocks for 6 engine steps -> one ``validate()``. Every K3 launch of
   the run (input and output kept) is held afterwards to parts (1), (2)
   and (4) of 3b's gate on its own batch. It fails unless that
   holds, every loss is finite, K3 ran once per collated batch and K1
   and K2 not at all, the
   first update (lr 0)
   left the acoustic weights as they were and the second moved them, the
   refiner stepped 3 times and its VQ statistics moved, and the noise
   scale and L1 weight follow the validation L1; and, for the vocoder,
   unless it trained on every step, ``d_loss``, ``g_loss`` and ``r1`` are
   finite, R1 is non-zero on the first discriminator step and zero on the
   second, after their second update every generator, GST and
   discriminator parameter that had a non-zero gradient has moved, the
   STFT loss's filterbank has not, and the generator's EMA is d * ema +
   (1 - d) * params after each update. On one batch of 2, the first
   acoustic and refiner losses, and on its first 32 frames the vocoder's
   first ``d_total`` (with R1) and ``g_loss``, on the card agree with the
   port on the CPU given the same draws (TF32 off). Step and collate
   times and peak memory.
5b. vocoder_export: ``save_vocoder_slim`` of the trained vocoder (EMA
   generator and GST); a pipeline of the trained acoustic and refiner
   models with both kernel flags on loads the export and serves one
   864-frame request: a finite, non-silent waveform, K1 and K2 4 launches
   each, within 5e-4 of the same pipeline with the flags off. Before
   that, the kernel-flagged generator and K2 called under a gradient on
   the card must raise (both kernels are forward-only) and launch
   nothing. Last, the zoo's ``vocoder.npz`` warm-starts a
   ``VocoderBlock`` at ``zoo_cfg(False)``, which takes one finite GAN step
   on 4 rows x 32 frames of a collated batch.
5c. checkpoint: the three default blocks at ``tts_cfg()`` widths on
   phase 5's wav tree, cut to batch 4 with one micro-batch: 4 engine
   steps straight, against 2 steps (``checkpoint_freq`` 2 writes
   ``last``), a freshly built trainer restored from ``last`` and steps 3
   and 4 on the batches that follow; the checkpoints go to the phase's
   temporary directory. Run with ``torch.backends.cudnn.deterministic``
   and ``torch.use_deterministic_algorithms(True, warn_only=True)`` (this
   phase only), the gate is bitwise equality of every entry of the two
   runs' states (parameters and buffers, Adam moments, counts, update
   steps, the generator's EMA, every generator state) and equal run
   states; if an op on the path warns that it has no deterministic
   implementation, the phase names it, runs a second uninterrupted run,
   and the gate becomes: the resumed run's max |difference| from the
   first is at most twice the two uninterrupted runs'. K3 launches once
   per collated batch (4 and the validation batch), no other kernel.
   The checkpoint's MB and the ms to save and to restore it.
5d. refenc: ``load_refenc(device="cuda")`` (the zoo's ``refenc.npz``)
   embeds 32 held-out ``ToneCorpus`` utterances (8 speakers x 4, 128
   frames) within ``REFENC_EMB_TOL`` of the CPU route, with the all-pairs
   EER of both; from the zoo's weights, 3 ``train_step``s, 1
   ``train_step_mixup`` and 1 ``train_step_accum`` (A = 2) at the zoo's
   width (ECAPA 512 channels, speaker_dim 256) on batches of 16 x 128
   frames: the first loss within ``XDEV_RTOL`` relative of the CPU's on
   the same weights and batch, every loss finite, every parameter moved;
   ms per step and peak memory; ms per embedding of a 2 s mel (172
   frames) at batch 1 and at batch 16. No kernel launches.
5e. prosody: ``load_prosody(device="cuda")`` (the zoo's ``prosody.npz``)
   on the mels of 4 utterances (4 speakers) of 864 frames (10 s) and of
   1,100 (past the S4 ``l_max`` of 1024): every output within
   ``PROSODY_RTOL`` of the CPU route (max |difference| / max |CPU
   output| over the batch); 3 ``ProsodyTrainer``
   steps on 16 x 128 frames with targets from ``targets_from_wav``, the
   first loss within ``XDEV_RTOL`` relative of the CPU's; 3
   ``EmotionTrainer`` steps; ms per predictor forward at 864 frames and
   per step. No kernel launches.
5f. diarizer: on the hard benchmark stream of
   ``eval_results/diar_embs.npz`` (81.3 s, 6 speakers, 12 dB SNR, 15
   overlapped onsets; written to a temporary wav): the zoo's slice
   encoder (``load_diar_encoder``) embeds the dump's 81 one-second
   windows on the card within ``DIAR_EMB_TOL`` of the CPU route, unit
   norm; ``dynamic_slice(wav, AUDIO, 0.8, 3.0)`` on the card and
   ``_explode`` at 1 s give exactly the dump's 27 slices and 81 windows
   (the probabilities' distance from the 0.5 and 0.25 thresholds
   printed); the production controller (``DIAR_PROD``, the zoo encoder)
   on the card ends ``ok`` with the recorded DER (``DIAR_DER`` strict,
   ``DIAR_DER_COLLAR`` with a 250 ms collar, to 4 decimals), speakers and
   segments, and the same segments, speaker partition and overlaps as
   the CPU route (its step times, run cold and warm, and seconds per
   second of audio); ``evaluate_dump`` gives ``DIAR_OFFLINE``; the
   overlap net trained on the card (300 steps, batch 32, ToneCorpus of 6
   speakers): the first loss within ``OVERLAP_RTOL`` of the CPU route on
   the same init and batch, every loss finite, held-out accuracy at
   least ``OVERLAP_MIN_ACC`` (the reference's 0.980 beside it), then the
   screened controller once (DER, screen calls, the overlap step's
   time); 5 ``GNNClusterer.train`` steps (margin ``GNN_MARGIN``) on the
   dump's embeddings with spectral labels, card and CPU, each loss
   within ``GNN_RTOL``. No kernel launches.
5g. observer: the observer ingestion job (``ObserverPipeline.run_job``)
   on 5f's stream: 5f's production controller with the zoo's slice
   encoder, the zoo's prosody predictor (``load_prosody``, its own
   config), and an ``ASRService`` whose ``ScriptedText`` transcriber
   fills the energy VAD's segments with fixed sentences. On the card, run
   cold and then warm: status ``done``, every stage ``ok``, 5f's
   speakers and segments, ``device_bytes_in_use`` above 0 in every
   resource snapshot; the same job on the CPU in this process: the same
   speakers, transcripts, tier-1 and tier-2 labels and statuses, arc
   pattern and plot-map beats, and ``prosody_trend.json`` within
   ``OBSERVER_TREND_TOL``, with the smallest margin of each decision
   printed (energy VAD, voicing, the f0 peak pick, drift's k-sigma test,
   tier 2's confidence thresholds). Then ``watch`` on a temporary inbox:
   a ``<stem>.wav`` and its ``.ready`` marker end ``done`` within
   ``OBSERVER_WATCH_S`` (the watcher and worker stopped and SIGINT's and
   SIGTERM's handlers put back after it), and ``main_observer --job
   --device cuda`` once in this process returns 0 with a ``done``
   summary. The job's seconds (cold, warm, per second of audio), its
   step times, and the watch round trip. No kernel launches.
5h. refenc_cli: the speaker encoder's console scripts at full width
   (``RefEncConfig()``: ECAPA-TDNN 512, a 256-d embedding) on a
   ``FormantCorpus`` wav tree of its 12 speakers (6 training and 2
   held-out utterances each of 300-400 frames, 3.5-4.6 s, written on 8
   threads): ``main_refenc_train --device cuda`` with the held-out list
   at batch 8, 3 s crops and 2 loader workers, ``REFENC_CLI_STEPS`` steps
   with the EER every ``REFENC_CLI_EVAL``: rc 0, the steps, 12 speakers,
   ``best`` and ``final`` written; each train step timed with the card
   synchronized, the loader's produced / consumed / failed-decode counts
   and the seconds spent waiting in its ``next`` (and their share of the
   run); the loader must be the native pthreads executor (``is_native``,
   built at first use against Python's ``Python.h``, whose path is
   printed). ``main_refenc_eer --checkpoint`` on the card and on the CPU: the
   same EER, the embeddings within ``REFENC_EMB_TOL``.
   ``main_refenc_fuse`` on the card: the reloaded ``.pt2`` program within
   ``EXPORT_TOL`` of the eager encoder on a held-out file's first 172
   frames, and the file's bytes. ``main_refenc_latency --runs 100`` beside
   5d's 2 s embedding. ``main_bench --device cuda`` (the reference's CI
   gate, the acoustic model against a ReLU MLP at its factor 20): its JSON
   and rc, which must agree (0 with a pass, 1 with the gate's error), and
   both models' forwards replayed from CUDA graphs (their device time)
   with that ratio beside it. ``microbenchmarks()`` on the card;
   ``evaluate_acoustic`` with the zoo's acoustic model on two batches of
   ``ACOUSTIC_EVAL_FRAMES``: ``val_loss`` card vs CPU within
   ``ACOUSTIC_EVAL_RTOL`` relative. One engine step of the three default
   blocks at 5c's cut (batch 4, one micro-batch) on a synthetic batch
   under an ``Observer`` that records its calls: one call per stage
   stepped, in order, no error. No kernel launches.
5i. parallel: a world-1 NCCL process group on card 0 (this process) and
   a mesh over it (``make_mesh``; the world size, backend and layouts
   printed): one engine step of the three blocks at 5c's cut (batch 4,
   one micro-batch, a synthetic batch of ``OBSERVED_FRAMES``) under the
   mesh against the same step without it, with cuDNN's and torch's
   deterministic algorithms on, bitwise (within ``MESH_STEP_TOL`` where
   an op on the path warns it has no deterministic implementation); phase
   4's requests through ``SynthesisServer(mesh=..., bf16=False)`` at the
   serving bucket: K1 and K2 4 launches each, the waveforms within
   ``WAV_TOL`` of phase 4's; the time of an NCCL all-reduce of the
   generator's gradient size (one rank: no link crossed), with its bytes.
   With two cards or more, ``dryrun_multichip(2)`` (dp = 2) and
   ``dryrun_multichip(2, tp=2)`` (band_tp) as NCCL ranks in processes of
   their own, each equal to one rank.
5j. parity: the parity harnesses (``ttsx_torch/eval/parity*.py``) at full
   width and cut steps (``PARITY_STEPS``; the prosody predictor at its
   default steps), each record printed on a line
   of its own: the standard set through ``parity_aux.EXPERIMENTS``
   (refenc, prosody, acoustic, refiner, vocoder, diarizer), under cuDNN's
   and torch's deterministic algorithms (``deterministic_ops``), each
   record holding the keys of the reference's record of the same experiment
   (``eval_results/parity.json``, ``parity_diar.json``) with finite
   values, the trained encoder's EER below random weights', the trained
   acoustic's MCD below random weights', the trained predictor's voiced
   f0 Pearson r above random weights', the GAN stable, its
   discriminators ``DISC_PARAMS``; ``e2e_parity`` at cut steps
   (``PARITY_E2E_STEPS``) exporting a zoo (the checked-in zoo's vocoder
   overrides) into the phase's directory, its text -> wav readouts (one
   pass and SDE) finite; none of these launches a kernel. That zoo
   through ``serve_from_zoo`` (both kernel flags on, f32) for one 10 s
   request: K1 and K2 4 launches each, the waveform within ``WAV_TOL``
   of the same zoo served on the plain path. ``record_baseline.record``
   at ``TTSXConfig()`` (per-stage ms and peak MB, printed on a line of
   its own; the peak statistics reset just before), and
   ``rule_calibration`` at ``tests/test_pipeline.py``'s sizes: group
   accuracy above 0.8, ECE below 0.15, 31 rules reachable.
6. timing: CUDA-event times of each kernel beside its plain version (K1
   and K2 at the stage shapes above; K3 by graph replay, eager beside, at
   each batch shape the trainer collated and at the 10 s clip, with the
   peak memory each of K3's versions takes beyond its input), K1's
   library call (``F.conv_transpose1d``, timed here
   only; K1, K2 and it replayed from a CUDA graph and eager), each kernel's
   bound from bytes and operations (K1, K2 and K5: three TF32 products
   per f32 product over the TF32 peak, with the f32 FMA time beside; K3:
   f32 operations over the f32 peak, with the same count over the FP64
   peak beside; K4: the least of the recurrence and
   the FFT count in f32 and the chunked form's products in 3xTF32, with
   the f32 bound beside), the model
   stages, and one 10 s request end to end. K4 per S4 layer shape
   (batch 1 and 4) beside its plain version, the fft route's time at the
   same shape (``ssm_kernel`` + ``fft_dw_conv``) and its bound, K4 and
   the fft route both replayed from a CUDA graph (device time; their
   short kernels make eager event timing read the host) and eager; one 10
   s request at batch 1 in bf16 beside f32 (median of five, interleaved,
   after a warm-up), with each stage's time in both and each request's
   peak memory beyond what was allocated before it; K5 per
   block shape (graph replay and eager) beside its plain version and
   bound, and three K5 launches against one K2 launch per stage; at
   batch 1 one refiner pass and
   ``sde_sample`` in each mode, the generator's K2 and per-block routes,
   and SDE requests end to end in each mode. The vocoder's
   ``disc_step`` with R1 and without and its ``gen_step``, plain and
   with ``remat``, on the largest batch it trained on (two each, host
   clock, the card synchronized),
   with each one's peak memory, the work ``gan_work`` counts for that
   batch, and the trainer's peak memory from phase 5.

Then the ``{"kernels": [...]}`` line (K1 and K2 at the serving bucket's
shapes: ``ms`` and the bounds summed over the four stage calls of one
forward, K1's and K2's ``ms`` and K1's ``library_ms`` from graph
replay, launches on the served forward; K3 at the largest collated
batch (``ms`` from graph replay, ``max_abs_err`` against the float64
log-mel), launches over the training run, one per collated batch, and
``f64_bound_ms`` beside its bound; K4 summed
over the 120 layer calls of one SDE synthesize call at batch 1 (``ms``
from graph replay), launches per call, its bound the least of three
counts (``k4_cost``) and ``f32_bound_ms`` the f32 counts' alone; K5
summed over the 12 blocks of the per-block generator route at batch 1
(``ms`` from graph replay), launches on that route;
each entry's ``ops_peak`` names the peak its operations bound uses and
``timing`` how its ``ms`` was taken; K1's and K2's ``mesh_launches``
count their launches on phase 5i's bucket under the mesh and
``parity_launches`` on phase 5j's exported zoo), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero without the ``ok`` line. Without a CUDA card, or without the
rest of the repository beside it, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import signal
import subprocess
import sys
import sysconfig
import tempfile
import time
from pathlib import Path

# H100 SXM peaks at 700 W (NVIDIA data sheet, dense): f32 and float64
# outside the tensor cores, TF32 on them, and HBM3 bandwidth. K3 runs a
# float64 FFT (its bound stays counted over the f32 peak, so that its row
# compares with earlier ones; the FP64 peak gives f64_bound_ms); K1, K2,
# K4 and K5 run 3xTF32 on the tensor cores (three TF32 products per f32
# product, at f32 accuracy), so their operations are bounded at that
# rate, the least time for this work at f32 accuracy on the card (K4: the
# least of its three counts, see k4_cost).
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
TIME_LIMIT_S = 1150
START = time.time()

FRAMES = 864            # one 10 s request at 22050 Hz, hop 256
MAX_BATCH = 4           # the serving bucket: 4 requests x 864 frames
REQUEST_FRAMES = (864, 600, 300)
K1_TOL = (1e-4, 1e-4)   # |kernel - plain| <= atol + rtol * |plain|
K2_TOL = (2e-4, 2e-4)
WAV_TOL = 5e-4          # max |wav(kernels) - wav(plain)|, tanh output
SILENT = 1e-3           # a waveform whose peak is below this is silent
MEL_BATCH = 16          # the trainer's batch
MEL_BUCKET = 98_304     # 12 x 8192: the trainer's largest bucket (4 s x 1/0.9)
CLIP_SAMPLES = 220_500  # one 10 s clip at 22.05 kHz
K3_TOL = (1e-4, 1e-4)   # log-mel against the float64 log-mel, and against
                        # plain on noise; K3 is the exact log-mel rounded to
                        # f32: 4.8e-7 from float64 measured on an H100
K3_TAIL_TOL = 1e-5      # frames that see only zero padding: exact zeros
TRAIN_STEPS = 6
XDEV_RTOL = 1e-4        # first-step losses, card vs CPU, same draws
XDEV_VOC_FRAMES = 32    # the vocoder's card-vs-CPU window (mel frames)
GAN_REPEATS = 2         # vocoder steps timed per kind
K4_TOL = (1e-4, 1e-4)   # the S4 recurrence; 7.7e-7 measured on an H100
K5_TOL = (1e-4, 1e-4)   # one FiLM resblock; 6.7e-6 measured
STAGE_TOL = K2_TOL      # three K5 launches against one K2 launch per stage
SDE_MEL_TOL = 1e-4      # max |mel_ref(K4) - mel_ref(fft)|; 3.6e-7 measured
SDE_WAV_TOL = WAV_TOL   # the same waveforms, and K5's route vs K2's;
                        # 5.6e-8 measured
SDE_REPEATS = 3         # end-to-end SDE requests timed per mode
SERVE_LAUNCHES = {"upsample": 4, "resblock_stack": 4, "mel_frontend": 0,
                  "s4_scan": 0, "resblock": 0}   # one served forward
# the reference's own max |wav(bf16 server) - wav(f32 server)| on each of
# the three requests at --seed 0 (bucket of 864 frames, both kernel flags
# on; ttsx on the CPU, printed by tests/test_torch_zoo_slow.py::
# test_zoo_bf16_server_at_864_frames_matches_reference); another seed
# takes the largest of them as every request's ceiling and the smallest
# as its floor
BF16_REF_DIST = (6.460e-4, 5.899e-4, 5.669e-4)
BF16_REF_FACTOR = 1.5   # phase 4c: |bf16 - f32| <= this * BF16_REF_DIST
BF16_REF_FLOOR = 0.5    # phase 4c: |bf16 - f32| >= this * BF16_REF_DIST
STREAM_FRAMES = 2592    # a 30 s request: 11 chunks of 256 with overlap 16
STREAM_CHUNK, STREAM_OVERLAP = 256, 16
STREAM_DIRECT_TOL = 1e-5   # one chunk through the streamer vs synthesize
BF16_REPEATS = 5        # 10 s requests timed per dtype
CKPT_BATCH = 4          # phase 5c: batch 4, one micro-batch (the cut)
CKPT_STEPS, CKPT_STOP = 4, 2   # 4 steps straight; stop at 2 and resume
HELD_OUT_SEED = 1000    # ToneCorpus utterances no zoo training run drew
REFENC_FRAMES = 128     # the speaker encoder's training crops
REFENC_BATCH = 16       # 8 speakers x 2 utterances
REFENC_EMB_TOL = 1e-5   # max |embedding(card) - embedding(CPU)|
REFENC_LATENCY_FRAMES = 172   # a 2 s mel, as refenc-latency times it
PROSODY_FRAMES = (864, 1100)  # the 10 s clip, and past the S4 l_max 1024
PROSODY_RTOL = 1e-4     # card vs CPU: max |diff| / max |CPU| per output
PROSODY_BATCH = 4       # utterances (4 speakers) at each length, so that
                        # the per-utterance outputs have a scale: one
                        # utterance's pause share read 1.8e-4 relative
                        # (near 0) in chip run 1, PR 14
STAGE12_STEPS = 3       # train steps of each stage-1/2 trainer
# phase 5f, the diarizer, on eval_results/diar_embs.npz (the hard stream)
DIAR_EMB_TOL = 1e-5     # max |slice embedding(card) - embedding(CPU)|
DIAR_PROD = dict(min_dur=0.8, max_dur=3.0, cluster_method="spectral",
                 subsegment_s=1.0, cluster_merge_thresh=0.75)
# the production controller (ttsx/eval/parity_diar.py:127-132) with the
# zoo's diar_encoder.npz on the dump's stream: parity_diar.json
# diarizer_hard.trained, which ttsx reproduces on the CPU to every digit;
# strict and 250 ms-collar DER (overlap speakers included), speakers,
# segments
DIAR_DER, DIAR_DER_COLLAR = 0.27676, 0.17144
DIAR_SPEAKERS, DIAR_SEGMENTS = 5, 60
# evaluate_dump on the dump (numpy: the same on any machine)
DIAR_OFFLINE = {"der": 0.1685, "der_collar": 0.0416, "k": 5, "k_true": 6,
                "n_segs": 58}
OVERLAP_STEPS, OVERLAP_BATCH = 300, 32   # as scripts/dump_diar_embs.py
OVERLAP_RTOL = 1e-5     # first overlap-net loss, card vs CPU, same batch
OVERLAP_MIN_ACC = 0.90  # held-out window accuracy after training
OVERLAP_REF_ACC = 0.980  # parity_diar.json overlap_window_eval (reference)
GNN_STEPS = 5
GNN_MARGIN = 2.0        # the default 0.3 leaves most of the 5 steps at
                        # zero loss on these well-separated embeddings
GNN_RTOL = 1e-5         # triplet loss per step, card vs CPU
# phase 5g, the observer job on the same stream: prosody_trend.json card
# vs CPU. f0 within one 0.01 rounding step (f32 autocorrelation peaks),
# energy one 1e-5 step; the predictor's outputs within PROSODY_RTOL of
# their largest CPU magnitude (5e's gate) plus their rounding step
OBSERVER_TREND_TOL = {"f0": 0.01, "energy": 1e-5}
OBSERVER_MODEL_STEP = {"model_f0": 0.01, "mfcc": 1e-3, "speech_rate": 0.0,
                       "pause_dur": 0.0}
OBSERVER_WATCH_S = 120  # a marker's job must be done within this
# phase 5h, the speaker encoder's console scripts on a FormantCorpus tree
REFENC_CLI_TRAIN, REFENC_CLI_HELD = 6, 2   # utterances per speaker
REFENC_CLI_FRAMES = (300, 401)   # 3.5-4.6 s at 22.05 kHz, hop 256
REFENC_CLI_STEPS, REFENC_CLI_EVAL = 40, 20
EXPORT_TOL = 1e-5       # the reloaded .pt2 program vs the eager encoder
ACOUSTIC_EVAL_RTOL = 1e-5   # val_loss card vs CPU, relative
ACOUSTIC_EVAL_FRAMES = (864, 600)   # two batches of served lengths
ACOUSTIC_EVAL_BATCH = 2
OBSERVED_FRAMES = 32    # the observed engine step's synthetic batch
MESH_STEP_TOL = 1e-5    # engine step under the mesh vs without, where an op
                        # on the path has no deterministic implementation
# phase 5j, the parity harnesses at full width and cut steps; the
# prosody predictor at its default 4,000: its voiced f0 r passes random
# weights' only after about 1,500 steps (-0.03 against 0.10 at 200 on the
# H100; the reference's own CPU run reads 0.074 against 0.075 at 500)
PARITY_STEPS = {"refenc": dict(steps=100), "prosody": dict(steps=4000),
                "acoustic": dict(steps=100),
                "refiner": dict(steps=50, acoustic_steps=50),
                "vocoder": dict(steps=20), "diarizer": dict(train_steps=50)}
PARITY_E2E_STEPS = dict(acoustic_steps=50, refiner_steps=50, vocoder_steps=20)
DISC_PARAMS = 28_631_892   # eval_results/parity.json "vocoder" at _tts_cfg()
RULE_MIN_ACC, RULE_MAX_ECE, RULE_COUNT = 0.8, 0.15, 31


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3),
                      **fields}), flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


GPU_STATE = ("clocks.sm", "clocks.max.sm", "clocks.mem", "power.draw",
             "temperature.gpu", "clocks_throttle_reasons.active")


def gpu_state() -> dict:
    """The card's clocks (MHz), power draw, temperature and active
    throttle reasons now, as ``nvidia-smi`` reads them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=" + ",".join(GPU_STATE),
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    values = r.stdout.strip().splitlines()[0].split(", ")
    return dict(zip(GPU_STATE, values), at_s=round(time.time() - START, 1))


def cuda_ms(fn, target_ms: float = 150.0) -> float:
    """Mean ms of ``fn`` on the card: CUDA events around a run of calls
    after a warm-up, sized to take about ``target_ms``."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t) * 1e3
    iters = max(3, min(50, int(target_ms / max(once, 1e-3))))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20) -> float:
    """Mean ms of ``fn`` on the card replayed from one CUDA graph of
    ``reps`` calls: the device's time without the host's cost of issuing
    each call, which event timing of eager calls reads for short kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return cuda_ms(g.replay) / reps


def bound_ms(nbytes: float, flops: float, tf32x3: bool = False):
    """(ms, what bounds it): the larger of the bytes over HBM's rate and
    the f32 operations over the f32 FMA peak ("operations"), or, with
    ``tf32x3``, three TF32 products per f32 product over the TF32 peak
    ("operations (3xTF32)")."""
    tb = nbytes / PEAK_HBM_BYTES * 1e3
    tf = (3 * flops / PEAK_TF32_FLOPS if tf32x3 else flops / PEAK_F32_FLOPS) * 1e3
    if tb > tf:
        return tb, "bytes"
    return tf, "operations (3xTF32)" if tf32x3 else "operations"


def f32_fma_ms(flops: float) -> float:
    """The same operations on the f32 FMA pipe at its peak."""
    return flops / PEAK_F32_FLOPS * 1e3


def err(got, ref):
    d = (got - ref).abs()
    return float(d.max()), float(d.max() / ref.abs().max().clamp_min(1e-30))


def within(got, ref, tol) -> bool:
    atol, rtol = tol
    return bool(((got - ref).abs() <= atol + rtol * ref.abs()).all())


# ------------------------------------------------------------ kernel shapes
def stage_shapes(vc, frames: int, batch: int):
    """(K1 args, K2 args) of each generator stage for ``batch`` requests of
    ``frames`` mel frames: K1 x [4B, T, Cin] -> [4B, T*f, Cout]; K2 x
    [4B, T*f, Cout] with the film at the mel rate, batch B."""
    out, ch, t = [], vc.hidden_dim, frames
    for f in vc.upsample_factors:
        out.append(dict(B=vc.num_bands * batch, T=t, cin=ch, cout=ch // 2, f=f,
                        Bf=batch, Tf=frames))
        ch //= 2
        t *= f
    return out


def make_k1(s, gen):
    import torch
    x = torch.randn(s["B"], s["T"], s["cin"], generator=gen)
    w = torch.randn(2 * s["f"], s["cin"], s["cout"], generator=gen) \
        * (2 * s["cin"]) ** -0.5
    b = torch.randn(s["cout"], generator=gen) * 0.1
    return [a.cuda() for a in (x, w, b)]


def make_k2(s, gen, n: int):
    import torch
    C = s["cout"]
    x = torch.randn(s["B"], s["T"] * s["f"], C, generator=gen)
    film = torch.randn(s["Bf"], s["Tf"], 2 * n * C, generator=gen) * 0.3
    w1 = torch.randn(n, 3, C, 2 * C, generator=gen) * (3 * C) ** -0.5
    b1 = torch.randn(n, 2 * C, generator=gen) * 0.1
    w2 = torch.randn(n, 3, C, C, generator=gen) * (3 * C) ** -0.5
    b2 = torch.randn(n, C, generator=gen) * 0.1
    return [a.cuda() for a in (x, film, w1, b1, w2, b2)]


def k1_cost(s):
    rows = s["B"] * s["T"] * s["f"]
    nbytes = 4 * (s["B"] * s["T"] * s["cin"] + 2 * s["f"] * s["cin"] * s["cout"]
                  + s["cout"] + rows * s["cout"])
    return nbytes, rows * s["cout"] * 4 * s["cin"]


def k2_cost(s, n: int):
    C, rows = s["cout"], s["B"] * s["T"] * s["f"]
    nbytes = 4 * (2 * rows * C + s["Bf"] * s["Tf"] * 2 * n * C
                  + n * (9 * C * C + 3 * C))
    return nbytes, rows * n * 18 * C * C


def requests(cfg, seed: int):
    import numpy as np
    from ttsx_torch.serve import SynthesisRequest
    rng = np.random.default_rng(seed)
    ac = cfg.acoustic
    return [SynthesisRequest(
        text_emb=rng.standard_normal((n, ac.text_emb_dim)).astype(np.float32),
        prosody=rng.standard_normal((n, ac.cond_dim)).astype(np.float32),
        emotion_probs=rng.dirichlet(np.ones(ac.emotion_dim)).astype(np.float32),
        speaker=(0.5 * rng.standard_normal(ac.speaker_dim)).astype(np.float32),
        style_id=int(rng.integers(0, cfg.refiner.num_styles)))
        for n in REQUEST_FRAMES]


def check_kernels(shapes, gen, dil):
    """Each kernel against its plain version at each stage shape."""
    import torch
    from ttsx_torch.ops.resblock_stack import (film_resblock_stack,
                                               film_resblock_stack_plain)
    from ttsx_torch.ops.upsample import convt_upsample, convt_upsample_plain
    checks = {"upsample": [], "resblock_stack": []}
    for s in shapes:
        x, w, b = make_k1(s, gen)
        got, ref = (convt_upsample(x, w, b, s["f"]),
                    convt_upsample_plain(x, w, b, s["f"]))
        torch.cuda.synchronize()
        checks["upsample"].append(dict(
            shape=[s["B"], s["T"], s["cin"], s["cout"], s["f"]],
            ok=within(got, ref, K1_TOL))
            | dict(zip(("max_abs_err", "max_rel_err"), err(got, ref))))
        a = make_k2(s, gen, len(dil))
        got, ref = (film_resblock_stack(*a, dil),
                    film_resblock_stack_plain(*a, dil))
        torch.cuda.synchronize()
        checks["resblock_stack"].append(dict(
            shape=[s["B"], s["T"] * s["f"], s["cout"], s["Bf"], s["Tf"]],
            ok=within(got, ref, K2_TOL))
            | dict(zip(("max_abs_err", "max_rel_err"), err(got, ref))))
        del x, w, b, a, got, ref
    return checks


def time_kernels(shapes, gen, dil):
    """Per stage: kernel, plain and (K1) library ms, and the bound. K1, its
    library call and K2 are timed by graph replay (``ms``, ``library_ms``:
    at stages 2-3 K1 takes tens of microseconds, which eager event timing
    reads as the host's launch cost) and eager beside it."""
    import torch.nn.functional as F
    from ttsx_torch.ops.resblock_stack import (film_resblock_stack,
                                               film_resblock_stack_plain)
    from ttsx_torch.ops.upsample import convt_upsample, convt_upsample_plain
    rows = {"upsample": [], "resblock_stack": []}
    for s in shapes:
        x, w, b = make_k1(s, gen)
        wt = w.permute(1, 2, 0).flip(-1).contiguous()     # torch [Cin, Cout, k]
        xc = x.transpose(1, 2).contiguous()
        lo, tf = s["f"] // 2, s["T"] * s["f"]
        nbytes, flops = k1_cost(s)
        bms, by = bound_ms(nbytes, flops, tf32x3=True)
        k1 = lambda: convt_upsample(x, w, b, s["f"])
        lib = lambda: F.conv_transpose1d(xc, wt, b, stride=s["f"])[:, :, lo:lo + tf]
        rows["upsample"].append(dict(
            ms=graph_ms(k1), eager_ms=cuda_ms(k1),
            plain_ms=cuda_ms(lambda: convt_upsample_plain(x, w, b, s["f"])),
            library_ms=graph_ms(lib), library_eager_ms=cuda_ms(lib),
            bound_ms=bms, bound_by=by, f32_fma_ms=f32_fma_ms(flops),
            gflop=flops / 1e9, mbytes=nbytes / 1e6))
        a = make_k2(s, gen, len(dil))
        nbytes, flops = k2_cost(s, len(dil))
        bms, by = bound_ms(nbytes, flops, tf32x3=True)
        k2 = lambda: film_resblock_stack(*a, dil)
        rows["resblock_stack"].append(dict(
            ms=graph_ms(k2), eager_ms=cuda_ms(k2),
            plain_ms=cuda_ms(lambda: film_resblock_stack_plain(*a, dil)),
            library_ms=None, bound_ms=bms, bound_by=by,
            f32_fma_ms=f32_fma_ms(flops), gflop=flops / 1e9,
            mbytes=nbytes / 1e6))
        del x, w, b, wt, xc, a
    return rows


# ------------------------------------------------------------ mel frontend
def mel_inputs(seed: int, sr: int):
    """A batch of 16 wavs of 1.5-4.4 s (odd rows white noise, even rows
    five-harmonic tones at 90-300 Hz) zero-padded to one 98,304-sample
    bucket, their lengths, and one 10 s noise clip."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(int(1.5 * sr), int(4.4 * sr), MEL_BATCH)
    wav = np.zeros((MEL_BATCH, MEL_BUCKET), np.float32)
    for i, n in enumerate(lengths):
        if i % 2:
            wav[i, :n] = 0.3 * rng.standard_normal(n)
        else:
            t = np.arange(n) / sr
            f0 = rng.uniform(90.0, 300.0)
            wav[i, :n] = sum(0.3 / k * np.sin(2 * np.pi * f0 * k * t)
                             for k in range(1, 6))
    clip = (0.3 * rng.standard_normal((1, CLIP_SAMPLES))).astype(np.float32)
    return wav, lengths, clip


def k3_cost(batch: int, n: int, audio):
    """Bytes (wav in, log-mel out, window, twiddles, filterbank) and the
    f32 operations the function needs per frame: window n_fft, a real
    FFT 2.5 n_fft log2 n_fft, magnitudes 4 n_bins, the filterbank's
    nonzero taps 2 nnz, the log n_mels (not the 4 n_fft n_bins of a DFT
    by dense bases)."""
    import math
    import numpy as np
    from ttsx_torch.dsp.stft import mel_filterbank
    bins = audio.n_fft // 2 + 1
    frames = batch * (1 + n // audio.hop_length)
    nnz = int(np.count_nonzero(mel_filterbank(
        audio.sample_rate, audio.n_fft, audio.n_mels, audio.f_min,
        audio.f_max)))
    nbytes = 4 * (batch * n + frames * audio.n_mels + 3 * audio.n_fft
                  + bins * audio.n_mels)
    per_frame = (audio.n_fft + 2.5 * audio.n_fft * math.log2(audio.n_fft)
                 + 4 * bins + 2 * nnz + audio.n_mels)
    return nbytes, frames * per_frame


def silent_frames(wav, audio):
    """[B, T] bool: the frames whose every sample, reflect padding
    included, is an exact zero."""
    import torch.nn.functional as F
    half = audio.n_fft // 2
    hit = F.pad((wav != 0).float()[:, None], (half, half), mode="reflect")
    return hit[:, 0].unfold(-1, audio.n_fft, audio.hop_length).sum(-1) == 0


def k3_check(wav, got, audio, groups, vs_plain=()):
    """K3's output ``got`` on ``wav`` [B, N] held to the four-part gate of
    the module docstring (3b): against the float64 log-mel within K3_TOL
    (1) on every value; per row group of ``groups`` (name -> rows), its
    worst |error| from float64 no larger than the plain version's (2) and,
    for the groups named in ``vs_plain``, against plain within K3_TOL
    (3); on the frames that read only zeros, against plain within
    K3_TAIL_TOL (4)."""
    import torch
    from ttsx_torch.ops.mel_frontend import log_mel_plain
    plain = log_mel_plain(wav, audio)
    exact = torch.as_tensor(log_mel_f64(wav.cpu().numpy(), audio),
                            device=wav.device)
    d, dp = (got.double() - exact).abs(), (plain.double() - exact).abs()
    dplain = (got - plain).abs()
    silent = silent_frames(wav, audio)
    tail = float(dplain[silent].max()) if bool(silent.any()) else 0.0
    parts = {"vs_float64": within(got.double(), exact, K3_TOL),
             "no_farther_than_plain": True, "vs_plain": True,
             "silent_vs_plain": tail <= K3_TAIL_TOL}
    fields = dict(shape=list(got.shape), max_abs_err=float(d.max()),
                  plain_max_abs_err=float(dp.max()), groups={})
    for name, rows in groups.items():
        g = dict(k3_vs_float64=float(d[rows].max()),
                 plain_vs_float64=float(dp[rows].max()))
        parts["no_farther_than_plain"] &= (g["k3_vs_float64"]
                                           <= g["plain_vs_float64"])
        if name in vs_plain:
            g["k3_vs_plain"] = float(dplain[rows].max())
            parts["vs_plain"] &= within(got[rows], plain[rows], K3_TOL)
        fields["groups"][name] = g
    return fields | dict(max_abs_err_silent=tail,
                         silent_frames=int(silent.sum()), parts=parts,
                         ok=all(parts.values()))


def check_mel(audio, wav, clip):
    """K3 on the batch (tone rows, noise rows) and on the 10 s clip, each
    held to the gate (``k3_check``)."""
    import torch
    from ttsx_torch.ops.mel_frontend import log_mel
    x = torch.as_tensor(wav, device="cuda")
    c = torch.as_tensor(clip, device="cuda")
    batch = k3_check(x, log_mel(x, audio), audio,
                     {"tones": slice(0, None, 2), "noise": slice(1, None, 2)},
                     vs_plain=("noise",))
    one = k3_check(c, log_mel(c, audio), audio, {"clip": slice(None)},
                   vs_plain=("clip",))
    return dict(batch=batch, clip=one,
                max_abs_err=max(batch["max_abs_err"], one["max_abs_err"]),
                ok=batch["ok"] and one["ok"])


def time_mel(audio, x):
    """K3 and its plain version on ``x`` [B, N] on the card: K3 by graph
    replay (``ms``; eager beside), the plain version eager, the bound
    (and the same count over the FP64 peak), and the peak memory each
    call takes beyond its input (after a warm-up, so the plain version's
    cached bases are not counted)."""
    import torch
    from ttsx_torch.ops.mel_frontend import log_mel, log_mel_plain
    nbytes, flops = k3_cost(*x.shape, audio)
    bms, by = bound_ms(nbytes, flops)
    extra = {}
    for name, fn in (("k3", log_mel), ("plain", log_mel_plain)):
        fn(x, audio)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(x, audio)
        torch.cuda.synchronize()
        extra[name] = (torch.cuda.max_memory_allocated() - base) / 1e6
    k3 = lambda: log_mel(x, audio)
    return dict(shape=list(x.shape), ms=graph_ms(k3), eager_ms=cuda_ms(k3),
                plain_ms=cuda_ms(lambda: log_mel_plain(x, audio)),
                library_ms=None, bound_ms=bms, bound_by=by,
                f64_bound_ms=max(nbytes / PEAK_HBM_BYTES,
                                 flops / PEAK_F64_FLOPS) * 1e3,
                gflop=flops / 1e9, mbytes=nbytes / 1e6,
                peak_extra_mb_k3=extra["k3"], peak_extra_mb_plain=extra["plain"])


def log_mel_f64(wav, audio):
    """The float64 log-mel of ``wav`` [B, N] (numpy) on the host: K3's
    reflect padding, window, filterbank and floors (1e-12 under the
    magnitude, 1e-5 under the log), the DFT by numpy's float64 FFT."""
    import numpy as np
    from ttsx_torch.dsp.stft import mel_filterbank, padded_window
    n_fft, hop = audio.n_fft, audio.hop_length
    x = np.pad(wav.astype(np.float64), ((0, 0), (n_fft // 2, n_fft // 2)),
               mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft, axis=1)
    win = padded_window(audio).astype(np.float64)
    spec = np.fft.rfft(frames[:, ::hop] * win, axis=-1)
    mag = np.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-12)
    fb = mel_filterbank(audio.sample_rate, n_fft, audio.n_mels, audio.f_min,
                        audio.f_max).astype(np.float64)
    return np.log(mag @ fb + 1e-5)


# --------------------------------------------------------- S4 (K4), K5
def refiner_s4_layers(refiner):
    """The refiner's S4 layers in the order a pass runs them: per band
    down_s4_0, down_s4_1, mid_s4, up_s4_0, up_s4_1."""
    from ttsx_torch.nn.s4 import S4
    return [m for m in refiner.modules() if isinstance(m, S4)]


def k4_args(layer, batch: int, gen):
    """LayerNorm-scale noise [batch, FRAMES, C] and the layer's own decays,
    b (ones) and readout c_full, as the layer hands them to K4."""
    import torch
    H, d = layer.a_diag.shape
    u = torch.randn(batch, FRAMES, H * d, generator=gen).cuda()
    with torch.no_grad():
        c = layer.c_full().contiguous()
    return u, layer.a_diag, torch.ones_like(layer.a_diag), c


def k4_cost(B: int, T: int, C: int, d: int, H: int):
    """Bytes (u read once, y written once, a, b, c_full) and K4's bound: the
    least of three counts of the same function, each over its own peak:
    the recurrence, 4 B T C d f32 operations (update and readout); the
    materialized kernel plus FFT convolution in f32 (decay times b per
    head, step and mode 2 H T d; the kernel's readout 2 T C d; real FFTs
    of u, of the kernel and the inverse, 2.5 n log2 n each per channel
    with n the power of two >= 2T - 1; complex products 6 (n/2 + 1) per
    channel); and the chunked form's two products, 4 B T C d operations in
    3xTF32 (three TF32 products per f32 product over the TF32 peak), which
    the kernel runs. Returns the bytes, the bound (the larger of the bytes
    over HBM's rate and the winning count's time), what bounds it, the
    winning count's name, the f32 bound (the larger of the bytes' time and
    the lesser f32 count) and the winning count's GFLOP."""
    import math
    n = 1 << (2 * T - 2).bit_length()
    rec = 4 * B * T * C * d
    fft = (2 * H * T * d + 2 * T * C * d + 6 * B * C * (n // 2 + 1)
           + (2 * B + 1) * C * 2.5 * n * math.log2(n))
    nbytes = 4 * (2 * B * T * C + 2 * H * d + H * d * (C // H))
    counts = {"recurrence": bound_ms(nbytes, rec),
              "fft": bound_ms(nbytes, fft),
              "products": bound_ms(nbytes, rec, tf32x3=True)}
    flops = {"recurrence": rec, "fft": fft, "products": rec}
    f32 = min(counts["recurrence"], counts["fft"])
    win = min(counts, key=lambda k: counts[k][0])
    return dict(bound_ms=counts[win][0], bound_by=counts[win][1],
                bound_count=win, f32_bound_ms=f32[0],
                gflop=flops[win] / 1e9, mbytes=nbytes / 1e6)


def check_k4(layers, gen):
    """K4 against scan_dw_conv at each layer's shape, batch 1 and 4."""
    import torch
    from ttsx_torch.ops.s4_scan import s4_scan, scan_dw_conv
    checks = []
    for B in (1, MAX_BATCH):
        for layer in layers:
            u, a, b, c = k4_args(layer, B, gen)
            got, ref = s4_scan(u, a, b, c), scan_dw_conv(u, a, b, c)
            torch.cuda.synchronize()
            checks.append(dict(shape=[B, FRAMES, u.shape[2], layer.d],
                               ok=within(got, ref, K4_TOL))
                          | dict(zip(("max_abs_err", "max_rel_err"),
                                     err(got, ref))))
    return checks


def per_block_generator(pipe):
    """A copy of ``pipe``'s generator on the per-block route: the upsample
    on K1, every FiLMResidualBlock with ``use_pallas`` (K5), no K2."""
    import dataclasses
    from ttsx_torch.models.vocoder import FiLMResidualBlock, Generator
    c = pipe.cfg
    vc = dataclasses.replace(c.vocoder, use_pallas_resblock_stack=False)
    gen = Generator(vc, c.acoustic.cond_dim, c.acoustic.emotion_dim)
    gen.load_state_dict(pipe.generator.state_dict())
    for m in gen.modules():
        if isinstance(m, FiLMResidualBlock):
            m.use_pallas = True
    return gen.to("cuda").eval()


def k5_stages(gen_module, batch: int, gen):
    """Per generator stage at one 10 s request's shape for ``batch``
    requests: x [4B, T, C], the stage's blocks (zoo weights), each block's
    full-rate scale and shift from a LayerNorm-scale conditioning [B,
    FRAMES, cond_dim], and K2's mel-rate film and stacked weights."""
    import torch
    from ttsx_torch.ops.resblock_stack import nearest_rows
    vc = gen_module.cfg
    tower = gen_module.band_tower.tower
    out = []
    with torch.no_grad():
        cond = torch.randn(batch, FRAMES, vc.cond_dim, generator=gen).cuda()
        for i, s in enumerate(stage_shapes(vc, FRAMES, batch)):
            T, C = s["T"] * s["f"], s["cout"]
            blocks = [getattr(tower, f"res_{i}_{j}")
                      for j in range(len(vc.res_dilations))]
            x = torch.randn(s["B"], T, C, generator=gen).cuda()
            rows = nearest_rows(T, FRAMES, x.device)
            films = [b.Dense_0(cond) for b in blocks]
            k5 = []
            for blk, film in zip(blocks, films):
                sc, sh = film[:, rows].repeat(s["B"] // batch, 1,
                                              1).chunk(2, -1)
                k5.append((sc.contiguous(), sh.contiguous(),
                           *(w.detach().contiguous()
                             for w in blk.kernel_weights()), blk.dilation))
            k2 = (torch.cat(films, -1).contiguous(),
                  *(torch.stack(ws).contiguous() for ws in
                    zip(*(b.kernel_weights() for b in blocks))))
            out.append(dict(x=x, k5=k5, k2=k2, B=s["B"], T=T, C=C))
    return out


def k5_cost(B: int, T: int, C: int):
    """Bytes (x, scale, shift read once, y written once, the weights) and
    f32 operations (the two k=3 convs, 18 C^2 a row) of one block."""
    return 4 * (4 * B * T * C + 9 * C * C + 3 * C), 18 * B * T * C * C


def k5_chain(x, k5):
    from ttsx_torch.ops.resblock import film_resblock
    for args in k5:
        x = film_resblock(x, *args)
    return x


def check_k5(stages):
    """K5 against its plain version per block, and three K5 launches
    against K2's one per stage, on the same input and weights."""
    import torch
    from ttsx_torch.ops.resblock import film_resblock, film_resblock_plain
    from ttsx_torch.ops.resblock_stack import film_resblock_stack
    blocks, per_stage = [], []
    for st in stages:
        x = st["x"]
        for args in st["k5"]:
            got, ref = film_resblock(x, *args), film_resblock_plain(x, *args)
            torch.cuda.synchronize()
            blocks.append(dict(shape=[st["B"], st["T"], st["C"], args[-1]],
                               ok=within(got, ref, K5_TOL))
                          | dict(zip(("max_abs_err", "max_rel_err"),
                                     err(got, ref))))
        dil = tuple(a[-1] for a in st["k5"])
        k2 = film_resblock_stack(x, *st["k2"], dil)
        k5 = k5_chain(x, st["k5"])
        torch.cuda.synchronize()
        per_stage.append(dict(shape=[st["B"], st["T"], st["C"]],
                              ok=within(k5, k2, STAGE_TOL))
                         | dict(zip(("max_abs_err", "max_rel_err"),
                                    err(k5, k2))))
    return blocks, per_stage


def time_k4(layers, batch: int, gen):
    """Per S4 layer shape: K4 and the fft route (``ssm_kernel`` +
    ``fft_dw_conv``; no single PyTorch call computes the function) replayed
    from a CUDA graph and eager, the plain version eager, and the bound."""
    from ttsx_torch.nn.s4 import fft_dw_conv, ssm_kernel
    from ttsx_torch.ops.s4_scan import s4_scan, scan_dw_conv
    rows = []
    for layer in layers:
        u, a, b, c = k4_args(layer, batch, gen)
        H, d = a.shape
        k4 = lambda: s4_scan(u, a, b, c)
        fft = lambda: fft_dw_conv(u, ssm_kernel(a, b, c, FRAMES), True)
        rows.append(dict(
            shape=[batch, FRAMES, u.shape[2], d],
            ms=graph_ms(k4), eager_ms=cuda_ms(k4),
            plain_ms=cuda_ms(lambda: scan_dw_conv(u, a, b, c)),
            fft_ms=graph_ms(fft), fft_eager_ms=cuda_ms(fft),
            library_ms=None, **k4_cost(batch, FRAMES, u.shape[2], d, H)))
    return rows


def time_k5(stages):
    """Per block shape: K5 (graph replay, eager beside it) and plain ms
    and the bound; per stage: three K5 launches against K2's one."""
    from ttsx_torch.ops.resblock import film_resblock, film_resblock_plain
    from ttsx_torch.ops.resblock_stack import film_resblock_stack
    blocks, per_stage = [], []
    for st in stages:
        x = st["x"]
        for args in st["k5"]:
            nbytes, flops = k5_cost(st["B"], st["T"], st["C"])
            bms, by = bound_ms(nbytes, flops, tf32x3=True)
            k5 = lambda: film_resblock(x, *args)
            blocks.append(dict(
                shape=[st["B"], st["T"], st["C"], args[-1]],
                ms=graph_ms(k5), eager_ms=cuda_ms(k5),
                plain_ms=cuda_ms(lambda: film_resblock_plain(x, *args)),
                library_ms=None, bound_ms=bms, bound_by=by,
                f32_fma_ms=f32_fma_ms(flops), gflop=flops / 1e9,
                mbytes=nbytes / 1e6))
        dil = tuple(a[-1] for a in st["k5"])
        per_stage.append(dict(
            shape=[st["B"], st["T"], st["C"]],
            k5x3_ms=cuda_ms(lambda: k5_chain(x, st["k5"])),
            k2_ms=cuda_ms(lambda: film_resblock_stack(x, *st["k2"], dil))))
    return blocks, per_stage


# ---------------------------------------------------------- SDE synthesis
def sde_cfg(mode: str):
    """The zoo's config with the refiner's S4 layers in ``mode``."""
    import dataclasses
    from ttsx_torch.core.config import zoo_cfg
    from ttsx_torch.zoo import zoo_info
    cfg = zoo_cfg(True, zoo_info().get("vocoder_overrides"))
    s4 = dataclasses.replace(cfg.refiner.s4, kernel_mode=mode)
    return dataclasses.replace(
        cfg, refiner=dataclasses.replace(cfg.refiner, s4=s4))


def sde_batch(pipe, reqs, batch: int, scale_stats, seed: int):
    """``reqs`` padded into a bucket of ``batch`` x FRAMES on the card: the
    five input tensors, the scale conditioning, the request lengths, and
    the noise of every SDE step from a generator on the card."""
    import torch
    from ttsx_torch.serve import SynthesisServer
    srv = SynthesisServer(pipe, device="cuda", max_batch=batch, frames=FRAMES,
                          bf16=False, scale_stats=scale_stats.cpu())
    *arrays, lens = srv.pad_batch(reqs)
    rc = pipe.cfg.refiner
    g = torch.Generator("cuda").manual_seed(seed)
    noise = [torch.randn(batch, FRAMES, rc.cnf_dim, generator=g, device="cuda")
             for _ in range(rc.sde_steps)]
    return ([torch.as_tensor(a, device="cuda") for a in arrays],
            srv.scale_stats.expand(batch, -1), lens, noise)


def synth_sde(pipe, arrays, scale, noise):
    """One SDE synthesize call, the launch counters zeroed just before and
    read just after: (output, counts)."""
    import torch
    from ttsx_torch import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    out = pipe.synthesize(*arrays, use_sde=True, scale=scale, noise=noise)
    torch.cuda.synchronize()
    return out, ops.launch_counts()


def check_waves(wav, lens, hop: int, what: str):
    """Each request's trimmed waveform: finite, not silent, len*hop long."""
    import numpy as np
    peaks = []
    for i, n in enumerate(lens):
        w = wav[i, :int(n) * hop, 0]
        if w.shape != (int(n) * hop,) or not np.isfinite(w).all():
            fail(f"{what}: bad waveform, shape {w.shape}, want "
                 f"{int(n) * hop} samples, finite "
                 f"{bool(np.isfinite(w).all())}")
        peaks.append(float(np.abs(w).max()))
        if peaks[-1] < SILENT:
            fail(f"{what}: silent waveform for a {int(n)}-frame request")
    return peaks


def sde_phase(pipe_p, pipe_f, reqs, scale_stats, seed: int):
    """The zoo's SDE synthesis with the refiner's S4 layers on K4
    (``pipe_p``) and on the fft route (``pipe_f``), same noise: one
    864-frame request and the 3-request bucket; the per-block generator
    route (K5) on the first; ``main_synth --zoo --sde`` once. Returns the
    phase's fields and the single request's inputs (for timing)."""
    import contextlib
    import io
    import numpy as np
    import torch
    from ttsx_torch import ops
    from ttsx_torch.cli.main import main_synth
    from ttsx_torch.data.dataset import read_wav
    hop = pipe_p.cfg.vocoder.hop_length
    steps = pipe_p.cfg.refiner.sde_steps
    k4_per_call = steps * len(refiner_s4_layers(pipe_p.refiner))
    want = {"pallas": dict(SERVE_LAUNCHES, s4_scan=k4_per_call),
            "fft": SERVE_LAUNCHES}
    fields = dict(steps=steps, launches_per_call=want["pallas"],
                  tolerance={"mel_ref": SDE_MEL_TOL, "wav": SDE_WAV_TOL},
                  cases={})
    for case, rs, batch in (("one", reqs[:1], 1), ("bucket", reqs, MAX_BATCH)):
        arrays, scale, lens, noise = sde_batch(pipe_p, rs, batch, scale_stats,
                                               seed)
        lens = [int(n) for n in lens[:len(rs)]]
        outs = {}
        for mode, pipe in (("pallas", pipe_p), ("fft", pipe_f)):
            t1 = time.perf_counter()
            out, launches = synth_sde(pipe, arrays, scale, noise)
            ms = (time.perf_counter() - t1) * 1e3
            if launches != want[mode]:
                fail(f"SDE {case} ({mode}): launches {launches}, want "
                     f"{want[mode]}")
            wav = out.wav.cpu().numpy()
            outs[mode] = dict(out=out, wav=wav, ms=ms, launches=launches,
                              peak=check_waves(wav, lens, hop,
                                               f"SDE {case} ({mode})"))
        p, f = outs["pallas"], outs["fft"]
        mel_err = max(float((p["out"].mel_ref[i, :n] - f["out"].mel_ref[i, :n])
                            .abs().max()) for i, n in enumerate(lens))
        wav_err = max(float(np.abs(p["wav"][i, :n * hop]
                                   - f["wav"][i, :n * hop]).max())
                      for i, n in enumerate(lens))
        sde_move = float((p["out"].mel_ref - p["out"].mel0).abs().max())
        fields["cases"][case] = dict(
            batch=batch, requests=lens, launches_pallas=p["launches"],
            launches_fft=f["launches"],
            first_call_ms={m: o["ms"] for m, o in outs.items()},
            peak={m: o["peak"] for m, o in outs.items()},
            mel_ref_max_abs_diff=mel_err, wav_max_abs_diff=wav_err,
            mel_ref_minus_mel0_max=sde_move)
        if mel_err > SDE_MEL_TOL or wav_err > SDE_WAV_TOL:
            fail(f"SDE {case}: the pallas and fft routes differ by "
                 f"{mel_err} (mel_ref) / {wav_err} (wav)")
        if case == "one":
            one = (arrays, scale, noise)
            mel_ref, wav_k2 = p["out"].mel_ref, p["out"].wav
    # the generator's per-block route (K5) on the single request's mel
    text, pros, emo, spk, sid = one[0]
    gen_pb = per_block_generator(pipe_p)
    vc = pipe_p.cfg.vocoder
    want_pb = dict(SERVE_LAUNCHES, resblock_stack=0, resblock=len(
        vc.upsample_factors) * len(vc.res_dilations))
    with torch.inference_mode():
        style = pipe_p.gst(mel_ref)
        torch.cuda.synchronize()
        ops.reset_launches()
        wav_pb = gen_pb(mel_ref, pros, style, emo, scale=one[1])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    pb_err = float((wav_pb - wav_k2).abs().max())
    fields["per_block_route"] = dict(launches=launches,
                                     wav_max_abs_diff_vs_k2_route=pb_err)
    if launches != want_pb:
        fail(f"per-block generator route: launches {launches}, want {want_pb}")
    if pb_err > SDE_WAV_TOL:
        fail(f"per-block route (K5) differs from K2's by {pb_err}")
    # the command line, once
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "synth.wav"
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main_synth(["--zoo", "--sde", "--frames", str(FRAMES),
                             "--device", "cuda", "--out", str(path),
                             "--seed", str(seed)])
        cli_s = time.perf_counter() - t1
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        wav, sr = read_wav(path)
    fields["main_synth"] = dict(rc=rc, line=line, seconds=cli_s,
                                file_samples=int(wav.shape[0]), sr=sr,
                                peak=float(np.abs(wav).max()))
    if (rc != 0 or line.get("wav") != str(path)
            or line.get("samples") != FRAMES * hop
            or wav.shape != (FRAMES * hop,) or not np.abs(wav).max() > SILENT):
        fail(f"main_synth --zoo --sde: {fields['main_synth']}")
    return fields, one


def time_sde(pipe_p, pipe_f, arrays, scale, noise):
    """Batch 1, 864 frames: one refiner pass (eager, and replayed from a
    CUDA graph: its device time) and ``sde_sample`` (8 passes) in each
    mode, the other stages, the generator's per-block route (K5)
    against its K2 route, and SDE requests end to end (host clock around
    ``synthesize`` and the copy of the waveform to the host)."""
    import numpy as np
    import torch
    from ttsx_torch.models.refiner import sde_sample
    text, pros, emo, spk, sid = arrays
    gen_pb = per_block_generator(pipe_p)
    out = {}
    with torch.inference_mode():
        mel0 = pipe_p.acoustic(text, pros, emo, speaker=spk).mel
        t_mid = mel0.new_full((1, 1), 0.5)
        mel_ref = sde_sample(pipe_p.refiner, mel0, pros, sid, text,
                             noise=noise)
        style = pipe_p.gst(mel_ref)
        out["acoustic_ms"] = cuda_ms(
            lambda: pipe_p.acoustic(text, pros, emo, speaker=spk))
        for mode, pipe in (("pallas", pipe_p), ("fft", pipe_f)):
            ref_pass = lambda: pipe.refiner(mel0, pros, sid, text, t=t_mid)
            out[f"refiner_pass_ms_{mode}"] = cuda_ms(ref_pass)
            out[f"refiner_pass_graph_ms_{mode}"] = graph_ms(ref_pass, reps=3)
            out[f"sde_sample_ms_{mode}"] = cuda_ms(lambda: sde_sample(
                pipe.refiner, mel0, pros, sid, text, noise=noise))
        out["gst_ms"] = cuda_ms(lambda: pipe_p.gst(mel_ref))
        out["generator_k2_route_ms"] = cuda_ms(
            lambda: pipe_p.generator(mel_ref, pros, style, emo, scale=scale))
        out["generator_per_block_route_ms"] = cuda_ms(
            lambda: gen_pb(mel_ref, pros, style, emo, scale=scale))
    for mode, pipe in (("pallas", pipe_p), ("fft", pipe_f)):
        e2e = []
        for _ in range(SDE_REPEATS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pipe.synthesize(*arrays, use_sde=True, scale=scale,
                            noise=noise).wav.cpu()
            e2e.append((time.perf_counter() - t1) * 1e3)
        out[f"e2e_ms_{mode}"] = float(np.median(e2e))
        out[f"e2e_ms_all_{mode}"] = e2e
    return out


# ------------------------------------------------- bf16 serving, voice, stream
def served(srv, reqs, what: str):
    """``srv.serve_batch(reqs)`` with the launch counters zeroed just
    before and read just after, each waveform checked (finite, not
    silent, float32, len * hop samples): (waveforms, counts, seconds)."""
    import numpy as np
    import torch
    from ttsx_torch import ops
    hop = srv.cfg.vocoder.hop_length
    torch.cuda.synchronize()
    ops.reset_launches()
    t1 = time.time()
    wavs = srv.serve_batch(reqs)
    secs = time.time() - t1
    launches = ops.launch_counts()
    for w_, r in zip(wavs, reqs):
        n_ = len(r.text_emb)
        if (w_.shape != (n_ * hop,) or w_.dtype != np.float32
                or not np.isfinite(w_).all()):
            fail(f"{what}: bad waveform, shape {w_.shape}, dtype {w_.dtype}, "
                 f"finite {bool(np.isfinite(w_).all())}, want {n_ * hop} "
                 "float32 samples")
        if float(np.abs(w_).max()) < SILENT:
            fail(f"{what}: silent waveform for a {n_}-frame request")
    return wavs, launches, secs


def serve_bf16_phase(reqs, wavs_f32, seed: int):
    """Phase 4c (see the module docstring). Returns the phase's fields,
    the bf16 server, its plain twin's pipeline and the stages of the
    padded bucket."""
    import numpy as np
    import torch
    from ttsx_torch import ops
    from ttsx_torch.serve import SynthesisServer
    from ttsx_torch.zoo import serve_from_zoo
    t1 = time.time()
    srv = serve_from_zoo(device="cuda", bf16=True, max_batch=MAX_BATCH,
                         frames=FRAMES)
    load_s = time.time() - t1
    if srv.dtype != torch.bfloat16 or {p.dtype for p in
                                       srv.pipe.parameters()} != {
                                           torch.bfloat16}:
        fail("the bf16 server does not hold bfloat16 parameters")
    wavs, launches, serve_s = served(srv, reqs, "bf16 serve")
    if launches != SERVE_LAUNCHES:
        fail(f"bf16 serve: launches {launches}, want {SERVE_LAUNCHES}")
    *arrays, _ = srv.pad_batch(reqs)
    arrays = [torch.as_tensor(a, device="cuda") for a in arrays]
    stages = srv.stages(*arrays)
    dtypes = {k: str(getattr(stages, k).dtype).replace("torch.", "")
              for k in ("mel0", "mel_ref", "wav")}
    plain_pipe = srv.pipe.with_vocoder_kernels(False)
    plain = SynthesisServer(plain_pipe, device="cuda", max_batch=MAX_BATCH,
                            frames=FRAMES, bf16=True,
                            scale_stats=srv.scale_stats.cpu())
    wavs_plain, plain_launches, _ = served(plain, reqs, "bf16 serve (plain)")
    del plain
    plain_err = max(float(np.abs(a - b).max())
                    for a, b in zip(wavs, wavs_plain))
    ref = BF16_REF_DIST if seed == 0 else (max(BF16_REF_DIST),) * len(reqs)
    ref_lo = (BF16_REF_DIST if seed == 0
              else (min(BF16_REF_DIST),) * len(reqs))
    dist = [float(np.abs(a - b).max()) for a, b in zip(wavs, wavs_f32)]
    bound = [BF16_REF_FACTOR * r for r in ref]
    floor = [BF16_REF_FLOOR * r for r in ref_lo]
    fields = dict(
        zoo_load_s=load_s, serve_s=serve_s, requests=list(REQUEST_FRAMES),
        launches=launches, stage_dtypes=dtypes,
        peak=[float(np.abs(w_).max()) for w_ in wavs],
        wav_max_abs_err_vs_plain=plain_err, wav_tolerance=WAV_TOL,
        plain_launches=plain_launches,
        wav_max_abs_diff_vs_f32=dist,
        wav_rms_diff_vs_f32=[float(np.sqrt(np.mean((a - b) ** 2)))
                             for a, b in zip(wavs, wavs_f32)],
        reference_bf16_vs_f32=list(ref), bound_vs_f32=bound,
        floor_vs_f32=floor)
    if set(dtypes.values()) != {"float32"}:
        fail(f"bf16 serve: stage dtypes {dtypes}, the reference's are "
             "float32")
    if any(plain_launches.values()):
        fail("the plain bf16 path launched a kernel")
    if plain_err > WAV_TOL:
        fail(f"bf16 serve: kernel path differs from plain by {plain_err}")
    if any(d > b for d, b in zip(dist, bound)):
        fail(f"bf16 serve: |bf16 - f32| {dist} exceeds {BF16_REF_FACTOR} x "
             f"the reference's own {list(ref)}")
    if any(d < f for d, f in zip(dist, floor)):
        fail(f"bf16 serve: |bf16 - f32| {dist} below {BF16_REF_FLOOR} x "
             f"the reference's own {list(ref_lo)}: the bf16 rounding did "
             "not take effect")
    return fields, srv, plain_pipe, (arrays, stages)


def voice_phase(srv, plain_pipe, bucket):
    """Phase 4d (see the module docstring)."""
    import numpy as np
    import torch
    from ttsx_torch import ops
    from ttsx_torch.serve import make_voice_transform
    arrays, stages = bucket
    mel_src = stages.mel_ref[:1]
    ref_mel = stages.mel_ref[1:2, :REQUEST_FRAMES[1]]
    pros = arrays[1][:1].to(srv.dtype)
    sid = torch.ones(1, dtype=torch.long, device="cuda")
    hop = srv.cfg.vocoder.hop_length
    outs = {}
    for route, pipe in (("kernels", srv.pipe), ("plain", plain_pipe)):
        fn = make_voice_transform(pipe)
        torch.cuda.synchronize()
        ops.reset_launches()
        t1 = time.time()
        wav = fn(mel_src, pros, sid, ref_mel)
        torch.cuda.synchronize()
        outs[route] = dict(wav=wav, launches=ops.launch_counts(),
                           s=time.time() - t1)
    wav = outs["kernels"]["wav"]
    w_ = wav.float().cpu().numpy()
    err = float((wav - outs["plain"]["wav"]).abs().max())
    fields = dict(mel_src_frames=int(mel_src.shape[1]),
                  ref_mel_frames=int(ref_mel.shape[1]), style_id_tgt=1,
                  dtype=str(wav.dtype).replace("torch.", ""),
                  samples=int(w_.shape[1]), peak=float(np.abs(w_).max()),
                  launches=outs["kernels"]["launches"],
                  plain_launches=outs["plain"]["launches"],
                  first_call_s=outs["kernels"]["s"],
                  wav_max_abs_err_vs_plain=err, wav_tolerance=WAV_TOL)
    if w_.shape != (1, FRAMES * hop, 1) or not np.isfinite(w_).all():
        fail(f"voice transform: bad waveform {w_.shape}, finite "
             f"{bool(np.isfinite(w_).all())}")
    if fields["peak"] < SILENT:
        fail("voice transform: silent waveform")
    if outs["kernels"]["launches"] != SERVE_LAUNCHES:
        fail(f"voice transform: launches {outs['kernels']['launches']}, "
             f"want {SERVE_LAUNCHES}")
    if any(outs["plain"]["launches"].values()):
        fail("the plain voice transform launched a kernel")
    if err > WAV_TOL:
        fail(f"voice transform: kernels differ from plain by {err}")
    return fields


def stream_phase(pipe, seed: int):
    """Phase 4e (see the module docstring)."""
    import numpy as np
    import torch
    from ttsx_torch import ops
    from ttsx_torch.streaming import StreamingSynthesizer
    ss = StreamingSynthesizer(pipe, chunk_frames=STREAM_CHUNK,
                              overlap_frames=STREAM_OVERLAP, device="cuda")
    cfg, ac = pipe.cfg, pipe.cfg.acoustic
    rng = np.random.default_rng(seed + 1)
    n = STREAM_FRAMES
    x = dict(text=rng.standard_normal((1, n, ac.text_emb_dim)),
             pros=rng.standard_normal((1, n, ac.cond_dim)),
             emo=rng.dirichlet(np.ones(ac.emotion_dim))[None],
             spk=0.5 * rng.standard_normal((1, ac.speaker_dim)))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    sid = np.array([int(rng.integers(0, cfg.refiner.num_styles))])
    chunks = ss.chunks(n)
    torch.cuda.synchronize()
    ops.reset_launches()
    t1 = time.time()
    wav = ss.synthesize(x["text"], x["pros"], x["emo"], x["spk"], sid)
    secs = time.time() - t1
    launches = ops.launch_counts()
    want = dict(SERVE_LAUNCHES, upsample=4 * len(chunks),
                resblock_stack=4 * len(chunks))
    # one chunk's length: the streamer against a direct call
    m = STREAM_CHUNK
    short = ss.synthesize(x["text"][:, :m], x["pros"][:, :m], x["emo"],
                          x["spk"], sid)
    direct = pipe.synthesize(*(torch.as_tensor(a, device="cuda") for a in (
        x["text"][:, :m], x["pros"][:, :m], x["emo"], x["spk"])),
        torch.as_tensor(sid, device="cuda")).wav[:, :, 0].cpu().numpy()
    direct_err = float(np.abs(short - direct).max())
    fields = dict(frames=n, chunk=STREAM_CHUNK, overlap=STREAM_OVERLAP,
                  chunks=len(chunks), samples=int(wav.shape[1]),
                  seconds_audio=n * ss.hop / cfg.vocoder.sr,
                  synth_s=secs, peak=float(np.abs(wav).max()),
                  launches=launches, want_launches=want,
                  one_chunk_vs_direct_max_abs=direct_err,
                  one_chunk_tolerance=STREAM_DIRECT_TOL)
    if wav.shape != (1, n * ss.hop) or not np.isfinite(wav).all():
        fail(f"stream: bad waveform {wav.shape}, finite "
             f"{bool(np.isfinite(wav).all())}")
    if fields["peak"] < SILENT:
        fail("stream: silent waveform")
    if launches != want:
        fail(f"stream: launches {launches}, want {want}")
    if direct_err > STREAM_DIRECT_TOL:
        fail(f"stream: one chunk differs from a direct call by {direct_err}")
    return fields


def time_bf16(pipe, reqs, scale_stats):
    """One 10 s request at batch 1 through a bf16 and an f32 server on the
    same f32 pipeline: each stage's time (CUDA events, inputs cast as the
    server casts them), a refiner pass and the acoustic model replayed
    from a CUDA graph (device time, without the host's cost of issuing
    each kernel), the request end to end (host clock around
    ``serve_batch``, BF16_REPEATS each after a warm-up, interleaved) and
    each request's peak memory beyond what was allocated before it."""
    import numpy as np
    import torch
    from ttsx_torch.serve import SynthesisServer
    t0 = time.time()
    srvs = {dt: SynthesisServer(pipe, device="cuda", max_batch=1,
                                frames=FRAMES, bf16=dt == "bf16",
                                scale_stats=scale_stats.cpu())
            for dt in ("f32", "bf16")}
    out = {}
    *arr, _ = srvs["f32"].pad_batch(reqs[:1])
    for dt, srv in srvs.items():
        text, pros, emo, spk = (torch.as_tensor(a, device="cuda")
                                .to(srv.dtype) for a in arr[:4])
        sid = torch.as_tensor(arr[4], device="cuda")
        p = srv.pipe
        scale = srv.scale_stats.expand(1, -1)
        with torch.inference_mode():
            mel0 = p.acoustic(text, pros, emo, speaker=spk).mel
            mel_ref = p.refiner(mel0, pros, sid, text).mel_ref
            style = p.gst(mel_ref)
            out[f"stages_ms_{dt}"] = {
                "acoustic": cuda_ms(lambda: p.acoustic(text, pros, emo,
                                                       speaker=spk)),
                "refiner": cuda_ms(lambda: p.refiner(mel0, pros, sid, text)),
                "gst": cuda_ms(lambda: p.gst(mel_ref)),
                "generator": cuda_ms(lambda: p.generator(
                    mel_ref, pros, style, emo, scale=scale))}
            out[f"graph_ms_{dt}"] = {
                "acoustic": graph_ms(lambda: p.acoustic(
                    text, pros, emo, speaker=spk), reps=3),
                "refiner": graph_ms(lambda: p.refiner(
                    mel0, pros, sid, text), reps=3)}
        srv.serve_batch(reqs[:1])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        srv.serve_batch(reqs[:1])
        torch.cuda.synchronize()
        out[f"request_peak_mem_gb_{dt}"] = (
            torch.cuda.max_memory_allocated() - base) / 1e9
    e2e = {dt: [] for dt in srvs}
    for _ in range(BF16_REPEATS):
        for dt, srv in srvs.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            srv.serve_batch(reqs[:1])
            e2e[dt].append((time.perf_counter() - t1) * 1e3)
    for dt, v in e2e.items():
        out[f"e2e_ms_{dt}"] = float(np.median(v))
        out[f"e2e_ms_all_{dt}"] = v
    out["bf16_over_f32"] = out["e2e_ms_bf16"] / out["e2e_ms_f32"]
    out["seconds"] = time.time() - t0
    return out


# ------------------------------------------------------------------ training
def write_wav_tree(root: Path, seed: int, sr: int) -> int:
    """<speaker>/<domain>/<style>/*.wav, 4 x 2 x 2 x 2 = 32 utterances of
    1.5-4 s with transcripts: voiced syllables (five harmonics of a
    wandering f0, 3-6 Hz envelope) with short pauses, over a little
    noise; speaker sets the pitch, style the loudness, domain the noise."""
    import numpy as np
    from ttsx_torch.data.dataset import write_wav
    rng = np.random.default_rng(seed)
    words = ("the a voice of train mel band noise clear slow fast tone "
             "speaker style domain test").split()
    n = 0
    for s in range(4):
        for d in ("studio", "phone"):
            for style in ("calm", "loud"):
                folder = root / f"spk{s}" / d / style
                folder.mkdir(parents=True)
                for u in range(2):
                    k = int(rng.integers(int(1.5 * sr), int(4.0 * sr)))
                    t = np.arange(k) / sr
                    f0 = (100 + 40 * s) * (1 + 0.1 * np.sin(
                        2 * np.pi * rng.uniform(0.5, 2) * t))
                    phase = 2 * np.pi * np.cumsum(f0) / sr
                    voice = sum(np.sin(h * phase) / h for h in range(1, 6))
                    env = np.clip(np.sin(2 * np.pi * rng.uniform(3, 6) * t),
                                  0, None)
                    amp = 0.2 if style == "calm" else 0.5
                    noise = 0.003 if d == "studio" else 0.02
                    wav = amp * env * voice / 2 + noise * rng.standard_normal(k)
                    write_wav(folder / f"u{u}.wav", wav.astype(np.float32), sr)
                    (folder / f"u{u}.txt").write_text(" ".join(
                        rng.choice(words, int(rng.integers(3, 9)))))
                    n += 1
    return n


def gan_work(vc, batch: int, samples: int):
    """Multiply-add operations (2 per MAC) of one forward of the generator
    and of each discriminator on ``batch`` waveforms of ``samples`` (the
    convolutions and transposed convolutions; the norms, FiLM, attention
    and activations are left out), in TFLOP."""
    def conv(t_out, cin, cout, k):
        return 2.0 * batch * t_out * cin * cout * k
    up = lambda t, s: -(-t // s)
    g = vc.disc_ch_growth
    mpd = 0.0
    for p in vc.disc_periods:
        h, cin = up(samples, p), 1
        for _ in range(4):
            h = up(h, 3)
            mpd += conv(h * p, cin, cin * g, 5)
            cin *= g
        mpd += conv(h * p, cin, 1, 3)
    msd, t = 0.0, samples
    for ks in vc.disc_kernel_sizes[:3]:
        tt, cin = t, 1
        for i in range(5):
            tt = up(tt, 2) if i < 3 else tt
            msd += conv(tt, cin, cin * g, ks)
            cin *= g
        msd += conv(tt, cin, 1, 3)
        t = up(t, 2)
    mbd, chunk = 0.0, up(samples, vc.num_bands)
    for _ in range(vc.num_bands):
        tt, cin = chunk, 1
        for _ in range(4):
            tt = up(tt, 2)
            mbd += conv(tt, cin, cin * g, 15)
            cin *= g
        mbd += conv(tt, cin, 1, 3)
    nb, hop = vc.num_bands, math.prod(vc.upsample_factors)
    t, ch = samples // hop, vc.hidden_dim
    gen = nb * conv(t, vc.channels // nb, ch, 7)
    for f in vc.upsample_factors:
        gen += nb * conv(t * f, ch, ch // 2, 2)       # 2f taps over f phases
        t, ch = t * f, ch // 2
        gen += nb * len(vc.res_dilations) * conv(t, ch, ch, 9)
    gen += conv(t, nb * ch, 1, 7)
    return {k: v / 1e12 for k, v in
            dict(generator=gen, mpd=mpd, msd=msd, mbd=mbd).items()}


def xdev_window(batch, frames: int, hop: int):
    """The first ``frames`` mel frames of a trainer batch and the wav's
    first ``frames * hop`` samples."""
    from ttsx_torch.train.blocks import FRAME_KEYS
    out = {k: (v[:, :frames] if k in FRAME_KEYS and v.ndim >= 2 else v)
           for k, v in batch.items()}
    out["wav"] = batch["wav"][:, :frames * hop]
    return out


def cross_device_losses(cfg, batch, seed: int):
    """First-step acoustic and refiner losses of fresh blocks (same seed,
    same init) on the CPU, with its draws recorded, and on the card with
    those draws replayed; the refiner takes the CPU's acoustic mel. The
    vocoder's first ``d_total`` (with R1) and ``g_loss`` likewise, on a
    window of ``XDEV_VOC_FRAMES`` frames."""
    from ttsx_torch.nn.draws import RecordingDraws, ReplayDraws
    from ttsx_torch.train.blocks import AcousticBlock, RefinerBlock
    out = {}
    for name, cls in (("acoustic", AcousticBlock), ("refiner", RefinerBlock)):
        cpu, card = cls(cfg, "cpu", seed), cls(cfg, "cuda", seed)
        cpu.state.draws = RecordingDraws(cpu.state.draws)
        if name == "acoustic":
            got_cpu = cpu.train_step(batch)
            mel_pred = got_cpu["mel_pred"]
        else:
            got_cpu = cpu.train_step(batch, mel_pred, 1.0, 1.0)
        card.state.draws = ReplayDraws(cpu.state.draws.records, "cuda")
        got_card = (card.train_step(batch) if name == "acoustic" else
                    card.train_step(batch, mel_pred.cuda(), 1.0, 1.0))
        if not card.state.draws.exhausted():
            fail(f"{name}: the card drew less than the CPU")
        a, b = float(got_cpu["metrics"]["loss"]), float(
            got_card["metrics"]["loss"])
        moved = [(p.detach().cpu() - q.detach().cpu()).abs().max()
                 for p, q in zip(cpu.model.parameters(),
                                 card.model.parameters())]
        out[name] = dict(loss_cpu=a, loss_card=b,
                         rel_err=abs(a - b) / max(abs(a), 1e-30),
                         card_device=str(next(card.model.parameters()).device),
                         params_max_abs_diff_after=float(max(moved)),
                         draws=len(cpu.state.draws.records))
        if name == "acoustic":
            out[name]["mel_pred_max_abs_diff"] = float(
                (got_card["mel_pred"].cpu() - mel_pred).abs().max())
    from ttsx_torch.train.blocks import VocoderBlock
    cpu, card = VocoderBlock(cfg, "cpu", seed), VocoderBlock(cfg, "cuda", seed)
    win = xdev_window(batch, XDEV_VOC_FRAMES, cpu.hop)
    cpu.states["gen"].draws = RecordingDraws(cpu.states["gen"].draws)
    got_cpu = {**cpu.disc_step(win), **cpu.gen_step(win)}
    card.states["gen"].draws = ReplayDraws(
        cpu.states["gen"].draws.records, "cuda")
    got_card = {**card.disc_step(win), **card.gen_step(win)}
    if not card.states["gen"].draws.exhausted():
        fail("vocoder: the card drew less than the CPU")
    for key in ("d_total", "g_loss"):
        a, b = float(got_cpu[key]), float(got_card[key])
        out[f"vocoder_{key}"] = dict(
            loss_cpu=a, loss_card=b, rel_err=abs(a - b) / max(abs(a), 1e-30),
            card_device=str(next(card.gen.parameters()).device),
            window=list(win["wav"].shape), r1_cpu=float(got_cpu["r1"]),
            r1_card=float(got_card["r1"]))
    return out


def train_phase(seed: int, workdir: Path):
    """The trainer's main path at full width on the card; see the module
    docstring (phase 5). Returns the phase's fields, the audio config,
    one wav batch K3 ran on of each shape, largest first (for the timing
    phase), the trainer, and the largest batch its vocoder trained on."""
    from ttsx_torch.core.config import tts_cfg
    from ttsx_torch.ops import mel_frontend as k3
    cfg = tts_cfg()
    n_utts = write_wav_tree(workdir / "wavs", seed, cfg.audio.sample_rate)
    launch, k3_seen = k3._launch, []

    def kept(wav, audio):
        """K3's own launch (counted there), its input and output kept for
        the check after the run."""
        out = launch(wav, audio)
        k3_seen.append((wav.clone(), out.clone(), audio))
        return out

    k3._launch = kept
    try:
        fields, trainer, gan_batch = run_trainer(cfg, seed, workdir)
    finally:
        k3._launch = launch
    checks = [k3_check(w, o, a, {"batch": slice(None)})
              for w, o, a in k3_seen]
    fields.update(utterances=n_utts, k3_checked=len(k3_seen),
                  k3_checks=checks, k3_tolerance=dict(
                      log_mel_vs_float64=K3_TOL, silent_abs=K3_TAIL_TOL),
                  k3_max_abs_err=max(c["max_abs_err"] for c in checks),
                  k3_plain_max_abs_err=max(c["plain_max_abs_err"]
                                           for c in checks),
                  k3_max_abs_err_silent=max(c["max_abs_err_silent"]
                                            for c in checks))
    if len(k3_seen) != fields["launches"]["mel_frontend"]:
        fail(f"kept {len(k3_seen)} K3 launches of "
             f"{fields['launches']['mel_frontend']}")
    if not all(c["ok"] for c in checks):
        fail(f"K3 fails its gate on a collated batch: "
             f"{[c for c in checks if not c['ok']]}")
    by_shape = {tuple(w.shape): w for w, _, _ in k3_seen}
    return fields, k3_seen[0][2], [by_shape[k] for k in sorted(
        by_shape, key=lambda k: (k[1], k[0]), reverse=True)], trainer, \
        gan_batch


class GanWatch:
    """Instruments the vocoder block of a trainer: each discriminator and
    generator step's metrics and ms; for each part, the parameters with a
    non-zero gradient at its first two updates and whether the second left
    them moved from where they started; the largest |EMA - (d * ema + (1 -
    d) * params)| over the generator's updates; the STFT filterbank."""

    def __init__(self, voc):
        self.voc, self.disc, self.gen, self.moved = voc, [], [], {}
        self.start, self.nonzero, self.batch = {}, {}, None
        self.ema_err = 0.0
        self.fb0 = {k: v.clone() for k, v in voc.stft.state_dict().items()}
        for kind in ("disc_step", "gen_step"):
            setattr(voc, kind, self._timed(kind, getattr(voc, kind)))
        for name, st in voc.states.items():
            st.tx.step = self._watched(name, st, st.tx.step)
        gen = voc.states["gen"]
        apply = gen.apply_gradients

        def checked():
            prev = {n: e.clone() for n, e in gen.ema.items()}
            lr = apply()
            d = gen.ema_decay
            for n, p in gen.module.named_parameters():
                want = d * prev[n] + (1.0 - d) * p.detach()
                self.ema_err = max(self.ema_err, float(
                    (gen.ema[n] - want).abs().max()))
            return lr
        gen.apply_gradients = checked

    def _timed(self, kind, fn):
        import torch

        def run(batch):
            if self.batch is None or (batch["wav"].shape[1]
                                      > self.batch["wav"].shape[1]):
                self.batch = batch
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = fn(batch)
            torch.cuda.synchronize()
            rec = {k: float(v) for k, v in m.items()}
            rec["ms"] = (time.perf_counter() - t1) * 1e3
            (self.disc if kind == "disc_step" else self.gen).append(rec)
            return m
        return run

    def _watched(self, name, st, step):
        import torch

        def run():
            params = st.tx.params
            if st.step == 0:
                self.start[name] = [p.detach().clone() for p in params]
                self.nonzero[name] = [False] * len(params)
            if st.step < 2:
                self.nonzero[name] = [
                    a or (p.grad is not None and bool(p.grad.ne(0).any()))
                    for a, p in zip(self.nonzero[name], params)]
            lr = step()
            if st.step == 1:
                still = [a for a, p, nz in zip(self.start[name], params,
                                               self.nonzero[name])
                         if nz and torch.equal(a, p.detach())]
                self.moved[name] = dict(params=len(params),
                                        nonzero_grad=sum(self.nonzero[name]),
                                        not_moved=len(still))
            return lr
        return run

    def check(self):
        """The phase's vocoder checks; returns its fields."""
        import numpy as np
        import torch
        if not self.disc or not self.gen:
            fail("the vocoder never trained")
        bad = [r for r in self.disc + self.gen
               if not all(np.isfinite(v) for v in r.values())]
        if bad:
            fail(f"non-finite vocoder metrics: {bad}")
        if not self.disc[0]["r1"] > 0 or len(self.disc) < 2 or \
                self.disc[1]["r1"] != 0:
            fail(f"R1 should be non-zero on the first discriminator step "
                 f"only: {[r['r1'] for r in self.disc]}")
        # the GST's gradient reaches it through the generator's FiLM
        # projections, which start at zero: none at its first two updates
        parts = ("gen", "gst", "mpd", "msd", "mbd")
        if set(self.moved) != set(parts) or any(
                v["not_moved"] or (n != "gst" and not v["nonzero_grad"])
                for n, v in self.moved.items()):
            fail(f"after update 2 a part's parameters with a gradient did "
                 f"not move: {self.moved}")
        if any(not torch.equal(v, self.fb0[k])
               for k, v in self.voc.stft.state_dict().items()):
            fail("the STFT loss's filterbank moved")
        if self.ema_err > 1e-6:
            fail(f"the generator's EMA is off d*e + (1-d)*p by "
                 f"{self.ema_err}")
        return dict(disc_steps=self.disc, gen_steps=self.gen,
                    moved_after_update_2=self.moved, ema_max_abs_err=self.ema_err,
                    updates={n: st.step for n, st in self.voc.states.items()},
                    filterbank_unchanged=True)


def run_trainer(cfg, seed: int, workdir: Path):
    """The phase's run: returns its fields and the trainer."""
    import numpy as np
    import torch
    from ttsx_torch import ops
    from ttsx_torch.cli.main import data_streams
    from ttsx_torch.train.engine import UnifiedTrainer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stream, val = data_streams(cfg, str(workdir / "wavs"), "cuda")
    collated, shapes = [], []

    def counted():
        for b in stream:
            collated.append(b["collate_time"])
            shapes.append(list(b["mel"].shape))
            yield b

    trainer = UnifiedTrainer(cfg, counted(), val, device="cuda")
    if list(trainer.blocks) != ["acoustic", "refiner", "vocoder"]:
        fail(f"the trainer's default blocks are {list(trainer.blocks)}")
    spans = {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans.setdefault(name, []).append(
                (time.perf_counter() - t1) * 1e3)
            return out
        return run

    for name in ("acoustic", "refiner"):
        blk = trainer.blocks[name]
        step_fn = "train_step_accum" if name == "acoustic" else "train_step"
        setattr(blk, step_fn, timed(name, getattr(blk, step_fn)))
        blk.state.tx.step = timed(f"{name}_optimizer", blk.state.tx.step)
    gan = GanWatch(trainer.blocks["vocoder"])
    ac = trainer.blocks["acoustic"].model
    rf = trainer.blocks["refiner"].model
    snap = lambda m: [p.detach().clone() for p in m.parameters()]
    moved = lambda a, b: any(not torch.equal(x, y) for x, y in zip(a, b))
    p0, vq0 = snap(ac), rf.vq.stage_0.embed_sum.clone()
    it = trainer.train_iter
    steps, times = [], []
    for i in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        steps.append(trainer.train_step(next(it)))
        times.append((time.perf_counter() - t1) * 1e3)
        if i == 0 and moved(p0, snap(ac)):
            fail("the first update (lr 0) moved the acoustic weights")
        if i == 1 and not moved(p0, snap(ac)):
            fail("the second update left the acoustic weights as they were")
    vm = trainer.validate()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_batches = len(collated) + len(val)
    losses = {k: v for m in steps for k, v in m.items() if k.endswith("loss")}
    bad = [k for m in steps for k, v in m.items()
           if k != "step_time_s" and not np.isfinite(v)]
    if bad or not np.isfinite(vm["val_l1"]):
        fail(f"non-finite training metrics: {bad} / {vm}")
    if launches["mel_frontend"] != n_batches:
        fail(f"K3 launched {launches['mel_frontend']} times for "
             f"{n_batches} collated batches")
    if launches["upsample"] or launches["resblock_stack"]:
        fail(f"the trainer launched a vocoder kernel: {launches}")
    if trainer.blocks["refiner"].state.step != TRAIN_STEPS // 2:
        fail(f"the refiner stepped {trainer.blocks['refiner'].state.step} "
             f"times in {TRAIN_STEPS} engine steps")
    if torch.equal(vq0, rf.vq.stage_0.embed_sum):
        fail("the refiner's VQ statistics did not move")
    st = trainer.state
    if (abs(st.noise_scale - float(np.clip(vm["val_l1"], 0.05, 1.0))) > 1e-9
            or abs(st.l1_weight - float(np.clip(1 - vm["val_l1"], 0.1, 1.0)))
            > 1e-9):
        fail(f"noise scale / L1 weight do not follow val L1: {vars(st)}")
    if sum(1 for m in steps if "vocoder/g_loss" in m) != TRAIN_STEPS:
        fail("the vocoder did not train on every engine step")
    vocoder = gan.check()
    xb = {k: v[:2] for k, v in val[0].items()}
    xdev = cross_device_losses(cfg, xb, seed)
    bad = {k: v for k, v in xdev.items() if not v["rel_err"] <= XDEV_RTOL}
    return dict(
        engine_steps=TRAIN_STEPS, blocks=list(trainer.blocks),
        batch=cfg.train.batch_size, grad_accum=cfg.train.grad_accum_steps,
        collated_batches=n_batches, mel_shapes=shapes,
        launches=launches, losses_last=losses,
        acoustic_loss=[m["acoustic/loss"] for m in steps],
        refiner_loss=[m["refiner/loss"] for m in steps if "refiner/loss" in m],
        refiner_updates=trainer.blocks["refiner"].state.step,
        vocoder_d_loss=[m["vocoder/d_loss"] for m in steps],
        vocoder_g_loss=[m["vocoder/g_loss"] for m in steps],
        vocoder_d_steps=[m["vocoder/d_steps"] for m in steps],
        vocoder=vocoder, vocoder_batch=list(gan.batch["wav"].shape),
        oom_count=st.oom_count,
        val=vm, noise_scale=st.noise_scale, l1_weight=st.l1_weight,
        step_ms=times, step_ms_median_after_first=float(np.median(times[1:])),
        block_ms=spans,
        collate_ms=[c * 1e3 for c in collated],
        collate_ms_mean=float(np.mean(collated)) * 1e3,
        peak_mem_gb=peak, cross_device=xdev, cross_device_rtol=XDEV_RTOL,
        cross_device_ok=not bad), trainer, gan.batch


def vocoder_export_phase(trainer, workdir: Path, batch, seed: int):
    """Phase 5b (see the module docstring). Returns its fields."""
    import dataclasses
    import numpy as np
    import torch
    from ttsx_torch import ops
    from ttsx_torch.core.config import zoo_cfg
    from ttsx_torch.models.pipeline import TTSPipeline
    from ttsx_torch.ops import film_resblock_stack
    from ttsx_torch.serve import SynthesisServer
    from ttsx_torch.train.blocks import VocoderBlock
    from ttsx_torch.train.slim_export import (load_vocoder_slim,
                                              save_vocoder_slim)
    from ttsx_torch.weights import load_flax, load_slim_npz
    from ttsx_torch.zoo import DEFAULT_ZOO
    voc = trainer.blocks["vocoder"]
    path = str(workdir / "vocoder.npz")
    save_vocoder_slim(path, voc, meta={"steps": trainer.state.global_step})
    cfg = trainer.cfg
    kcfg = dataclasses.replace(cfg, vocoder=dataclasses.replace(
        cfg.vocoder, use_pallas_upsample=True, use_pallas_resblock_stack=True))
    pipe = TTSPipeline(kcfg, acoustic=trainer.blocks["acoustic"].model,
                       refiner=trainer.blocks["refiner"].model)
    trees = load_slim_npz(path)
    load_flax(pipe.generator, trees["gen_ema"])
    load_flax(pipe.gst, trees["gst"])
    pipe = pipe.to("cuda")
    served_params = pipe.generator.state_dict()
    ema_err = max(float((served_params[n] - e).abs().max())
                  for n, e in voc.states["gen"].ema.items())
    # K1 and K2 are forward-only: a call that needs a gradient raises
    ops.reset_launches()
    x = torch.randn(1, 16, kcfg.vocoder.channels, device="cuda")
    refused = []
    for what, call in (
            ("generator", lambda: pipe.generator(
                x, torch.zeros(1, 16, kcfg.acoustic.cond_dim, device="cuda"),
                torch.zeros(1, kcfg.vocoder.style_dim, device="cuda"),
                torch.zeros(1, kcfg.acoustic.emotion_dim, device="cuda"))),
            ("resblock_stack", lambda: film_resblock_stack(
                torch.randn(4, 64, 8, device="cuda", requires_grad=True),
                torch.randn(1, 16, 48, device="cuda"),
                torch.randn(3, 3, 8, 16, device="cuda"),
                torch.zeros(3, 16, device="cuda"),
                torch.randn(3, 3, 8, 8, device="cuda"),
                torch.zeros(3, 8, device="cuda"), (1, 3, 5)))):
        try:
            call()
        except RuntimeError as e:
            if "forward-only" not in str(e):
                raise
            refused.append(what)
    if refused != ["generator", "resblock_stack"] or any(
            ops.launch_counts().values()):
        fail(f"K1 / K2 under a gradient: refused {refused}, launches "
             f"{ops.launch_counts()}")
    reqs = requests(kcfg, seed)[:1]
    srv = SynthesisServer(pipe, device="cuda", max_batch=1, frames=FRAMES,
                          bf16=False)
    wavs, launches, secs = served(srv, reqs, "vocoder_export")
    if launches != SERVE_LAUNCHES:
        fail(f"launches serving the exported vocoder {launches}, want "
             f"{SERVE_LAUNCHES}")
    plain = SynthesisServer(pipe.with_vocoder_kernels(False), device="cuda",
                            max_batch=1, frames=FRAMES, bf16=False)
    ops.reset_launches()
    wavs_plain = plain.serve_batch(reqs)
    if any(ops.launch_counts().values()):
        fail("the plain path launched a kernel")
    wav_err = max(float(np.abs(a - b).max()) for a, b in zip(wavs, wavs_plain))
    if wav_err > WAV_TOL:
        fail(f"the exported vocoder through K1 and K2 differs from plain by "
             f"{wav_err}")
    # the zoo's export warm-starts a block, which takes one GAN step
    zb = VocoderBlock(zoo_cfg(False), "cuda", seed)
    meta = load_vocoder_slim(str(DEFAULT_ZOO / "vocoder.npz"), zb)
    few = xdev_window({k: v[:4] for k, v in batch.items()}, XDEV_VOC_FRAMES,
                      zb.hop)
    zoo_step = {k: float(v) for k, v in {**zb.disc_step(few),
                                         **zb.gen_step(few)}.items()}
    if not all(np.isfinite(v) for v in zoo_step.values()):
        fail(f"the zoo-warm-started GAN step is not finite: {zoo_step}")
    return dict(export_mb=Path(path).stat().st_size / 1e6,
                export_keys=len(np.load(path).files),
                served_vs_ema_max_abs_diff=ema_err, refused_gradient=refused,
                served_frames=REQUEST_FRAMES[0], launches=launches,
                serve_s=secs, peak=float(np.abs(wavs[0]).max()),
                wav_max_abs_err_vs_plain=wav_err, wav_tolerance=WAV_TOL,
                zoo_warm_start_steps=int(meta["steps"]),
                zoo_warm_start_batch=list(few["wav"].shape),
                zoo_warm_start_step=zoo_step)


# ------------------------------------------- checkpoints, stages 1 and 2
def state_diff(got, want):
    """(every entry bitwise equal, max |difference| over the float
    entries) of two flat train states."""
    import torch
    equal, worst = True, 0.0
    for k, w in want.items():
        g = got[k]
        if not torch.equal(g, w):
            equal = False
            if w.is_floating_point():
                worst = max(worst, float((g.float() - w.float()).abs().max()))
            else:
                worst = float("inf")
    return equal, worst


def checkpoint_phase(workdir: Path):
    """Phase 5c (see the module docstring). Returns its fields."""
    import torch
    from ttsx_torch import ops
    from ttsx_torch.cli.main import data_streams
    from ttsx_torch.core.config import tts_cfg
    from ttsx_torch.train.checkpoint import STATE_FILE, flatten
    from ttsx_torch.train.engine import EXTRA, UnifiedTrainer
    cfg = tts_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=CKPT_BATCH, grad_accum_steps=1, val_freq=0,
        checkpoint_freq=CKPT_STOP))
    torch.cuda.synchronize()
    ops.reset_launches()
    stream, _ = data_streams(cfg, str(workdir / "wavs"), "cuda")
    batches = [next(stream) for _ in range(CKPT_STEPS)]
    ckdir = workdir / "checkpoints"
    run_keys = ("global_step",) + tuple(EXTRA)

    def run(steps, start=0, directory=None):
        """A trainer on batches[start:] to ``steps``; restored from
        ``last`` first when it starts past 0. Returns (its flat state
        copied, its run state, ms of the restore)."""
        tr = UnifiedTrainer(cfg, iter(batches[start:]), [], device="cuda",
                            checkpoint_dir=directory)
        restore_ms = None
        if start:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if not tr.restore_checkpoint("last"):
                fail("no 'last' checkpoint to resume from")
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t1) * 1e3
        tr.train(max_steps=steps)
        torch.cuda.synchronize()
        return tr, restore_ms

    with deterministic_ops() as caught:
        tr, _ = run(CKPT_STEPS)
        want = {k: v.clone() for k, v in flatten(tr.block_states).items()}
        want_run = {k: getattr(tr.state, k) for k in run_keys}
        step_ms = [t * 1e3 for t in tr.state.step_times]
        del tr
        tr, _ = run(CKPT_STOP, directory=str(ckdir))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.save_checkpoint("timed")
        save_ms = (time.perf_counter() - t1) * 1e3
        del tr
        tr, restore_ms = run(CKPT_STEPS, CKPT_STOP, str(ckdir))
        bitwise, resumed_diff = state_diff(flatten(tr.block_states), want)
        got_run = {k: getattr(tr.state, k) for k in run_keys}
        del tr
        nondet = nondeterministic(caught)
        straight_diff = None
        if nondet:
            tr, _ = run(CKPT_STEPS)
            straight_diff = state_diff(flatten(tr.block_states), want)[1]
            del tr
    launches = ops.launch_counts()
    fields = dict(
        batch=CKPT_BATCH, grad_accum=1, steps=CKPT_STEPS, stop_at=CKPT_STOP,
        mel_shapes=[list(b["mel"].shape) for b in batches],
        entries=len(want), bitwise_equal=bitwise,
        resumed_max_abs_diff=resumed_diff,
        nondeterministic_ops=nondet,
        straight_runs_max_abs_diff=straight_diff,
        run_state=got_run, run_state_equal=got_run == want_run,
        step_ms=step_ms,
        checkpoint_mb=(ckdir / "timed" / STATE_FILE).stat().st_size / 1e6,
        save_ms=save_ms, restore_ms=restore_ms, launches=launches)
    if launches != {**{k: 0 for k in launches},
                    "mel_frontend": CKPT_STEPS + 1}:
        fail(f"launches in the checkpoint phase {launches}")
    if not fields["run_state_equal"]:
        fail(f"resumed run state {got_run} != uninterrupted {want_run}")
    if nondet:
        if not resumed_diff <= 2 * straight_diff:
            fail(f"resumed run {resumed_diff} from the uninterrupted one, "
                 f"two uninterrupted runs {straight_diff} apart")
    elif not bitwise:
        fail(f"the resumed run differs from the uninterrupted one by "
             f"{resumed_diff} with every op deterministic")
    return fields


def timed_steps(step, n: int):
    """Runs ``step()`` n times; (results, ms of each, the card synced)."""
    import torch
    out, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out.append(step())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    return out, ms


def refenc_phase(seed: int):
    """Phase 5d (see the module docstring). Returns its fields."""
    import numpy as np
    import torch
    from ttsx_torch import ops
    from ttsx_torch.data.tonecorpus import ToneCorpus
    from ttsx_torch.eval.metrics import all_pairs_eer
    from ttsx_torch.train.refenc_trainer import RefEncTrainer
    from ttsx_torch.zoo import AUDIO, load_refenc
    torch.cuda.synchronize()
    ops.reset_launches()
    card, enc = load_refenc(device="cuda")
    cpu, _ = load_refenc(device="cpu")
    corpus = ToneCorpus(n_speakers=8, audio=AUDIO)

    def mels(per_speaker, frames, s):
        utts = corpus.utterances(per_speaker, frames, seed=s)
        return (corpus.features(utts, device="cuda")["mel"],
                np.asarray([u.speaker for u in utts]))

    held, spk = mels(4, REFENC_FRAMES, HELD_OUT_SEED + seed)
    e_card, e_cpu = card.embed(held).cpu(), cpu.embed(held)
    emb_err = float((e_card - e_cpu).abs().max())
    eer = {"card": all_pairs_eer(e_card.numpy(), spk),
           "cpu": all_pairs_eer(e_cpu.numpy(), spk)}
    # steps at the zoo's width from its weights, the rate warmed up in one
    # update (the zoo's 5000-update warmup would leave lr near 0)
    tcfg = dataclasses.replace(card.cfg, warmup_steps=1)
    tr_card, tr_cpu = RefEncTrainer(tcfg, "cuda"), RefEncTrainer(tcfg, "cpu")
    tr_card.params.load_state_dict(card.params.state_dict())
    tr_cpu.params.load_state_dict(cpu.params.state_dict())
    del card, cpu
    mel, lab = mels(REFENC_BATCH // 8, REFENC_FRAMES, HELD_OUT_SEED + 1)
    mel2, lab2 = mels(REFENC_BATCH // 8, REFENC_FRAMES, HELD_OUT_SEED + 2)
    start = [p.detach().clone() for p in tr_card.params.parameters()]
    torch.cuda.reset_peak_memory_stats()
    first_cpu = float(tr_cpu.train_step(mel, lab)["loss"])
    steps, step_ms = timed_steps(lambda: tr_card.train_step(mel, lab),
                                 STAGE12_STEPS)
    alpha = np.random.default_rng(seed).beta(0.4, 0.4, REFENC_BATCH)
    perm = np.random.default_rng(seed + 1).permutation(REFENC_BATCH)
    (mix,), mix_ms = timed_steps(lambda: tr_card.train_step_mixup(
        mel, mel2[perm], lab, lab2[perm], alpha.astype(np.float32)), 1)
    (acc,), acc_ms = timed_steps(lambda: tr_card.train_step_accum(
        np.stack([mel, mel2]), np.stack([lab, lab2])), 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in steps + [mix, acc]]
    unmoved = [n for (n, p), p0 in zip(tr_card.params.named_parameters(),
                                       start) if torch.equal(p.detach(), p0)]
    lat, _ = mels(1, REFENC_LATENCY_FRAMES, HELD_OUT_SEED + 3)
    with torch.inference_mode():
        x1 = torch.as_tensor(lat[:1], device="cuda")
        x16 = torch.as_tensor(np.concatenate([lat, lat])[:REFENC_BATCH],
                              device="cuda")
        ms1, ms16 = cuda_ms(lambda: enc(x1)), cuda_ms(lambda: enc(x16))
    launches = ops.launch_counts()
    fields = dict(
        config=dict(ecapa_channels=tcfg.ecapa_channels,
                    speaker_dim=tcfg.speaker_dim, loss=tcfg.loss,
                    num_speakers=tcfg.num_speakers),
        held_out=list(held.shape), embedding_max_abs_diff_card_vs_cpu=emb_err,
        embedding_tolerance=REFENC_EMB_TOL, eer=eer,
        batch=list(mel.shape), losses=losses, first_loss_cpu=first_cpu,
        first_loss_rel_err=abs(losses[0] - first_cpu) / abs(first_cpu),
        unmoved_parameters=unmoved, step_ms=step_ms, mixup_ms=mix_ms[0],
        accum2_ms=acc_ms[0], train_peak_mem_gb=peak,
        embed_ms_batch1=ms1, embed_ms_per_item_batch16=ms16 / REFENC_BATCH,
        latency_frames=REFENC_LATENCY_FRAMES, launches=launches)
    if not emb_err <= REFENC_EMB_TOL:
        fail(f"speaker embeddings card vs CPU differ by {emb_err}")
    if not fields["first_loss_rel_err"] <= XDEV_RTOL:
        fail(f"refenc first-step loss card {losses[0]} vs CPU {first_cpu}")
    if not all(np.isfinite(losses)) or unmoved:
        fail(f"refenc losses {losses}, parameters unmoved {unmoved}")
    if any(launches.values()):
        fail(f"the speaker encoder launched a kernel: {launches}")
    return fields


def prosody_phase(seed: int):
    """Phase 5e (see the module docstring). Returns its fields."""
    import numpy as np
    import torch
    from ttsx_torch import ops
    from ttsx_torch.data.tonecorpus import ToneCorpus
    from ttsx_torch.train.emotion_trainer import EmotionTrainer
    from ttsx_torch.train.prosody_trainer import ProsodyTrainer
    from ttsx_torch.zoo import AUDIO, load_prosody
    torch.cuda.synchronize()
    ops.reset_launches()
    tr_card, pred = load_prosody(device="cuda")
    tr_cpu, pred_cpu = load_prosody(device="cpu")
    corpus = ToneCorpus(n_speakers=8, audio=AUDIO, intonation=0.2)
    outputs, scales = {}, {}
    for i, frames in enumerate(PROSODY_FRAMES):
        utts = corpus.utterances(1, frames, seed=HELD_OUT_SEED + seed + i,
                                 speakers=range(PROSODY_BATCH))
        mel = torch.as_tensor(corpus.features(utts, device="cuda")["mel"])
        with torch.no_grad():
            got, ref = pred(mel.cuda()), pred_cpu(mel)
        outputs[frames] = {k: err(got[k].cpu(), ref[k])[1] for k in ref}
        scales[frames] = {k: float(v.abs().max()) for k, v in ref.items()}
        if frames == PROSODY_FRAMES[0]:
            x = mel[:1].cuda()
            with torch.inference_mode():
                fwd_ms = cuda_ms(lambda: pred(x))
    worst = max(v for o in outputs.values() for v in o.values())
    utts = corpus.utterances(REFENC_BATCH // 8, REFENC_FRAMES,
                             seed=HELD_OUT_SEED + 4)
    mel = corpus.features(utts, device="cuda")["mel"]
    wav = torch.as_tensor(np.stack([u.wav for u in utts]), device="cuda")
    targets = {k: v.cpu().numpy() for k, v in ProsodyTrainer.targets_from_wav(
        wav, tr_card.cfg, REFENC_FRAMES).items()}
    torch.cuda.reset_peak_memory_stats()
    first_cpu = float(tr_cpu.train_step(mel, targets)["loss"])
    steps, step_ms = timed_steps(lambda: tr_card.train_step(mel, targets),
                                 STAGE12_STEPS)
    losses = [float(m["loss"]) for m in steps]
    peak = torch.cuda.max_memory_allocated() / 1e9
    rng = np.random.default_rng(seed)
    emo = EmotionTrainer(device="cuda", seed=seed)
    vader = rng.normal(size=(REFENC_BATCH, 4)).astype(np.float32)
    pvec = rng.normal(size=(REFENC_BATCH, 19)).astype(np.float32)
    multi_hot = (rng.random((REFENC_BATCH, 6)) > 0.7).astype(np.float32)
    emo_steps, emo_ms = timed_steps(lambda: emo.train_step(vader, pvec,
                                                           multi_hot),
                                    STAGE12_STEPS)
    emo_losses = [float(m["loss"]) for m in emo_steps]
    launches = ops.launch_counts()
    fields = dict(
        config=dict(cond_dim=tr_card.cfg.cond_dim,
                    n_layers=tr_card.cfg.n_layers,
                    s4=dataclasses.asdict(tr_card.cfg.s4)),
        outputs_rel_err_card_vs_cpu=outputs, outputs_max_abs_cpu=scales,
        rtol=PROSODY_RTOL,
        outputs_batch=PROSODY_BATCH, forward_ms_864_batch1=fwd_ms,
        batch=list(mel.shape), losses=losses,
        first_loss_cpu=first_cpu,
        first_loss_rel_err=abs(losses[0] - first_cpu) / abs(first_cpu),
        step_ms=step_ms, train_peak_mem_gb=peak, emotion_losses=emo_losses,
        emotion_step_ms=emo_ms, launches=launches)
    if not worst <= PROSODY_RTOL:
        fail(f"prosody outputs card vs CPU: {outputs}")
    if not fields["first_loss_rel_err"] <= XDEV_RTOL:
        fail(f"prosody first-step loss card {losses[0]} vs CPU {first_cpu}")
    if not all(np.isfinite(losses + emo_losses)):
        fail(f"prosody losses {losses}, emotion losses {emo_losses}")
    if any(launches.values()):
        fail(f"the prosody phase launched a kernel: {launches}")
    return fields


def diar_der(res, truth):
    """(strict DER, 250 ms-collar DER) of a controller result, its
    overlap regions scored with both speakers (parity_diar.py:134-140)."""
    from ttsx_torch.eval.metrics import diarization_error_rate
    hyp = [(s, e, spk) for (s, e), spk in zip(res["slices"], res["speakers"])]
    hyp += [(s, e, spk) for s, e, sa, sb, _c in res["overlap_speakers"]
            for spk in (sa, sb)]
    return (diarization_error_rate(truth, hyp),
            diarization_error_rate(truth, hyp, collar=0.25))


def partition(speakers):
    """Speaker names -> indices in order of first appearance."""
    first = {}
    return [first.setdefault(s, len(first)) for s in speakers]


def diarize(ctl, wav_path: str, out: Path):
    """(result, seconds, step_times) of one ``diarize_single``; fails
    unless the job's log says ``ok`` and the result holds segments."""
    t1 = time.perf_counter()
    res = ctl.diarize_single(wav_path, str(out))
    sec = time.perf_counter() - t1
    status = json.loads((out / "diarization_log.json").read_text())
    if status.get("status") != "ok" or not res or not res["slices"]:
        fail(f"diarize_single failed: {status}")
    return res, sec, json.loads((out / "step_times.json").read_text())


def diarizer_phase(seed: int, workdir: Path):
    """Phase 5f (see the module docstring). Returns its fields."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from ttsx_torch import ops
    from ttsx_torch.data.dataset import write_wav
    from ttsx_torch.data.tonecorpus import ToneCorpus
    from ttsx_torch.pipeline.diarizer.cluster import spectral_cluster
    from ttsx_torch.pipeline.diarizer.controller import DiarizerController
    from ttsx_torch.pipeline.diarizer.gnn import GNNClusterer
    from ttsx_torch.pipeline.diarizer.offline import evaluate_dump
    from ttsx_torch.pipeline.diarizer.overlap_net import (
        OverlapScreen, init_overlap_net, make_overlap_windows,
        train_overlap_net)
    from ttsx_torch.pipeline.diarizer.slicer import (dynamic_slice,
                                                     vad_probabilities)
    from ttsx_torch.zoo import AUDIO, DEFAULT_ZOO, load_diar_encoder
    dump_path = DEFAULT_ZOO.parent / "diar_embs.npz"
    D = np.load(dump_path, allow_pickle=True)
    wav = D["wav"]
    truth = [(float(s), float(e), str(k)) for s, e, k in
             zip(D["truth_start"], D["truth_end"], D["truth_spk"])]
    wins = [tuple(w) for w in D["win_plain"]]
    audio_s = len(wav) / AUDIO.sample_rate
    wav_path = workdir / "dialogue_hard.wav"
    write_wav(wav_path, wav.astype(np.float32), AUDIO.sample_rate)
    torch.cuda.synchronize()
    ops.reset_launches()

    # the zoo's slice encoder on the dump's 81 windows, card vs CPU
    card, cpu = load_diar_encoder(device="cuda"), load_diar_encoder(
        device="cpu")
    e_card, e_cpu = card.extract(wav, wins), cpu.extract(wav, wins)
    t1 = time.perf_counter()
    card.extract(wav, wins)
    embed_s = time.perf_counter() - t1
    emb_err = float(np.abs(e_card - e_cpu).max())
    norm_err = float(np.abs(np.linalg.norm(e_card, axis=1) - 1.0).max())

    # the VAD slicer on the card against the dump's slices and windows
    p_card = vad_probabilities(wav, AUDIO, device="cuda")
    p_cpu = vad_probabilities(wav, AUDIO, device="cpu")
    slices, _ = dynamic_slice(wav, AUDIO, DIAR_PROD["min_dur"],
                              DIAR_PROD["max_dur"], device="cuda")
    card_wins = DiarizerController(AUDIO, subsegment_s=1.0,
                                   device="cuda")._explode(slices)
    slicer = dict(
        n_slices=len(slices), n_windows=len(card_wins),
        equal_dump_slices=bool(np.array_equal(np.asarray(slices),
                                              D["slices_raw"])),
        equal_dump_windows=bool(np.array_equal(np.asarray(card_wins),
                                               D["win_plain"])),
        prob_max_abs_diff_card_vs_cpu=float(np.abs(p_card - p_cpu).max()),
        margin_prob_thresh=float(np.abs(p_card - 0.5).min()),
        margin_snap_thresh=float(np.abs(p_card - 0.25).min()))

    # the production controller with the zoo encoder, card and CPU
    runs = {}
    for name, dev, enc in (("card", "cuda", card), ("card_warm", "cuda", card),
                           ("cpu", "cpu", cpu)):
        ctl = DiarizerController(AUDIO, embedder=enc, device=dev, **DIAR_PROD)
        res, sec, steps = diarize(ctl, str(wav_path), workdir / name)
        der, der_c = diar_der(res, truth)
        runs[name] = dict(res=res, seconds=sec, step_times=steps, der=der,
                          der_collar=der_c)
    got, ref = runs["card"], runs["cpu"]
    controller = {k: dict(seconds=v["seconds"],
                          s_per_audio_s=v["seconds"] / audio_s,
                          step_times=v["step_times"], der=v["der"],
                          der_collar=v["der_collar"],
                          n_speakers=len(set(v["res"]["speakers"])),
                          n_segments=len(v["res"]["slices"]))
                  for k, v in runs.items()}
    same_as_cpu = (got["res"]["slices"] == ref["res"]["slices"]
                   and partition(got["res"]["speakers"])
                   == partition(ref["res"]["speakers"])
                   and got["res"]["overlaps"] == ref["res"]["overlaps"])
    offline = evaluate_dump(str(dump_path))

    # the learned overlap screen, trained on the card
    corpus = ToneCorpus(n_speakers=6, audio=AUDIO, seed=0)
    t1 = time.perf_counter()
    net = train_overlap_net(corpus, AUDIO, steps=OVERLAP_STEPS,
                            batch=OVERLAP_BATCH, seed=0, device="cuda")
    torch.cuda.synchronize()
    overlap_train_s = time.perf_counter() - t1
    X, y = make_overlap_windows(corpus, AUDIO, 256, seed=0, device="cuda")
    idx = np.random.default_rng(0).integers(0, len(X), OVERLAP_BATCH)
    with torch.no_grad():
        first_cpu = float(F.binary_cross_entropy_with_logits(
            init_overlap_net(AUDIO, 0, device="cpu")(torch.as_tensor(X[idx])),
            torch.as_tensor(y[idx])))
    losses = net["losses"]
    screen = OverlapScreen(AUDIO, net["params"], device="cuda")
    calls = [0]

    def counted(w):
        calls[0] += 1
        return screen(w)

    ctl = DiarizerController(AUDIO, embedder=card, overlap_screen=counted,
                             device="cuda", **DIAR_PROD)
    res_s, sec_s, steps_s = diarize(ctl, str(wav_path), workdir / "screened")
    der_s = diar_der(res_s, truth)

    # the GNN clusterer's triplet steps, card vs CPU
    labels = spectral_cluster(D["emb_plain"])
    gnn = {}
    for dev in ("cuda", "cpu"):
        g = GNNClusterer(seed=seed)
        g.train(D["emb_plain"], labels, margin=GNN_MARGIN, steps=GNN_STEPS,
                device=dev)
        gnn[dev] = g.losses
    gnn_rel = max(abs(a - b) / max(abs(b), 1e-12)
                  for a, b in zip(gnn["cuda"], gnn["cpu"]))
    launches = ops.launch_counts()

    fields = dict(
        audio_s=audio_s,
        embedder=dict(windows=len(wins), dim=int(e_card.shape[1]),
                      max_abs_diff_card_vs_cpu=emb_err, tolerance=DIAR_EMB_TOL,
                      max_norm_err=norm_err, extract_81_windows_s=embed_s),
        slicer=slicer,
        controller=controller, controller_same_as_cpu=same_as_cpu,
        recorded=dict(der=DIAR_DER, der_collar=DIAR_DER_COLLAR,
                      n_speakers=DIAR_SPEAKERS, n_segments=DIAR_SEGMENTS),
        offline=offline,
        overlap_net=dict(steps=OVERLAP_STEPS, batch=OVERLAP_BATCH,
                         train_s=overlap_train_s, first_loss=losses[0],
                         first_loss_cpu=first_cpu,
                         first_loss_rel_err=abs(losses[0] - first_cpu)
                         / abs(first_cpu),
                         last_loss=losses[-1], eval=net["eval"],
                         train_acc=net["train_acc"],
                         reference_eval_acc=OVERLAP_REF_ACC),
        screened=dict(der=der_s[0], der_collar=der_s[1],
                      seconds=sec_s, step_times=steps_s,
                      screen_calls=calls[0],
                      overlap_step_ms_per_call=1e3 * steps_s["overlap"]
                      / max(calls[0], 1),
                      n_speakers=len(set(res_s["speakers"])),
                      n_overlaps=len(res_s["overlaps"])),
        gnn=dict(steps=GNN_STEPS, margin=GNN_MARGIN, losses_card=gnn["cuda"],
                 losses_cpu=gnn["cpu"], max_rel_err=gnn_rel),
        launches=launches)
    if not emb_err <= DIAR_EMB_TOL or not norm_err <= 1e-5:
        fail(f"slice embeddings card vs CPU {emb_err}, norm error {norm_err}")
    if not (slicer["equal_dump_slices"] and slicer["equal_dump_windows"]):
        fail(f"the card's slices differ from the dump's: {slicer}")
    c = controller["card"]
    if (round(c["der"], 4), round(c["der_collar"], 4)) != (
            round(DIAR_DER, 4), round(DIAR_DER_COLLAR, 4)) or (
            c["n_speakers"], c["n_segments"]) != (DIAR_SPEAKERS,
                                                   DIAR_SEGMENTS):
        fail(f"production controller on the card: {c}")
    if not same_as_cpu:
        fail("the card's segments, partition or overlaps differ from the "
             "CPU route's")
    if offline != DIAR_OFFLINE:
        fail(f"evaluate_dump gives {offline}, want {DIAR_OFFLINE}")
    if not fields["overlap_net"]["first_loss_rel_err"] <= OVERLAP_RTOL:
        fail(f"overlap net first loss card {losses[0]} vs CPU {first_cpu}")
    if not np.isfinite(losses).all():
        fail(f"overlap net losses not finite: {losses}")
    if not net["eval"]["acc"] >= OVERLAP_MIN_ACC:
        fail(f"overlap net held-out accuracy {net['eval']}")
    if not gnn_rel <= GNN_RTOL:
        fail(f"GNN losses card {gnn['cuda']} vs CPU {gnn['cpu']}")
    if any(launches.values()):
        fail(f"the diarizer launched a kernel: {launches}")
    return fields


class Names:
    """``uuid.uuid4`` stand-in (speakers are named from it): 1, 2, ... as
    hex, so that two runs of one job name their speakers alike."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return type("U", (), {"hex": f"{self.n:08x}"})()


def read_tree(root: Path) -> dict:
    """{relative path: parsed JSON} of a job's JSON artifacts."""
    return {str(p.relative_to(root)): json.loads(p.read_text())
            for p in sorted(root.rglob("*.json"))}


def job_margins(out: Path, speakers, audio) -> dict:
    """The smallest margin of each decision of an observer job on the
    card, from its per-speaker wavs and artifacts: energy VAD (frame RMS
    over the loudest frame against 0.02), voicing (the autocorrelation
    peak against 0.3, frame energy against 1e-3), the f0 peak pick (the
    best lag's autocorrelation over the next best's in the band, voiced
    frames), drift's k-sigma test (|smoothed delta| against its
    threshold, relative to it) and tier 2's confidences against 0.90
    and 0.65."""
    import numpy as np
    import torch
    from ttsx_torch.data.dataset import read_wav
    from ttsx_torch.dsp.stft import frame_signal
    from ttsx_torch.pipeline.drift import savgol_smooth
    m = {k: math.inf for k in ("vad", "peak", "energy", "lag_gap",
                               "drift", "tier2_conf")}
    for spk in speakers:
        wav, _ = read_wav(out / "speakers" / f"{spk}.wav",
                          audio.sample_rate)
        x = torch.as_tensor(wav[None], device="cuda")
        fr = frame_signal(x, audio.win_length, audio.hop_length)
        rms = torch.sqrt((fr ** 2).mean(-1) + 1e-10)[0]
        m["vad"] = min(m["vad"], float((rms / rms.max().clamp_min(1e-6)
                                        - 0.02).abs().min()))
        fr = fr - fr.mean(-1, keepdim=True)
        energy = torch.sqrt((fr ** 2).mean(-1) + 1e-10)[0]
        w = fr.shape[-1]
        n = 1 << (2 * w - 1).bit_length()
        spec = torch.fft.rfft(fr, n=n, dim=-1)
        ac = torch.fft.irfft(spec * spec.conj(), n=n, dim=-1)[..., :w]
        ac = (ac / ac[..., :1].clamp_min(1e-10))[0]
        lo = max(2, int(audio.sample_rate / 500.0))
        hi = min(w - 1, int(audio.sample_rate / 65.0))
        top = ac[:, lo:hi].topk(2, dim=-1).values
        voiced = (top[:, 0] > 0.3) & (energy > 1e-3)
        m["peak"] = min(m["peak"], float((top[:, 0] - 0.3).abs().min()))
        m["energy"] = min(m["energy"], float((energy - 1e-3).abs().min()))
        if voiced.any():
            gap = (top[:, 0] - top[:, 1])[voiced]
            m["lag_gap"] = min(m["lag_gap"], float(gap.min()))
        d = out / "emotion_tags" / spk
        deltas = np.asarray(json.loads((d / "drift_vector.json")
                                       .read_text())["deltas"])
        sm = savgol_smooth(deltas)
        th = np.array([2.0 * (sm[max(0, i - 50):i + 1].std() + 1e-6)
                       for i in range(len(sm))])
        m["drift"] = min(m["drift"], float((np.abs(np.abs(sm) - th)
                                            / th).min()))
        for t in json.loads((d / "tier2_tags.json").read_text())["tags"]:
            m["tier2_conf"] = min(m["tier2_conf"], min(
                abs(t["confidence"] - 0.90), abs(t["confidence"] - 0.65)))
    return m


def observer_phase(seed: int, workdir: Path):
    """Phase 5g (see the module docstring). Returns its fields."""
    import contextlib
    import io
    import uuid
    import numpy as np
    import torch
    from ttsx_torch import ops
    from ttsx_torch.cli.main import main_observer
    from ttsx_torch.data.dataset import write_wav
    from ttsx_torch.pipeline import ObserverPipeline, watch
    from ttsx_torch.pipeline.asr import ASRService, ScriptedText
    from ttsx_torch.pipeline.diarizer.controller import DiarizerController
    from ttsx_torch.zoo import AUDIO, DEFAULT_ZOO, load_diar_encoder
    from ttsx_torch.zoo import load_prosody
    D = np.load(DEFAULT_ZOO.parent / "diar_embs.npz", allow_pickle=True)
    wav = D["wav"].astype(np.float32)
    audio_s = len(wav) / AUDIO.sample_rate
    wav_path = workdir / "dialogue_hard.wav"
    write_wav(wav_path, wav, AUDIO.sample_rate)
    models = {dev: (load_diar_encoder(device=dev),
                    load_prosody(device=dev)[1]) for dev in ("cuda", "cpu")}

    def pipeline(dev):
        enc, pred = models[dev]
        ctl = DiarizerController(AUDIO, embedder=enc, device=dev,
                                 **DIAR_PROD)
        asr = ASRService(transcribe_fn=ScriptedText(ASRService(
            audio=AUDIO, device=dev)), audio=AUDIO, device=dev)
        return dict(au=AUDIO, diarizer=ctl, asr=asr, prosody_params=pred,
                    device=dev)

    def job(dev, out):
        """(summary, seconds, artifacts) of one job; fails unless it is
        done with every stage ok and speakers."""
        pipe = ObserverPipeline(**pipeline(dev))
        uuid.uuid4 = Names()
        if dev == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        summary = pipe.run_job(str(wav_path), str(out))
        if dev == "cuda":
            torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        if (summary["status"] != "done" or not summary["speakers"]
                or set(summary["stages"].values()) != {"ok"}):
            fail(f"observer job on {dev}: {summary}")
        return summary, sec, read_tree(out)

    new_uuid = uuid.uuid4
    torch.cuda.synchronize()
    ops.reset_launches()
    try:
        cold, cold_s, _ = job("cuda", workdir / "cold")
        warm, warm_s, got = job("cuda", workdir / "warm")
        cpu, cpu_s, want = job("cpu", workdir / "cpu")
    finally:
        uuid.uuid4 = new_uuid
    log = got["diarization_log.json"]
    bytes_in_use = [r.get("device_bytes_in_use", 0)
                    for r in warm["resources"]]

    # card vs CPU: decisions equal, the trend within its tolerances
    def labels(tree, name, keys):
        return {k: [[t[x] for x in keys] for t in v["tags"]]
                for k, v in tree.items() if k.endswith(name)}
    equal = dict(
        speakers=warm["speakers"] == cpu["speakers"],
        transcripts={k: v for k, v in got.items()
                     if k.endswith("transcript.json")}
        == {k: v for k, v in want.items() if k.endswith("transcript.json")},
        tier1=labels(got, "tier1_tags.json", ("label", "status"))
        == labels(want, "tier1_tags.json", ("label", "status")),
        tier2=labels(got, "tier2_tags.json", ("label", "rule_id", "status"))
        == labels(want, "tier2_tags.json", ("label", "rule_id", "status")),
        arc_pattern=got["arc_classification.json"]["pattern"]
        == want["arc_classification.json"]["pattern"],
        plot_map_beats=got["plot_map.json"]["beats"]
        == want["plot_map.json"]["beats"])
    trend_err, trend_tol = {}, {}
    for k, v in want.items():
        if not k.endswith("prosody_trend.json"):
            continue
        for key, ref in v.items():
            a, b = np.asarray(got[k][key], float), np.asarray(ref, float)
            if a.shape != b.shape:
                fail(f"{k}[{key}]: shape {a.shape} on the card, {b.shape} "
                     f"on the CPU")
            tol = OBSERVER_TREND_TOL.get(key, 0.0)
            if key in OBSERVER_MODEL_STEP:
                tol = (PROSODY_RTOL * float(np.abs(b).max())
                       + OBSERVER_MODEL_STEP[key])
            e = float(np.abs(a - b).max()) if a.size else 0.0
            trend_err[key] = max(trend_err.get(key, 0.0), e)
            trend_tol[key] = max(trend_tol.get(key, 0.0), tol)
            if not e <= tol + 1e-9:
                fail(f"{k}[{key}] card vs CPU {e} > {tol}")
    margins = job_margins(workdir / "warm", warm["speakers"], AUDIO)

    # watch mode: a marker in an inbox, processed to done
    inbox, outbox = workdir / "inbox", workdir / "watched"
    inbox.mkdir()
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                  signal.SIGTERM)}
    watcher, worker, q = watch(str(inbox), str(outbox), poll_s=0.1,
                               **pipeline("cuda"))
    try:
        write_wav(inbox / "stream.wav", wav, AUDIO.sample_rate)
        t1 = time.perf_counter()
        (inbox / "stream.wav.ready").write_text("")
        while (time.perf_counter() - t1 < OBSERVER_WATCH_S
               and q.get_status("stream") not in ("done", "failed",
                                                  "partial-failure")):
            time.sleep(0.02)
        watch_s = time.perf_counter() - t1
        watch_status = q.get_status("stream")
    finally:
        watcher.stop()
        worker.stop()
        for s, h in handlers.items():
            signal.signal(s, h)
    if watch_status != "done":
        fail(f"the watched job is {watch_status} after {watch_s:.1f} s")

    # the command line, once, in this process
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = main_observer(["--job", str(wav_path), "--device", "cuda",
                            "--output-dir", str(workdir / "cli")])
    cli = json.loads(printed.getvalue())
    launches = ops.launch_counts()
    if rc != 0 or cli["status"] != "done" or not cli["speakers"] or set(
            cli["stages"].values()) != {"ok"}:
        fail(f"main_observer: rc {rc}, {cli}")

    fields = dict(
        audio_s=audio_s, speakers=len(warm["speakers"]),
        segments=log["n_slices"],
        first_job_s=cold_s, warm_job_s=warm_s,
        warm_s_per_audio_s=warm_s / audio_s, cpu_job_s=cpu_s,
        step_times=dict(card_cold=cold["step_times"],
                        card_warm=warm["step_times"],
                        cpu=cpu["step_times"]),
        device_bytes_in_use=[min(bytes_in_use), max(bytes_in_use)],
        card_equals_cpu=equal, trend_max_abs_diff_card_vs_cpu=trend_err,
        trend_tolerance=trend_tol, margins=margins,
        watch=dict(status=watch_status, round_trip_s=watch_s),
        main_observer=dict(rc=rc, status=cli["status"],
                           speakers=len(cli["speakers"])),
        launches=launches)
    if (len(warm["speakers"]), log["n_slices"]) != (DIAR_SPEAKERS,
                                                    DIAR_SEGMENTS):
        fail(f"observer job: {len(warm['speakers'])} speakers, "
             f"{log['n_slices']} segments; 5f gives {DIAR_SPEAKERS}, "
             f"{DIAR_SEGMENTS}")
    if not min(bytes_in_use) > 0:
        fail(f"device_bytes_in_use {bytes_in_use}")
    if not all(equal.values()):
        fail(f"the card's job differs from the CPU's: {equal}")
    if any(launches.values()):
        fail(f"the observer job launched a kernel: {launches}")
    return fields


def formant_lists(seed: int, workdir: Path, audio):
    """FormantCorpus's 12 speakers, ``REFENC_CLI_TRAIN`` training and
    ``REFENC_CLI_HELD`` held-out utterances each of ``REFENC_CLI_FRAMES``
    frames, as wavs under ``workdir``; returns the training list's and the
    held-out list's paths and the host seconds. Utterance k is drawn from
    its own generator, seeded (seed, k), on 8 threads."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from ttsx_torch.data.dataset import write_wav
    from ttsx_torch.data.formantcorpus import FormantCorpus
    t1 = time.perf_counter()
    corpus = FormantCorpus(audio=audio)
    per = REFENC_CLI_TRAIN + REFENC_CLI_HELD
    for s_ in range(corpus.n_speakers):
        (workdir / "wavs" / f"spk{s_:02d}").mkdir(parents=True)

    def one(k):
        rng = np.random.default_rng((seed, k))
        spk = k // per
        u = corpus.utterance(spk, int(rng.integers(*REFENC_CLI_FRAMES)), rng)
        path = workdir / "wavs" / f"spk{spk:02d}" / f"u{k % per}.wav"
        write_wav(path, u.wav, audio.sample_rate)
        return f"{path}\tspk{spk:02d}", k % per < REFENC_CLI_TRAIN

    with ThreadPoolExecutor(8) as ex:
        rows = list(ex.map(one, range(corpus.n_speakers * per)))
    lists = []
    for train in (True, False):
        path = workdir / ("train.tsv" if train else "held.tsv")
        path.write_text("\n".join(r for r, t in rows if t == train) + "\n")
        lists.append(path)
    return lists[0], lists[1], time.perf_counter() - t1


def cli_json(main, argv):
    """(rc, the last stdout line as JSON, seconds) of a console script
    called in this process."""
    import contextlib
    import io
    out = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    secs = time.perf_counter() - t1
    print(out.getvalue(), end="", flush=True)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), secs


def refenc_cli_phase(seed: int, workdir: Path, embed_ms_5d: float):
    """Phase 5h (see the module docstring). Returns its fields."""
    import numpy as np
    import torch
    from ttsx_torch import ops
    from ttsx_torch.cli.main import bench_fns, main_bench
    from ttsx_torch.cli.refenc import (embed_files, load_encoder,
                                       main_refenc_eer, main_refenc_fuse,
                                       main_refenc_latency, main_refenc_train)
    from ttsx_torch.core.config import RefEncConfig, tts_cfg, zoo_cfg
    from ttsx_torch.data import load_file_list, prefetch, read_wav
    from ttsx_torch.data.synthetic import synthetic_batch
    from ttsx_torch.dsp.stft import mel_spectrogram
    from ttsx_torch.eval import evaluate_acoustic, load_pt2, microbenchmarks
    from ttsx_torch.models.acoustic import AcousticModel
    from ttsx_torch.train.engine import UnifiedTrainer
    from ttsx_torch.train.observer import Observer
    from ttsx_torch.train.refenc_trainer import RefEncTrainer
    from ttsx_torch.weights import load_flax
    from ttsx_torch.zoo import load_zoo_trees
    torch.cuda.synchronize()
    ops.reset_launches()
    rcfg = RefEncConfig()
    train_list, held_list, corpus_s = formant_lists(seed, workdir,
                                                    rcfg.audio)

    # refenc-train, with the loader's waits in next() and each train step
    # (the card synchronized around it) timed
    waits, steps_ms, loaders = [], [], []
    next_, step_ = prefetch.WavBatchLoader.next, RefEncTrainer.train_step

    def timed_next(self, timeout_ms=30000):
        t1 = time.perf_counter()
        out = next_(self, timeout_ms)
        waits.append(time.perf_counter() - t1)
        loaders[:] = [self]
        return out

    def timed_step(self, *a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = step_(self, *a, **kw)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    ckpt = workdir / "run" / "checkpoints"
    prefetch.WavBatchLoader.next = timed_next
    RefEncTrainer.train_step = timed_step
    try:
        rc, train, train_s = cli_json(main_refenc_train, [
            str(train_list), "--eval-list", str(held_list),
            "--max-steps", str(REFENC_CLI_STEPS),
            "--eval-every", str(REFENC_CLI_EVAL), "--seed", str(seed),
            "--output-dir", str(workdir / "run"), "--device", "cuda"])
    finally:
        prefetch.WavBatchLoader.next = next_
        RefEncTrainer.train_step = step_
    produced, consumed, decode_errors = loaders[0].stats()
    is_native = loaders[0].is_native
    if not is_native:
        fail("refenc-train's loader did not take the native executor")
    if (rc, train["steps"], train["n_speakers"]) != (0, REFENC_CLI_STEPS, 12):
        fail(f"refenc-train rc {rc}: {train}")
    if not ((ckpt / "best" / "meta.json").exists()
            and (ckpt / "final" / "meta.json").exists()):
        fail(f"refenc-train left no best/ and final/ under {ckpt}")

    # refenc-eer on the card and on the CPU, and the embeddings behind it
    eer, embs = {}, {}
    for dev in ("cuda", "cpu"):
        rc, out, secs = cli_json(main_refenc_eer, [
            str(held_list), "--checkpoint", str(ckpt), "--device", dev])
        if rc:
            fail(f"refenc-eer on {dev} rc {rc}")
        eer[dev] = dict(out, seconds=secs)
        embs[dev] = embed_files(load_encoder(rcfg, dev, 0, str(ckpt)),
                                load_file_list(held_list), dev)[0]
    emb_err = float(np.abs(embs["cuda"] - embs["cpu"]).max())

    # refenc-fuse: the .pt2 program reloaded against the eager encoder
    pt2 = workdir / "reference_encoder_exported.pt2"
    rc, fuse, fuse_s = cli_json(main_refenc_fuse, [
        "--checkpoint", str(ckpt), "--out", str(pt2), "--device", "cuda"])
    enc = load_encoder(rcfg, "cuda", 0, str(ckpt))
    wav, _ = read_wav(load_file_list(held_list)[0][0], rcfg.audio.sample_rate)
    with torch.no_grad():
        mel = mel_spectrogram(torch.as_tensor(wav[None], device="cuda"),
                              rcfg.audio)[:, :REFENC_LATENCY_FRAMES]
        export_err = float((load_pt2(pt2)(mel) - enc(mel)).abs().max())
    if rc or not fuse["aot_compiled"]:
        fail(f"refenc-fuse rc {rc}: {fuse}")

    rc, latency, _ = cli_json(main_refenc_latency, ["--runs", "100",
                                                    "--device", "cuda"])
    rc_bench, bench, _ = cli_json(main_bench, ["--device", "cuda"])
    model_fn, model_args, mlp, mlp_args, factor = bench_fns("cuda")
    with torch.inference_mode():
        graph = {"acoustic_ms": graph_ms(lambda: model_fn(*model_args)),
                 "mlp_ms": graph_ms(lambda: mlp(*mlp_args))}
    graph["ratio"] = graph["acoustic_ms"] / graph["mlp_ms"]
    if rc or rc_bench != (0 if bench.get("pass") else 1):
        fail(f"refenc-latency rc {rc}; ttsx-bench rc {rc_bench}: {bench}")

    micro = {k: v["mean_s"] * 1e3
             for k, v in microbenchmarks(device="cuda").items()}
    # evaluate_acoustic: the zoo's acoustic model on two served batches
    acfg = zoo_cfg().acoustic
    tree = load_zoo_trees()["acoustic"]
    rng = np.random.default_rng(seed)
    batches = [dict(
        text_emb=rng.standard_normal((ACOUSTIC_EVAL_BATCH, T,
                                      acfg.text_emb_dim)).astype(np.float32),
        prosody=rng.standard_normal((ACOUSTIC_EVAL_BATCH, T, acfg.cond_dim)
                                    ).astype(np.float32),
        emotion_probs=rng.dirichlet(np.ones(acfg.emotion_dim),
                                    ACOUSTIC_EVAL_BATCH).astype(np.float32),
        mel=rng.standard_normal((ACOUSTIC_EVAL_BATCH, T, acfg.mel_dim)
                                ).astype(np.float32),
        speaker=(0.5 * rng.standard_normal((ACOUSTIC_EVAL_BATCH,
                                            acfg.speaker_dim))
                 ).astype(np.float32),
        speaker_id=np.arange(ACOUSTIC_EVAL_BATCH) + 2 * i)
        for i, T in enumerate(ACOUSTIC_EVAL_FRAMES)]
    acoustic = {dev: evaluate_acoustic(
        load_flax(AcousticModel(acfg), tree).to(dev).eval(), batches)
        for dev in ("cuda", "cpu")}
    loss_rel = (abs(acoustic["cuda"]["val_loss"] - acoustic["cpu"]["val_loss"])
                / abs(acoustic["cpu"]["val_loss"]))

    # one engine step at phase 5c's cut under a counting observer
    cfg = tts_cfg()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=CKPT_BATCH, grad_accum_steps=1, val_freq=0,
        checkpoint_freq=0))
    observed = []
    obs = Observer(lambda stage, batch: observed.append(stage))
    batch = synthetic_batch(cfg, batch=CKPT_BATCH, frames=OBSERVED_FRAMES,
                            seed=seed)
    tr = UnifiedTrainer(cfg, iter([]), None, device="cuda", observer=obs)
    metrics = tr.train_step(batch)
    stepped = sorted({k.split("/")[0] for k in metrics if "/" in k})
    del tr
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    wait_s = float(sum(waits))
    # Python's headers, which the native loader's build reads
    python_h = str(Path(sysconfig.get_paths()["include"]) / "Python.h")
    python_h = python_h if Path(python_h).exists() else None
    fields = dict(
        corpus=dict(speakers=12, train_per_speaker=REFENC_CLI_TRAIN,
                    held_per_speaker=REFENC_CLI_HELD,
                    frames=list(REFENC_CLI_FRAMES), host_s=corpus_s),
        refenc_train=dict(train, seconds=train_s,
                          step_ms_median=float(np.median(steps_ms)),
                          step_ms=steps_ms,
                          loader=dict(produced=produced, consumed=consumed,
                                      decode_errors=decode_errors,
                                      is_native=is_native,
                                      python_h=python_h,
                                      next_calls=len(waits), wait_s=wait_s,
                                      wait_share_of_run=wait_s / train_s,
                                      wait_ms_max=max(waits) * 1e3)),
        refenc_eer=dict(eer, embedding_max_abs_diff_card_vs_cpu=emb_err,
                        tolerance=REFENC_EMB_TOL),
        refenc_fuse=dict(fuse, seconds=fuse_s,
                         reloaded_vs_eager_max_abs_err=export_err,
                         tolerance=EXPORT_TOL),
        refenc_latency=dict(latency, refenc_phase_embed_ms_batch1=embed_ms_5d),
        bench=dict(bench, rc=rc_bench, factor=factor, graph_replay=graph),
        microbenchmarks_ms=micro,
        evaluate_acoustic=dict(acoustic, frames=list(ACOUSTIC_EVAL_FRAMES),
                               val_loss_rel_diff=loss_rel,
                               tolerance=ACOUSTIC_EVAL_RTOL),
        observed_step=dict(stages=stepped, calls=obs.calls,
                           errors=obs.errors, observed=observed),
        launches=launches)
    if eer["cuda"]["eer"] != eer["cpu"]["eer"]:
        fail(f"refenc-eer card {eer['cuda']} vs CPU {eer['cpu']}")
    if not emb_err <= REFENC_EMB_TOL:
        fail(f"refenc-eer embeddings card vs CPU differ by {emb_err}")
    if not export_err <= EXPORT_TOL:
        fail(f"the reloaded .pt2 program differs from the encoder by "
             f"{export_err}")
    if not loss_rel <= ACOUSTIC_EVAL_RTOL:
        fail(f"evaluate_acoustic val_loss card vs CPU: {acoustic}")
    if obs.errors or obs.calls != len(stepped) or observed != stepped:
        fail(f"observer calls {observed} ({obs.errors} errors) for the "
             f"stages stepped {stepped}")
    if any(launches.values()):
        fail(f"the refenc console scripts launched a kernel: {launches}")
    return fields


@contextlib.contextmanager
def deterministic_ops():
    """cuDNN and torch's deterministic algorithms (warnings only) inside
    the block, which gets the warnings list (``nondeterministic`` reads
    the ops without a deterministic implementation from it)."""
    import os
    import warnings
    import torch
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas


def nondeterministic(caught) -> list:
    """The ops that warned they have no deterministic implementation."""
    return sorted({str(w.message).split(" does not have")[0]
                   for w in caught if "deterministic" in str(w.message)})


def parallel_phase(seed: int, srv, reqs, wavs):
    """Phase 5i (see the module docstring). Returns (its fields, the
    kernel launches of the served bucket under the mesh)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ttsx_torch import ops
    from ttsx_torch.core.config import tts_cfg
    from ttsx_torch.core.mesh import make_mesh
    from ttsx_torch.data.synthetic import synthetic_batch
    from ttsx_torch.parallel.dryrun import dryrun_multichip
    from ttsx_torch.parallel.spawn import free_port
    from ttsx_torch.serve import SynthesisServer
    from ttsx_torch.train.checkpoint import flatten
    from ttsx_torch.train.engine import UnifiedTrainer
    count = torch.cuda.device_count()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device="cuda")
        backend = str(dist.get_backend())
        # one engine step of the three blocks at 5c's cut, with the mesh
        # and without, on one synthetic batch
        cfg = tts_cfg()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=CKPT_BATCH, grad_accum_steps=1,
            val_freq=0, checkpoint_freq=0))
        batch = synthetic_batch(cfg, batch=CKPT_BATCH,
                                frames=OBSERVED_FRAMES, seed=seed)
        runs = {}
        with deterministic_ops() as caught:
            for name, m in (("mesh", mesh), ("plain", None)):
                tr = UnifiedTrainer(cfg, iter([]), device="cuda", mesh=m)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                metrics = tr.train_step(batch)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t1) * 1e3
                metrics.pop("step_time_s")
                runs[name] = (metrics, {k: v.clone() for k, v in
                                        flatten(tr.block_states).items()},
                              step_ms)
                del tr
            nondet = nondeterministic(caught)
        bitwise, state_err = state_diff(runs["mesh"][1], runs["plain"][1])
        metrics_equal = runs["mesh"][0] == runs["plain"][0]
        stepped = sorted({k.split("/")[0] for k in runs["mesh"][0]
                          if "/" in k})
        finite = all(math.isfinite(v) for v in runs["mesh"][0].values())
        entries = len(runs["plain"][1])
        step_ms = {name: r[2] for name, r in runs.items()}
        del runs

        # the serving bucket at the zoo's width through the server under
        # the mesh, against phase 4's mesh-less server
        meshed = SynthesisServer(srv.pipe, device="cuda", max_batch=MAX_BATCH,
                                 frames=FRAMES, bf16=False,
                                 scale_stats=srv.scale_stats.cpu(),
                                 mesh=mesh)
        torch.cuda.synchronize()
        ops.reset_launches()
        t1 = time.time()
        got = meshed.serve_batch(reqs)
        serve_s = time.time() - t1
        launches = ops.launch_counts()
        wav_err = max(float(np.abs(a - b).max()) for a, b in zip(got, wavs))
        del meshed

        # an NCCL all-reduce of the generator's gradient size
        numel = sum(p.numel() for p in srv.pipe.generator.parameters())
        allreduce_ms = mesh.time_all_reduce(numel)
    finally:
        dist.destroy_process_group()
    layouts = ["dp=1 x tp=1 (world 1, in this process)"]
    multi = {}
    if count >= 2:
        # two cards: dp = 2 and dp = 1 x tp = 2 (band_tp), NCCL ranks in
        # their own processes, each against one rank
        multi["dp2"] = dryrun_multichip(2)
        multi["dp1_tp2"] = dryrun_multichip(2, tp=2)
        layouts += ["dp=2 x tp=1 (2 processes)",
                    "dp=1 x tp=2 band_tp (2 processes)"]
    fields = dict(
        world=1, backend=backend, device_count=count, layouts=layouts,
        engine_step=dict(batch=CKPT_BATCH, frames=OBSERVED_FRAMES,
                         stepped=stepped, finite=finite,
                         metrics_equal=metrics_equal, entries=entries,
                         bitwise_equal=bitwise, max_abs_diff=state_err,
                         nondeterministic_ops=nondet,
                         step_ms=step_ms,
                         tolerance=MESH_STEP_TOL),
        serve=dict(requests=list(REQUEST_FRAMES), serve_s=serve_s,
                   launches=launches, wav_max_abs_err_vs_meshless=wav_err,
                   wav_tolerance=WAV_TOL),
        allreduce=dict(numel=numel, bytes=4 * numel, ms=allreduce_ms,
                       gb_per_s=4 * numel / allreduce_ms / 1e6,
                       note="one rank: NCCL's in-place all-reduce on one "
                            "card, no link crossed"),
        multi_card=multi)
    if stepped != ["acoustic", "refiner", "vocoder"] or not finite:
        fail(f"engine step under the mesh: stages {stepped}, finite {finite}")
    if nondet:
        if not state_err <= MESH_STEP_TOL:
            fail(f"engine step under the mesh {state_err} from the step "
                 f"without it ({nondet} nondeterministic)")
    elif not (bitwise and metrics_equal):
        fail(f"engine step under the mesh differs from the step without it "
             f"by {state_err} with every op deterministic")
    if launches != SERVE_LAUNCHES:
        fail(f"launches on the served bucket under the mesh {launches}, "
             f"want {SERVE_LAUNCHES}")
    if not wav_err <= WAV_TOL:
        fail(f"waveforms under the mesh differ from the mesh-less server's "
             f"by {wav_err}")
    return fields, launches


def missing_keys(ref, got, path=""):
    """The keys of ``ref`` (nested dicts) that ``got`` lacks, but the two
    the CLI adds to a record (``cli_args``, ``vocoder_overrides``)."""
    out = []
    for k, v in ref.items():
        if k in ("cli_args", "vocoder_overrides"):
            continue
        if k not in got:
            out.append(path + k)
        elif isinstance(v, dict) and isinstance(got[k], dict):
            out += missing_keys(v, got[k], f"{path}{k}.")
    return out


def not_finite(x, path=""):
    """The paths of the numbers in ``x`` (nested dicts and lists) that are
    not finite."""
    if isinstance(x, dict):
        return [p for k, v in x.items() for p in not_finite(v, f"{path}{k}.")]
    if isinstance(x, list):
        return [p for i, v in enumerate(x) for p in not_finite(v, f"{path}{i}.")]
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return [] if math.isfinite(x) else [path.rstrip(".")]
    return []


def parity_phase(seed: int, workdir: Path):
    """Phase 5j (see the module docstring). Returns (its fields, the kernel
    launches of the exported zoo's request)."""
    import numpy as np
    import torch
    from ttsx_torch import ops
    from ttsx_torch.eval.parity_aux import EXPERIMENTS
    from ttsx_torch.eval.parity_e2e import e2e_parity
    from ttsx_torch.eval.record_baseline import record
    from ttsx_torch.eval.rule_calibration import rule_stability, tier_accuracy
    from ttsx_torch.serve import SynthesisServer
    from ttsx_torch.zoo import DEFAULT_ZOO, serve_from_zoo, zoo_info
    refs = json.loads((DEFAULT_ZOO.parent / "parity.json").read_text())
    refs["diarizer"] = json.loads(
        (DEFAULT_ZOO.parent / "parity_diar.json").read_text())["diarizer"]
    torch.cuda.synchronize()
    ops.reset_launches()
    recs, secs = {}, {}
    # deterministic algorithms: the predictor's training is chaotic, and
    # the card's atomic reductions alone moved its f0 r from 0.14 to 0.93
    # between runs of one seed; with them a run of one seed is repeatable
    with deterministic_ops() as caught:
        for name, kw in PARITY_STEPS.items():
            t1 = time.time()
            if name == "diarizer":
                kw = dict(kw, out_dir=str(workdir))
            r = EXPERIMENTS[name](**kw, device="cuda")
            recs[name] = {k: v for k, v in r.items() if not k.startswith("_")}
            secs[name] = round(time.time() - t1, 3)
            print(json.dumps({"parity_record": name, **recs[name]}),
                  flush=True)
            missing = missing_keys(refs[name], recs[name])
            bad = not_finite(recs[name])
            if missing or bad:
                fail(f"parity {name}: missing the reference's keys "
                     f"{missing}, not finite {bad}")
    r = recs
    gates = {
        "refenc_eer_below_random": r["refenc"]["eer"]
        < r["refenc"]["eer_random_weights"],
        "acoustic_mcd_below_random": r["acoustic"]["mcd_db"]
        < r["acoustic"]["mcd_random_weights_db"],
        "prosody_f0_r_above_random": r["prosody"]["f0_pearson_voiced"]
        > r["prosody"]["f0_pearson_voiced_random_weights"],
        "vocoder_stable": r["vocoder"]["stable"],
        "disc_params": r["vocoder"]["disc_params"] == DISC_PARAMS}
    if not all(gates.values()):
        fail(f"parity gates {gates}")

    t1 = time.time()
    zoo = workdir / "zoo"
    overrides = zoo_info().get("vocoder_overrides")
    e2e = e2e_parity(**PARITY_E2E_STEPS, zoo_dir=str(zoo),
                     vocoder_overrides=overrides, device="cuda")
    secs["e2e"] = round(time.time() - t1, 3)
    print(json.dumps({"parity_record": "e2e", **e2e}), flush=True)
    bad = not_finite({k: e2e[k] for k in ("text_to_wav", "text_to_wav_ema",
                                          "text_to_wav_sde_ema")})
    if bad:
        fail(f"e2e readouts not finite: {bad}")
    harness_launches = ops.launch_counts()
    if any(harness_launches.values()):
        fail(f"the parity harnesses launched kernels: {harness_launches}")

    # the exported zoo through K1 and K2, then on the plain path
    srv = serve_from_zoo(str(zoo), device="cuda", bf16=False, max_batch=1,
                         frames=FRAMES)
    if not (srv.cfg.vocoder.use_pallas_upsample
            and srv.cfg.vocoder.use_pallas_resblock_stack):
        fail("the exported zoo's server does not run the kernels")
    reqs = requests(srv.cfg, seed)[:1]
    wavs, launches, serve_s = served(srv, reqs, "parity zoo")
    if launches != SERVE_LAUNCHES:
        fail(f"launches serving the exported zoo {launches}, want "
             f"{SERVE_LAUNCHES}")
    plain = SynthesisServer(srv.pipe.with_vocoder_kernels(False),
                            device="cuda", max_batch=1, frames=FRAMES,
                            bf16=False, scale_stats=srv.scale_stats.cpu())
    ops.reset_launches()
    wavs_plain = plain.serve_batch(reqs)
    if any(ops.launch_counts().values()):
        fail("the plain path launched a kernel")
    wav_err = float(np.abs(wavs[0] - wavs_plain[0]).max())
    if wav_err > WAV_TOL:
        fail(f"the exported zoo through K1 and K2 differs from plain by "
             f"{wav_err}")
    del srv, plain

    t1 = time.time()
    torch.cuda.reset_peak_memory_stats()
    rb = record(device="cuda")
    secs["record_baseline"] = round(time.time() - t1, 3)
    print(json.dumps({"record_baseline": rb}), flush=True)
    if not_finite(rb):
        fail(f"record_baseline not finite: {rb}")

    t1 = time.time()
    acc = tier_accuracy(n_segments=120, seed=1, work_dir=str(workdir / "rc"))
    stab = rule_stability(samples_per_rule=40, sigmas=(0.25,),
                          max_draws=60_000)["aggregate"]
    secs["rule_calibration"] = round(time.time() - t1, 3)
    rules = {"group_accuracy": acc["group_accuracy"], "ece": acc["ece"],
             **stab}
    if not (acc["group_accuracy"] > RULE_MIN_ACC and acc["ece"] < RULE_MAX_ECE
            and stab["rules_reachable"] == RULE_COUNT):
        fail(f"rule calibration out of bounds: {rules}")
    return dict(
        steps=PARITY_STEPS, e2e_steps=PARITY_E2E_STEPS,
        experiment_seconds=secs,
        nondeterministic_ops=nondeterministic(caught),
        gates=gates, readouts={
            "refenc": {k: r["refenc"][k] for k in ("eer",
                                                    "eer_random_weights")},
            "acoustic": {k: r["acoustic"][k] for k in (
                "mcd_db", "mcd_random_weights_db", "final_loss")},
            "refiner": {lv: v["mcd_db"] for lv, v in
                        r["refiner"]["levels"].items()},
            "prosody": {k: r["prosody"][k] for k in (
                "f0_pearson_voiced", "f0_pearson_voiced_random_weights",
                "energy_pearson", "energy_pearson_random_weights")},
            "vocoder": {k: r["vocoder"][k] for k in (
                "d_loss_tail_mean", "g_loss_tail_mean", "stable",
                "disc_params")},
            "diarizer": {k: r["diarizer"][k]["der"] for k in ("untrained",
                                                               "trained")},
            "e2e": {k: e2e[k]["wav_mcd_db"] for k in (
                "copy_synthesis", "text_to_wav", "text_to_wav_sde_ema")}},
        harness_launches=harness_launches, zoo_launches=launches,
        zoo_serve_s=round(serve_s, 3), zoo_wav_max_abs_err_vs_plain=wav_err,
        wav_tolerance=WAV_TOL, zoo_peak=float(np.abs(wavs[0]).max()),
        record_baseline=rb, rule_calibration=rules), launches


def time_gan(voc, batch):
    """ms of the vocoder's disc_step with R1 and without and of its
    gen_step, plain and with ``remat`` (each FiLM residual block
    recomputed in the backward pass), on ``batch`` (host clock around
    each, the card synchronized; ``GAN_REPEATS`` each), each with its
    peak memory, and the work counted by ``gan_work`` for the batch."""
    import numpy as np
    import torch
    mpd, r1_every = voc.states["mpd"], voc.vc.r1_interval
    tower = voc.gen.band_tower.tower
    plain = tower.cfg
    out = {}
    for kind, fn, r1, remat in (
            ("disc_step_r1", voc.disc_step, True, False),
            ("disc_step", voc.disc_step, False, False),
            ("gen_step", voc.gen_step, None, False),
            ("gen_step_remat", voc.gen_step, None, True)):
        tower.cfg = dataclasses.replace(plain, remat=remat)
        ms = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(GAN_REPEATS):
            if r1 is not None:
                mpd.step = r1_every * (mpd.step // r1_every + 1) - (not r1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = fn(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            if r1 is not None and (float(m["r1"]) > 0) != r1:
                fail(f"{kind}: r1 {float(m['r1'])}")
        out[kind] = dict(ms=ms, ms_median=float(np.median(ms)),
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    tower.cfg = plain
    out["batch"] = list(batch["wav"].shape)
    out["work_tflop"] = gan_work(voc.vc, *batch["wav"].shape[:2])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    try:
        import ttsx_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: {e}; run it from the root of a checkout",
              file=sys.stderr)
        return 2
    signal.alarm(TIME_LIMIT_S)   # a hang ends the run without a result
    import numpy as np
    from ttsx_torch import ops
    from ttsx_torch.core.config import AudioConfig, zoo_cfg
    from ttsx_torch.core.device import set_f32_numerics
    from ttsx_torch.ops import build
    from ttsx_torch.serve import SynthesisServer
    from ttsx_torch.zoo import load_pipeline, serve_from_zoo

    set_f32_numerics()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    t0 = time.time()
    emit("env", t0, python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=kind,
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         gpu_state=gpu_state(),
         tf32_conv=torch.backends.cudnn.allow_tf32,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32)

    t0 = time.time()
    libs = build.build_all()
    emit("build", t0, libraries=sorted(libs),
         ptxas={n: build.ptxas_report(n).splitlines() for n in libs})

    # -- 3. kernels against their plain versions at the stage shapes of
    # one 10 s request (batch 1) and of the serving bucket (batch 4)
    t0 = time.time()
    vc = zoo_cfg().vocoder
    dil = tuple(vc.res_dilations)
    gen = torch.Generator().manual_seed(args.seed)
    shapes = {b: stage_shapes(vc, FRAMES, b) for b in (1, MAX_BATCH)}
    checks = {b: check_kernels(shapes[b], gen, dil) for b in shapes}
    # K4 and K5 on the zoo's own weights: the refiner's 15 S4 layers, the
    # generator's res_{i}_{j} blocks
    pipe_p, zoo_meta = load_pipeline(sde_cfg("pallas"), device="cuda")
    s4_layers = refiner_s4_layers(pipe_p.refiner)
    k4_checks = check_k4(s4_layers, gen)
    k5_stage_in = {b: k5_stages(pipe_p.generator, b, gen)
                   for b in (1, MAX_BATCH)}
    k5_checks = {b: check_k5(k5_stage_in[b]) for b in k5_stage_in}
    emit("kernels", t0, tolerance={"upsample": K1_TOL, "resblock_stack": K2_TOL,
                                   "s4_scan": K4_TOL, "resblock": K5_TOL,
                                   "k5x3_vs_k2_per_stage": STAGE_TOL,
                                   "rule": "abs(kernel-plain) <= atol + rtol*abs(plain)"},
         checks_by_batch=checks, s4_scan=k4_checks,
         resblock_by_batch={b: v[0] for b, v in k5_checks.items()},
         resblock_stage_vs_k2_by_batch={b: v[1] for b, v in k5_checks.items()})
    bad = sorted({k for c in checks.values() for k, v in c.items()
                  if not all(x["ok"] for x in v)})
    bad += ["s4_scan"] * (not all(c["ok"] for c in k4_checks))
    bad += ["resblock"] * (not all(c["ok"] for v in k5_checks.values()
                                   for c in v[0]))
    bad += ["resblock x3 vs resblock_stack"] * (
        not all(c["ok"] for v in k5_checks.values() for c in v[1]))
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    del k5_stage_in

    # -- 3b. K3 against the float64 log-mel (and plain) on a training
    # batch and a clip
    t0 = time.time()
    audio = AudioConfig(mel_normalize=False)
    mel_wav, mel_lengths, mel_clip = mel_inputs(args.seed, audio.sample_rate)
    mel_check = check_mel(audio, mel_wav, mel_clip)
    emit("mel_frontend", t0, tolerance={
        "log_mel_vs_float64": K3_TOL, "vs_plain": K3_TOL,
        "vs_plain_on": ["noise", "clip"], "silent_abs": K3_TAIL_TOL},
         lengths=[int(n) for n in mel_lengths], **mel_check)
    if not mel_check["ok"]:
        fail(f"K3 fails its gate: batch {mel_check['batch']['parts']}, "
             f"clip {mel_check['clip']['parts']}")

    # -- 4. serve the zoo model through the kernels, then the plain path
    t0 = time.time()
    srv = serve_from_zoo(device="cuda", bf16=False, max_batch=MAX_BATCH,
                         frames=FRAMES)
    load_s = time.time() - t0
    if not (srv.cfg.vocoder.use_pallas_upsample
            and srv.cfg.vocoder.use_pallas_resblock_stack):
        fail("the zoo server does not run the kernels")
    reqs = requests(srv.cfg, args.seed)
    torch.cuda.synchronize()
    ops.reset_launches()
    t1 = time.time()
    wavs = srv.serve_batch(reqs)
    serve_s = time.time() - t1
    launches = ops.launch_counts()
    hop = srv.cfg.vocoder.hop_length
    for w_, n_ in zip(wavs, REQUEST_FRAMES):
        if w_.shape != (n_ * hop,) or not np.isfinite(w_).all():
            fail(f"bad waveform: shape {w_.shape}, finite "
                 f"{bool(np.isfinite(w_).all())}, want {n_ * hop} samples")
        if float(np.abs(w_).max()) < SILENT:
            fail(f"silent waveform for a {n_}-frame request")
    if launches != SERVE_LAUNCHES:
        fail(f"launches on the served forward {launches}, want "
             f"{SERVE_LAUNCHES}")
    plain_pipe = srv.pipe.with_vocoder_kernels(False)
    plain = SynthesisServer(plain_pipe, device="cuda", max_batch=MAX_BATCH,
                            frames=FRAMES, bf16=False,
                            scale_stats=srv.scale_stats.cpu())
    ops.reset_launches()
    wavs_plain = plain.serve_batch(reqs)
    if any(ops.launch_counts().values()):
        fail("the plain path launched a kernel")
    wav_err = max(float(np.abs(a - b).max()) for a, b in zip(wavs, wavs_plain))
    emit("serve", t0, zoo_load_s=round(load_s, 3), serve_s=round(serve_s, 3),
         requests=list(REQUEST_FRAMES),
         samples=[len(w_) for w_ in wavs],
         peak=[float(np.abs(w_).max()) for w_ in wavs],
         rms=[float(np.sqrt(np.mean(w_ ** 2))) for w_ in wavs],
         launches=launches, wav_max_abs_err_vs_plain=wav_err,
         wav_tolerance=WAV_TOL,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if wav_err > WAV_TOL:
        fail(f"kernel path waveforms differ from the plain path by {wav_err}")
    del plain, wavs_plain

    # -- 4b. SDE synthesis: K4 on the refiner's S4 layers, against fft
    t0 = time.time()
    pipe_f, _ = load_pipeline(sde_cfg("fft"), device="cuda")
    sde, sde_one = sde_phase(pipe_p, pipe_f, reqs, srv.scale_stats,
                             args.seed)
    emit("sde", t0, **sde)
    k5_launches = sde["per_block_route"]["launches"]["resblock"]

    # -- 4c. bf16 serving (the reference's default) on the same requests
    t0 = time.time()
    bf16, srv_bf, plain_bf, bucket = serve_bf16_phase(reqs, wavs, args.seed)
    emit("serve_bf16", t0, **bf16)

    # -- 4d. the voice transform on the bf16 server's pipeline
    t0 = time.time()
    emit("voice", t0, **voice_phase(srv_bf, plain_bf, bucket))
    del srv_bf, plain_bf, bucket

    # -- 4e. streaming synthesis of a 30 s request on the f32 pipeline
    t0 = time.time()
    emit("stream", t0, **stream_phase(srv.pipe, args.seed))

    # -- 5. the trainer's three blocks on a wav tree, K3 in the collator
    t0 = time.time()
    state_before = gpu_state()
    with tempfile.TemporaryDirectory() as tmp:
        train, k3_audio, k3_wavs, trainer, gan_batch = train_phase(
            args.seed, Path(tmp))
        train_launches = train["launches"]
        emit("train", t0, gpu_state_before=state_before,
             gpu_state_after=gpu_state(), **train)
        if not train["cross_device_ok"]:
            fail(f"first-step losses on the card and the CPU differ by more "
                 f"than {XDEV_RTOL}: {train['cross_device']}")

        # -- 5b. the trained vocoder's slim export served through K1 and K2
        t0 = time.time()
        emit("vocoder_export", t0, **vocoder_export_phase(
            trainer, Path(tmp), gan_batch, args.seed))
        voc = trainer.blocks["vocoder"]
        del trainer

        # -- 5c. checkpoints: a run stopped at step 2 and resumed from
        # 'last' against an uninterrupted one
        t0 = time.time()
        emit("checkpoint", t0, **checkpoint_phase(Path(tmp)))

    # -- 5d. stage 1, the zoo's speaker encoder: card vs CPU, its trainer
    t0 = time.time()
    refenc = refenc_phase(args.seed)
    emit("refenc", t0, **refenc)

    # -- 5e. stage 2, the zoo's prosody predictor and the emotion head
    t0 = time.time()
    emit("prosody", t0, **prosody_phase(args.seed))

    # -- 5f. the speaker diarizer on the hard benchmark stream
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        emit("diarizer", t0, **diarizer_phase(args.seed, Path(tmp)))

    # -- 5g. the observer ingestion job on the same stream
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        emit("observer", t0, **observer_phase(args.seed, Path(tmp)))

    # -- 5h. the speaker encoder's console scripts, ttsx-bench, the eval
    # package and the engine's observer hook
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        emit("refenc_cli", t0, **refenc_cli_phase(
            args.seed, Path(tmp), refenc["embed_ms_batch1"]))

    # -- 5i. the mesh: an NCCL group, an engine step and the served bucket
    # under it against the same without it
    t0 = time.time()
    parallel, mesh_launches = parallel_phase(args.seed, srv, reqs, wavs)
    emit("parallel", t0, **parallel)

    # -- 5j. the parity harnesses at cut steps, the zoo they export served
    # through K1 and K2, record_baseline and the rule calibration
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        parity, parity_launches = parity_phase(args.seed, Path(tmp))
    emit("parity", t0, **parity)

    # -- 6. timing: K3 at each batch shape the trainer collated (the
    # largest first) and at the clip, K1 and K2 at the stage shapes of
    # batch 1 and of the serving bucket
    t0 = time.time()
    state_before = gpu_state()
    mel_rows = [time_mel(k3_audio, w) for w in k3_wavs]
    mel_rows.append(time_mel(k3_audio, torch.as_tensor(mel_clip,
                                                       device="cuda")))
    mel_row = mel_rows[0]
    same = [c for c, sh in zip(train["collate_ms"], train["mel_shapes"])
            if sh[1] == mel_row["shape"][1] // k3_audio.hop_length + 1]
    k3_collate_ms = float(np.median(same)) if same else None
    del k3_wavs
    torch.cuda.reset_peak_memory_stats()
    rows = {b: time_kernels(shapes[b], gen, dil) for b in shapes}
    # model stages and one 10 s request end to end (batch 1)
    one = SynthesisServer(srv.pipe, device="cuda", max_batch=1, frames=FRAMES,
                          bf16=False, scale_stats=srv.scale_stats.cpu())
    *arr, _ = one.pad_batch(reqs[:1])
    text, pros, emo, spk, sid = (torch.as_tensor(a_, device=one.device)
                                 for a_ in arr)
    p = srv.pipe
    scale = srv.scale_stats.expand(1, -1)
    with torch.inference_mode():
        mel0 = p.acoustic(text, pros, emo, speaker=spk).mel
        mel_ref = p.refiner(mel0, pros, sid, text).mel_ref
        style = p.gst(mel_ref)
        stages = {
            "acoustic_ms": cuda_ms(lambda: p.acoustic(text, pros, emo, speaker=spk)),
            "refiner_ms": cuda_ms(lambda: p.refiner(mel0, pros, sid, text)),
            "gst_ms": cuda_ms(lambda: p.gst(mel_ref)),
            "generator_kernels_ms": cuda_ms(
                lambda: p.generator(mel_ref, pros, style, emo, scale=scale)),
            "generator_plain_ms": cuda_ms(
                lambda: plain_pipe.generator(mel_ref, pros, style, emo, scale=scale)),
        }
    one.serve_batch(reqs[:1])
    e2e = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one.serve_batch(reqs[:1])
        e2e.append((time.perf_counter() - t1) * 1e3)
    k4_rows = {b: time_k4(s4_layers, b, gen) for b in (1, MAX_BATCH)}
    k5_rows = {b: time_k5(k5_stages(pipe_p.generator, b, gen))
               for b in (1, MAX_BATCH)}
    sde_times = time_sde(pipe_p, pipe_f, *sde_one)
    timing_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gan_times = time_gan(voc, gan_batch)
    del voc
    bf16_times = time_bf16(srv.pipe, reqs, srv.scale_stats)
    emit("timing", t0, kernels_by_batch=rows, mel_frontend=mel_rows,
         s4_scan_by_batch=k4_rows,
         resblock_by_batch={b: v[0] for b, v in k5_rows.items()},
         resblock_stage_vs_k2_by_batch={b: v[1] for b, v in k5_rows.items()},
         sde_batch1=sde_times, serve_bf16_vs_f32_batch1=bf16_times,
         vocoder_gan=gan_times, trainer_peak_mem_gb=train["peak_mem_gb"],
         gpu_state_before=state_before, gpu_state_after=gpu_state(),
         collate_ms_median_at_k3_shape=k3_collate_ms,
         k3_share_of_collate=(mel_row["ms"] / k3_collate_ms if same
                              else None),
         stages_batch1=stages,
         e2e_ms_10s_request=sorted(e2e)[len(e2e) // 2], e2e_ms_all=e2e,
         audio_s=FRAMES * hop / vc.sr, peak_mem_gb=timing_peak_gb)

    # the kernels line reads the main path's shapes: the serving bucket
    main_rows, main_checks = rows[MAX_BATCH], checks[MAX_BATCH]
    total = lambda name, key: (None if main_rows[name][0][key] is None
                               else sum(r[key] for r in main_rows[name]))
    # bound_by is "bytes" or "operations"; ops_peak says which peak the
    # operations were counted at ("tf32x3": three TF32 products per f32
    # product over PEAK_TF32_FLOPS, "f32": PEAK_F32_FLOPS) and timing how
    # ms was taken ("graph": CUDA-graph replay, "eager": CUDA events)
    meta = {
        "upsample": ("ttsx_torch/ops/csrc/upsample.cu",
                     "ttsx/ops/upsample_kernel.py:127", "graph"),
        "resblock_stack": ("ttsx_torch/ops/csrc/resblock_stack.cu",
                           "ttsx/ops/resblock_stack_kernel.py:211", "graph"),
    }
    kernels = []
    for name, (src, replaces, timing) in meta.items():
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in main_checks[name]),
            ms=total(name, "ms"), plain_ms=total(name, "plain_ms"),
            bound_ms=total(name, "bound_ms"),
            bound_by=max(main_rows[name], key=lambda r: r["bound_ms"])[
                "bound_by"].split()[0],
            library_ms=total(name, "library_ms"),
            ops_peak="tf32x3", timing=timing,
            mesh_launches=mesh_launches[name],
            parity_launches=parity_launches[name]))
    kernels.append(dict(
        name="mel_frontend", route="cuda",
        source="ttsx_torch/ops/csrc/mel_frontend.cu",
        replaces="ttsx/ops/mel_kernel.py:87",
        launches=train_launches["mel_frontend"],
        max_abs_err=max(mel_check["max_abs_err"], train["k3_max_abs_err"]),
        ms=mel_row["ms"],
        plain_ms=mel_row["plain_ms"], bound_ms=mel_row["bound_ms"],
        bound_by=mel_row["bound_by"], library_ms=None, ops_peak="f32",
        timing="graph", f64_bound_ms=mel_row["f64_bound_ms"]))
    # K4: one SDE synthesize call at batch 1 (8 refiner passes of the 15
    # layer shapes); K5: the per-block generator route at batch 1 (12 blocks)
    k4_one, (k5_one, _) = k4_rows[1], k5_rows[1]
    passes = pipe_p.cfg.refiner.sde_steps
    k4_launches = sde["cases"]["one"]["launches_pallas"]["s4_scan"]
    for name, src, replaces, n, errs, rows_, scale, peak, timing in (
            ("s4_scan", "ttsx_torch/ops/csrc/s4_scan.cu",
             "ttsx/ops/s4_kernel.py:119", k4_launches,
             [c["max_abs_err"] for c in k4_checks], k4_one, passes,
             "tf32x3" if all(r["bound_count"] == "products" for r in k4_one)
             else "f32", "graph"),
            ("resblock", "ttsx_torch/ops/csrc/resblock.cu",
             "ttsx/ops/resblock_kernel.py:157", k5_launches,
             [c["max_abs_err"] for v in k5_checks.values() for c in v[0]],
             k5_one, 1, "tf32x3", "graph")):
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=n, max_abs_err=max(errs),
            ms=scale * sum(r["ms"] for r in rows_),
            plain_ms=scale * sum(r["plain_ms"] for r in rows_),
            bound_ms=scale * sum(r["bound_ms"] for r in rows_),
            bound_by=max(rows_, key=lambda r: r["bound_ms"])["bound_by"].split()[0],
            library_ms=None, ops_peak=peak, timing=timing))
    # K4's bound from its f32 counts alone, beside the recount
    k4_entry = next(k for k in kernels if k["name"] == "s4_scan")
    k4_entry["f32_bound_ms"] = passes * sum(r["f32_bound_ms"] for r in k4_one)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
