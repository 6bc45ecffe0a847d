"""PyTorch/CUDA port of ttsx's text->waveform synthesis chain and its
trainer (acoustic, refiner and the vocoder GAN, with checkpoints), of
stages 1 and 2 (the speaker encoder and the prosody predictor with their
trainers and console scripts), and of the ingestion pipeline (the
speaker diarizer and the observer job).

Layout mirrors ``ttsx``: ``core`` (configs, YAML / JSON files), ``nn``
(layers), ``models`` (speaker encoder, prosody, acoustic, refiner,
vocoder, discriminators, pipeline), ``ops`` (hand-written CUDA kernels
with their plain PyTorch versions), ``dsp`` and ``data`` (the trainers'
data paths, the prefetching wav loader, the synthetic corpora),
``train`` (blocks, engine and its observer hook, checkpoints, the
stage-1/2 trainers), ``eval`` (EER, MCD, DER; timers and CI gates; the
acoustic evaluation; ``torch.export`` programs; the parity harnesses,
``record_baseline`` and the rule calibration), ``pipeline`` (the stage
contract, the diarizer, the observer job), ``utils`` (logs, figures, the
file-size gate), ``cli``, ``weights`` (flax tree / slim npz -> state
dicts), ``zoo``, ``serve`` and ``streaming``. The serving surface is
exported here, imported on first use as in ``ttsx``. Importing the
package loads no kernel and needs neither a card nor a compiler.
"""
__version__ = "0.1.0"

# name -> "module:attr" (resolved on first access)
_EXPORTS = {
    "SynthesisRequest": "ttsx_torch.serve:SynthesisRequest",
    "SynthesisServer": "ttsx_torch.serve:SynthesisServer",
    "make_voice_transform": "ttsx_torch.serve:make_voice_transform",
    "StreamingSynthesizer": "ttsx_torch.streaming:StreamingSynthesizer",
    "serve_from_zoo": "ttsx_torch.zoo:serve_from_zoo",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        target = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'ttsx_torch' has no attribute {name!r}")
    import importlib
    mod, attr = target.split(":")
    value = getattr(importlib.import_module(mod), attr)
    globals()[name] = value
    return value
