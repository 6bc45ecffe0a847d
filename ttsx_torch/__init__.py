"""PyTorch/CUDA port of ttsx's text->waveform synthesis chain and its
acoustic + refiner trainer.

Layout mirrors ``ttsx``: ``core`` (configs), ``nn`` (layers), ``models``
(acoustic, refiner, vocoder, pipeline), ``ops`` (hand-written CUDA
kernels with their plain PyTorch versions), ``dsp`` and ``data`` (the
trainer's data path), ``train`` (blocks and engine), ``cli``,
``weights`` (flax tree / slim npz -> state dicts), ``zoo`` and ``serve``.
Importing the package loads no kernel and needs neither a card nor a
compiler.
"""
__version__ = "0.1.0"
