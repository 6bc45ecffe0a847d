"""Batched wav prefetch loader (``ttsx/data/prefetch.py``): background
threads decode and random-crop wavs into whole [batch, crop] float32
batches in a bounded queue, so host IO overlaps the steps on the card.
The mel frontend then runs as one batched call per batch.

Two executors, as in the reference: the native pthreads pool
(``ttsx_torch.native``'s ``_ttsx_prefetch``, its own copy of
``ttsx/native/prefetch.c``), which ``native=None`` takes where it builds
and ``native=True`` requires (raising with the compiler's error where it
does not build), and Python threads, which ``native=False`` asks for and
``native=None`` takes where the pool does not build. ``is_native`` says
which runs. ``stats()`` counts what either did (batches produced and
consumed, failed decodes); the reference's Python executor returns
zeros there.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ttsx_torch.data.dataset import read_wav

RETRIES = 17    # decode attempts for one row before it carries label -1


class WavBatchLoader:
    """(path, label) items -> endless stream of (wav [B, crop] float32,
    labels [B] int32) batches, prefetched by ``workers`` threads.

    Items are drawn with replacement (worker i from a generator seeded
    ``seed + i``), each cropped at a random start; a file shorter than
    ``crop`` is zero-padded. A file that fails to decode is replaced by
    another draw, up to ``RETRIES`` times; a row whose draws all failed
    carries label -1 and a zero waveform, so filter with ``lab >= 0`` when
    the list may hold broken files. ``sample_rate`` 0 keeps each file's
    own rate.
    """

    def __init__(self, items: Sequence[Tuple[str, int]], crop: int,
                 batch: int, sample_rate: int = 0, workers: int = 2,
                 depth: int = 4, seed: int = 0,
                 native: Optional[bool] = None):
        self.crop = int(crop)
        self.batch = int(batch)
        paths = [str(p) for p, _ in items]
        labels = [int(l) for _, l in items]
        self._native = None
        self._threads: list = []
        self._stop = threading.Event()
        if native is not False:
            from ttsx_torch.native import load, try_load
            ext = (load("_ttsx_prefetch") if native
                   else try_load("_ttsx_prefetch"))
            if ext is not None:
                self._native = ext.Prefetcher(
                    paths, labels, self.crop, self.batch,
                    target_sr=sample_rate, workers=workers, depth=depth,
                    seed=seed)
                return
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._counts = [0, 0, 0]    # produced, consumed, decode errors

        def work(wid: int):
            rng = np.random.default_rng(seed + wid)
            while not self._stop.is_set():
                wav = np.zeros((self.batch, self.crop), np.float32)
                lab = np.full(self.batch, -1, np.int32)
                errors = 0
                for b in range(self.batch):
                    for _ in range(RETRIES):
                        i = int(rng.integers(len(paths)))
                        try:
                            w, _ = read_wav(paths[i], sample_rate)
                        except (OSError, ValueError):
                            errors += 1
                            continue
                        if len(w) >= self.crop:
                            s = int(rng.integers(0, len(w) - self.crop + 1))
                            wav[b] = w[s:s + self.crop]
                        else:
                            wav[b, :len(w)] = w
                        lab[b] = labels[i]
                        break
                with self._lock:
                    self._counts[2] += errors
                while not self._stop.is_set():
                    try:
                        self._q.put((wav, lab), timeout=0.1)
                    except queue.Full:
                        continue
                    with self._lock:
                        self._counts[0] += 1
                    break

        self._threads = [threading.Thread(target=work, args=(i,),
                                          daemon=True)
                         for i in range(workers)]
        for t in self._threads:
            t.start()

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def next(self, timeout_ms: int = 30000
             ) -> Tuple[np.ndarray, np.ndarray]:
        """The next batch; ``TimeoutError`` if none comes within
        ``timeout_ms``."""
        if self._native is not None:
            return self._native.next(timeout_ms=timeout_ms)
        try:
            out = self._q.get(timeout=timeout_ms / 1000.0)
        except queue.Empty:
            raise TimeoutError(f"no batch within {timeout_ms} ms")
        with self._lock:
            self._counts[1] += 1
        return out

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next()

    def stats(self) -> Tuple[int, int, int]:
        """(batches produced, batches consumed, failed decodes)."""
        if self._native is not None:
            return tuple(self._native.stats())
        with self._lock:
            return tuple(self._counts)

    def close(self):
        if self._native is not None:
            self._native.close()
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
