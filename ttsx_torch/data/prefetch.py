"""Batched wav prefetch loader (``ttsx/data/prefetch.py``): background
threads decode and random-crop wavs into whole [batch, crop] float32
batches in a bounded queue, so host IO overlaps the steps on the card.
The mel frontend then runs as one batched call per batch.

The reference's default route is a native pthreads executor
(``ttsx/native/prefetch.c``), with this Python-thread executor as its
fallback. The port has the Python-thread executor only: ``native=True``
raises, as the reference does where its extension is missing, and
``is_native`` is False. ``stats()`` counts what the executor did
(batches produced and consumed, failed decodes), as the native
executor's does; the reference's fallback returns zeros.
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
        if native:
            raise RuntimeError("native prefetcher unavailable")
        self.crop = int(crop)
        self.batch = int(batch)
        paths = [str(p) for p, _ in items]
        labels = [int(l) for _, l in items]
        self._stop = threading.Event()
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
        return False

    def next(self, timeout_ms: int = 30000
             ) -> Tuple[np.ndarray, np.ndarray]:
        """The next batch; ``TimeoutError`` if none comes within
        ``timeout_ms``."""
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
        with self._lock:
            return tuple(self._counts)

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
