"""Bounded rotating file logging for long-running pipeline deployments
(a copy of ``ttsx/utils/logs.py``).

Re-designs the reference's log management
(reference_encoder/hyper_diarizer/cli.py:33-36 and
reference_encoder/modules/plot_map/plot_map.py:14-18): a
RotatingFileHandler (1 MB x 5 backups) on the diarizer / pipeline
loggers so watcher-mode deployments never grow unbounded log files.

`attach_rotating_handler` is idempotent per (logger, file): calling it
on every job is safe and never stacks duplicate handlers.
"""
from __future__ import annotations

import logging
from logging.handlers import RotatingFileHandler
from pathlib import Path

_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def attach_rotating_handler(logger: logging.Logger, path,
                            max_bytes: int = 1_000_000,
                            backup_count: int = 5) -> logging.Logger:
    """Attach a rotating file handler writing to `path` (idempotent)."""
    path = Path(path).absolute()
    for h in logger.handlers:
        if (isinstance(h, RotatingFileHandler)
                and Path(h.baseFilename) == path):
            return logger
    path.parent.mkdir(parents=True, exist_ok=True)
    h = RotatingFileHandler(path, maxBytes=max_bytes,
                            backupCount=backup_count)
    h.setFormatter(logging.Formatter(_FMT))
    logger.addHandler(h)
    if logger.level == logging.NOTSET:
        logger.setLevel(logging.INFO)
    return logger
