"""Bounded rotating file logging for long-running pipeline deployments
(a copy of ``ttsx/utils/logs.py``).

Re-designs the reference's log management
(reference_encoder/hyper_diarizer/cli.py:33-36 and
reference_encoder/modules/plot_map/plot_map.py:14-18): a
RotatingFileHandler (1 MB x 5 backups) on the diarizer / pipeline
loggers so watcher-mode deployments never grow unbounded log files.

`attach_rotating_handler` is idempotent per (logger, file): calling it
on every job is safe and never stacks duplicate handlers. `LogFile` is
what a per-job log uses in the port: one handler it owns on the logger,
moved to each new path, where the reference attaches a handler per job
directory and leaves them all open (each line then goes to every
earlier job's log).
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


class LogFile:
    """The one rotating handler an owner (a controller, a pipeline, a
    stage) keeps on ``logger``: ``point(path)`` moves it to ``path``,
    closing the handler it installed for an earlier path; a handler for
    ``path`` already on the logger (a caller's) is used and not owned."""

    def __init__(self, logger: logging.Logger):
        self.logger = logger
        self.handler: RotatingFileHandler | None = None

    def _handler_for(self, path: Path):
        return next((h for h in self.logger.handlers
                     if isinstance(h, RotatingFileHandler)
                     and Path(h.baseFilename) == path), None)

    def point(self, path) -> None:
        path = Path(path).absolute()
        own = self.handler
        if own is not None and Path(own.baseFilename) == path:
            return
        if own is not None:
            self.logger.removeHandler(own)
            own.close()
            self.handler = None
        if self._handler_for(path) is None:
            attach_rotating_handler(self.logger, path)
            self.handler = self._handler_for(path)
