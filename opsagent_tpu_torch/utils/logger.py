"""Logging: JSON file logs with size rotation + colored console output
(the port's copy of ``opsagent_tpu/utils/logger.py``).

Capability parity with the reference's pkg/utils/logger.go (zap + lumberjack:
10MB/10 backups/7 days rotation logger.go:53-67, JSON file core + colored
console core logger.go:149-173, package-level helpers logger.go:199-221),
built on the stdlib ``logging`` package.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import sys
import threading
import time
from typing import Any

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_COLORS = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[35m",
}
_RESET = "\033[0m"


class JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry: dict[str, Any] = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(record.created)),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if isinstance(extra, dict):
            entry.update(extra)
        return json.dumps(entry, ensure_ascii=False)


class ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "")
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        base = f"{ts} {color}{record.levelname:<5}{_RESET} {record.getMessage()}"
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        return base


_lock = threading.Lock()
_initialized = False


class DailyRotatingFileHandler(logging.handlers.RotatingFileHandler):
    """Size rotation WITHIN a day plus daily filename rotation and
    age-based retention, matching the reference's lumberjack setup
    (10MB/10 backups/7-day MaxAge/compress, logger.go:53-67) combined
    with its daily filename reset (logger.go:70-98: the log file is
    reopened under a new date-stamped name when the day changes).

    ``logs/opsagent.log`` becomes ``logs/opsagent-YYYY-MM-DD.log``; when
    the calendar date changes the handler switches to the new day's file
    and prunes any log artifacts older than ``retention_days``. Rotated
    same-day backups are gzip-compressed when ``compress`` is set
    (lumberjack Compress, logger.go:66)."""

    def __init__(
        self,
        file_path: str,
        max_bytes: int = 10 * 1024 * 1024,
        backup_count: int = 10,
        retention_days: int = 7,
        compress: bool = True,
    ):
        self._base = file_path
        self._retention = retention_days
        self._day = time.strftime("%Y-%m-%d")
        super().__init__(
            self._dated(), maxBytes=max_bytes, backupCount=backup_count,
            delay=True,
        )
        if compress:
            # The stdlib namer/rotator hooks keep the .N.gz names
            # consistent through the backup shift loop (renaming the
            # backups out-of-band instead would leave doRollover's shift
            # finding nothing, silently dropping all but one backup).
            self.namer = lambda name: name + ".gz"
            self.rotator = self._gzip_rotate
        # Enforce retention at startup too: short-lived processes (every
        # CLI invocation) never cross midnight in-process, so rollover
        # alone would never prune.
        self.prune()

    def _dated(self) -> str:
        root, ext = os.path.splitext(self._base)
        return f"{root}-{self._day}{ext}"

    def shouldRollover(self, record: logging.LogRecord) -> bool:  # noqa: N802
        if time.strftime("%Y-%m-%d") != self._day:
            return True
        return bool(super().shouldRollover(record))

    def doRollover(self) -> None:  # noqa: N802
        today = time.strftime("%Y-%m-%d")
        if today != self._day:
            # Day changed: reopen under the new date-stamped name (no
            # backup shuffle — each day keeps its own file) and prune.
            if self.stream:
                self.stream.close()
                self.stream = None
            self._day = today
            self.baseFilename = os.path.abspath(self._dated())
            self.prune()
            return
        super().doRollover()

    def prune(self) -> None:
        """Delete log artifacts older than retention_days (lumberjack
        MaxAge equivalent; <= 0 means never expire, as MaxAge=0 does).

        Only files THIS handler writes are eligible: the date-stamped
        daily file plus its .N size-rollover / .gz compression suffixes.
        A bare prefix glob would also match unrelated same-prefix logs
        (e.g. opsagent-http.log next to opsagent.log) and delete another
        subsystem's data once it aged past retention. listdir+regex
        rather than glob: a log dir containing glob metacharacters
        ("logs[prod]/") would silently match nothing and disable
        retention."""
        import re

        if self._retention <= 0:
            return
        root, ext = os.path.splitext(self._base)
        own = re.compile(
            re.escape(os.path.basename(root))
            + r"-\d{4}-\d{2}-\d{2}"
            + re.escape(ext)
            + r"(\.\d+)?(\.gz)?$"
        )
        cutoff = time.time() - self._retention * 86400.0
        logdir = os.path.dirname(self._base) or "."
        try:
            entries = os.listdir(logdir)
        except OSError:
            return
        for fname in entries:
            if not own.fullmatch(fname):
                continue
            p = os.path.join(logdir, fname)
            try:
                if os.path.getmtime(p) < cutoff:
                    os.remove(p)
            except OSError:  # racing writers / already gone
                pass

    @staticmethod
    def _gzip_rotate(source: str, dest: str) -> None:
        import gzip
        import shutil

        try:
            with open(source, "rb") as src, gzip.open(dest, "wb") as dst:
                shutil.copyfileobj(src, dst)
            os.remove(source)
        except OSError:  # fall back to a plain rename
            try:
                # A partially written .gz must not enter the backup shift
                # chain as a corrupt artifact.
                os.remove(dest)
            except OSError:
                pass
            if os.path.exists(source):
                os.replace(source, dest.removesuffix(".gz"))


def init_logger(
    level: str = "info",
    fmt: str = "json",
    output: str = "stdout",
    file_path: str = "logs/opsagent.log",
    max_size_mb: int = 10,
    max_backups: int = 10,
    retention_days: int = 7,
    compress: bool = True,
) -> logging.Logger:
    """Initialize the root 'opsagent' logger: rotating JSON file and/or
    colored console, mirroring the reference's tee of both cores."""
    global _initialized
    logger = logging.getLogger("opsagent")
    with _lock:
        logger.setLevel(_LEVELS.get(level.lower(), logging.INFO))
        logger.handlers.clear()
        logger.propagate = False
        if output in ("stdout", "both"):
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                JSONFormatter() if fmt == "json" and output != "both" else ColorFormatter()
            )
            logger.addHandler(h)
        if output in ("file", "both"):
            os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
            fh = DailyRotatingFileHandler(
                file_path,
                max_bytes=max_size_mb * 1024 * 1024,
                backup_count=max_backups,
                retention_days=retention_days,
                compress=compress,
            )
            fh.setFormatter(JSONFormatter())
            logger.addHandler(fh)
        _initialized = True
    return logger


def get_logger(name: str = "") -> logging.Logger:
    if not _initialized:
        init_logger()
    if name:
        return logging.getLogger("opsagent").getChild(name)
    return logging.getLogger("opsagent")
