"""Structured logging: pretty stdout + hourly-rolling file.

The port's own copy of `speaksense_tpu/utils/logging.py`,
with the same names and behaviour.

Mirror of the reference's src/utils/logger.rs:8-43 (tracing-subscriber pretty
layer + hourly rolling non-blocking appender under ./logs, env-filtered,
local-time %Y-%m-%d %H:%M). Python equivalent: stdlib logging with a
TimedRotatingFileHandler; level from ASR_LOG (the reference honors RUST_LOG).
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from pathlib import Path

_FORMAT = "%(asctime)s %(levelname)-5s %(name)s: %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"


def init(log_dir: str = "./logs", level: str | None = None,
         filename_prefix: str = "asr") -> None:
    """Install stdout + hourly-rolling file handlers on the root logger."""
    level_name = (level or os.environ.get("ASR_LOG")
                  or os.environ.get("RUST_LOG", "info")).upper()
    # RUST_LOG may carry module filters ("info,tower=warn"); take the default
    level_name = level_name.split(",")[0]
    lvl = getattr(logging, level_name, logging.INFO)

    root = logging.getLogger()
    root.setLevel(lvl)
    for h in list(root.handlers):
        root.removeHandler(h)

    stream = logging.StreamHandler()
    stream.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
    root.addHandler(stream)

    try:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fileh = logging.handlers.TimedRotatingFileHandler(
            str(Path(log_dir) / f"{filename_prefix}.log"), when="H", backupCount=72)
        fileh.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
        root.addHandler(fileh)
    except OSError as e:  # pragma: no cover
        root.warning("file logging disabled: %s", e)
