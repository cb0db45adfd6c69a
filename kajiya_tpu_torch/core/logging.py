"""Console + file logging setup (port of `kajiya_tpu/core/logging.py`, the
role of `kajiya/src/logging.rs:1-72`): INFO+ coloured to the console, DEBUG+
plain to the log file, on the logger `kajiya_tpu_torch`."""
from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\033[37m", logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m", logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        base = super().format(record)
        color = _COLORS.get(record.levelno, "")
        return f"{color}{base}{_RESET}" if sys.stderr.isatty() else base


def set_up_logging(log_file: str | None = "output.log",
                   console_level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger("kajiya_tpu_torch")
    if logger.handlers:
        return logger
    logger.setLevel(logging.DEBUG)

    ch = logging.StreamHandler()
    ch.setLevel(console_level)
    ch.setFormatter(_ColorFormatter("%(levelname).1s %(name)s: %(message)s"))
    logger.addHandler(ch)

    if log_file:
        fh = logging.FileHandler(log_file, mode="w")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(fh)
    return logger
