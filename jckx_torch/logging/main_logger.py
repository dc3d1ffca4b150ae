"""Process-wide singleton logger — port of ``jckx/logging/main_logger.py``.

As the reference's ``logger/main_logger.py:9-103``: one logger per
process, a console handler, a timestamped log file in the run dir when
``log_file`` is 1, and an excepthook that puts uncaught exceptions in the
log. As jckx: ``metrics.jsonl`` beside the log holds the scalars (losses,
FID / IS, step time, images/s) with jckx's keys. One process writes
everything: the port has no multi-process run yet (ROADMAP A13).
"""

from __future__ import annotations

import json
import logging
import os
import sys
from datetime import datetime
from typing import Any, Optional

_LOG_FORMAT = "%(asctime)s [%(levelname)s] %(message)s"
_NAME = "jckx_torch"


def _excepthook(exc_type, exc_value, exc_tb):
    if issubclass(exc_type, KeyboardInterrupt):
        sys.__excepthook__(exc_type, exc_value, exc_tb)
    else:
        logging.getLogger(_NAME).critical("uncaught exception — aborting run",
                                          exc_info=(exc_type, exc_value, exc_tb))


class MainLogger:  # singleton
    _instance = None
    _initialized = False

    def __new__(cls, *args, **kwargs):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __init__(self, config: Optional[Any] = None):
        if self._initialized:
            # components built before the run dir exists (the data
            # preprocessor) create the singleton first; the trainer's call
            # with the run dir attaches the file
            self._maybe_attach_file(config)
            return
        self.logger = logging.getLogger(_NAME)
        self.logger.setLevel(logging.DEBUG)
        self.logger.propagate = False
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter(_LOG_FORMAT))
        self.logger.addHandler(console)
        self._jsonl_path = None
        self._file_attached = False
        self._maybe_attach_file(config)
        self._initialized = True
        sys.excepthook = _excepthook

    def _maybe_attach_file(self, config: Optional[Any]) -> None:
        if (self._file_attached or config is None or getattr(config, "log_file", 0) != 1
                or not getattr(config, "save_path", "")):
            return
        run_dir = config.save_path
        os.makedirs(run_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        to_file = logging.FileHandler(os.path.join(run_dir, f"{stamp}.log"))
        to_file.setFormatter(logging.Formatter(_LOG_FORMAT))
        self.logger.addHandler(to_file)
        self._jsonl_path = os.path.join(run_dir, "metrics.jsonl")
        self._file_attached = True

    def debug(self, msg: str):
        self.logger.debug(msg)

    def info(self, msg: str):
        self.logger.info(msg)

    def warning(self, msg: str):
        self.logger.warning(msg)

    def error(self, msg: str):
        self.logger.error(msg)

    def scalars(self, record: dict):
        """One JSON line in ``metrics.jsonl`` (when a log file is attached)."""
        if self._jsonl_path is None:
            return
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    @classmethod
    def reset(cls):
        """Drop the singleton (tests, or several runs in one process)."""
        if cls._instance is not None:
            for h in list(cls._instance.logger.handlers):
                cls._instance.logger.removeHandler(h)
                h.close()
        cls._instance = None
        cls._initialized = False


def time_to_str(time_diff: float) -> str:
    """Reference ``logger/utils.py:1-2``."""
    h = int(time_diff // 3600)
    m = int(time_diff % 3600 // 60)
    s = time_diff % 60
    return f"{h}h {m}m {s:.1f}s"
