"""Logging with a run-folder tee (counterpart of
``visualbert_tpu/utils/logging.py``; the reference tees stdout to
``run_N.log``, train.py:97-115)."""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "visualbert_torch"
_FORMAT = "%(asctime)s %(name)s %(levelname)s: %(message)s"


def get_logger(name: str = _ROOT) -> logging.Logger:
    """A logger under ``visualbert_torch``, whose records go to stderr."""
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
    return logging.getLogger(name)


def add_run_folder(folder: str) -> logging.FileHandler:
    """Create the run folder and tee the port's logs into ``run_N.log``
    there (first free N). The caller removes and closes the returned
    handler when the run ends."""
    os.makedirs(folder, exist_ok=True)
    n = 0
    while os.path.exists(os.path.join(folder, f"run_{n}.log")):
        n += 1
    handler = logging.FileHandler(os.path.join(folder, f"run_{n}.log"))
    handler.setFormatter(logging.Formatter(_FORMAT))
    get_logger().addHandler(handler)
    return handler
