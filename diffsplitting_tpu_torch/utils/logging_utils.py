"""File and screen logging helpers. Counterpart: diffsplitting_tpu/utils/logging_utils.py."""

from __future__ import annotations

import logging
import os


def mkdirs(paths):
    if isinstance(paths, str):
        os.makedirs(paths, exist_ok=True)
    else:
        for path in paths:
            os.makedirs(path, exist_ok=True)


def setup_logger(logger_name, root, phase, level=logging.INFO, screen=False):
    """Named logger writing `<root>/<phase>.log`, optionally echoing to stderr."""
    logger = logging.getLogger(logger_name)
    formatter = logging.Formatter(
        "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
        datefmt="%y-%m-%d %H:%M:%S",
    )
    log_file = os.path.join(root, f"{phase}.log")
    fh = logging.FileHandler(log_file, mode="w")
    fh.setFormatter(formatter)
    logger.setLevel(level)
    logger.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    return logger
