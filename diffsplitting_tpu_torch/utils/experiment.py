"""Versioned experiment directories.

Counterpart: diffsplitting_tpu/utils/experiment.py, copied: runs live under
`<root>/<YYMM>/<dataset>-<model>-<loss>/<version>/` with auto-incrementing
integer versions; concurrent creators resolve mkdir collisions by retrying
with a fresh version number.
"""

from __future__ import annotations

import time
from datetime import datetime
from pathlib import Path
from typing import Tuple

_MAX_MKDIR_RETRIES = 10


def get_new_model_version(model_dir) -> str:
    """Next integer version under model_dir (subdirs must be integers)."""
    taken = []
    for child in Path(model_dir).iterdir():
        if not child.name.lstrip("-").isdigit():
            raise ValueError(
                f"Invalid subdirectory:{model_dir}/{child.name}. "
                "Only integer versions are allowed"
            )
        taken.append(int(child.name))
    return str(max(taken) + 1) if taken else "0"


def get_model_name(config) -> str:
    data_name = config["datasets"]["train"]["name"]
    model_name = config["model"]["which_model_G"]
    # sr_* configs omit loss_type
    loss_name = config["model"].get("loss_type") or "l1"
    return f"{data_name}-{model_name}-{loss_name}"


def get_month() -> str:
    return datetime.now().strftime("%y%m")


def get_workdir(config, root_dir) -> Tuple[str, str]:
    """Create the run directory; returns (absolute_workdir, relative_path).
    Collisions with concurrent runs retry up to _MAX_MKDIR_RETRIES times
    with a re-read version."""
    root = Path(root_dir)
    model_dir = root / get_month() / get_model_name(config)
    model_dir.mkdir(parents=True, exist_ok=True)

    for attempt in range(_MAX_MKDIR_RETRIES + 1):
        version = get_new_model_version(model_dir)
        workdir = model_dir / version
        try:
            workdir.mkdir(exist_ok=False)
        except FileExistsError:
            if attempt == _MAX_MKDIR_RETRIES:
                raise ValueError(f"Cannot create a new directory. {workdir} already exists.")
            time.sleep(0.5)
            continue
        return str(workdir), str(Path(get_month()) / get_model_name(config) / version)

    raise RuntimeError("unreachable")


__all__ = ["get_workdir", "get_model_name", "get_new_model_version", "get_month"]
