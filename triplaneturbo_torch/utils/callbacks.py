"""Trial provenance: code and config snapshots, metrics and progress files.

Counterpart of ``triplaneturbo_tpu/utils/callbacks.py``: every trial directory
records the git-tracked code, the parsed and raw configs and the command line,
and a JSONL step-metrics log with a progress file.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Sequence

from .config import dump_config


def snapshot_code(trial_dir: str, repo_root: Optional[str] = None) -> Optional[str]:
    """Copy every git-tracked file into ``<trial>/code``; None outside a git checkout."""
    repo_root = repo_root or os.getcwd()
    dst = os.path.join(trial_dir, "code")
    try:
        files = subprocess.run(["git", "ls-files"], cwd=repo_root, capture_output=True,
                               text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return None
    for rel in files:
        # never snapshot earlier trial directories or caches
        if rel.startswith(("outputs/", ".jax_cache/", ".cache/")):
            continue
        src = os.path.join(repo_root, rel)
        if not os.path.isfile(src):
            continue
        out = os.path.join(dst, rel)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        shutil.copy2(src, out)
    return dst


def snapshot_config(trial_dir: str, cfg: Any, raw_path: Optional[str] = None,
                    cmd: Optional[Sequence[str]] = None) -> str:
    """Write ``parsed.yaml``, a copy of the raw config as ``raw.yaml`` and the command
    line (``cmd``, else ``sys.argv``) as ``cmd.txt`` into ``<trial>/configs``."""
    d = os.path.join(trial_dir, "configs")
    os.makedirs(d, exist_ok=True)
    dump_config(os.path.join(d, "parsed.yaml"), cfg)
    if raw_path and os.path.exists(raw_path):
        shutil.copy2(raw_path, os.path.join(d, "raw.yaml"))
    with open(os.path.join(d, "cmd.txt"), "w") as f:
        f.write(" ".join(sys.argv if cmd is None else cmd) + "\n")
    return d


class MetricsLogger:
    """One JSON line of metrics a logged step (``metrics.jsonl``) and a progress file."""

    def __init__(self, trial_dir: str):
        os.makedirs(trial_dir, exist_ok=True)
        self.path = os.path.join(trial_dir, "metrics.jsonl")
        self.progress_path = os.path.join(trial_dir, "progress.txt")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 2)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                pass  # not a scalar
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def progress(self, step: int, total: int, msg: str = "") -> None:
        with open(self.progress_path, "w") as f:
            f.write(f"{step}/{total} {msg}\n")
