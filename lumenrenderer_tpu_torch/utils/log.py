"""Structured logging: port of `lumenrenderer_tpu/utils/log.py`.

Two named loggers: `lumen.core` (renderer, accel, kernels) and
`lumen.client` (the CLI, user scripts). `frame_record()` writes one record
a frame from a stats dict, a key=value line or, with LUMEN_LOG_JSON=1, JSON,
at DEBUG level; LUMEN_LOG_LEVEL sets the loggers' level (default INFO).
"""
from __future__ import annotations

import json
import logging
import os
import sys
from typing import Dict

_FMT = "%(asctime)s [%(name)s] %(levelname)s: %(message)s"
_configured = False


def _configure():
    global _configured
    if _configured:
        return
    level = os.environ.get("LUMEN_LOG_LEVEL", "INFO").upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
    for name in ("lumen.core", "lumen.client"):
        lg = logging.getLogger(name)
        if not lg.handlers:
            lg.addHandler(handler)
        lg.setLevel(level)
        lg.propagate = False
    _configured = True


def core() -> logging.Logger:
    """The engine's logger."""
    _configure()
    return logging.getLogger("lumen.core")


def client() -> logging.Logger:
    """The application's logger."""
    _configure()
    return logging.getLogger("lumen.client")


def frame_record(stats: Dict[str, float], logger: logging.Logger = None,
                 level: int = logging.DEBUG) -> None:
    """Write one structured record of a frame's stats dict."""
    lg = logger or core()
    if os.environ.get("LUMEN_LOG_JSON") == "1":
        lg.log(level, json.dumps({"frame_stats": stats}))
    else:
        body = " ".join(
            f"{k.replace(' ', '_')}={v:.3f}" if isinstance(v, float)
            else f"{k.replace(' ', '_')}={v}"
            for k, v in stats.items())
        lg.log(level, "frame %s", body)
