"""Minimal structured logger (stdlib-only, no external deps).

Two output modes, selected by environment at first use:

  * default — human-readable single lines (``HH:MM:SS LEVEL name | msg``);
  * ``REPRO_TORCH_LOG_JSON=1`` — structured JSON-lines: one JSON object per
    record with ``ts``/``level``/``component``/``msg`` plus any structured
    fields bound via :func:`bind` or passed through ``extra={"fields": ...}``
    — machine-parseable run logs for the observability pipeline
    (DESIGN.md §13), e.g. ``trainer`` step records carrying
    rank/generation/component.

``REPRO_TORCH_LOG_LEVEL`` selects the level either way (default INFO).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_FMT = "%(asctime)s %(levelname)-7s %(name)s | %(message)s"
_configured = False


class JsonFormatter(logging.Formatter):
    """One JSON object per record; structured fields ride in
    ``record.fields`` (set via ``logger.info(..., extra={"fields": {...}})``
    or a :func:`bind` adapter) and are merged into the top-level object."""

    def format(self, record: logging.LogRecord) -> str:
        obj = {
            "ts": round(time.time(), 6),
            "level": record.levelname,
            "component": record.name.removeprefix("repro_torch."),
            "msg": record.getMessage(),
        }
        fields = getattr(record, "fields", None)
        if isinstance(fields, dict):
            for k, v in fields.items():
                if k not in obj:
                    obj[k] = v if isinstance(
                        v, (str, int, float, bool, type(None))
                    ) else str(v)
        if record.exc_info:
            obj["exc"] = self.formatException(record.exc_info)
        return json.dumps(obj, sort_keys=False)


class _BoundAdapter(logging.LoggerAdapter):
    """LoggerAdapter merging bound fields (rank, generation, component
    context) into every record's ``fields`` dict. In text mode the fields
    are appended to the message; in JSON mode they become object keys."""

    def process(self, msg, kwargs):
        fields = dict(self.extra or {})
        fields.update(kwargs.pop("fields", {}) or {})
        extra = kwargs.setdefault("extra", {})
        merged = dict(fields)
        merged.update(extra.get("fields", {}) or {})
        extra["fields"] = merged
        if merged and not _json_mode():
            ctx = " ".join(f"{k}={v}" for k, v in merged.items())
            msg = f"{msg} [{ctx}]"
        return msg, kwargs


def _json_mode() -> bool:
    return os.environ.get("REPRO_TORCH_LOG_JSON", "") == "1"


def _configure() -> None:
    global _configured
    if _configured:
        return
    level = os.environ.get("REPRO_TORCH_LOG_LEVEL", "INFO").upper()
    handler = logging.StreamHandler(sys.stderr)
    if _json_mode():
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
    root = logging.getLogger("repro_torch")
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"repro_torch.{name}")


def bind(logger: logging.Logger, **fields) -> logging.LoggerAdapter:
    """A logger with structured fields attached to every record, e.g.
    ``log = bind(get_logger("runtime.trainer"), rank=0, component="trainer")``
    — the fields become JSON keys under ``REPRO_TORCH_LOG_JSON=1`` and a
    ``[k=v ...]`` suffix in text mode."""
    return _BoundAdapter(logger, fields)


def reconfigure_for_tests() -> None:
    """Reset the cached handler config (tests flipping REPRO_TORCH_LOG_JSON)."""
    global _configured
    root = logging.getLogger("repro_torch")
    for h in list(root.handlers):
        root.removeHandler(h)
    _configured = False
