"""Structured JSONL event log (the port's copy of ``EventLog`` and
``event_log`` from ``coldrec_tpu/utils/logging.py``).

``EventLog`` appends one JSON object per event to ``$COLDREC_EVENT_LOG`` (or
a given path): run metadata, each epoch's batch losses and time split,
validation metrics, timings. A no-op unless enabled, so the default run stays
print-compatible with the reference.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class EventLog:
    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get("COLDREC_EVENT_LOG")
        self._fh = open(self.path, "a", buffering=1) if self.path else None

    def emit(self, event: str, **fields):
        if self._fh is None:
            return
        rec = {"ts": round(time.time(), 3), "event": event}
        rec.update(fields)
        self._fh.write(json.dumps(rec) + "\n")

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


_global_log: Optional[EventLog] = None


def event_log() -> EventLog:
    """The process's event log, opened on first use from
    ``$COLDREC_EVENT_LOG``, and opened anew (the old one closed) when that
    variable has changed since."""
    global _global_log
    path = os.environ.get("COLDREC_EVENT_LOG")
    if _global_log is None or _global_log.path != path:
        if _global_log is not None:
            _global_log.close()
        _global_log = EventLog(path)
    return _global_log
