"""Trace-correlated structured logging.

The port's copy of ``tpushare/trace/jsonlog.py``. ``TPUSHARE_LOG_JSON=1``
switches the console handler to this formatter
(:func:`tpushare_torch.cmd.main.configure_logging`): one JSON object a
line, each carrying the decision trace id active on the emitting thread,
so a log aggregator can go from a pod's flight-recorder trace to every
line the extender wrote while making that decision, and back.
"""

from __future__ import annotations

import json
import logging
import time

from tpushare_torch.trace import recorder as _recorder_mod


class TraceJsonFormatter(logging.Formatter):
    """One JSON object per record: ts, level, logger, message, and the
    current decision's ``traceId`` when the emitting thread holds one."""

    #: The "Z" suffix below promises UTC; keep formatTime honest.
    converter = time.gmtime

    def __init__(self, recorder: "_recorder_mod.FlightRecorder | None" = None
                 ) -> None:
        super().__init__()
        self._recorder = recorder

    def _trace_id(self) -> str:
        from tpushare_torch import trace
        rec = self._recorder if self._recorder is not None else trace.recorder()
        return rec.current_trace_id()

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S")
                  + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        tid = self._trace_id()
        if tid:
            doc["traceId"] = tid
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        # default=str: a log call with a non-serializable arg must emit
        # a degraded line, never throw into the caller.
        return json.dumps(doc, default=str)
