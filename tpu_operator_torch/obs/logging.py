"""Root logging for the port's binaries (the validator, the device plugin,
the node agents): text by default, one JSON object per record on
``--log-format=json`` or ``TPU_OPERATOR_LOG_FORMAT=json``.  Own copy of
``tpu_operator/obs/logging.py``'s formats."""

from __future__ import annotations

import json
import logging
import sys

TEXT_FORMAT = "%(asctime)s %(levelname)s %(name)s %(message)s"

FORMAT_TEXT = "text"
FORMAT_JSON = "json"


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exc_info"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class _StderrHandler(logging.StreamHandler):
    """Writes to ``sys.stderr`` as it is at each record, not as it was at
    set-up (a caller may swap the stream, as pytest's capture does)."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr


def setup(fmt: str = FORMAT_TEXT, level: int = logging.INFO) -> None:
    """Replace the root handlers with one in ``fmt``."""
    handler = _StderrHandler()
    handler.setFormatter(JsonFormatter() if fmt == FORMAT_JSON else logging.Formatter(TEXT_FORMAT))
    root = logging.getLogger()
    root.setLevel(level)
    root.handlers[:] = [handler]
