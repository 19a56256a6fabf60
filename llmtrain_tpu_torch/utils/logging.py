"""Structured logging for the framework (the port's copy of
``llmtrain_tpu/utils/logging.py``; same logger name, so both packages
log under ``llmtrain``).

Parity target: reference ``src/llmtrain/utils/logging.py`` — named logger
``llmtrain`` with ``propagate=False`` (logging.py:89), single-line JSON
formatter with timestamp/level/logger/message/exc_info (logging.py:11-23),
idempotent handler management that reuses the stream handler and swaps file
handlers (logging.py:48-87).
"""

from __future__ import annotations

import json
import logging
import sys
from datetime import datetime, timezone
from pathlib import Path

LOGGER_NAME = "llmtrain"


class JsonFormatter(logging.Formatter):
    """Format each record as one line of JSON."""

    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "timestamp": datetime.fromtimestamp(record.created, tz=timezone.utc).isoformat(),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exc_info"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def get_logger() -> logging.Logger:
    return logging.getLogger(LOGGER_NAME)


def configure_logging(
    *,
    level: str = "INFO",
    json_output: bool = True,
    log_file: str | Path | None = None,
    stream=None,
) -> logging.Logger:
    """Configure the framework logger idempotently.

    Repeated calls reuse the existing stream handler (re-targeting its stream
    and formatter) and replace any file handlers so tests and multi-call CLI
    paths never stack duplicate handlers.
    """
    logger = get_logger()
    logger.setLevel(level)
    logger.propagate = False

    formatter: logging.Formatter
    if json_output:
        formatter = JsonFormatter()
    else:
        formatter = logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")

    target_stream = stream if stream is not None else sys.stderr

    stream_handler: logging.StreamHandler | None = None
    for handler in list(logger.handlers):
        if isinstance(handler, logging.FileHandler):
            handler.close()
            logger.removeHandler(handler)
        elif isinstance(handler, logging.StreamHandler):
            stream_handler = handler

    if stream_handler is None:
        stream_handler = logging.StreamHandler(target_stream)
        logger.addHandler(stream_handler)
    else:
        stream_handler.setStream(target_stream)
    stream_handler.setFormatter(formatter)

    if log_file is not None:
        file_handler = logging.FileHandler(log_file, encoding="utf-8")
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)

    return logger
