"""Native TensorBoard event-file tracker, zero dependencies (the port's
copy of ``llmtrain_tpu/tracking/tensorboard.py``; the same calls write the
same records byte for byte, up to the wall times and the file name's
hostname).

Like the native SQLite store (tracking/sqlite.py) this writes its format
by hand, so hosts without TensorBoard installed track out of the box.
TensorBoard's on-disk protocol is TFRecord framing (masked CRC-32C) around hand-encoded ``tensorflow.Event``
protobuf messages — both stable, versioned wire formats. Scalars land
as ``simple_value`` summaries (one event per ``log_metrics`` call);
params land once as a markdown table through the text plugin, which is
how TensorBoard renders run configuration.

Any TensorBoard (``tensorboard --logdir <dir>``) reads the output.

Protobuf wire encoding used (proto3, all hand-rolled below):

* ``Event``: 1 wall_time (double), 2 step (int64), 3 file_version
  (string), 5 summary (message).
* ``Summary``: 1 value (repeated message); ``Summary.Value``: 1 tag
  (string), 2 simple_value (float), 8 tensor (message), 9 metadata.
* ``SummaryMetadata``: 1 plugin_data (message: 1 plugin_name string);
  ``TensorProto``: 1 dtype (enum, DT_STRING=7), 8 string_val (bytes).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path
from typing import Any

# ---------------------------------------------------------------- CRC-32C
# Castagnoli polynomial (reflected 0x1EDC6F41 -> 0x82F63B78), table-driven.
_CRC_TABLE: list[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord's rotated+offset mask over the raw CRC."""
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _pb_bytes(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _pb_string(field: int, s: str) -> bytes:
    return _pb_bytes(field, s.encode("utf-8"))


def _pb_double(field: int, x: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", x)


def _pb_float(field: int, x: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(x))


def _pb_int64(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n & 0xFFFFFFFFFFFFFFFF)


def _scalar_value(tag: str, value: float) -> bytes:
    return _pb_bytes(1, _pb_string(1, tag) + _pb_float(2, value))


def _text_value(tag: str, text: str) -> bytes:
    """Summary.Value carrying a string TensorProto for the text plugin."""
    tensor = _pb_int64(1, 7) + _pb_bytes(8, text.encode("utf-8"))  # DT_STRING
    metadata = _pb_bytes(1, _pb_string(1, "text"))  # plugin_data.plugin_name
    return _pb_bytes(1, _pb_string(1, tag) + _pb_bytes(8, tensor) + _pb_bytes(9, metadata))


def _event(wall_time: float, step: int | None, body: bytes) -> bytes:
    ev = _pb_double(1, wall_time)
    if step is not None:
        ev += _pb_int64(2, step)
    return ev + body


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


def resolve_logdir(tracking_uri: str) -> Path:
    """``file:`` URIs and plain paths both point at a logdir root."""
    uri = tracking_uri
    if uri.startswith("file://"):
        uri = uri[len("file://") :]
    elif uri.startswith("file:"):
        uri = uri[len("file:") :]
    return Path(uri)


class TensorBoardTracker:
    """Tracker backend writing one event file per run.

    Layout is TensorBoard's convention: ``<logdir>/<experiment>/<run>``
    is a run directory holding a single ``events.out.tfevents.*`` file,
    so ``tensorboard --logdir <logdir>`` shows experiments/runs as
    nested groups. Metrics flush on every call — a killed training run
    (the failure-detection story) loses at most the current event, and
    the file is readable DURING the run, which is the point of choosing
    TensorBoard over a post-hoc store.
    """

    def __init__(
        self,
        tracking_uri: str,
        experiment: str,
        *,
        run_name: str | None = None,
    ) -> None:
        self._root = resolve_logdir(tracking_uri)
        self._experiment = experiment
        self._run_name = run_name
        self._fh: Any | None = None

    # ------------------------------------------------------------ runs
    def start_run(self, run_id: str, run_name: str | None = None) -> None:
        if self._fh is not None:
            raise RuntimeError("start_run called twice on this tracker")
        run_dir = self._root / self._experiment / (run_name or self._run_name or run_id)
        run_dir.mkdir(parents=True, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.v2"
        )
        self._fh = open(run_dir / fname, "wb")
        # The version record must be the file's first event.
        self._write(_event(time.time(), None, _pb_string(3, "brain.Event:2")))

    def _write(self, event: bytes) -> None:
        if self._fh is None:
            raise RuntimeError("tracker is not started (or already ended)")
        self._fh.write(_tfrecord(event))
        self._fh.flush()

    # ------------------------------------------------------------ logging
    def log_params(self, params: dict[str, Any]) -> None:
        from .mlflow import _flatten_params

        flat = _flatten_params(params)
        rows = "\n".join(
            "| {} | {} |".format(
                k, str(flat[k]).replace("|", "\\|").replace("\n", " ")
            )
            for k in sorted(flat, key=str)
        )
        table = "| param | value |\n|---|---|\n" + rows
        self._write(
            _event(time.time(), 0, _pb_bytes(5, _text_value("params/config", table)))
        )

    def log_metrics(self, metrics: dict[str, float], step: int | None = None) -> None:
        if not metrics:
            return
        body = b"".join(
            _scalar_value(tag, value) for tag, value in metrics.items()
        )
        self._write(_event(time.time(), step, _pb_bytes(5, body)))

    def log_artifact(self, local_path: str, artifact_path: str | None = None) -> None:
        # TensorBoard has no artifact store; record the path as text so
        # the run page links back to it (artifacts by reference, not by
        # copy).
        self._write(
            _event(
                time.time(),
                0,
                _pb_bytes(
                    5,
                    _text_value(
                        "artifacts/" + (artifact_path or Path(local_path).name),
                        str(local_path),
                    ),
                ),
            )
        )

    def end_run(self, status: str = "FINISHED") -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


__all__ = ["TensorBoardTracker", "resolve_logdir"]
