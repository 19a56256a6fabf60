"""Tracker protocol + no-op implementation (the port's copy of
``llmtrain_tpu/tracking/base.py``): ``Tracker`` with
start_run/log_params/log_metrics/log_artifact/end_run, and ``NullTracker``
for non-main ranks and disabled tracking.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable


@runtime_checkable
class Tracker(Protocol):
    def start_run(self, run_id: str, run_name: str | None = None) -> None: ...

    def log_params(self, params: dict[str, Any]) -> None: ...

    def log_metrics(self, metrics: dict[str, float], step: int | None = None) -> None: ...

    def log_artifact(self, local_path: str, artifact_path: str | None = None) -> None: ...

    def end_run(self, status: str = "FINISHED") -> None: ...


class NullTracker:
    """No-op tracker for non-main ranks and disabled tracking."""

    def start_run(self, run_id: str, run_name: str | None = None) -> None:
        pass

    def log_params(self, params: dict[str, Any]) -> None:
        pass

    def log_metrics(self, metrics: dict[str, float], step: int | None = None) -> None:
        pass

    def log_artifact(self, local_path: str, artifact_path: str | None = None) -> None:
        pass

    def end_run(self, status: str = "FINISHED") -> None:
        pass
