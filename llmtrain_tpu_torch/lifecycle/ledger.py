"""Durable promotion ledger: ``promotions.jsonl`` in the watched run dir
(the port's copy of ``llmtrain_tpu/lifecycle/ledger.py``; the lines keep
its keys, so either package's ``goodput`` reads the other's ledger).

Same durability stance as the checkpoint manifests and the goodput
ledger: the ONLY record of what the promotion controller decided is an
append-only JSONL file, fsynced per line, living next to the training
run's other artifacts. A promote process SIGKILLed mid-decision leaves
at worst one torn trailing line (skipped on replay); re-running
``llmtrain promote`` replays the ledger and resumes after the last
terminal decision instead of double-promoting.

Entry schema (one JSON object per line)::

    {"seq": 3, "ts_unix": 1770000000.0, "decision": "promote",
     "step": 200, "checkpoint": ".../step_000200.ckpt",
     "reason": null, "scores": {"eval_loss": 2.1, ...}}

``decision`` is one of :data:`DECISIONS`; ``canary_start`` opens a
candidate's window and exactly one of the :data:`TERMINAL_DECISIONS`
closes it.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any

DECISIONS = ("canary_start", "promote", "rollback", "abort")
TERMINAL_DECISIONS = frozenset({"promote", "rollback", "abort"})


class PromotionLedger:
    """Append-only JSONL decision log with crash-safe replay."""

    def __init__(self, path: str | Path) -> None:
        self._path = Path(path)
        self._next_seq = 0
        for entry in self.entries():
            self._next_seq = max(self._next_seq, int(entry.get("seq", -1)) + 1)

    @property
    def path(self) -> Path:
        return self._path

    # ------------------------------------------------------------- writing

    def append(
        self,
        decision: str,
        *,
        step: int,
        checkpoint: str | None = None,
        reason: str | None = None,
        scores: dict[str, Any] | None = None,
        **extra: Any,
    ) -> dict[str, Any]:
        """Write one decision line (fsync before returning — the entry
        must survive a SIGKILL that lands right after the decision)."""
        if decision not in DECISIONS:
            raise ValueError(f"unknown promotion decision {decision!r}")
        entry: dict[str, Any] = {
            "seq": self._next_seq,
            "ts_unix": time.time(),
            "decision": decision,
            "step": int(step),
            "checkpoint": checkpoint,
            "reason": reason,
            "scores": scores or {},
        }
        entry.update(extra)
        self._path.parent.mkdir(parents=True, exist_ok=True)
        line = json.dumps(entry, sort_keys=True)
        with open(self._path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._next_seq += 1
        return entry

    # ------------------------------------------------------------- reading

    def entries(self) -> list[dict[str, Any]]:
        """Parsed ledger lines, oldest first. An unparseable line (the
        torn tail a SIGKILL can leave) is skipped, not fatal."""
        try:
            raw = self._path.read_text(encoding="utf-8")
        except OSError:
            return []
        out = []
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
            except ValueError:
                continue
            if isinstance(entry, dict) and entry.get("decision") in DECISIONS:
                out.append(entry)
        return out

    def last_promoted(self) -> dict[str, Any] | None:
        """The newest ``promote`` entry — the fleet's baseline on resume."""
        for entry in reversed(self.entries()):
            if entry["decision"] == "promote":
                return entry
        return None

    def decided_steps(self) -> set[int]:
        """Steps with a TERMINAL decision. Replay skips these: a step
        already promoted/rolled-back/aborted is never re-canaried, which
        is what makes re-running promote after a SIGKILL idempotent."""
        return {
            int(e["step"])
            for e in self.entries()
            if e["decision"] in TERMINAL_DECISIONS
        }

    def pending_canary(self) -> dict[str, Any] | None:
        """A ``canary_start`` not yet closed by a terminal decision for
        the same step — the candidate a killed promote was judging."""
        pending: dict[int, dict[str, Any]] = {}
        for entry in self.entries():
            step = int(entry["step"])
            if entry["decision"] == "canary_start":
                pending[step] = entry
            elif entry["decision"] in TERMINAL_DECISIONS:
                pending.pop(step, None)
        if not pending:
            return None
        return pending[max(pending)]

    def summary(self) -> dict[str, Any]:
        """Counts + last promoted step, the shape the goodput ledger and
        the CLI report embed."""
        entries = self.entries()
        counts = {d: 0 for d in DECISIONS}
        for e in entries:
            counts[e["decision"]] += 1
        promoted = self.last_promoted()
        return {
            "path": str(self._path),
            "entries": len(entries),
            "decisions": counts,
            "last_promoted_step": promoted["step"] if promoted else None,
            "last_promoted_checkpoint": (
                promoted["checkpoint"] if promoted else None
            ),
        }


__all__ = ["DECISIONS", "TERMINAL_DECISIONS", "PromotionLedger"]
