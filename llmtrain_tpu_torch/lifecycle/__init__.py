"""Train→canary→promote lifecycle (``llmtrain promote``), the port's copy of
``llmtrain_tpu/lifecycle/``.

Closes the loop the serving tier left open: training commits checkpoints
(atomic manifests), serving hot-swaps them (rolling reloads), but a
human still glued the two — and nothing protected live traffic from a
regressed checkpoint. This package is the supervisor in between:

* :mod:`~.watch` — polls a training run's manifest stream for new
  committed checkpoints (durable artifacts only, the goodput stance).
* :mod:`~.controller` — canaries each commit on one replica, scores it
  over a soak window (held-out eval loss + TTFT/per-token percentiles,
  optional A/B traffic split), then promotes fleet-wide or auto-rolls
  back — including rolling back a partially applied fleet swap.
* :mod:`~.ledger` — every decision is a durable ``promotions.jsonl``
  line, so a SIGKILLed promote resumes without double-promoting and the
  goodput ledger can attribute the run's promotion history.
"""

from .controller import PromotionController, RouterFleet
from .ledger import DECISIONS, TERMINAL_DECISIONS, PromotionLedger
from .watch import CheckpointWatcher

__all__ = [
    "CheckpointWatcher",
    "DECISIONS",
    "PromotionController",
    "PromotionLedger",
    "RouterFleet",
    "TERMINAL_DECISIONS",
]
