"""Promotion controller: canary → score → promote/rollback, supervised (the
port's copy of ``llmtrain_tpu/lifecycle/controller.py``).

In the port a replica's "params" are a decode-ready model module: the
loader builds a FRESH module for every candidate and the baseline keeps
its own, so a swap never writes into a module an older epoch still reads
(serving/router.py ``InProcessReplica.reload``).

The control loop ``llmtrain promote`` runs:

1. **Watch** — poll the training run's manifest stream for a commit
   newer than everything already decided (:mod:`~.watch`).
2. **Canary** — hot-swap the candidate into ONE designated replica via
   the router's single-replica reload; the placement layer excludes the
   canary from live traffic (or steers it a seeded A/B fraction,
   ``promote.traffic_split``).
3. **Score** — a soak window: seeded synthetic probes against the
   canary measure TTFT/per-token percentiles; the same probes against a
   reference replica give the baseline side of the A/B; held-out eval
   loss comes from the existing eval path (``Trainer.evaluate``).
   Gates are regression DELTAS: failed requests, eval-loss delta,
   SLO-percentile slowdown factors.
4. **Decide** — promote fleet-wide (``rolling_reload``) or roll the
   canary back to the promoted baseline. A PARTIALLY applied fleet swap
   (a replica failing its reload mid-roll) triggers a fleet-wide
   rollback so the fleet never settles mixed-epoch (the router's
   ``epoch_divergence`` gauge is the observable for this state).

Every decision is a durable :class:`~.ledger.PromotionLedger` line plus
a telemetry instant plus ``promote/*`` gauges (``llmtrain_promote_*``
in Prometheus). The controller owns NO threads and does no I/O beyond
its collaborators — watcher, fleet, evaluator, params loader and clock
are all injected, so the whole decision surface unit-tests with fakes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from ..config.schemas import PromoteConfig
from ..serving.loadgen import build_requests, percentiles
from ..telemetry.tracing import new_trace_id
from ..utils.logging import get_logger
from .ledger import PromotionLedger
from .watch import CheckpointWatcher

logger = get_logger()


@dataclass
class _Baseline:
    """The currently promoted identity every rollback restores."""

    params: Any
    step: int
    checkpoint: str | None
    eval_loss: float | None = None


@dataclass
class PromotionResult:
    """What ``run()`` returns; the CLI maps ``status`` to the exit
    taxonomy (training_finished/max_promotions → 0, training_dead →
    EXIT_TRAIN_FAILURE)."""

    status: str
    promotions: int = 0
    rollbacks: int = 0
    aborts: int = 0
    last_promoted_step: int | None = None
    ledger_summary: dict[str, Any] = field(default_factory=dict)


class RouterFleet:
    """Fleet adapter over a :class:`~..serving.router.ReplicaRouter`.

    The controller only ever talks to this surface (swap one replica,
    swap the fleet, split traffic, soak) — tests substitute a fake with
    the same four verbs.
    """

    def __init__(
        self,
        router: Any,
        *,
        vocab_size: int,
        prompt_tokens_min: int = 4,
        prompt_tokens_max: int = 16,
        max_new_tokens: int = 8,
        eos_token_id: int | None = None,
    ) -> None:
        self.router = router
        self.vocab_size = int(vocab_size)
        self.prompt_tokens_min = int(prompt_tokens_min)
        self.prompt_tokens_max = int(prompt_tokens_max)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id

    @property
    def replica_count(self) -> int:
        return len(self.router.replicas)

    def canary_swap(
        self, idx: int, params: Any, step: int | None, checkpoint: str | None
    ) -> None:
        self.router.reload_replica(
            idx, params=params, step=step, checkpoint=checkpoint
        )

    def fleet_swap(
        self, params: Any, step: int | None, checkpoint: str | None
    ) -> list[dict[str, Any]]:
        return self.router.rolling_reload(
            params=params, step=step, checkpoint=checkpoint
        )

    def set_traffic_split(self, idx: int, frac: float, seed: int) -> None:
        self.router.set_canary(idx, traffic_frac=frac, seed=seed)

    def clear_traffic_split(self) -> None:
        self.router.clear_canary()

    def param_steps(self) -> list[int | None]:
        return [
            rep.get("param_step")
            for rep in self.router.stats()["router"]["replicas"]
        ]

    def soak(
        self, idx: int, *, requests: int, seed: int, timeout_sec: float
    ) -> dict[str, Any]:
        """Seeded probe burst against ONE replica; server-side TTFT and
        inter-token gaps aggregated the same way the loadgen SLO block
        is (ServerStats semantics, measured per-replica)."""
        reqs = build_requests(
            num_requests=requests,
            seed=seed,
            vocab_size=self.vocab_size,
            prompt_tokens_min=self.prompt_tokens_min,
            prompt_tokens_max=self.prompt_tokens_max,
            max_new_tokens=self.max_new_tokens,
            eos_token_id=self.eos_token_id,
        )
        replica = self.router.replicas[idx]
        for req in reqs:
            replica.submit(req)
        deadline = time.monotonic() + timeout_sec
        for req in reqs:
            if not req.done.wait(timeout=max(0.0, deadline - time.monotonic())):
                req.abandon()
        for req in reqs:
            req.done.wait(timeout=30.0)
        completed = [r for r in reqs if r.finish_reason in ("eos", "length")]
        failed = [r for r in reqs if r.finish_reason == "error"]
        ttft = [r.ttft_ms for r in completed if r.ttft_ms is not None]
        per_token: list[float] = []
        for r in completed:
            for a, b in zip(r.token_times, r.token_times[1:]):
                per_token.append((b - a) * 1e3)
        ttft_pct = percentiles(ttft)
        tok_pct = percentiles(per_token)
        return {
            "requests": len(reqs),
            "completed": len(completed),
            "failed": len(failed),
            "timed_out": len(reqs) - len(completed) - len(failed),
            "ttft_p50_ms": ttft_pct["p50"],
            "ttft_p95_ms": ttft_pct["p95"],
            "per_token_p50_ms": tok_pct["p50"],
            "per_token_p99_ms": tok_pct["p99"],
        }


class PromotionController:
    """The decision loop. Pure orchestration over injected collaborators:

    * ``watcher`` — :class:`CheckpointWatcher` (or fake): ``poll``,
      ``training_finished``, ``training_alive``.
    * ``fleet`` — :class:`RouterFleet` (or fake): ``replica_count``,
      ``canary_swap``, ``fleet_swap``, ``set_traffic_split``,
      ``clear_traffic_split``, ``soak``, ``param_steps``.
    * ``load_params`` — checkpoint path → inference params pytree.
    * ``evaluator`` — checkpoint path → held-out eval loss (None skips
      the eval gate).
    * ``ledger`` — :class:`PromotionLedger` on the watched run dir.
    """

    def __init__(
        self,
        *,
        cfg: PromoteConfig,
        watcher: CheckpointWatcher | Any,
        fleet: Any,
        ledger: PromotionLedger,
        baseline_params: Any,
        baseline_step: int = -1,
        baseline_checkpoint: str | None = None,
        load_params: Callable[[Path], Any] | None = None,
        evaluator: Callable[[Path], float | None] | None = None,
        registry: Any | None = None,
        timeline: Any | None = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.cfg = cfg
        self.watcher = watcher
        self.fleet = fleet
        self.ledger = ledger
        self.registry = registry
        self.timeline = timeline
        self._load_params = load_params or (lambda p: p)
        self._evaluator = evaluator
        self._clock = clock
        self._sleep = sleep
        self.baseline = _Baseline(
            params=baseline_params,
            step=int(baseline_step),
            checkpoint=baseline_checkpoint,
        )
        self.promotions = 0
        self.rollbacks = 0
        self.aborts = 0
        # Promotion-cycle trace id: minted per candidate so the cycle's
        # decision instants and canary-window span correlate with the
        # serving traces that overlapped the soak (llmtrain trace show).
        self._cycle_trace_id: str | None = None
        if cfg.canary_replica >= fleet.replica_count:
            raise ValueError(
                f"promote.canary_replica ({cfg.canary_replica}) is out of "
                f"range for a {fleet.replica_count}-replica fleet"
            )

    # ----------------------------------------------------------- telemetry

    def _instant(self, decision: str, step: int, **args: Any) -> None:
        if self.timeline is not None:
            if self._cycle_trace_id is not None:
                args.setdefault("trace_id", self._cycle_trace_id)
            self.timeline.instant(
                f"promote/{decision}", cat="promote", step=step, **args
            )

    def _publish(self, **extra: float) -> None:
        if self.registry is None:
            return
        gauges = {
            "promote/promotions_total": float(self.promotions),
            "promote/rollbacks_total": float(self.rollbacks),
            "promote/aborts_total": float(self.aborts),
            "promote/last_promoted_step": float(self.baseline.step),
        }
        for name, value in extra.items():
            gauges[f"promote/{name}"] = float(value)
        self.registry.publish(gauges)

    # ---------------------------------------------------------------- loop

    def run(self) -> PromotionResult:
        """Watch → canary → decide until the stream ends. Resumes from
        the ledger: steps with a terminal decision are never re-judged,
        the newest ``promote`` entry re-anchors the baseline step."""
        decided = self.ledger.decided_steps()
        floor = max([self.baseline.step, *decided], default=self.baseline.step)
        pending = self.ledger.pending_canary()
        if pending is not None:
            # A killed promote left this candidate mid-judgement; re-open
            # its window (the second canary_start is the resume marker).
            floor = min(floor, int(pending["step"]) - 1)
        last_progress = self._clock()
        while True:
            if self.cfg.max_promotions and self.promotions >= self.cfg.max_promotions:
                return self._result("max_promotions")
            polled = self.watcher.poll(after_step=floor)
            if polled is None:
                if self.watcher.training_finished():
                    return self._result("training_finished")
                if self.watcher.training_alive(
                    stale_sec=self.cfg.idle_timeout_sec
                ):
                    last_progress = self._clock()
                elif self._clock() - last_progress > self.cfg.idle_timeout_sec:
                    return self._result("training_dead")
                self._sleep(self.cfg.poll_sec)
                continue
            ckpt, step = polled
            last_progress = self._clock()
            self._process_candidate(Path(ckpt), int(step))
            floor = max(floor, int(step))

    def _result(self, status: str) -> PromotionResult:
        logger.info(
            "promote: %s (promotions=%d rollbacks=%d aborts=%d)",
            status, self.promotions, self.rollbacks, self.aborts,
        )
        self._publish()
        return PromotionResult(
            status=status,
            promotions=self.promotions,
            rollbacks=self.rollbacks,
            aborts=self.aborts,
            last_promoted_step=(
                self.baseline.step if self.baseline.step >= 0 else None
            ),
            ledger_summary=self.ledger.summary(),
        )

    # ----------------------------------------------------------- one cycle

    def _process_candidate(self, ckpt: Path, step: int) -> None:
        self._cycle_trace_id = new_trace_id()
        win_t0 = time.perf_counter()
        try:
            self._run_cycle(ckpt, step)
        finally:
            if self.timeline is not None:
                try:
                    # The whole candidate cycle (swap + soak + decision)
                    # as one span, visible next to serving traces in the
                    # merged Perfetto view.
                    self.timeline.record(
                        "promote/canary_window",
                        t0=win_t0,
                        t1=time.perf_counter(),
                        cat="promote",
                        step=step,
                        checkpoint=str(ckpt),
                        trace_id=self._cycle_trace_id,
                    )
                except Exception:  # noqa: BLE001 — telemetry best-effort
                    pass
            self._cycle_trace_id = None

    def _run_cycle(self, ckpt: Path, step: int) -> None:
        cfg = self.cfg
        idx = cfg.canary_replica
        self.ledger.append("canary_start", step=step, checkpoint=str(ckpt))
        self._instant("canary_start", step, checkpoint=str(ckpt))
        if self.registry is not None:
            # Counter convention: no _total suffix here — the Prometheus
            # renderer appends it (→ llmtrain_promote_candidates_total).
            self.registry.inc("promote/candidates")
        self._publish(canary_step=step, canary_active=1.0)
        logger.info("promote: canarying step %d (%s)", step, ckpt.name)

        try:
            params = self._load_params(ckpt)
        except Exception as exc:  # noqa: BLE001 — a bad payload is a decision
            self._abort(step, ckpt, f"params load failed: {exc}")
            return
        # Exclude the canary from live placement (or A/B a seeded
        # fraction onto it) for the whole soak window.
        self.fleet.set_traffic_split(idx, cfg.traffic_split, cfg.soak_seed)
        try:
            try:
                self.fleet.canary_swap(idx, params, step, str(ckpt))
            except Exception as exc:  # noqa: BLE001
                self._abort(step, ckpt, f"canary swap failed: {exc}")
                return
            reason, scores = self._score(ckpt, step, idx)
            # Decide INSIDE the split window: on a rollback the canary
            # must be restored to the baseline before it rejoins live
            # placement, or a regressed candidate briefly serves traffic.
            if reason is None:
                self._promote(ckpt, step, params, scores)
            else:
                self._rollback_canary(ckpt, step, idx, reason, scores)
        finally:
            self.fleet.clear_traffic_split()

    def _abort(self, step: int, ckpt: Path, reason: str) -> None:
        self.aborts += 1
        self.ledger.append("abort", step=step, checkpoint=str(ckpt), reason=reason)
        self._instant("abort", step, reason=reason)
        self._publish(canary_active=0.0)
        logger.warning("promote: step %d aborted: %s", step, reason)

    # ------------------------------------------------------------- scoring

    def _score(
        self, ckpt: Path, step: int, idx: int
    ) -> tuple[str | None, dict[str, Any]]:
        """Soak + eval the canary; first failing gate wins. Returns
        (None, scores) on pass, (reason, scores) on regression."""
        cfg = self.cfg
        scores: dict[str, Any] = {}
        canary = self.fleet.soak(
            idx,
            requests=cfg.soak_requests,
            seed=cfg.soak_seed,
            timeout_sec=cfg.soak_timeout_sec,
        )
        scores["canary"] = canary
        bad = int(canary.get("failed", 0)) + int(canary.get("timed_out", 0))
        if bad > cfg.allow_failed_requests:
            return f"canary_request_failures: {bad}", scores

        if self._evaluator is not None:
            try:
                cand_loss = self._evaluator(ckpt)
            except Exception as exc:  # noqa: BLE001 — eval crash = regression
                return f"eval failed: {exc}", scores
            if cand_loss is not None:
                scores["eval_loss"] = float(cand_loss)
                base_loss = self._baseline_eval_loss()
                if base_loss is not None:
                    delta = float(cand_loss) - base_loss
                    scores["baseline_eval_loss"] = base_loss
                    scores["eval_loss_delta"] = round(delta, 6)
                    self._publish(last_eval_loss_delta=delta)
                    if delta > cfg.max_eval_loss_delta:
                        return (
                            f"eval_regression: delta {delta:.4f} > "
                            f"{cfg.max_eval_loss_delta}",
                            scores,
                        )

        # SLO side of the A/B: the same seeded probes against a
        # reference replica still serving the promoted baseline.
        ref_idx = next(
            (i for i in range(self.fleet.replica_count) if i != idx), None
        )
        if ref_idx is not None:
            reference = self.fleet.soak(
                ref_idx,
                requests=cfg.soak_requests,
                seed=cfg.soak_seed,
                timeout_sec=cfg.soak_timeout_sec,
            )
            scores["reference"] = reference
            for metric, bound in (
                ("ttft_p95_ms", cfg.ttft_p95_slowdown),
                ("per_token_p99_ms", cfg.per_token_p99_slowdown),
            ):
                if bound is None:
                    continue
                c, r = canary.get(metric), reference.get(metric)
                if c is not None and r is not None and r > 0 and c / r > bound:
                    return (
                        f"slo_regression: {metric} {c:.1f}ms vs "
                        f"{r:.1f}ms baseline (> {bound}x)",
                        scores,
                    )
        return None, scores

    def _baseline_eval_loss(self) -> float | None:
        if self.baseline.eval_loss is not None:
            return self.baseline.eval_loss
        if self._evaluator is None or self.baseline.checkpoint is None:
            return None
        try:
            loss = self._evaluator(Path(self.baseline.checkpoint))
        except Exception:  # noqa: BLE001 — no baseline, no eval gate
            return None
        if loss is not None:
            self.baseline.eval_loss = float(loss)
        return self.baseline.eval_loss

    # ------------------------------------------------------------ outcomes

    def _promote(
        self, ckpt: Path, step: int, params: Any, scores: dict[str, Any]
    ) -> None:
        results = self.fleet.fleet_swap(params, step, str(ckpt))
        failed = [r for r in results if "error" in r]
        if failed:
            # A partially applied fleet swap: some replicas admitted the
            # candidate, some did not (epoch_divergence > 0). Converge
            # DOWN: roll every replica back to the promoted baseline.
            restore = self.fleet.fleet_swap(
                self.baseline.params,
                self.baseline.step,
                self.baseline.checkpoint,
            )
            scores["fleet_swap"] = results
            scores["fleet_restore"] = restore
            self.rollbacks += 1
            self.ledger.append(
                "rollback",
                step=step,
                checkpoint=str(ckpt),
                reason=(
                    "partial_fleet_swap: "
                    + ", ".join(r["replica"] for r in failed)
                ),
                scores=scores,
            )
            self._instant("rollback", step, reason="partial_fleet_swap")
            if self.registry is not None:
                self.registry.inc("promote/rollbacks_total")
            self._publish(canary_active=0.0)
            logger.warning(
                "promote: step %d fleet swap failed on %d replica(s); "
                "rolled the fleet back to step %d",
                step, len(failed), self.baseline.step,
            )
            return
        scores["fleet_swap"] = results
        self.promotions += 1
        self.baseline = _Baseline(
            params=params,
            step=step,
            checkpoint=str(ckpt),
            eval_loss=scores.get("eval_loss"),
        )
        self.ledger.append(
            "promote", step=step, checkpoint=str(ckpt), scores=scores
        )
        self._instant("promote", step, checkpoint=str(ckpt))
        self._publish(canary_active=0.0)
        logger.info("promote: step %d promoted fleet-wide", step)

    def _rollback_canary(
        self,
        ckpt: Path,
        step: int,
        idx: int,
        reason: str,
        scores: dict[str, Any],
    ) -> None:
        extra: dict[str, Any] = {}
        try:
            self.fleet.canary_swap(
                idx,
                self.baseline.params,
                self.baseline.step,
                self.baseline.checkpoint,
            )
        except Exception as exc:  # noqa: BLE001 — record, don't crash the loop
            extra["canary_restore_error"] = str(exc)
            logger.error(
                "promote: restoring the canary to step %d failed: %s",
                self.baseline.step, exc,
            )
        self.rollbacks += 1
        self.ledger.append(
            "rollback",
            step=step,
            checkpoint=str(ckpt),
            reason=reason,
            scores=scores,
            **extra,
        )
        self._instant("rollback", step, reason=reason)
        self._publish(canary_active=0.0)
        logger.warning("promote: step %d rolled back: %s", step, reason)


__all__ = ["PromotionController", "PromotionResult", "RouterFleet"]
