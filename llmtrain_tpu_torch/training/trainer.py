"""Step-based trainer (port of ``llmtrain_tpu/training/trainer.py`` for one
device, or data parallel over processes, one device each).

Same loop as JAX: a 1-indexed step loop over batches from the
deterministic sampler (assembled ahead by the prefetcher), gradient
accumulation inside the step, interval metrics logged every
``log_every_steps`` (loss, lr, tokens/s, step time, MFU against the H100
peak, data wait, host dispatch, peak device memory), token-weighted eval
every ``eval_every_steps``, checkpoints every ``save_every_steps`` and at
the last step, resume from a checkpoint with the config-mismatch warning,
and preemption: SIGTERM saves a checkpoint at the step it lands in and
returns with ``preempted=True``, so ``train --auto-resume`` continues
from there. :meth:`Trainer.evaluate` runs the validation loop alone
(``eval``), on the EMA shadow with ``use_ema``.

Fault tolerance (resilience/, wired at JAX's places):

* the non-finite guard: one flag on the device over the loss and the
  gradients, the update applied under it (no host read per tensor), the
  consecutive-skip counter read at log boundaries and its cap
  (:class:`NonFiniteLossError`, exit 1);
* loss-spike rollback (:meth:`Trainer._maybe_rollback`): the interval's
  host losses feed the detector; on a spike the newest verified
  checkpoint saved before it is restored into the live model, optimizer
  and EMA, the sampler skips the consumed window, the prefetcher reseeks,
  replayed steps draw fresh dropout streams, and past ``max_rollbacks``
  the run stops (``RollbackBudgetExceededError``, exit 1); several ranks
  agree on the spike step and rank 0's target;
* the fault plan (``resilience.faults``): NaN windows inside the step,
  host-side spikes, SIGTERM, SIGKILL (in the loop or inside a checkpoint
  write), hangs of the loop or the prefetcher, checkpoint corruption, and
  failing dataset setups (``InjectedFault``, exit 75 past the retries),
  each stamped on the timeline as a ``fault_*`` instant;
* the hang watchdog and heartbeat (exit 76 with a hang report), armed
  after the first dispatched step, and straggler telemetry over the
  ranks at log boundaries;
* checkpoints through the manifest commit protocol, written on the
  manager's thread from an owned host copy (``checkpoint_save`` spans the
  gather), a failed write surfacing at the next log boundary;
* elastic resume: a checkpoint saved at another world size with the same
  global micro-batch continues the saved trajectory (``elastic_reshard``);
  any other topology change raises ``TopologyMismatchError`` (exit 2).

Data parallel (a ``torch.distributed`` group formed by
``distributed.setup_distributed``, one process per device): each of the
W ranks takes its B rows of the sampler's global batch of B·W rows, and
its share of each eval batch; the step sums the gradients over the ranks
(training/train_step.py) and the eval sums the loss and token sums. Only
rank 0 writes checkpoints, and the others wait at a barrier after each
save; on resume rank 0 picks the checkpoint and broadcasts its step, so
every rank restores the same file. SIGTERM to any rank stops every rank
at the same step: the flags are OR-ed over the ranks at each log
boundary. ``trainer.extra.profile_start_step`` traces a window of steps
with ``torch.profiler`` (:class:`_StepProfiler`).

Telemetry (telemetry/, the :class:`~..telemetry.Telemetry` facade) is
wired as in JAX: the step loop's spans and instants land on the event
timeline, every interval metric goes through the metrics registry to the
tracker at each log boundary, memory is sampled there, and the end of
``fit`` writes ``telemetry/timeline.jsonl``, ``telemetry/trace.json``,
``telemetry/metrics.prom``, ``report.json`` and ``report.md`` (with the
goodput ledger and the cost attribution of one train step, counted on
``meta`` tensors: telemetry/profiling.py) and registers them with the
tracker. ``telemetry.enabled: false`` turns every span and instant into a
no-op and writes none of these files.

A config that switches on a part of the JAX trainer the port does not run
yet raises ``NotImplementedError`` at construction, naming the ROADMAP.md
item (:func:`refuse_unported`).
"""

from __future__ import annotations

import math
import re
import signal
import threading
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch
import yaml

from ..config.schemas import RunConfig
from ..data.prefetch import BatchPrefetcher
from ..data.sampler import DeterministicSampler
from ..distributed import (
    active_state,
    allgather_any,
    allgather_scalar,
    barrier,
    broadcast_int_from_main,
    collective_errors,
    collective_wait_seconds,
    resolve_device,
)
from ..interop.flax_params import flax_params_to_state_dict, state_dict_to_flax_params
from ..registry import get_data_module, get_model_adapter, initialize_registries
from ..resilience.elastic import (
    TopologyMismatchError,
    classify_topology_change,
    describe_topology,
    resume_batch_index,
)
from ..resilience.faults import FaultPlan, retry, retry_rng
from ..resilience.guard import NonFiniteLossError
from ..resilience.spike import LossSpikeDetector, RollbackBudgetExceededError
from ..resilience.watchdog import HangWatchdog, ProgressBeacon, StragglerTracker
from ..telemetry import Telemetry
from ..tracking.base import Tracker
from ..utils.hw import mfu as compute_mfu
from ..utils.hw import peak_flops, peak_memory_bytes, transformer_flops_per_token
from ..utils.logging import get_logger
from .checkpoint import (
    CheckpointManager,
    ema_from_payload,
    opt_state_from_host,
    opt_state_to_host,
    read_manifest,
    resolve_resume_path,
    warn_on_config_mismatch,
)
from .optimizer import build_model_optimizer, find_ema_tree, lr_schedule
from .train_step import TrainState, make_eval_step, make_train_step

logger = get_logger()

_NOT_PORTED = "is not yet ported to llmtrain_tpu_torch"
# Bound on the checkpoint drain of an abort path (an exception unwinding
# the loop, the watchdog's hook): a write wedged on dead storage is
# abandoned instead of holding the exit.
_ABORT_DRAIN_TIMEOUT_SEC = 30.0
_NO_EMA = ("no EMA state in the optimizer — train with trainer.extra.ema_decay to track "
           "shadow weights")


@dataclass(frozen=True)
class TrainResult:
    """Final outcome of a training run (the JAX ``TrainResult``)."""

    final_step: int
    final_loss: float
    final_val_loss: float | None
    total_time: float
    peak_memory: float
    val_metrics: dict[str, float] | None
    first_step_loss: float | None
    resumed_from_step: int | None
    parameter_count: int
    trainable_parameter_count: int
    total_tokens: int = 0
    preempted: bool = False
    rollbacks: int = 0


def _mesh_refusal(cfg: RunConfig, world_size: int) -> str | None:
    """What of ``distributed.mesh`` the port cannot run: any axis but
    ``data`` larger than one device, or a ``data`` axis that is not the
    process count (``-1`` means all of them)."""
    sizes = cfg.distributed.mesh.model_dump()
    data = sizes.pop("data")
    if any(v > 1 for v in sizes.values()):
        return "distributed.mesh with an axis other than data larger than one device"
    if data not in (-1, world_size):
        return (f"distributed.mesh.data={data} with {world_size} process(es) (the data "
                "axis is the process count, -1)")
    return None


def refuse_unported(cfg: RunConfig, world_size: int = 1) -> None:
    """Raise ``NotImplementedError`` for a config that switches on a part
    of the JAX trainer the port does not run yet (``world_size``: the
    processes of the data-parallel group, 1 without one)."""
    mesh = _mesh_refusal(cfg, world_size)
    checks = [
        (mesh is not None, mesh, "parallelism"),
        (cfg.trainer.zero.enabled, "trainer.zero (sharded optimizer state)", "parallelism"),
        (cfg.model.remat or cfg.model.extra.get("activation_tiers") is not None,
         "model.remat / model.extra.activation_tiers", "parallelism"),
        (cfg.model.extra.get("lora") is not None, "LoRA models (model.extra.lora)",
         "model zoo"),
    ]
    for on, what, item in checks:
        if on:
            raise NotImplementedError(f"{what} {_NOT_PORTED} (ROADMAP.md queue A: {item})")


def _commit_observer(telemetry: Telemetry):
    """The checkpoint manager's commit observer (called on the writer
    thread): one counter tick and one timeline instant per PUBLISHED
    manifest. It holds the telemetry, not the trainer, so a finished
    trainer and its device tensors are freed with their last reference
    rather than by the cycle collector."""

    def on_commit(step: int, manifest: Path) -> None:
        telemetry.metrics.inc("checkpoint/commits")
        telemetry.timeline.instant("checkpoint_commit", cat="ckpt", step=step)

    return on_commit


class Trainer:
    def __init__(self, cfg: RunConfig, run_dir: Path | None,
                 tracker: Tracker | None = None) -> None:
        """The data-parallel group is the one ``setup_distributed`` formed,
        if any. Every rank gets the run dir; only rank 0 writes to it.
        All tracker traffic goes through the telemetry registry, so a
        failing tracker degrades to warnings (None: no tracker)."""
        self._dist = active_state()
        self._world = self._dist.num_processes if self._dist else 1
        self._rank = self._dist.process_index if self._dist else 0
        self._is_main = self._rank == 0
        refuse_unported(cfg, self._world)
        self._cfg = cfg
        self._run_dir = run_dir
        self._device = resolve_device(cfg.run.device)
        self._telemetry = Telemetry(cfg, run_dir, tracker, process_index=self._rank,
                                    is_main=self._is_main, device=self._device)
        initialize_registries()
        self._adapter = get_model_adapter(cfg.model.name)()
        self._data_module = get_data_module(cfg.data.name)()
        # Fault-tolerance wiring (resilience/): the fault plan is inert
        # unless the config injects something; rollback bookkeeping lives
        # on the instance so checkpoint saves can round-trip it.
        self._resilience = cfg.resilience
        self._faults = FaultPlan.from_config(cfg.resilience.faults)
        self._rollback_count = 0
        self._spike_detector: LossSpikeDetector | None = None
        self._beacon: ProgressBeacon | None = None
        self._straggler: StragglerTracker | None = None
        self._last_restored_resilience: dict[str, Any] = {}
        self._last_restored_manifest: dict[str, Any] | None = None
        tokenizer = None
        try:
            tokenizer = self._adapter.build_tokenizer(cfg)
        except NotImplementedError:
            raise  # a refusal (exit 2), not an offline environment
        except Exception as exc:  # noqa: BLE001 — offline environments: tokenizer optional
            logger.warning("build_tokenizer failed (%s); continuing without one", exc)
        # Dataset loading is the init stage that touches disks and caches:
        # transient failures get full-jitter backoff, seeded per rank so the
        # ranks' retries do not march in step.
        retry(
            self._faults.flaky("dataset_load", lambda: self._data_module.setup(cfg, tokenizer)),
            attempts=cfg.resilience.retry_attempts,
            base_delay=cfg.resilience.retry_base_delay,
            description="dataset setup",
            rng=retry_rng(cfg.run.seed, self._rank),
        )
        self._model = self._adapter.build_model(cfg, self._device)
        self._global_micro = cfg.trainer.micro_batch_size * self._world
        optimizer = build_model_optimizer(cfg, self._model)
        self._schedule = lr_schedule(cfg.trainer)
        # Every rank gets a manager over the shared run dir (the spike
        # rollback restores on every rank); only rank 0 writes.
        self._ckpt_mgr: CheckpointManager | None = None
        if run_dir is not None:
            keep_last_k = int(cfg.trainer.extra.get("keep_last_k", 3))
            self._ckpt_mgr = CheckpointManager(Path(run_dir) / "checkpoints",
                                               keep_last_k=keep_last_k,
                                               on_commit=_commit_observer(self._telemetry))
        guard = cfg.resilience.nonfinite_guard
        self._state = TrainState(
            step=0, model=self._model, optimizer=optimizer,
            nonfinite_count=(torch.zeros((), dtype=torch.int32, device=self._device)
                             if guard else None),
        )
        self._train_step_fn = make_train_step(
            self._adapter, self._model,
            grad_accum_steps=cfg.trainer.grad_accum_steps,
            use_dropout=cfg.model.dropout > 0.0,
            seed=cfg.run.seed,
            nonfinite_guard=guard,
            inject_nan_window=self._faults.nan_window(),
            data_parallel=self._dist is not None,
            rank=self._rank,
        )
        self._eval_step_fn = make_eval_step(self._adapter, self._model)
        self._param_count = sum(p.numel() for p in self._model.parameters())
        self._trainable_count = self._param_count
        self._peak_flops = peak_flops(self._device)
        self._train_seqlen = cfg.model.block_size
        self._data_offset = 0
        self._resume_count = 0
        self._sampler: DeterministicSampler | None = None
        self._dataset_specs: dict[int, tuple[tuple[str, ...], int]] = {}
        # Cost-attribution inputs captured during fit (telemetry/profiling.py):
        # the shapes and dtypes of the batch the step ran on.
        self._batch_struct: dict[str, tuple[tuple[int, ...], torch.dtype]] | None = None
        self._tokens_per_step = 0

    @property
    def state(self) -> TrainState:
        return self._state

    @property
    def model(self) -> torch.nn.Module:
        return self._model

    # ------------------------------------------------------------------ data

    def _dataset_spec(self, dataset) -> tuple[tuple[str, ...], int]:
        """Cached (batch keys, sequence length) of a dataset."""
        cached = self._dataset_specs.get(id(dataset))
        if cached is None:
            probe = dataset.get_examples(np.asarray([0]))
            cached = (tuple(probe), probe["input_ids"].shape[1])
            self._dataset_specs[id(dataset)] = cached
        return cached

    def _to_device(self, arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self._device)
                for k, v in arrays.items()}

    def global_batch(self, sampler: DeterministicSampler, dataset, step: int) -> dict:
        """This rank's (A, B, T) share of optimizer step ``step``'s global
        batch on the device: rows [r·B, (r+1)·B) of each micro-batch."""
        accum = self._cfg.trainer.grad_accum_steps
        base_index = (step - 1) * accum + self._data_offset
        lo = self._rank * self._cfg.trainer.micro_batch_size
        hi = lo + self._cfg.trainer.micro_batch_size
        rows = [dataset.get_examples(sampler.batch_indices(base_index + a)[lo:hi])
                for a in range(accum)]
        return self._to_device({k: np.stack([r[k] for r in rows]) for k in rows[0]})

    def _rank_rows(self, indices: np.ndarray, n_pad: int) -> tuple[np.ndarray, int]:
        """This rank's equal share of a forward-only batch whose last
        ``n_pad`` rows are padding, and the padding rows in the share."""
        per = len(indices) // self._world
        lo, hi = self._rank * per, (self._rank + 1) * per
        return indices[lo:hi], max(0, hi - max(lo, len(indices) - n_pad))

    def _sum_over_ranks(self, *values: torch.Tensor) -> list[float]:
        """Host floats of device scalars, summed over the ranks."""
        stacked = torch.stack([v.float() for v in values])
        if self._dist is not None:
            import torch.distributed as dist

            with collective_errors():
                dist.all_reduce(stacked)
        return [float(v) for v in stacked.cpu()]

    def _eval_batch(self, dataset, indices: np.ndarray, *, n_pad: int = 0) -> dict:
        """(B, T) batch from example indices, always with an attention
        mask; the last ``n_pad`` rows are zero-masked padding."""
        examples = dataset.get_examples(indices)
        if "attention_mask" not in examples:
            examples["attention_mask"] = np.ones_like(examples["input_ids"])
        if n_pad:
            examples["attention_mask"] = examples["attention_mask"].copy()
            examples["attention_mask"][len(indices) - n_pad:] = 0
        return self._to_device(examples)

    # ------------------------------------------------------------------ eval only

    def evaluate(
        self,
        resume_from: str | None = None,
        *,
        use_ema: bool = False,
        quantize: str | None = None,
    ) -> dict[str, float] | None:
        """Eval-only pass (JAX ``Trainer.evaluate``): load ``resume_from``'s
        params (if given) and run the full validation loop once, without
        training. Returns ``{"val/loss": ...}``, or None when the data
        module has no validation split. The step in the log line is the
        checkpoint's (0 for a fresh init).

        Only the params are read (no optimizer state, no topology check: an
        eval makes no trajectory claim), so a checkpoint either package
        wrote evaluates. ``quantize="int8"`` evaluates a copy of the model
        under weight-only int8 (ops/quant.py), the serving path's weights,
        so ``val/loss`` is the quality cost of quantized decode; the
        trainer's own model keeps its weights. ``use_ema`` evaluates a copy
        carrying the EMA shadow (``trainer.extra.ema_decay``): the
        checkpoint's, or with no checkpoint the live optimizer's; it
        composes with ``quantize`` (the shadow is quantized)."""
        import copy

        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize mode: {quantize!r}")
        step = 0
        shadow: dict[str, torch.Tensor] | None = None
        if resume_from is not None:
            path = resolve_resume_path(resume_from, self._cfg.output.root_dir)
            payload = CheckpointManager.load(path)
            warn_on_config_mismatch(
                payload, yaml.safe_dump(self._cfg.model_dump(), sort_keys=False), path
            )
            self._model.load_state_dict(flax_params_to_state_dict(payload["params"]),
                                        strict=True)
            if use_ema:
                if find_ema_tree(payload["opt_state"]) is None:
                    raise ValueError(_NO_EMA)
                shadow = ema_from_payload(payload, self._model)
            step = int(payload["step"])
            self._state.step = step
            logger.info("evaluating checkpoint %s (step %d)", path, step)
        elif use_ema:
            ema = self._state.optimizer.ema
            if ema is None:
                raise ValueError(_NO_EMA)
            shadow = {n: e.to(p.dtype) for n, e, p in zip(
                self._state.optimizer.names, ema, self._state.optimizer.params)}
        eval_fn = self._eval_step_fn
        model = self._model
        if shadow is not None:
            model = copy.deepcopy(self._model)
            model.load_state_dict(shadow, strict=False)
            eval_fn = make_eval_step(self._adapter, model)
        if quantize == "int8":
            from ..ops.quant import quantize_model

            if not hasattr(self._model, "n_heads"):
                raise ValueError("--quantize int8 evaluates the gpt model only")
            if model is self._model:
                model = copy.deepcopy(self._model)
            stats = quantize_model(model)
            logger.info(
                "int8 weight quantization: %d/%d params quantized, %.2fx weight-byte compression",
                stats["quantized_params"], stats["total_params"], stats["compression"],
            )
            eval_fn = make_eval_step(self._adapter, model)
        return self._evaluate(step, step, eval_fn)

    # ------------------------------------------------------------------ fit

    def fit(
        self, max_steps_override: int | None = None, resume_from: str | None = None
    ) -> TrainResult:
        cfg = self._cfg
        max_steps = max_steps_override or cfg.trainer.max_steps
        accum = cfg.trainer.grad_accum_steps
        log_every = cfg.trainer.log_every_steps
        eval_every = cfg.trainer.eval_every_steps
        save_every = cfg.trainer.save_every_steps

        train_ds = self._data_module.train_dataset()
        sampler = DeterministicSampler(
            num_examples=len(train_ds),
            batch_size=self._global_micro,
            seed=cfg.run.seed,
            shuffle=not cfg.run.deterministic,
        )
        self._sampler = sampler

        res_cfg = self._resilience
        multi_process = self._world > 1
        self._spike_detector = (
            LossSpikeDetector(factor=res_cfg.spike_factor, beta=res_cfg.spike_ewma_beta,
                              min_history=res_cfg.spike_min_history)
            if res_cfg.spike_detection else None
        )
        if self._spike_detector is not None and multi_process:
            # The rollback restores the SAME file on every rank (consensus
            # in _maybe_rollback): a rank without the run dir would desync
            # the first collective of a spike. The flag is gathered so
            # every rank raises together instead of leaving the others
            # waiting in a collective.
            if allgather_any(self._ckpt_mgr is None):
                raise ValueError(
                    "multi-process spike rollback requires every rank to "
                    "see the shared run directory (checkpoints volume); "
                    "construct the Trainer with the run-dir path on all "
                    "ranks or disable resilience.spike_detection"
                )
        self._rollback_count = 0
        self._data_offset = 0
        self._resume_count = 0

        # Hang watchdog + heartbeat + straggler telemetry
        # (resilience/watchdog.py): the beacon records progress at each
        # dispatched step; the watchdog exits 76 when nothing lands within
        # the stall timeout.
        wd_cfg = res_cfg.watchdog
        self._beacon = None
        watchdog: HangWatchdog | None = None
        if wd_cfg.enabled:
            hb_path = wd_cfg.heartbeat_path
            if hb_path is None and self._run_dir is not None:
                # The run dir is shared between ranks: past rank 0 each
                # gets its own file, so a healthy rank cannot mask a hung
                # one from an outside freshness check.
                name = "heartbeat" if self._is_main else f"heartbeat.r{self._rank}"
                hb_path = str(Path(self._run_dir) / name)
            self._beacon = ProgressBeacon(
                hb_path, heartbeat_interval_sec=wd_cfg.heartbeat_interval_sec
            )
            import tempfile

            report_dir = (Path(self._run_dir) if self._run_dir is not None
                          else Path(tempfile.gettempdir()))
            watchdog = HangWatchdog(
                self._beacon,
                stall_timeout_sec=wd_cfg.stall_timeout_sec,
                poll_interval_sec=wd_cfg.poll_interval_sec,
                report_dir=report_dir,
                process_index=self._rank,
                on_hang=self._on_watchdog_hang,
                timeline=self._telemetry.timeline,
            )
        self._straggler = (
            StragglerTracker(skew_factor=wd_cfg.straggler_skew_factor,
                             patience=wd_cfg.straggler_patience)
            if multi_process and wd_cfg.straggler_telemetry else None
        )

        resumed_from_step: int | None = None
        if resume_from is not None:
            # The fit path owns the identical-trajectory contract: the
            # manifest's topology is checked (elastic over the data axis,
            # TopologyMismatchError otherwise), and the rollback and sampler
            # bookkeeping and the detector's trend continue where the
            # checkpointed run left them.
            resumed_from_step = self._restore(resume_from, validate_topology=True)
            resil = self._last_restored_resilience
            self._rollback_count = int(resil.get("rollback_count", 0))
            manifest_data = (self._last_restored_manifest or {}).get("data") or {}
            if "consumed_micro_batches" in manifest_data:
                # The manifest's global-batch progress is the stream
                # position on any world size.
                self._data_offset = resume_batch_index(
                    manifest_data, step=resumed_from_step, grad_accum_steps=accum
                ) - resumed_from_step * accum
            else:
                self._data_offset = int(resil.get("data_offset", 0))
            self._resume_count = int(resil.get("resume_count", 0)) + 1
            self._telemetry.metrics.inc("resilience/resumes")
            self._telemetry.metrics.publish(
                {"resilience/resume_count": float(self._resume_count)}, step=resumed_from_step
            )
            if self._spike_detector is not None:
                self._spike_detector.load_state(resil)
        start_step = (resumed_from_step or 0) + 1
        if start_step > max_steps:
            logger.warning(
                "resume step %d >= max_steps %d; no training steps will run",
                start_step - 1, max_steps,
            )

        self._train_seqlen = self._dataset_spec(train_ds)[1]
        tokens_per_step = accum * self._global_micro * self._train_seqlen
        self._tokens_per_step = tokens_per_step
        if self._device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self._device)
        tl = self._telemetry.timeline
        # Fired fault injections land on the event timeline, so a drill is
        # auditable from the trace alone.
        self._faults.observer = lambda kind, at_step: (
            tl.instant(f"fault_{kind}", cat="fault", step=at_step),
            self._telemetry.metrics.inc("faults/injected"),
        )
        self._telemetry.start()
        opt_mem = self._opt_state_memory()
        self._telemetry.record_opt_state_bytes(opt_mem)
        logger.info(
            "optimizer state: %.1f MiB total, %.1f MiB on device 0, %.1f MiB host-resident",
            opt_mem["opt_state_bytes"] / 2**20,
            opt_mem["opt_state_bytes_per_device"] / 2**20,
            opt_mem["opt_state_bytes_host"] / 2**20,
        )
        self._telemetry.metrics.safe_log_params(cfg.model_dump())

        first_step_loss: float | None = None
        final_val_loss: float | None = None
        final_val_metrics: dict[str, float] | None = None
        step_loss_dev = None
        past_end_loss: float | None = None
        total_tokens = (start_step - 1) * tokens_per_step
        interval_losses: list[torch.Tensor] = []
        interval_shard: list[tuple[torch.Tensor, torch.Tensor]] = []
        interval_tokens = 0
        interval_data_wait = 0.0
        interval_dispatch = 0.0
        nonfinite = None
        interval_start = time.perf_counter()
        interval_wait_start = collective_wait_seconds()
        start_time = time.perf_counter()

        # Preemption: SIGTERM only latches a flag; after the step it lands
        # in (one process) or at the next log boundary, where the ranks OR
        # their flags (several), the loop saves a checkpoint at that step
        # and returns cleanly, so --auto-resume continues where the evicted
        # run stopped. Acting on a local flag alone would leave the other
        # ranks waiting in the next step's all-reduce.
        preempted = False
        # Distinct sentinel, not `old_term is None`: signal.signal() returns
        # None when the previous handler was installed by C code.
        handler_installed = False
        old_term = None

        def _on_sigterm(signum, frame):
            nonlocal preempted
            preempted = True

        if threading.current_thread() is threading.main_thread():
            old_term = signal.signal(signal.SIGTERM, _on_sigterm)
            handler_installed = True
        else:
            logger.warning(
                "Trainer.fit is running off the main thread: SIGTERM "
                "preemption handling is DISABLED for this run (no "
                "checkpoint-on-eviction; the process default handler "
                "applies)"
            )
        final_step_override: int | None = None
        loop_completed = False
        profiler = _StepProfiler(cfg, self._run_dir, process_index=self._rank,
                                 num_processes=self._world, timeline=tl)

        prefetcher: BatchPrefetcher | None = None
        if cfg.trainer.prefetch_depth > 0 and start_step <= max_steps:
            prefetcher = BatchPrefetcher(
                lambda s: self.global_batch(sampler, train_ds, s),
                depth=cfg.trainer.prefetch_depth,
                start_step=start_step,
                before_assemble=lambda s: self._faults.maybe_hang(s, site="prefetcher"),
                timeline=tl,
            )
        try:
            if start_step > max_steps and resumed_from_step:
                past_end_loss = self._restored_step_loss(sampler, train_ds, resumed_from_step)
            step = start_step - 1
            while step < max_steps:
                step += 1
                profiler.maybe_start(step)
                t_fetch = time.perf_counter()
                if prefetcher is not None:
                    batch = prefetcher.get(step)
                else:
                    batch = self.global_batch(sampler, train_ds, step)
                t_dispatch = time.perf_counter()
                if self._batch_struct is None:
                    self._batch_struct = {k: (tuple(v.shape), v.dtype)
                                          for k, v in batch.items()}
                with self._telemetry.step_annotation(step):
                    metrics = self._train_step_fn(self._state, batch, self._rollback_count)
                t_done = time.perf_counter()
                interval_data_wait += t_dispatch - t_fetch
                interval_dispatch += t_done - t_dispatch
                # The same clock reads feed the interval sums and the
                # timeline, so the spans and train/data_wait_ms agree.
                tl.record("data_wait", cat="data", step=step, t0=t_fetch, t1=t_dispatch)
                tl.record("host_dispatch", step=step, t0=t_dispatch, t1=t_done)
                profiler.maybe_stop(step, sync=metrics["loss"])
                if self._beacon is not None:
                    # Progress = the step DISPATCHED. A hung card holds the
                    # host back within a step or two (the allocator, the
                    # log boundary's sync), so dispatch is a faithful
                    # liveness signal. The watchdog arms after the first
                    # dispatched step, so the kernels' first-use builds and
                    # Triton compiles never count against the timeout.
                    self._beacon.touch(step)
                    if watchdog is not None:
                        watchdog.arm()  # no-op once armed
                # Injected preemption goes through the real OS signal path;
                # an injected crash is a SIGKILL (nothing below runs); an
                # injected hang BLOCKS here for real.
                self._faults.maybe_sigterm(step)
                self._faults.maybe_kill(step)
                self._faults.maybe_hang(step)

                step_loss_dev = metrics["loss"]
                nonfinite = metrics.get("nonfinite_count")
                interval_losses.append(metrics["loss"])
                if multi_process:
                    interval_shard.append((metrics["per_example_loss_sum"],
                                           metrics["per_example_tokens"]))
                interval_tokens += tokens_per_step
                total_tokens += tokens_per_step
                if step == 1:
                    first_step_loss = float(metrics["loss"])

                if multi_process and step % log_every == 0:
                    stop_now = allgather_any(preempted)
                else:
                    stop_now = preempted and not multi_process
                # A signal during the very last step changes nothing: the
                # run completes and reports an un-preempted result.
                stop_now = stop_now and step < max_steps
                if step % save_every == 0 or step == max_steps or stop_now:
                    self._save_checkpoint(step)
                    # Only the writing rank damages the file.
                    self._faults.maybe_corrupt_checkpoint(
                        step, self._ckpt_mgr if self._is_main else None
                    )
                if stop_now:
                    tl.instant("preempted", cat="resilience", step=step,
                               checkpointed=self._ckpt_mgr is not None)
                    # Flush now: the grace period may end in SIGKILL before
                    # the unwind, and the goodput ledger reads these events.
                    tl.flush()
                    if self._ckpt_mgr is not None and self._is_main:
                        logger.warning(
                            "SIGTERM received: preemption checkpoint saved at step %d; "
                            "stopping cleanly (resume with --resume)", step,
                        )
                    elif self._ckpt_mgr is not None:
                        logger.warning(
                            "SIGTERM received: stopping cleanly at step %d (preemption "
                            "checkpoint written by the main rank)", step,
                        )
                    else:
                        logger.warning(
                            "SIGTERM received: stopping cleanly at step %d WITHOUT a "
                            "checkpoint (no run dir / checkpoint manager on this process)",
                            step,
                        )
                    final_step_override = step
                    break

                if step % log_every == 0 or step == max_steps:
                    # Sync on the interval's losses before stamping the end
                    # time, so queued device work is charged to the interval.
                    t_sync = time.perf_counter()
                    with tl.span("interval_sync", step=step):
                        losses_host = torch.stack(interval_losses).float().cpu().numpy()
                    t_synced = time.perf_counter()
                    first_interval_step = step - len(interval_losses) + 1
                    losses_host = self._faults.poison_host_losses(losses_host,
                                                                  first_interval_step)
                    self._check_nonfinite_guard(nonfinite, losses_host, step)
                    rolled_back_to = self._maybe_rollback(losses_host, first_interval_step,
                                                          step)
                    if rolled_back_to is not None:
                        # The replayed window's events are tagged, not
                        # dropped, and the rollback is an instant; both
                        # land before the next flush.
                        tl.tag_rollback(rolled_back_to + 1, step)
                        tl.instant("rollback", cat="resilience", step=step,
                                   restored_step=rolled_back_to,
                                   rollback_count=self._rollback_count)
                        self._telemetry.metrics.inc("resilience/rollbacks")
                        # Replay from the restored step with the sampler
                        # advanced past the bad window and fresh dropout
                        # streams; the token odometer rewinds to what a
                        # resume from the restored step would report.
                        total_tokens -= (step - rolled_back_to) * tokens_per_step
                        interval_losses = []
                        interval_shard = []
                        interval_tokens = 0
                        interval_data_wait = 0.0
                        interval_dispatch = 0.0
                        interval_start = time.perf_counter()
                        interval_wait_start = collective_wait_seconds()
                        step_loss_dev = None
                        nonfinite = None
                        step = rolled_back_to
                        if prefetcher is not None:
                            # Everything queued was built under the old
                            # offset: restart the producer at the first
                            # replayed step under the advanced one.
                            prefetcher.reseek(step + 1)
                        continue
                    interval_time = time.perf_counter() - interval_start
                    if prefetcher is not None:
                        self._telemetry.metrics.publish(
                            {"data/prefetch_queue_depth": float(prefetcher.queue_depth)}, step
                        )
                    self._log_train_interval(
                        step=step,
                        max_steps=max_steps,
                        losses_host=losses_host,
                        interval_shard=interval_shard,
                        interval_tokens=interval_tokens,
                        interval_time=interval_time,
                        total_tokens=total_tokens,
                        interval_data_wait=interval_data_wait,
                        interval_dispatch=interval_dispatch,
                        interval_wait=(t_synced - t_sync + collective_wait_seconds()
                                       - interval_wait_start),
                    )
                    interval_losses = []
                    interval_shard = []
                    interval_tokens = 0
                    interval_data_wait = 0.0
                    interval_dispatch = 0.0
                    interval_start = time.perf_counter()
                    interval_wait_start = collective_wait_seconds()

                if step % eval_every == 0 or step == max_steps:
                    with tl.span("eval", cat="eval", step=step):
                        val_metrics = self._evaluate(step, max_steps)
                    if val_metrics:
                        final_val_metrics = val_metrics
                        final_val_loss = val_metrics.get("val/loss", final_val_loss)
            loop_completed = True
        finally:
            if prefetcher is not None:
                prefetcher.close()
            self._faults.observer = None
            # Transport teardown only (endpoint + a timeline flush so crash
            # evidence persists); the report runs after the result is known.
            self._telemetry.close()
            if watchdog is not None:
                watchdog.disarm()
            if handler_installed:
                # SIG_DFL where the previous handler came from C code: it
                # cannot be re-installed, and SIGTERM must stay lethal.
                signal.signal(signal.SIGTERM,
                              old_term if old_term is not None else signal.SIG_DFL)
            profiler.close(sync=step_loss_dev)
            if self._ckpt_mgr is not None:
                # The final save must be durable; while an exception
                # unwinds, a write failure is logged instead of masking it,
                # and the drain is bounded.
                if loop_completed:
                    self._ckpt_mgr.close()
                else:
                    try:
                        self._ckpt_mgr.close(timeout=_ABORT_DRAIN_TIMEOUT_SEC)
                    except Exception as ckpt_exc:  # noqa: BLE001
                        logger.error("async checkpoint write failed during unwind: %s",
                                     ckpt_exc)
        total_time = time.perf_counter() - start_time
        final_loss = float(step_loss_dev) if step_loss_dev is not None else 0.0
        final_step = final_step_override or max_steps
        if start_step > max_steps:
            final_step = resumed_from_step or 0
            if past_end_loss is not None:
                final_loss = past_end_loss
        result = TrainResult(
            final_step=final_step,
            final_loss=final_loss,
            final_val_loss=final_val_loss,
            total_time=total_time,
            peak_memory=peak_memory_bytes(self._device),
            val_metrics=final_val_metrics,
            first_step_loss=first_step_loss,
            resumed_from_step=resumed_from_step,
            parameter_count=self._param_count,
            trainable_parameter_count=self._trainable_count,
            total_tokens=total_tokens,
            preempted=final_step_override is not None,
            rollbacks=self._rollback_count,
        )
        # End-of-run telemetry: report.json/report.md + the Perfetto trace,
        # then their registration with the tracker. Best-effort.
        try:
            perf_attribution = self._build_perf_attribution(
                steps=max(0, final_step - start_step + 1)
            )
            self._telemetry.finalize(
                train_result=asdict(result),
                run_id=self._run_dir.name if self._run_dir is not None else None,
                perf_attribution=perf_attribution,
                precision=self._precision_block(),
            )
            self._telemetry.register_artifacts()
        except Exception as exc:  # noqa: BLE001 — reporting must not fail the run
            logger.warning("telemetry finalize failed: %s", exc)
        return result

    def _precision_block(self) -> dict[str, Any]:
        """Numerics provenance for report.json: the values the model was
        built with (after the loss's auto-selection), read off the model."""
        return {
            "dtype": str(self._cfg.model.dtype),
            "param_dtype": str(self._cfg.model.param_dtype),
            "loss_impl": getattr(self._model, "loss_impl", "dense"),
            "matmul_precision": getattr(self._model, "matmul_precision", "f32"),
        }

    def train_step_profile(self, *, peaks: dict[str, float], full: bool = False,
                           top_k: int = 10) -> dict[str, Any] | None:
        """The cost count of one train step at the batch shapes the fit ran
        (telemetry/profiling.py): the step runs on a ``meta`` copy of the
        model and of the optimizer, so nothing executes, no device memory
        is allocated, and the live parameters, optimizer and generators
        are untouched. Before any step ran, the batch is the one the
        training set would give. It is counted on this rank's rows without
        the gradient all-reduce (its bytes are estimated beside it) and
        without the non-finite guard. ``full`` adds the per-op
        table and the roofline class. None on any failure."""
        from ..telemetry import profiling

        try:
            struct = self._batch_struct or self._planned_batch_struct()
            model = profiling.meta_module(self._model)
            optimizer = build_model_optimizer(self._cfg, model)
            step_fn = make_train_step(
                self._adapter, model,
                grad_accum_steps=self._cfg.trainer.grad_accum_steps,
                use_dropout=self._cfg.model.dropout > 0.0,
                seed=self._cfg.run.seed,
                rank=self._rank,
            )
            state = TrainState(step=self._state.step, model=model, optimizer=optimizer)
            batch = {k: torch.empty(shape, dtype=dtype, device="meta")
                     for k, (shape, dtype) in struct.items()}
        except Exception as exc:  # noqa: BLE001 — attribution must not fail the run
            logger.warning("train step cost count skipped: %s", exc)
            return None
        if full:
            return profiling.count_profile(step_fn, (state, batch), name="train_step",
                                           peaks=peaks,
                                           collective_bytes=self._grad_collective_bytes(),
                                           top_k=top_k)
        return profiling.count_cost_profile(step_fn, (state, batch), name="train_step")

    def _grad_collective_bytes(self) -> float:
        """Estimated gradient all-reduce bytes a step: a ring over the
        ranks of the f32 gradients (JAX's estimate)."""
        from ..telemetry.profiling import gradient_collective_bytes

        return gradient_collective_bytes({"data": self._world},
                                         float(self._trainable_count) * 4.0)

    def _planned_batch_struct(self) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """Shapes and dtypes of this rank's (A, B, T) batch, from one
        training example."""
        probe = self._data_module.train_dataset().get_examples(np.asarray([0]))
        lead = (self._cfg.trainer.grad_accum_steps, self._cfg.trainer.micro_batch_size)
        return {k: (lead + tuple(v.shape[1:]), torch.from_numpy(np.ascontiguousarray(v)).dtype)
                for k, v in probe.items()}

    def palm_flops_per_token(self) -> float:
        return transformer_flops_per_token(
            n_params=self._param_count,
            n_layers=self._cfg.model.n_layers,
            seq_len=self._train_seqlen,
            d_model=self._cfg.model.d_model,
            n_trainable_params=self._trainable_count,
        )

    def device_kind(self) -> str:
        """The card's name, or "cpu"."""
        if self._device.type == "cuda":
            return torch.cuda.get_device_name(self._device)
        return "cpu"

    def _build_perf_attribution(self, *, steps: int) -> dict[str, Any] | None:
        """Cost-attribution block for report.json (telemetry/profiling.py):
        the train step's cost count classified on the device roofline and
        reconciled against the measured MFU. Publishes the ``perf/*``
        gauges as a side effect. None when gated off, when no step ran, or
        on any failure."""
        tcfg = self._cfg.telemetry
        if not (tcfg.enabled and tcfg.report and tcfg.perf_attribution):
            return None
        # Without a run dir no report.json is written: the count buys nothing.
        if self._run_dir is None or self._batch_struct is None or steps <= 0:
            return None
        try:
            from ..telemetry import profiling

            peaks = profiling.resolve_peaks(self.device_kind(), tcfg.device_peaks)
            cost = self.train_step_profile(peaks=peaks)
            if cost is None:
                return None
            latest = {k: v[0] for k, v in self._telemetry.metrics.latest().items()}
            step_time_sec = latest.get("train/step_time_sec") or 0.0
            block = profiling.build_perf_attribution(
                executables=[cost],
                peaks=peaks,
                n_chips=self._world,
                step_time_ms=step_time_sec * 1e3 if step_time_sec > 0 else None,
                tokens_per_step=float(self._tokens_per_step) or None,
                palm_flops_per_token=self.palm_flops_per_token(),
                measured_mfu=latest.get("train/mfu"),
                collective_bytes=self._grad_collective_bytes(),
                span_totals=self._telemetry.timeline.span_totals(),
                steps=steps,
            )
            self._telemetry.metrics.publish(profiling.attribution_gauges(block))
            return block
        except Exception as exc:  # noqa: BLE001 — attribution must not fail the run
            logger.warning("perf attribution skipped: %s", exc)
            return None

    def _opt_state_memory(self) -> dict[str, int]:
        """Optimizer-state footprint: its total bytes, the bytes on the
        run's device, and the bytes held elsewhere (the host)."""
        total = on_device = 0
        for t in self._state.optimizer.state_tensors():
            nbytes = t.numel() * t.element_size()
            total += nbytes
            if t.device.type == self._device.type:
                on_device += nbytes
        return {
            "opt_state_bytes": total,
            "opt_state_bytes_per_device": on_device,
            "opt_state_bytes_host": total - on_device,
        }

    def _restored_step_loss(self, sampler: DeterministicSampler, dataset, step: int) -> float:
        """Token-weighted forward loss over the batch of training step
        ``step`` (resume at or past max_steps reports a measured loss)."""
        accum = self._cfg.trainer.grad_accum_steps
        base = (step - 1) * accum
        total_loss = total_tok = 0.0
        for a in range(accum):
            rows, _ = self._rank_rows(sampler.batch_indices(base + a), 0)
            loss_sum, tokens = self._eval_step_fn(self._eval_batch(dataset, rows))
            part_loss, part_tok = self._sum_over_ranks(loss_sum.sum(), tokens.sum())
            total_loss += part_loss
            total_tok += part_tok
        return total_loss / max(total_tok, 1.0)

    # ------------------------------------------------------------------ resilience

    def _check_nonfinite_guard(self, nonfinite: torch.Tensor | None, losses_host: np.ndarray,
                               step: int) -> None:
        """Warn about updates the guard skipped in the interval; abort once
        the consecutive-skip cap is reached. Runs where the losses already
        reached the host: one read of the device counter."""
        if nonfinite is None:
            return
        consecutive = int(nonfinite)
        # Non-finite host losses catch mid-interval skips; the device
        # counter catches finite losses over non-finite gradients.
        skipped = max(int(np.count_nonzero(~np.isfinite(losses_host))),
                      min(consecutive, len(losses_host)))
        if skipped:
            logger.warning(
                "non-finite loss/grads: %d optimizer update(s) skipped by the "
                "guard in the last %d step(s)", skipped, len(losses_host),
            )
            self._telemetry.metrics.inc("resilience/nonfinite_skips", skipped)
            self._telemetry.timeline.instant(
                "nonfinite_skip", cat="resilience", step=step, skipped=skipped
            )
        cap = self._cfg.resilience.max_consecutive_nonfinite
        if consecutive >= cap:
            raise NonFiniteLossError(
                f"aborting at step {step}: {consecutive} consecutive optimizer "
                f"updates were non-finite (cap {cap}) — the run has diverged; "
                "params/opt_state are untouched since the last finite step and "
                "the newest checkpoint remains restorable"
            )

    def _maybe_rollback(self, losses_host: np.ndarray, first_interval_step: int,
                        step: int) -> int | None:
        """Feed the interval's losses to the spike detector; on a spike,
        restore the newest verified checkpoint saved BEFORE the spiking step
        into the live model, optimizer and EMA, and advance the data stream
        past the consumed window (JAX ``_maybe_rollback``). Returns the
        restored step (the loop replays from there), or None."""
        detector = self._spike_detector
        if detector is None:
            return None
        spike_step = None
        spike_loss = trend = None
        for i, value in enumerate(np.asarray(losses_host)):
            if detector.observe(float(value)):
                spike_step = first_interval_step + i
                spike_loss, trend = float(value), detector.trend
                break
        multi_process = self._world > 1
        if multi_process:
            # Consensus: ANY rank's spike rolls back EVERY rank, to before
            # the earliest flagged step.
            views = allgather_scalar(float(spike_step) if spike_step is not None else -1.0)
            flagged = [int(v) for v in views if v >= 0]
            consensus_step = min(flagged) if flagged else None
            if consensus_step is not None and spike_step is None:
                logger.warning(
                    "loss spike at step %d flagged by another rank; joining "
                    "the consensus rollback", consensus_step,
                )
            spike_step = consensus_step
        if spike_step is None:
            return None
        if spike_loss is None:
            # A consensus-joined rank: the spiking loss was another rank's.
            spike_loss = float("nan")
            if trend is None:
                trend = detector.trend if detector.trend is not None else float("nan")
        if multi_process and self._ckpt_mgr is None:
            raise RuntimeError(
                "consensus spike rollback needs a checkpoint manager on "
                "every rank but this rank has none"
            )
        if self._ckpt_mgr is None:
            logger.error(
                "loss spike at step %d (%.4f vs trend %.4f) but no checkpoint "
                "manager on this process; spike rollback disabled for the "
                "rest of the run",
                spike_step, spike_loss, trend or 0.0,
            )
            self._spike_detector = None
            return None
        if self._rollback_count >= self._resilience.max_rollbacks:
            raise RollbackBudgetExceededError(
                f"loss spike at step {spike_step} ({spike_loss:.4f} vs trend "
                f"{trend:.4f}) after exhausting the rollback budget "
                f"({self._resilience.max_rollbacks}) — the run diverges "
                "deterministically; change the config instead of retrying"
            )
        # The target must PREDATE the spike: a save inside the spiking
        # interval is valid by integrity and poisoned by value.
        with self._telemetry.timeline.span("checkpoint_wait", cat="ckpt", step=step):
            self._ckpt_mgr.wait_pending()
        if multi_process:
            # Rank 0 picks (its manager did the writes) and broadcasts the
            # step; every rank restores that file.
            target_step = -1
            if self._is_main:
                picked = self._ckpt_mgr.latest_valid_checkpoint(before_step=spike_step)
                if picked is not None:
                    target_step = int(picked.stem.split("_")[1])
            target_step = broadcast_int_from_main(target_step)
            target = (self._ckpt_mgr.directory / f"step_{target_step:06d}.ckpt"
                      if target_step >= 0 else None)
            if target is not None and not self._is_main:
                # A shared filesystem's attribute cache can lag on other
                # ranks: poll briefly before restoring.
                deadline = time.monotonic() + 60.0
                while not target.is_file() and time.monotonic() < deadline:
                    time.sleep(0.5)
                if not target.is_file():
                    raise RuntimeError(
                        f"rollback target {target} (broadcast by rank 0) "
                        "never became visible on this rank's filesystem "
                        "view — shared runs volume misconfigured?"
                    )
        else:
            target = self._ckpt_mgr.latest_valid_checkpoint(before_step=spike_step)
        if target is None:
            # Early spike, before the first save: train through it.
            logger.warning(
                "loss spike at step %d (%.4f vs trend %.4f) but no verified "
                "checkpoint predates it; continuing without rollback",
                spike_step, spike_loss, trend or 0.0,
            )
            return None
        with self._telemetry.timeline.span("rollback_restore", cat="resilience", step=step):
            restored_step = self._restore(str(target))
        accum = self._cfg.trainer.grad_accum_steps
        # Onto the LIVE offset, not the checkpoint's: a second rollback to a
        # checkpoint older than the first must keep advancing the stream.
        self._data_offset += (step - restored_step) * accum
        self._rollback_count += 1
        logger.warning(
            "loss spike at step %d (%.4f vs trend %.4f): rolled back to "
            "checkpoint step %d (rollback %d/%d); sampler advanced %d "
            "micro-batches past the bad window",
            spike_step, spike_loss, trend or 0.0, restored_step,
            self._rollback_count, self._resilience.max_rollbacks,
            (step - restored_step) * accum,
        )
        return restored_step

    def _on_watchdog_hang(self) -> None:
        """Watchdog pre-exit hook: stamp the hang on the timeline and flush
        it, then drain the checkpoint write within the abort bound. Every
        part is best-effort: the watchdog's bounded fire window wins."""
        try:
            self._telemetry.timeline.instant("hang_detected", cat="resilience")
            self._telemetry.timeline.flush()
        except Exception:  # noqa: BLE001 — the exit must proceed
            pass
        if self._ckpt_mgr is not None:
            self._ckpt_mgr.close(timeout=_ABORT_DRAIN_TIMEOUT_SEC)

    # ------------------------------------------------------------------ checkpoints

    def _current_topology(self) -> dict[str, Any]:
        """This run's topology block, recorded in every manifest and held
        against a resumed checkpoint's (resilience/elastic.py): JAX's
        ``describe_topology`` of a mesh whose data axis spans the
        processes, one device each."""
        world = self._world
        mesh = {k: (world if k == "data" else 1) for k in self._cfg.distributed.mesh.model_dump()}
        return describe_topology(
            mesh,
            data_parallel=world,
            global_micro_batch=self._global_micro,
            micro_batch_size=int(self._cfg.trainer.micro_batch_size),
            grad_accum_steps=int(self._cfg.trainer.grad_accum_steps),
            num_processes=world,
        )

    def _manifest_extra(self, step: int) -> dict[str, Any]:
        consumed = step * self._cfg.trainer.grad_accum_steps + self._data_offset
        data = {
            **self._sampler.progress(consumed),
            "data_offset": int(self._data_offset),
            # The prefetcher's generation: its reseeks, one per rollback.
            "prefetch_depth": int(self._cfg.trainer.prefetch_depth),
            "prefetch_generation": int(self._rollback_count),
        }
        # Segment provenance for the goodput ledger (telemetry/goodput.py):
        # which process lifetime committed this step and when it started.
        # The id is the timeline's durable header count, so manifests and
        # timeline segments agree by construction.
        timeline = self._telemetry.timeline
        resilience = {
            "segment_id": int(timeline.segment_id),
            "process_start_unix_time": round(timeline.origin_unix_time, 3),
            "saved_unix_time": round(time.time(), 3),
        }
        return {"topology": self._current_topology(), "data": data,
                "resilience": resilience}

    def _resilience_payload(self) -> dict[str, Any] | None:
        """The scalars saved beside the state, so the guard's counter, the
        rollback bookkeeping and the detector's trend survive a resume."""
        out: dict[str, Any] = {}
        if self._state.nonfinite_count is not None:
            out["nonfinite_count"] = int(self._state.nonfinite_count)
        if self._rollback_count:
            out["rollback_count"] = self._rollback_count
        if self._data_offset:
            out["data_offset"] = self._data_offset
        if self._resume_count:
            out["resume_count"] = self._resume_count
        if self._spike_detector is not None:
            out.update(self._spike_detector.state())
        return out or None

    def host_state(self) -> dict[str, Any]:
        """Params in the flax layout and the optimizer state: owned host
        copies, which later in-place updates of the live tensors do not
        reach (a checkpoint serialises them on a thread)."""
        m = self._cfg.model
        n_kv = int(m.extra.get("n_kv_heads", 0))
        return {
            "params": state_dict_to_flax_params(
                self._model.state_dict(), n_heads=m.n_heads, n_kv_heads=n_kv
            ),
            "opt_state": opt_state_to_host(self._state.optimizer.state_dict(),
                                           n_heads=m.n_heads, n_kv_heads=n_kv),
        }

    def _save_checkpoint(self, step: int) -> None:
        """Rank 0 gathers the state to the host and queues the write on the
        manager's thread (msgpack, sha-256, fsync and the publish overlap
        the next steps), so ``checkpoint_save`` spans the gather only, as
        in JAX; the commit counter and instant follow the published
        manifest (:func:`_commit_observer`). With several ranks every
        rank then waits at a barrier."""
        with self._telemetry.timeline.span("checkpoint_save", cat="ckpt", step=step):
            if self._ckpt_mgr is not None and self._is_main:
                self._ckpt_mgr.save_host_async(
                    step,
                    self.host_state(),
                    self._cfg.model_dump(),
                    resilience=self._resilience_payload(),
                    manifest_extra=self._manifest_extra(step),
                    inject_kill=self._faults.take_checkpoint_kill(step),
                )
                self._telemetry.metrics.inc("ckpt/saves")
        barrier()

    def _agreed_resume_path(self, resume_spec: str) -> Path:
        """The checkpoint every rank restores: rank 0 resolves the spec and
        broadcasts the step; a rank whose own resolution names another step
        takes rank 0's file in the same directory."""
        root = self._cfg.output.root_dir
        if self._world == 1:
            return resolve_resume_path(resume_spec, root)
        path: Path | None = None
        step = -1
        try:
            path = resolve_resume_path(resume_spec, root)
            match = re.match(r"^step_(\d+)\.ckpt$", path.name)
            step = int(match.group(1)) if match else -1
        except FileNotFoundError:
            if self._is_main:
                step = -2
        agreed = broadcast_int_from_main(step if self._is_main else 0)
        if agreed == -2 or path is None:
            raise FileNotFoundError(f"no checkpoint to resume from for {resume_spec!r}")
        if agreed >= 0 and agreed != step:
            path = path.parent / f"step_{agreed:06d}.ckpt"
        return path

    def _restore(self, resume_spec: str, *, validate_topology: bool = False) -> int:
        """Load a checkpoint into the live model, optimizer (its EMA
        included) and guard counter; returns the restored step, and keeps
        the payload's resilience scalars and the manifest for the caller.
        ``validate_topology`` (the resume path) holds the manifest's
        topology against this run's: a change over the data axis alone is
        an elastic resume (the state is full host arrays, so re-sharding
        is which rows each rank takes), anything else raises
        :class:`TopologyMismatchError`. The spike rollback restores a step
        of this run and checks nothing."""
        path = self._agreed_resume_path(resume_spec)
        manifest = read_manifest(path)
        self._last_restored_manifest = manifest
        if validate_topology:
            verdict = classify_topology_change((manifest or {}).get("topology"),
                                               self._current_topology())
            if manifest is None or manifest.get("synthesized"):
                logger.warning(
                    "checkpoint %s carries no saved topology (pre-manifest "
                    "checkpoint or synthesized manifest): elastic/topology "
                    "validation SKIPPED — if the mesh, micro_batch_size, or "
                    "grad_accum_steps changed since it was saved, the resumed "
                    "trajectory will not continue the saved run's",
                    path.name,
                )
            if verdict["elastic"]:
                changes = ", ".join(verdict["changes"])
                logger.warning(
                    "elastic resume: topology changed (%s) with the global "
                    "micro-batch preserved — re-sharding params/optimizer "
                    "state onto the new mesh; the loss trajectory continues "
                    "the saved run's at matching global steps",
                    changes,
                )
                self._telemetry.timeline.instant("elastic_reshard", cat="resilience",
                                                 changes=changes)
                self._telemetry.metrics.inc("resilience/elastic_reshard")
        payload = CheckpointManager.load(path)
        warn_on_config_mismatch(
            payload, yaml.safe_dump(self._cfg.model_dump(), sort_keys=False), path
        )
        step = int(payload["step"])
        self._model.load_state_dict(flax_params_to_state_dict(payload["params"]), strict=True)
        self._state.optimizer.load_state_dict(opt_state_from_host(payload["opt_state"]))
        self._state.step = step
        resil = payload.get("resilience") or {}
        self._last_restored_resilience = {k: v for k, v in resil.items()}
        if self._state.nonfinite_count is not None:
            self._state.nonfinite_count = torch.tensor(
                int(resil.get("nonfinite_count", 0)), dtype=torch.int32, device=self._device
            )
        logger.info("resumed from %s at step %d", path, step)
        return step

    # ------------------------------------------------------------------ metrics

    def _log_train_interval(
        self,
        *,
        step: int,
        max_steps: int,
        losses_host: np.ndarray,
        interval_shard: list[tuple[torch.Tensor, torch.Tensor]],
        interval_tokens: int,
        interval_time: float,
        total_tokens: int,
        interval_data_wait: float,
        interval_dispatch: float,
        interval_wait: float = 0.0,
    ) -> None:
        """Publish and log one interval's metrics. ``interval_wait``: the
        host seconds of the interval spent waiting on other ranks (inside
        collectives) or on the device (the boundary's sync)."""
        if self._ckpt_mgr is not None:
            # A failed async checkpoint write fails the run within one log
            # interval, not at the next save or at close().
            self._ckpt_mgr.poll()
        steps = len(losses_host)
        avg_loss = float(losses_host.mean())
        avg_step_time = interval_time / steps if steps else 0.0
        tokens_per_sec = interval_tokens / interval_time if interval_time > 0 else 0.0
        data_wait_ms = interval_data_wait / steps * 1e3 if steps else 0.0
        host_dispatch_ms = interval_dispatch / steps * 1e3 if steps else 0.0
        current_lr = self._schedule(step - 1)
        interval_mfu = compute_mfu(
            tokens_per_sec / self._world,  # the tokens are the global batch's
            n_params=self._param_count,
            n_layers=self._cfg.model.n_layers,
            seq_len=self._train_seqlen,
            d_model=self._cfg.model.d_model,
            peak_flops=self._peak_flops,
            n_trainable_params=self._trainable_count,
        )
        # Straggler telemetry (several processes): every rank's mean step
        # time of the interval net of its waits, gathered at the boundary
        # the ranks already meet at, reduced to max/median skew. Net, not
        # wall: every step's all-reduce makes the ranks' wall times equal,
        # the waiting ranks' included, so a slow rank shows only in what
        # it spent outside the waits.
        step_time_skew: float | None = None
        if self._straggler is not None:
            net = max(0.0, interval_time - interval_wait) / steps if steps else 0.0
            per_host = np.asarray(allgather_scalar(net))
            straggle = self._straggler.observe(per_host)
            step_time_skew = straggle["skew"]
            logger.info(
                "stragglers: step_time max=%.4fs median=%.4fs skew=%.2fx (slowest host %d)",
                straggle["max_sec"], straggle["median_sec"], straggle["skew"],
                straggle["slowest_host"],
            )
            if straggle["persistent"]:
                logger.warning(
                    "persistent straggler: host %d has been the slowest with >=%.1fx skew "
                    "for %d consecutive intervals — check that host before it stalls "
                    "the job",
                    straggle["slowest_host"], self._resilience.watchdog.straggler_skew_factor,
                    straggle["streak"],
                )
                self._telemetry.metrics.inc("resilience/straggler_warnings")
                self._telemetry.timeline.instant(
                    "straggler_persistent", cat="resilience", step=step,
                    slowest_host=straggle["slowest_host"], skew=round(straggle["skew"], 3),
                    streak=straggle["streak"],
                )
        # Per-rank losses (several processes): each rank's interval mean of
        # its token-weighted step means, gathered on every rank.
        shard_losses = (self._gather_shard_means(interval_shard)
                        if self._world > 1 else None)
        if self._is_main:
            # Every metric goes through the registry: buffered here, pushed
            # to the tracker by the one flush below, where a failing tracker
            # degrades to a warning, and kept live for Prometheus and the
            # report.
            registry = self._telemetry.metrics
            if shard_losses is not None:
                for r in range(self._world):
                    registry.publish(
                        {
                            f"train/loss_rank_{r}": float(shard_losses[r]),
                            f"train/lr_rank_{r}": current_lr,
                            f"train/tokens_per_sec_rank_{r}": tokens_per_sec / self._world,
                            f"train/step_time_sec_rank_{r}": avg_step_time,
                            f"train/tokens_total_rank_{r}": float(total_tokens / self._world),
                        },
                        step=step,
                    )
            global_metrics = {
                "train/loss": avg_loss,
                "train/lr": current_lr,
                "train/tokens_per_sec": tokens_per_sec,
                "train/step_time_sec": avg_step_time,
                "train/tokens_total": float(total_tokens),
                "train/mfu": interval_mfu,
                "train/data_wait_ms": data_wait_ms,
                "train/host_dispatch_ms": host_dispatch_ms,
            }
            if step_time_skew is not None:
                global_metrics["train/step_time_skew"] = step_time_skew
            registry.publish(global_metrics, step=step)
        # The one flush point per log interval: memory sample, the tracker,
        # the timeline's JSONL and the Prometheus textfile (every rank;
        # only the main one writes files).
        self._telemetry.flush(step)
        peak_mem = peak_memory_bytes(self._device)
        logger.info(
            "step=%d/%d  loss=%.4f  lr=%.6e  tokens_per_sec=%.1f  step_time=%.4fs  "
            "mfu=%.4f  data_wait=%.2fms  host_dispatch=%.2fms  peak_mem=%.2fGiB",
            step, max_steps, avg_loss, current_lr, tokens_per_sec, avg_step_time,
            interval_mfu, data_wait_ms, host_dispatch_ms, peak_mem / 2**30,
        )

    def _gather_shard_means(self, stats: list[tuple[torch.Tensor, torch.Tensor]]) -> list[float]:
        """Every rank's mean over the steps of ``stats`` of its
        token-weighted loss (JAX ``_shard_means``), gathered on every rank."""
        means = [float(ls.sum() / tc.sum().clamp_min(1.0)) for ls, tc in stats]
        return list(allgather_scalar(float(np.mean(means)) if means else 0.0))

    # ------------------------------------------------------------------ eval

    def _evaluate(self, step: int, max_steps: int,
                  eval_fn: Any = None) -> dict[str, float] | None:
        """Token-weighted loss over the whole validation split; the last
        batch is padded with zero-masked rows (exact under the weighting).
        ``eval_fn`` replaces the model's eval step (a quantized copy)."""
        eval_fn = eval_fn or self._eval_step_fn
        val_ds = self._data_module.val_dataset()
        if val_ds is None:
            return None
        n = len(val_ds)
        # JAX's batch: a multiple of the data-parallel degree, padded with
        # zero-masked rows; each rank evaluates its equal share.
        mult = self._world
        eval_bs = min(max(self._global_micro // mult, 1) * mult, -(-n // mult) * mult)
        loss_total = torch.zeros((), dtype=torch.float32, device=self._device)
        tok_total = torch.zeros((), dtype=torch.float32, device=self._device)
        shard_stats: list[tuple[torch.Tensor, torch.Tensor]] = []
        for b in range(math.ceil(n / eval_bs)):
            real = np.arange(b * eval_bs, min((b + 1) * eval_bs, n))
            pad = eval_bs - len(real)
            indices = np.concatenate([real, np.zeros(pad, dtype=np.int64)])
            rows, rows_pad = self._rank_rows(indices, pad)
            loss_sum, tokens = eval_fn(self._eval_batch(val_ds, rows, n_pad=rows_pad))
            loss_total += loss_sum.sum()
            tok_total += tokens.sum()
            if self._world > 1:
                shard_stats.append((loss_sum, tokens))
        total_loss, total_tok = self._sum_over_ranks(loss_total, tok_total)
        val_loss = total_loss / max(total_tok, 1.0)
        metrics = {"val/loss": val_loss}
        shard_losses = self._gather_shard_means(shard_stats) if self._world > 1 else None
        if self._is_main:
            registry = self._telemetry.metrics
            if shard_losses is not None:
                for r in range(self._world):
                    registry.publish({f"val/loss_rank_{r}": float(shard_losses[r])}, step=step)
            registry.publish(metrics, step=step)
        self._telemetry.flush(step)
        parts = "  ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
        logger.info("val_step=%d/%d  %s", step, max_steps, parts)
        return metrics


class _StepProfiler:
    """Optional ``torch.profiler`` trace over a window of training steps
    (JAX ``_StepProfiler`` with ``jax.profiler``):

        trainer:
          extra:
            profile_start_step: 10     # 0/absent = disabled
            profile_num_steps: 3
            profile_all_hosts: false   # several processes: trace every one

    The Chrome trace (``steps_<first>-<last>.pt.trace.json``, CPU and, on
    the card, CUDA activity) lands in ``{run_dir}/logs/profile``; with
    several processes only rank 0 traces, or with ``profile_all_hosts``
    every rank into its own ``host_{i}``. Start and stop are guarded: a
    profiler failure never stops training. The window's edges are logged
    and stamped on the event timeline (``profiler_start`` /
    ``profiler_stop`` instants), so the trace aligns with the run's own
    span record."""

    def __init__(self, cfg: RunConfig, run_dir: Path | None, *, process_index: int = 0,
                 num_processes: int = 1, timeline: Any | None = None) -> None:
        self._start_step = int(cfg.trainer.extra.get("profile_start_step", 0))
        self._num_steps = max(1, int(cfg.trainer.extra.get("profile_num_steps", 3)))
        all_hosts = bool(cfg.trainer.extra.get("profile_all_hosts", False))
        self._dir: Path | None = None
        if run_dir is not None:
            base = Path(run_dir) / "logs" / "profile"
            if num_processes <= 1:
                self._dir = base
            elif all_hosts:
                self._dir = base / f"host_{process_index}"
            elif process_index == 0:
                self._dir = base
        self._cuda = cfg.run.device != "cpu"
        self._timeline = timeline
        self._prof: Any = None
        self._begun_at: int | None = None
        self._last = 0

    @property
    def enabled(self) -> bool:
        return self._start_step > 0 and self._dir is not None

    def maybe_start(self, step: int) -> None:
        # ``>=``: a resumed run whose first step is past the window start
        # still traces, from its first step.
        if (not self.enabled or self._prof is not None or self._begun_at is not None
                or step < self._start_step):
            return
        try:
            from torch.profiler import ProfilerActivity, profile

            self._dir.mkdir(parents=True, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if self._cuda:
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
            self._prof = prof
            logger.info("profiler trace started at step %d -> %s", step, self._dir)
            if self._timeline is not None:
                self._timeline.instant("profiler_start", cat="profile", step=step,
                                       dir=str(self._dir))
        except Exception as exc:  # noqa: BLE001 — profiling must never kill training
            logger.warning("profiler start failed (%s); continuing without trace", exc)
        self._begun_at = step  # one attempt per run

    def maybe_stop(self, step: int, sync: Any = None) -> None:
        if self._prof is None:
            return
        self._last = step
        if step >= self._begun_at + self._num_steps - 1:
            self.close(sync=sync)

    def close(self, sync: Any = None) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        try:
            if isinstance(sync, torch.Tensor) and sync.is_cuda:
                torch.cuda.synchronize(sync.device)  # the window's queued work
            prof.stop()
            path = self._dir / f"steps_{self._begun_at}-{self._last}.pt.trace.json"
            prof.export_chrome_trace(str(path))
            logger.info("profiler trace written to %s", path)
            if self._timeline is not None:
                self._timeline.instant("profiler_stop", cat="profile", dir=str(self._dir))
        except Exception as exc:  # noqa: BLE001
            logger.warning("profiler stop failed (%s)", exc)


__all__ = [
    "NonFiniteLossError",
    "TopologyMismatchError",
    "TrainResult",
    "Trainer",
    "refuse_unported",
]
