"""Strict, frozen Pydantic configuration tree — the port's own copy.

Copy of ``llmtrain_tpu/config/schemas.py`` so that every preset under
``configs/presets/`` validates to the same values in both packages
(tests/test_torch_config.py holds the two loaders against each other).
Section docstrings still name the JAX package's modules: they describe
what each knob means there, and the sections this port does not yet run
(training, continuous serving, fleet, tuning) are validated but unused.

One divergence: ``run.device`` also accepts ``"cuda"``, and defaults to
it. The port reads ``"tpu"`` (the value the existing presets carry) and
``"cuda"`` alike as "run on the card", and only an explicit ``"cpu"`` as
the CPU (llmtrain_tpu_torch/distributed/__init__.py).
"""

from typing import Any, Literal

from pydantic import BaseModel, ConfigDict, Field, model_validator

try:  # typing.Self is 3.11+; typing_extensions covers the 3.10 floor
    from typing import Self
except ImportError:  # pragma: no cover - exercised on 3.10 runtimes
    from typing_extensions import Self

_STRICT = ConfigDict(extra="forbid", frozen=True, validate_default=True)


class RunSectionConfig(BaseModel):
    """Run-level identity, seeding and device selection."""

    name: str
    seed: int = 1337
    device: Literal["cpu", "tpu", "cuda"] = "cuda"
    deterministic: bool = True
    notes: str | None = None
    # Persistent JAX compilation-cache directory. None = the library
    # default (~/.cache/llmtrain_tpu/jax); the LLMTRAIN_COMPILATION_CACHE
    # env var overrides either (and "off" disables caching entirely) —
    # see llmtrain_tpu.distributed.resolve_compilation_cache_dir. On k8s,
    # point this (or the env var) at a mounted cache volume so
    # podFailurePolicy retries skip the minutes-long recompile.
    compilation_cache_dir: str | None = None

    model_config = _STRICT


class ModelConfig(BaseModel):
    """Architecture hyper-parameters handed to the model adapter.

    Field names and constraints mirror reference schemas.py:24-51 so configs
    translate 1:1; ``dtype``/``param_dtype`` are TPU additions.
    """

    name: str
    init: Literal["random"] = "random"
    block_size: int = Field(256, ge=8)
    d_model: int = Field(384, ge=8)
    n_layers: int = Field(6, ge=1)
    n_heads: int = Field(6, ge=1)
    d_ff: int = Field(1536, ge=8)
    dropout: float = Field(0.1, ge=0.0, lt=1.0)
    tie_embeddings: bool = True
    vocab_size: int | None = None
    dtype: Literal["float32", "bfloat16"] = "float32"
    param_dtype: Literal["float32", "bfloat16"] = "float32"
    remat: bool = False
    attention: Literal["dense", "flash", "ring", "ulysses"] = "dense"
    extra: dict[str, Any] = Field(default_factory=dict)

    model_config = _STRICT

    @model_validator(mode="after")
    def check_model_dimensions(self) -> Self:
        if self.d_model % self.n_heads != 0:
            raise ValueError("d_model must be divisible by n_heads")
        if self.d_ff < self.d_model:
            raise ValueError("d_ff must be greater than or equal to d_model")
        # Strict-validate the per-layer activation-tier spec at config
        # time (unknown tiers, malformed/overlapping/out-of-range ranges,
        # conflict with the deprecated `remat` flag). A backend without a
        # pinned_host memory space is deliberately NOT a config error —
        # offload degrades to full remat at runtime with a warning
        # (models/activation_policy.py).
        spec = self.extra.get("activation_tiers")
        if spec is not None:
            from .activation_tiers import parse_activation_tiers

            if self.remat:
                raise ValueError(
                    "model.remat: true conflicts with model.extra."
                    "activation_tiers; drop model.remat (tiers subsume it)"
                )
            try:
                parse_activation_tiers(str(spec), self.n_layers)
            except ValueError as exc:
                raise ValueError(f"model.extra.activation_tiers: {exc}") from exc
        return self


class DataConfig(BaseModel):
    """Dataset selection, splits, and HuggingFace overrides.

    Mirrors reference schemas.py:54-71 (``num_workers`` kept for config
    compatibility; the JAX input pipeline is synchronous prefetch, not torch
    worker processes).
    """

    name: str
    cache_dir: str = ".cache/datasets"
    num_workers: int = Field(2, ge=0)
    train_split: str = "train"
    val_split: str = "validation"
    dataset_name: str | None = None
    dataset_config: str | None = None
    text_column: str | None = None
    extra: dict[str, Any] = Field(default_factory=dict)

    model_config = _STRICT


class ZeroConfig(BaseModel):
    """ZeRO-style cross-replica optimizer-state sharding
    (parallel/sharding.py:mesh_opt_state_shardings, docs/perf.md "Sharded
    optimizer state").

    With ``enabled`` the AdamW/adafactor state leaves are partitioned
    along the combined data-parallel axes (``data``/``fsdp``/``expert``)
    instead of being replicated on every replica — the weight-update
    sharding of Xu et al. (arXiv:2004.13336). Per-replica optimizer
    memory drops ~N_dp×; the loss trajectory is bitwise-identical to the
    replicated path at the default ``stage`` 1.

    ``stage`` picks how gradients synchronize:

    * ``1`` — gradients keep the parameter layout (XLA's all-reduce, as
      today); only the update compute + state storage shard. Bitwise-
      identical trajectories zero on/off (tests/test_zero.py pins it).
    * ``2`` — gradients are constrained to the sharded layout too, so
      GSPMD emits reduce-scatter and the full gradient tree never
      materializes replicated after accumulation. The global-norm clip
      then reduces shard partials first, which reassociates the float
      sum: trajectories track the replicated path to ~1e-6, not bitwise.

    ``host_offload`` pins the (sharded) optimizer state to host memory
    between steps: on backends with a ``pinned_host`` memory space (TPU)
    via memory-kind shardings, elsewhere via an explicit host round-trip
    around the step — HBM for the state drops to ~0 at the cost of a
    per-step H2D/D2H of the state shard.
    """

    enabled: bool = False
    stage: Literal[1, 2] = 1
    host_offload: bool = False

    model_config = _STRICT

    @model_validator(mode="after")
    def check_offload(self) -> Self:
        if self.host_offload and not self.enabled:
            raise ValueError(
                "trainer.zero.host_offload requires trainer.zero.enabled: "
                "true (the offload pins the ZeRO-sharded state tree)"
            )
        return self


class TrainerConfig(BaseModel):
    """Training-loop pacing, optimizer and logging cadence.

    Mirrors reference schemas.py:74-99 incl. the warmup<=max_steps validator.
    """

    max_steps: int = Field(1000, ge=1)
    micro_batch_size: int = Field(8, ge=1)
    grad_accum_steps: int = Field(4, ge=1)
    lr: float = Field(3e-4, gt=0.0)
    weight_decay: float = Field(0.1, ge=0.0)
    warmup_steps: int = Field(100, ge=0)
    max_grad_norm: float = Field(1.0, gt=0.0)
    log_every_steps: int = Field(10, ge=1)
    eval_every_steps: int = Field(100, ge=1)
    save_every_steps: int = Field(500, ge=1)
    # Batches the async input pipeline assembles ahead of the step loop
    # (data/prefetch.py): host-side gathers + H2D overlap the previous
    # step's device compute. 0 = synchronous assembly (the pre-prefetch
    # path, kept as the escape hatch). Loss trajectories are bitwise
    # identical either way — the prefetcher only changes WHEN batches are
    # built, never what is built (tests/test_prefetch.py).
    prefetch_depth: int = Field(2, ge=0)
    # ZeRO-style optimizer-state sharding over the data-parallel axes
    # (see ZeroConfig above; off by default — replicated state, the
    # pre-zero layout, stays the bit-exact parity baseline).
    zero: ZeroConfig = Field(default_factory=ZeroConfig)
    extra: dict[str, Any] = Field(default_factory=dict)

    model_config = _STRICT

    @model_validator(mode="after")
    def check_steps(self) -> Self:
        if self.warmup_steps > self.max_steps:
            raise ValueError("warmup_steps cannot exceed max_steps")
        return self


class MeshConfig(BaseModel):
    """Named device-mesh axis sizes.

    ``-1`` on exactly one axis means "fill with all remaining devices" (like a
    reshape wildcard). Axis order is the physical iteration order — ``data``
    outermost so data-parallel replicas land on distinct hosts and
    tensor/sequence shards ride ICI.
    """

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    pipeline: int = 1
    expert: int = 1

    model_config = _STRICT

    @model_validator(mode="after")
    def check_axes(self) -> Self:
        sizes = self.axis_sizes()
        wildcards = sum(1 for v in sizes.values() if v == -1)
        if wildcards > 1:
            raise ValueError("at most one mesh axis may be -1 (wildcard)")
        for axis, v in sizes.items():
            if v == 0 or v < -1:
                raise ValueError(f"mesh axis {axis!r} must be a positive int or -1")
        # `pipeline` is only consumed by models that stack their layer dim
        # on the "layers" logical axis (gpt_pipeline); whether the selected
        # model supports it is validated by the Trainer against the
        # adapter's `supports_pipeline` flag — config can't see the model.
        # (`expert` is wired: MoE expert weights shard over it and it carries
        # batch shards for dense compute — parallel/sharding.py.)
        return self

    def axis_sizes(self) -> dict[str, int]:
        return {
            "data": self.data,
            "fsdp": self.fsdp,
            "tensor": self.tensor,
            "sequence": self.sequence,
            "pipeline": self.pipeline,
            "expert": self.expert,
        }


class DistributedConfig(BaseModel):
    """JAX multi-process runtime hints and the device mesh.

    Replaces the reference's ``DDPConfig`` (schemas.py:102-120). The
    rendezvous fields map torch's env contract onto
    ``jax.distributed.initialize``: RANK→process_id, WORLD_SIZE→num_processes,
    MASTER_ADDR/PORT→coordinator. Env vars beat config values, matching
    reference distributed/__init__.py:100-118.
    """

    enabled: bool = False
    backend: Literal["jax"] = "jax"
    timeout_sec: int = Field(1800, ge=1)
    num_processes: int | None = None
    process_id: int | None = None
    coordinator_addr: str | None = None
    coordinator_port: int | None = None
    mesh: MeshConfig = Field(default_factory=MeshConfig)

    model_config = _STRICT


class FaultInjectionConfig(BaseModel):
    """Deterministic fault injection for exercising the recovery paths.

    Every field defaults to "inject nothing" — production configs never set
    these; tests and chaos drills do. Step-indexed faults use 1-based
    optimizer-step numbering, matching the trainer's loop and log lines.
    """

    # Poison loss AND grads with NaN inside the jitted train step for
    # ``nan_loss_steps`` consecutive optimizer steps starting at this one.
    nan_loss_at_step: int | None = Field(None, ge=1)
    nan_loss_steps: int = Field(1, ge=1)
    # Scale the host-observed loss of exactly this step (one-shot, so the
    # replayed step after a rollback is not re-poisoned).
    spike_loss_at_step: int | None = Field(None, ge=1)
    spike_loss_scale: float = Field(100.0, gt=1.0)
    # Deliver SIGTERM to this process right after dispatching this step.
    sigterm_at_step: int | None = Field(None, ge=1)
    # Preemption-named twin of sigterm_at_step: a real SIGTERM delivered
    # to self at EXACTLY this step, driving the clean-preemption save +
    # exit-0 path — the same seeded, in-config treatment kill_at_step
    # gives SIGKILL. The fleet storm schedule (fleet/chaos.py) uses this
    # for step-exact graceful evictions; mutually exclusive with
    # sigterm_at_step (they share the one-shot delivery slot).
    preempt_at_step: int | None = Field(None, ge=1)
    # Hard-kill (SIGKILL — no handler, no cleanup, no checkpoint) this
    # process right after dispatching this step. The crash-shaped failure
    # the atomic commit protocol + chaos harness (resilience/chaos.py)
    # exist for: nothing on the way down gets a chance to tidy up.
    kill_at_step: int | None = Field(None, ge=1)
    # Aim the SIGKILL INSIDE the async checkpoint write instead: the first
    # save at/after kill_at_step (or the first save at all when
    # kill_at_step is unset) dies between its staged files and the
    # manifest publish — the exact window that makes a multi-file
    # checkpoint torn without atomic commits.
    kill_during_checkpoint: bool = False
    # After the checkpoint save at/after this step, damage the newest
    # checkpoint file on disk (one-shot).
    corrupt_checkpoint_at_step: int | None = Field(None, ge=1)
    corrupt_mode: Literal["truncate", "garbage"] = "truncate"
    # Make the first N attempts of these operations raise, to exercise the
    # exponential-backoff retry() wiring.
    dataset_load_failures: int = Field(0, ge=0)
    distributed_init_failures: int = Field(0, ge=0)
    # Block the host step loop FOR REAL right after dispatching this step
    # (one-shot) — the hang-shaped failure the watchdog exists to kill.
    # Without a duration the block is indefinite (the watchdog, or the k8s
    # liveness probe, is what ends it); with one, the loop resumes after —
    # a controllable straggler/GC-pause stand-in.
    hang_at_step: int | None = Field(None, ge=1)
    hang_duration_sec: float | None = Field(None, gt=0.0)
    # Fire the hang inside the background prefetcher's assembly thread
    # instead of the host step loop: the consumer then starves on the
    # queue — the stall signature of a wedged data pipeline, which the
    # watchdog must detect exactly like a host-loop hang. Requires
    # trainer.prefetch_depth >= 1 (with the synchronous fallback there is
    # no prefetcher to hang, so the injection never fires).
    hang_in_prefetcher: bool = False

    model_config = _STRICT

    @model_validator(mode="after")
    def check_preempt_alias(self) -> Self:
        if self.preempt_at_step is not None and self.sigterm_at_step is not None:
            raise ValueError(
                "faults.preempt_at_step and faults.sigterm_at_step are the "
                "same one-shot SIGTERM injection — set exactly one"
            )
        return self


class WatchdogConfig(BaseModel):
    """Hang watchdog + heartbeat + straggler telemetry
    (llmtrain_tpu/resilience/watchdog.py).

    The watchdog hard-exits a stalled run with the retryable
    EXIT_HANG_DETECTED (76) after dumping all-thread stacks and JAX
    diagnostics to ``{run_dir}/hang_report_*.txt`` — a stuck collective
    never raises, so detection has to come from outside the step loop.
    """

    enabled: bool = False
    # No optimizer step dispatched for this long => the run is hung. Budget
    # for the slowest legitimate gap: first-step compile, periodic eval,
    # and checkpoint host-gather all count as "no progress".
    stall_timeout_sec: float = Field(300.0, gt=0.0)
    # Watchdog poll cadence; default None = stall_timeout_sec / 10.
    poll_interval_sec: float | None = Field(None, gt=0.0)
    # Heartbeat file the beacon touches for the k8s livenessProbe exec.
    # None = {run_dir}/heartbeat. Point it at container-local storage
    # (e.g. /tmp/llmtrain-heartbeat) on k8s: the probe must observe THIS
    # pod, not whichever pod last touched a shared volume.
    heartbeat_path: str | None = None
    heartbeat_interval_sec: float = Field(1.0, ge=0.0)
    # Per-host step-time skew telemetry on multi-process runs (allgathered
    # at log boundaries, so it adds no extra device syncs).
    straggler_telemetry: bool = True
    straggler_skew_factor: float = Field(2.0, gt=1.0)
    straggler_patience: int = Field(3, ge=1)

    model_config = _STRICT


class ChaosConfig(BaseModel):
    """Chaos/storm drill gates (resilience/chaos.py, fleet/chaos.py).

    ``min_goodput_frac`` is the configurable goodput floor asserted by the
    single-run chaos drill and per tenant by the fleet storm: the
    productive_train share of total wall-clock (telemetry/goodput.py)
    must not fall below it after all kill/resume cycles. 0.0 (default)
    checks only that the ledger exists and balances.
    """

    min_goodput_frac: float = Field(0.0, ge=0.0, le=1.0)

    model_config = _STRICT


class ResilienceConfig(BaseModel):
    """Fault-tolerance knobs (llmtrain_tpu/resilience/).

    New subsystem over the reference, which has no recovery machinery at
    all (SURVEY §5; PAPER.md §2.4 lists elastic recovery as absent): a
    non-finite guard inside the jitted train step, a loss-spike detector
    with checkpoint auto-rollback, and retry policy for flaky
    initialization. Checkpoint sha-256 integrity sidecars are always on —
    they need no configuration.
    """

    # Mask the optimizer update (optax apply_if_finite style) whenever loss
    # or any gradient is non-finite; the step still advances so the data
    # stream moves past the poisonous batch.
    nonfinite_guard: bool = False
    # Abort the run once this many CONSECUTIVE updates were skipped —
    # persistent NaN means divergence, not a bad batch.
    max_consecutive_nonfinite: int = Field(25, ge=1)
    # Rolling-EWMA loss-spike detector; on a spike, restore the newest
    # verified checkpoint and advance the sampler past the bad window.
    spike_detection: bool = False
    spike_factor: float = Field(4.0, gt=1.0)
    spike_ewma_beta: float = Field(0.9, gt=0.0, lt=1.0)
    spike_min_history: int = Field(20, ge=1)
    max_rollbacks: int = Field(2, ge=0)
    # Exponential-backoff retry for distributed init and dataset loading.
    retry_attempts: int = Field(3, ge=1)
    retry_base_delay: float = Field(0.05, ge=0.0)
    # Hang watchdog + heartbeat + straggler telemetry.
    watchdog: WatchdogConfig = Field(default_factory=WatchdogConfig)
    faults: FaultInjectionConfig = Field(default_factory=FaultInjectionConfig)
    # Chaos-drill gates (goodput floor) — resilience/chaos.py.
    chaos: ChaosConfig = Field(default_factory=ChaosConfig)

    model_config = _STRICT


class TracingConfig(BaseModel):
    """Distributed request tracing (telemetry/tracing.py,
    docs/observability.md "Distributed request tracing").

    Tail-based sampling keeps the hot path near-free: every request
    buffers its spans in memory, but only slow / errored / failed-over /
    forced (``X-Trace: force``) traces flush full-detail ``cat="trace"``
    trees into the timeline for ``llmtrain trace`` to reassemble.
    """

    enabled: bool = True
    # Keep the slowest fraction of requests (top percentile of a sliding
    # latency reservoir): 0.05 = roughly the p95+ tail.
    slow_keep_frac: float = Field(0.05, gt=0.0, le=1.0)
    # Sliding latency reservoir sizing the slow threshold estimate.
    reservoir: int = Field(512, ge=16)
    # Always keep the first N traces per process so a fresh fleet has
    # something to show before the reservoir warms up.
    warmup_keep: int = Field(16, ge=0)
    # Per-request span buffer cap; overflow is counted, not grown.
    max_spans_per_trace: int = Field(256, ge=8)

    model_config = _STRICT


class TelemetryConfig(BaseModel):
    """Unified telemetry subsystem (llmtrain_tpu/telemetry/,
    docs/observability.md): step-event timeline with Perfetto export,
    device/host memory accounting, the metrics registry every component
    publishes through, a Prometheus text endpoint, and the end-of-run
    report.json/report.md.

    Defaults are production-shaped and near-free on the hot path (span
    recording is a dict append; memory sampling runs at log-interval
    cadence only). ``prometheus`` is the one opt-in: it binds a port.
    """

    enabled: bool = True
    # Structured span/instant timeline: {run_dir}/telemetry/timeline.jsonl
    # per flush + Perfetto-loadable trace.json at end of run.
    timeline: bool = True
    # Retained-event cap; overflow drops the oldest already-persisted
    # events (counted in the report, never silent).
    max_events: int = Field(200_000, ge=1000)
    # Wrap steps/spans in jax.profiler Step/TraceAnnotations so an xprof
    # window lines up 1:1 with the framework timeline.
    xprof_annotations: bool = True
    # mem/hbm_used, mem/hbm_peak, mem/host_rss ... sampled per log interval,
    # with a headroom warning when used/limit crosses the threshold.
    memory: bool = True
    hbm_headroom_warn_frac: float = Field(0.92, gt=0.0, le=1.0)
    # Stdlib HTTP /metrics endpoint (main process only; k8s Jobs carry the
    # matching prometheus.io/scrape annotations).
    prometheus: bool = False
    prometheus_host: str = "0.0.0.0"
    prometheus_port: int = Field(9200, ge=0, le=65535)  # 0 = ephemeral
    # node-exporter textfile-collector snapshot, rewritten atomically at
    # every flush: {run_dir}/telemetry/metrics.prom.
    prometheus_textfile: bool = True
    # End-of-run report.json/report.md in the run dir.
    report: bool = True
    # Cost-attribution block (telemetry/profiling.py): XLA cost_analysis
    # totals from the jitted train step, roofline class, MFU
    # reconciliation — a `perf_attribution` block in report.json plus
    # perf/* gauges. Costs one extra trace+lower of the step function at
    # end of fit (no XLA compile, nothing executes).
    perf_attribution: bool = True
    # Roofline peak overrides merged over the built-in DEVICE_PEAKS row
    # for the detected device kind. Keys: peak_flops, hbm_bytes_per_sec,
    # ici_bytes_per_sec (values in FLOP/s and bytes/s).
    device_peaks: dict[str, float] = Field(default_factory=dict)
    # Distributed request tracing with tail-based sampling (serving
    # fleet + promote lifecycle; `llmtrain trace` reads the output).
    tracing: TracingConfig = Field(default_factory=TracingConfig)

    model_config = _STRICT


class OverloadConfig(BaseModel):
    """SLO-aware overload control (serving/overload.py, docs/serving.md
    "Overload and SLOs").

    Bounded deadline-aware admission, priority classes with per-class
    token buckets, load shedding, and brownout with hysteresis. When
    enabled the continuous-batching scheduler rejects fast (HTTP 429 +
    Retry-After) instead of queueing requests to die, and degrades
    predictably under sustained pressure.
    """

    enabled: bool = False
    # Hard cap on the admission queue; submits past it reject with
    # reason=queue_full.
    queue_cap: int = Field(64, ge=1)
    # Deadline applied to requests that carry none (0 = no deadline:
    # such requests are never rejected for deadline reasons).
    default_deadline_ms: float = Field(0.0, ge=0.0)
    # EWMA smoothing for the per-queue-slot wait estimator, plus the
    # prior used before any observation lands.
    ewma_beta: float = Field(0.8, gt=0.0, lt=1.0)
    prior_wait_ms: float = Field(50.0, gt=0.0)
    # Priority classes and their weighted-round-robin dequeue weights.
    # Higher weight = more dequeues per cycle; every class with queued
    # work is visited each cycle, so batch never starves interactive
    # and vice versa.
    classes: dict[str, int] = Field(
        default_factory=lambda: {"interactive": 4, "batch": 1}
    )
    # Class assigned to requests with an unknown/absent priority.
    default_class: str = "interactive"
    # Optional per-class token-bucket admission rate (requests/sec) and
    # burst size. Classes absent from the map are not rate limited.
    class_rate_rps: dict[str, float] = Field(default_factory=dict)
    class_burst: dict[str, float] = Field(default_factory=dict)
    # Per-client token buckets at the HTTP boundary, keyed by the
    # X-Client-Id header (0 = disabled).
    client_rate_rps: float = Field(0.0, ge=0.0)
    client_burst: float = Field(8.0, ge=1.0)
    max_tracked_clients: int = Field(1024, ge=1)
    # Brownout hysteresis: enter after enter_ticks consecutive scheduler
    # steps with predicted queue wait >= high_ms; exit after exit_ticks
    # consecutive steps < low_ms. While active, max_new_tokens is
    # clamped and speculative decoding is disabled to protect TTFT.
    brownout_high_ms: float = Field(500.0, gt=0.0)
    brownout_low_ms: float = Field(100.0, gt=0.0)
    brownout_enter_ticks: int = Field(3, ge=1)
    brownout_exit_ticks: int = Field(3, ge=1)
    brownout_max_new_tokens: int = Field(16, ge=1)

    model_config = _STRICT

    @model_validator(mode="after")
    def check_overload(self) -> Self:
        if not self.classes:
            raise ValueError("serving.overload.classes must be non-empty")
        if any(w < 1 for w in self.classes.values()):
            raise ValueError(
                "serving.overload.classes weights must be >= 1"
            )
        if self.default_class not in self.classes:
            raise ValueError(
                f"serving.overload.default_class {self.default_class!r} "
                f"not in classes {sorted(self.classes)}"
            )
        for field in ("class_rate_rps", "class_burst"):
            unknown = set(getattr(self, field)) - set(self.classes)
            if unknown:
                raise ValueError(
                    f"serving.overload.{field} keys {sorted(unknown)} "
                    f"not in classes {sorted(self.classes)}"
                )
        if any(v <= 0 for v in self.class_rate_rps.values()):
            raise ValueError(
                "serving.overload.class_rate_rps values must be > 0"
            )
        if any(v < 1 for v in self.class_burst.values()):
            raise ValueError(
                "serving.overload.class_burst values must be >= 1"
            )
        if self.brownout_low_ms >= self.brownout_high_ms:
            raise ValueError(
                "serving.overload.brownout_low_ms must be < "
                "brownout_high_ms (hysteresis needs a gap)"
            )
        return self


class RouterConfig(BaseModel):
    """Replica-router knobs (serving/router.py, ``llmtrain serve
    --router``, docs/serving.md "Fleet tier").

    The router places each request on one of N replicas by score:
    ``affinity_weight * matched_prefix_blocks - load`` — prefix-cache-
    aware placement so requests sharing a system prompt land where their
    KV blocks already live. Replicas failing ``fail_threshold``
    consecutive requests are evicted and probed again after
    ``revive_sec``.
    """

    # In-process replicas `--router` spins up when no --backends given.
    replicas: int = Field(2, ge=1)
    # Score weight of one matched prefix block vs one unit of load.
    affinity_weight: float = Field(4.0, ge=0.0)
    # LRU cap on the prefix-hash -> replica affinity index.
    max_affinity_entries: int = Field(4096, ge=1)
    # Consecutive failures before a replica is evicted from rotation.
    fail_threshold: int = Field(3, ge=1)
    # Seconds before an evicted replica gets a revival probe.
    revive_sec: float = Field(10.0, gt=0.0)
    # Timeout for health/stats probes (GET /healthz, /stats) — separate
    # from the per-request timeout so a wedged replica can't stall the
    # router's health sweep.
    probe_timeout_sec: float = Field(10.0, gt=0.0)
    # Failover retry budget: at most this many retries per window across
    # the fleet, so an overloaded fleet is never DDoS'd by its own
    # router. 0 = unlimited.
    retry_budget: int = Field(16, ge=0)
    retry_window_sec: float = Field(10.0, gt=0.0)

    model_config = _STRICT


class ServingConfig(BaseModel):
    """Inference-serving knobs (llmtrain_tpu/serving/, docs/serving.md).

    ``mode`` selects the backend of ``llmtrain serve``/``serve-bench``:
    ``simple`` keeps the original one-decode-at-a-time locked path;
    ``continuous`` runs the paged-KV continuous-batching scheduler —
    N in-flight sequences of different lengths share one jitted decode
    program, with shape buckets bounding the XLA compile count.
    """

    mode: Literal["simple", "continuous"] = "simple"
    # In-flight sequences the batched decode step can hold.
    max_batch_slots: int = Field(8, ge=1)
    # Paged KV cache: positions per block, and the pool size in blocks
    # (0 = derived: 1 null block + max_batch_slots worst-case sequences).
    block_tokens: int = Field(16, ge=1)
    num_blocks: int = Field(0, ge=0)
    # Shape buckets bounding compiles: prompts pad to the smallest
    # prompt_bucket >= their length, the decode batch to the smallest
    # batch_bucket >= the in-flight count. Empty = powers of two up to
    # block_size / max_batch_slots. The engine asserts the compiled
    # program count stays within len(prompt)+len(batch) buckets.
    prompt_buckets: list[int] = Field(default_factory=list)
    batch_buckets: list[int] = Field(default_factory=list)
    # Scheduler policy: 'paged' = continuous batching (throughput);
    # 'speculative' = draft-and-verify decode per request (latency; needs
    # serve --draft-config/--draft-from, occupancy stays 1).
    policy: Literal["paged", "speculative"] = "paged"
    speculative_gamma: int = Field(4, ge=1)
    # Shared-prefix KV reuse: content-addressed read-only prefix blocks
    # with refcounts and copy-on-write at the first divergent token
    # (serving/paged_kv.py).
    prefix_cache: bool = False
    # Chunked prefill: > 0 splits long prompts into chunks of at most
    # this many tokens, interleaved one per scheduler step with decode —
    # long prompts stop blocking in-flight decodes, and the compile
    # budget grows only by the chunk's bucket. 0 = whole-prompt prefill.
    # Incompatible with the speculative policy.
    prefill_chunk: int = Field(0, ge=0)
    # Replica-router tier (`llmtrain serve --router`).
    router: RouterConfig = Field(default_factory=RouterConfig)
    # SLO-aware overload control (admission, priorities, shedding,
    # brownout) for the continuous scheduler.
    overload: OverloadConfig = Field(default_factory=OverloadConfig)
    # Request validation caps (shared by both modes).
    max_new_tokens_cap: int = Field(256, ge=1)
    default_max_new_tokens: int = Field(48, ge=1)
    # Handler threads give up on a queued request after this long.
    request_timeout_sec: float = Field(120.0, gt=0.0)
    # /healthz turns 503 when the scheduler loop's step beacon is older
    # than this (or the thread is dead) — the k8s livenessProbe contract.
    liveness_stale_sec: float = Field(30.0, gt=0.0)

    model_config = _STRICT

    @model_validator(mode="after")
    def check_buckets(self) -> Self:
        for name, buckets in (
            ("prompt_buckets", self.prompt_buckets),
            ("batch_buckets", self.batch_buckets),
        ):
            if any(b < 1 for b in buckets):
                raise ValueError(f"serving.{name} entries must be >= 1")
            if buckets != sorted(buckets):
                raise ValueError(f"serving.{name} must be ascending")
        if self.batch_buckets and self.batch_buckets[-1] != self.max_batch_slots:
            raise ValueError(
                "the largest serving.batch_bucket must equal "
                f"serving.max_batch_slots ({self.max_batch_slots})"
            )
        if self.num_blocks and self.num_blocks < 2:
            raise ValueError("serving.num_blocks must be 0 (derived) or >= 2")
        if self.prefill_chunk and self.policy == "speculative":
            raise ValueError(
                "serving.prefill_chunk requires the paged policy — the "
                "speculative draft loop prefills whole prompts"
            )
        if (
            self.prefill_chunk
            and self.prompt_buckets
            and self.prefill_chunk > self.prompt_buckets[-1]
        ):
            raise ValueError(
                f"serving.prefill_chunk ({self.prefill_chunk}) exceeds the "
                f"largest prompt bucket ({self.prompt_buckets[-1]}) — chunks "
                "must pad into an existing bucket"
            )
        return self


class FleetTenantConfig(BaseModel):
    """One tenant of the multi-tenant fleet supervisor (llmtrain_tpu/fleet/,
    ``llmtrain fleet``, docs/robustness.md "Fleet: many tenants, shared
    capacity").

    A tenant is a full training job derived from the enclosing config:
    ``overrides`` deep-merges into the resolved base (different lr, LoRA
    block, data mix, ...), the supervisor re-roots its output under the
    fleet work dir and launches it as a real ``train --auto-resume``
    subprocess with a stable run id (= the tenant name), so evictions
    resume from the newest commit and ``resilience/resume_count`` keeps
    accumulating across respawns.

    ``min_devices``/``max_devices`` bound the tenant's data-parallel world
    size on the shared pool (``max_devices`` is the quota). The scheduler
    only ever assigns world sizes that divide the tenant's global
    micro-batch (``trainer.micro_batch_size`` after overrides) so every
    resize is an ELASTIC topology change — ``micro_batch_size × dp`` stays
    constant and the trajectory is preserved (resilience/elastic.py).
    """

    name: str
    # Higher priority wins capacity first; ties break by name so the
    # scheduling policy is a deterministic pure function.
    priority: int = 0
    min_devices: int = Field(1, ge=1)
    max_devices: int = Field(1, ge=1)
    overrides: dict[str, Any] = Field(default_factory=dict)

    model_config = _STRICT

    @model_validator(mode="after")
    def check_bounds(self) -> Self:
        if self.max_devices < self.min_devices:
            raise ValueError(
                f"tenant {self.name!r}: max_devices ({self.max_devices}) "
                f"must be >= min_devices ({self.min_devices})"
            )
        if not self.name or "/" in self.name or self.name.startswith("."):
            raise ValueError(
                "tenant names become run ids and directory names; "
                f"{self.name!r} is not a safe path component"
            )
        return self


class FleetConfig(BaseModel):
    """Multi-tenant fleet supervisor over a bounded emulated device pool
    (llmtrain_tpu/fleet/supervisor.py).

    ``pool_devices`` bounds total capacity; the deterministic scheduling
    policy (fleet/policy.py) grants every runnable tenant its
    ``min_devices`` in priority order, suspends (never crashes) what no
    longer fits when the pool shrinks, and grows tenants toward their
    quota with whatever is left. Preemption is graceful-first:
    SIGTERM (clean preemption save) → ``preempt_grace_sec`` deadline →
    SIGKILL, with seeded full-jitter backoff (``retry_rng``) pacing each
    tenant's respawns.
    """

    pool_devices: int = Field(2, ge=1)
    tenants: list[FleetTenantConfig] = Field(default_factory=list)
    # Escalation ladder: how long a SIGTERM'd tenant gets to finish its
    # clean preemption save before the supervisor hard-kills it.
    preempt_grace_sec: float = Field(20.0, gt=0.0)
    # Full-jitter respawn backoff (resilience/faults.py retry semantics):
    # eviction k of a tenant sleeps uniform(0, min(max, base·2^(k-1))).
    respawn_backoff_base_sec: float = Field(0.05, ge=0.0)
    respawn_backoff_max_sec: float = Field(2.0, gt=0.0)
    # Supervisor reconcile cadence.
    tick_sec: float = Field(0.1, gt=0.0)
    # A tenant exceeding this many respawns is failed instead of
    # crash-looping the pool forever.
    max_respawns_per_tenant: int = Field(20, ge=1)
    # Per-segment wall-clock budget; a tenant subprocess exceeding it is
    # killed and the drill invariant machinery reports the wedge.
    segment_timeout_sec: float = Field(600.0, gt=0.0)
    # A running tenant whose watchdog heartbeat file is staler than this
    # is counted unhealthy in the fleet view (llmtrain_fleet_* gauges).
    heartbeat_stale_sec: float = Field(30.0, gt=0.0)

    model_config = _STRICT

    @model_validator(mode="after")
    def check_tenants(self) -> Self:
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"fleet tenant names must be unique, got {names}")
        for t in self.tenants:
            if t.min_devices > self.pool_devices:
                raise ValueError(
                    f"tenant {t.name!r} needs min_devices={t.min_devices} "
                    f"but the pool only has {self.pool_devices} devices — "
                    "it could never be scheduled"
                )
        return self


class MLflowConfig(BaseModel):
    """MLflow tracking options (reference schemas.py:123-136).

    Divergence: ``backend`` selects the tracking implementation —
    ``auto`` (default) uses the MLflow client when the extra is
    importable and falls back to the dependency-free native SQLite store
    (tracking/sqlite.py) otherwise; ``mlflow``/``native`` force one, and
    ``tensorboard`` writes native TensorBoard event files
    (tracking/tensorboard.py, ``tracking_uri`` is the logdir). The
    reference always requires the mlflow package when enabled.
    """

    enabled: bool = True
    tracking_uri: str = "file:./mlruns"
    experiment: str = "llm-train-k8s"
    run_name: str | None = None
    log_models: bool = False
    backend: Literal["auto", "mlflow", "native", "tensorboard"] = "auto"

    model_config = _STRICT


class LoggingConfig(BaseModel):
    """Structured-logging settings (reference schemas.py:139-151, unchanged)."""

    level: Literal["DEBUG", "INFO", "WARNING", "ERROR"] = "INFO"
    json_output: bool = True
    log_to_file: bool = True
    file_name: str = "train.log"

    model_config = _STRICT


class OutputConfig(BaseModel):
    """Run-dir paths and persistence toggles (reference schemas.py:154-166)."""

    root_dir: str = "runs"
    run_id: str | None = None
    save_config_copy: bool = True
    save_meta_json: bool = True

    model_config = _STRICT


class TuneConfig(BaseModel):
    """Mesh-plan auto-tuner knobs (llmtrain_tpu/autotune/, ``llmtrain tune``,
    docs/perf.md "Mesh planning and auto-tuning").

    The tuner enumerates mesh shape × microbatch × remat × zero stage,
    prunes analytically (roofline + predicted HBM, autotune/search.py),
    then probe-fits the survivors as short subprocess runs scored by the
    measured ``perf_attribution`` MFU. Every knob here bounds device
    time, not correctness — the emitted config re-validates through this
    very schema before it is written.
    """

    # Optimizer steps per probe fit (enough for compile + a few measured
    # steps; the first step's compile time is excluded by the metrics).
    probe_steps: int = Field(4, ge=1)
    # Wall-clock cap per probe subprocess; timeouts score as failures.
    probe_timeout_sec: float = Field(120.0, gt=0.0)
    # Total measuring budget: once spent, remaining survivors are skipped
    # (recorded in the tune report, never silently).
    budget_sec: float = Field(600.0, gt=0.0)
    # Survivor cap after analytic pruning; the baseline probe is exempt.
    max_probes: int = Field(4, ge=1)
    # Explicit microbatch grid; empty = {mb/2, mb, 2·mb} around the
    # config's trainer.micro_batch_size.
    microbatch_candidates: list[int] = Field(default_factory=list)
    # Which dimensions to search; a disabled dimension stays pinned at
    # the config's value.
    search_mesh: bool = True
    search_remat: bool = True
    search_zero: bool = True
    # Only propose plans the elastic-resume topology matrix would accept
    # from the current config's topology (resilience/elastic.py) — for
    # re-tuning a run that must resume from its existing checkpoints.
    preserve_topology: bool = False
    # Per-device HBM feasibility limit override (bytes). None = the
    # DEVICE_HBM_BYTES row for the detected device kind.
    hbm_limit_bytes: float | None = Field(None, gt=0.0)
    # Candidate-order shuffle seed; None = run.seed.
    seed: int | None = None

    model_config = _STRICT

    @model_validator(mode="after")
    def check_candidates(self) -> Self:
        if any(m < 1 for m in self.microbatch_candidates):
            raise ValueError("tune.microbatch_candidates entries must be >= 1")
        return self


class PromoteConfig(BaseModel):
    """Promotion-lifecycle knobs (llmtrain_tpu/lifecycle/, ``llmtrain
    promote``, docs/robustness.md "Canary, promote, rollback").

    The controller watches a training run's manifest stream
    (``latest_valid_checkpoint`` polling — durable artifacts only, the
    goodput stance), canaries every new commit on one designated replica,
    scores it over a soak window, then promotes fleet-wide or rolls the
    canary back. All gates are regression DELTAS against the previously
    promoted baseline, so the loop needs no absolute SLO numbers.
    """

    # Manifest-stream poll cadence on the watched run dir.
    poll_sec: float = Field(2.0, gt=0.0)
    # No new commit AND no training heartbeat for this long → the run is
    # presumed finished/dead and promote exits (taxonomy code).
    idle_timeout_sec: float = Field(600.0, gt=0.0)
    # Replica index that receives canary swaps (the rest keep serving
    # the promoted params).
    canary_replica: int = Field(0, ge=0)
    # Live-traffic fraction the router steers to the canary during the
    # soak (A/B split at the placement layer). 0 = synthetic soak probes
    # only, live traffic never touches the canary.
    traffic_split: float = Field(0.0, ge=0.0, le=1.0)
    # Synthetic soak probes the controller sends to the canary replica to
    # populate TTFT / per-token reservoirs before judging.
    soak_requests: int = Field(16, ge=1)
    soak_timeout_sec: float = Field(120.0, gt=0.0)
    soak_seed: int = 0
    # Gate 1 — eval regression: candidate held-out loss may exceed the
    # promoted baseline's by at most this much.
    max_eval_loss_delta: float = Field(0.05, ge=0.0)
    # Gate 2 — SLO regression: canary p95 TTFT / p99 per-token latency
    # may exceed the baseline percentile by at most this factor (2.0 =
    # twice as slow). None disables the bound.
    ttft_p95_slowdown: float | None = Field(2.0, gt=1.0)
    per_token_p99_slowdown: float | None = Field(2.0, gt=1.0)
    # Any soak-window failed/timed-out canary request fails the gate.
    allow_failed_requests: int = Field(0, ge=0)
    # Stop after this many promotions (0 = run until the stream ends).
    max_promotions: int = Field(0, ge=0)

    model_config = _STRICT


class RunConfig(BaseModel):
    """Top-level schema tying every section into one executable run.

    Mirrors reference schemas.py:169-186 with ``ddp`` → ``distributed``.
    """

    schema_version: int = Field(1, ge=1)
    run: RunSectionConfig
    model: ModelConfig
    data: DataConfig
    trainer: TrainerConfig
    distributed: DistributedConfig = Field(default_factory=DistributedConfig)
    resilience: ResilienceConfig = Field(default_factory=ResilienceConfig)
    telemetry: TelemetryConfig = Field(default_factory=TelemetryConfig)
    serving: ServingConfig = Field(default_factory=ServingConfig)
    fleet: FleetConfig = Field(default_factory=FleetConfig)
    mlflow: MLflowConfig = Field(default_factory=MLflowConfig)
    logging: LoggingConfig = Field(default_factory=LoggingConfig)
    output: OutputConfig = Field(default_factory=OutputConfig)
    tune: TuneConfig = Field(default_factory=TuneConfig)
    promote: PromoteConfig = Field(default_factory=PromoteConfig)

    model_config = _STRICT
