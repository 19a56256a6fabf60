"""Elastic topology-change classification for checkpoint resume (port of
``llmtrain_tpu/resilience/elastic.py``, dict math only; the port keeps its
own copy).

A run that dies on 8 processes must be able to come back on whatever
capacity the cluster returns — 4, 2, 1 — without changing the training
math (the Varuna/Bamboo elastic-recovery argument, PAPERS.md). In this
framework that contract is checkable up front: checkpoints store FULL
host arrays, the data stream is a pure function of ``(seed, global batch
index)``, and RNG folds from the step alone, so a resume reproduces the
exact trajectory iff

* the **global** micro-batch (``micro_batch_size × data-parallel degree``)
  is unchanged — the sampler's batch contents depend on nothing else;
* ``grad_accum_steps`` is unchanged — it defines how micro-batches group
  into optimizer steps, i.e. the meaning of "step N";
* the model-parallel axes (``tensor``/``sequence``/``pipeline``) are
  unchanged — re-partitioning the contraction dimensions reorders the
  floating-point reductions inside the step, which silently breaks the
  identical-trajectory guarantee the resume claims.

Re-sharding over the BATCH axes (``data``/``fsdp``/``expert``) is the
elastic case. The port's checkpoints hold full host arrays and the port's
mesh is one data axis over the processes, so re-sharding is which rows of
each global batch a rank takes; the sampler offsets recompute from the
manifest-recorded global-batch progress. Everything else aborts with
:class:`TopologyMismatchError` — mapped to exit code 2 (config error) by
``resilience/exit_codes.py``, because retrying the same config replays
the same mismatch.

Deliberately dependency-free (dict math only): the exit-code taxonomy and
the chaos harness import it without the runtime.
"""

from __future__ import annotations

from typing import Any

# Mesh axes whose resize is a pure re-shard of batch-dim data (elastic);
# all other axes re-partition the model math itself.
ELASTIC_AXES = ("data", "fsdp", "expert")
MODEL_AXES = ("tensor", "sequence", "pipeline")


class TopologyMismatchError(RuntimeError):
    """The saved and current topologies cannot produce the same trajectory
    (tensor-parallel degree changed, global batch changed, ...). Exit
    code 2: deterministic config problem, retrying replays it."""


def describe_topology(
    mesh_sizes: dict[str, int],
    *,
    data_parallel: int,
    global_micro_batch: int,
    micro_batch_size: int,
    grad_accum_steps: int,
    num_processes: int = 1,
) -> dict[str, Any]:
    """The topology block a checkpoint manifest records (and resume
    validates against). Plain ints/dicts only — it must survive JSON."""
    return {
        "mesh": {k: int(v) for k, v in mesh_sizes.items()},
        "data_parallel": int(data_parallel),
        "global_micro_batch": int(global_micro_batch),
        "micro_batch_size": int(micro_batch_size),
        "grad_accum_steps": int(grad_accum_steps),
        "num_processes": int(num_processes),
    }


def classify_topology_change(
    saved: dict[str, Any] | None, current: dict[str, Any]
) -> dict[str, Any]:
    """Compare a manifest's topology block against the resuming run's.

    Returns ``{"elastic": bool, "changes": [str, ...]}`` when the resume
    can proceed (``elastic`` means the mesh changed but only over batch
    axes — param/optimizer state re-shards, trajectory is preserved), or
    raises :class:`TopologyMismatchError` with an actionable message when
    it cannot. ``saved=None`` (pre-manifest checkpoint, synthesized
    manifest) validates nothing: the topology is unknown, resume proceeds
    as it always did.
    """
    if not saved:
        return {"elastic": False, "changes": []}
    changes: list[str] = []
    saved_mesh = saved.get("mesh") or {}
    cur_mesh = current.get("mesh") or {}
    for axis in MODEL_AXES:
        was, now = int(saved_mesh.get(axis, 1)), int(cur_mesh.get(axis, 1))
        if was != now:
            raise TopologyMismatchError(
                f"checkpoint was saved with mesh axis {axis!r}={was} but this "
                f"run uses {axis}={now}: re-partitioning the {axis} axis "
                "changes the in-step reduction order, so the resumed "
                "trajectory would silently diverge from the saved run. "
                "Restore on a mesh with the same "
                f"{'/'.join(MODEL_AXES)} degrees (batch axes "
                f"{'/'.join(ELASTIC_AXES)} may change freely)."
            )
    saved_global = saved.get("global_micro_batch")
    cur_global = current.get("global_micro_batch")
    if saved_global is not None and int(saved_global) != int(cur_global):
        raise TopologyMismatchError(
            f"checkpoint was saved with a global micro-batch of "
            f"{int(saved_global)} (micro_batch_size "
            f"{saved.get('micro_batch_size')} x data-parallel "
            f"{saved.get('data_parallel')}) but this run produces "
            f"{int(cur_global)} (micro_batch_size "
            f"{current.get('micro_batch_size')} x data-parallel "
            f"{current.get('data_parallel')}): the deterministic sampler "
            "maps (seed, batch index) -> examples through the GLOBAL batch "
            "size, so changing it re-deals the data stream. To resume on a "
            "different world size, scale trainer.micro_batch_size inversely "
            "so micro_batch_size x data_parallel stays constant."
        )
    saved_accum = saved.get("grad_accum_steps")
    if saved_accum is not None and int(saved_accum) != int(
        current.get("grad_accum_steps")
    ):
        raise TopologyMismatchError(
            f"checkpoint was saved with grad_accum_steps="
            f"{int(saved_accum)} but this run uses "
            f"{int(current.get('grad_accum_steps'))}: accumulation defines "
            "how micro-batches group into optimizer steps, so step numbers "
            "(and the resume point) would mean different data. Keep "
            "grad_accum_steps fixed across resumes."
        )
    for axis in ELASTIC_AXES:
        was, now = int(saved_mesh.get(axis, 1)), int(cur_mesh.get(axis, 1))
        if was != now:
            changes.append(f"{axis}: {was} -> {now}")
    saved_procs = saved.get("num_processes")
    if saved_procs is not None and int(saved_procs) != int(
        current.get("num_processes", 1)
    ):
        changes.append(
            f"processes: {int(saved_procs)} -> {int(current.get('num_processes', 1))}"
        )
    return {"elastic": bool(changes), "changes": changes}


def resume_batch_index(
    saved_data: dict[str, Any] | None, *, step: int, grad_accum_steps: int
) -> int:
    """First global micro-batch index the resumed run consumes, recomputed
    from the manifest's recorded progress.

    The sampler is stateless — batch ``b`` is a function of ``(seed, b)``
    — so "sampler state" is exactly one integer: how many global
    micro-batches the saved run had consumed (its rollback-advanced
    ``data_offset`` included). When the manifest predates that record (or
    was synthesized), the index falls back to pure step math, which is the
    pre-elastic behavior."""
    base = step * grad_accum_steps
    if not saved_data:
        return base
    consumed = saved_data.get("consumed_micro_batches")
    if consumed is None:
        return base
    return int(consumed)


__all__ = [
    "ELASTIC_AXES",
    "MODEL_AXES",
    "TopologyMismatchError",
    "classify_topology_change",
    "describe_topology",
    "resume_batch_index",
]
