#!/usr/bin/env python3
"""Where a remat ladder's peak device memory falls within a training step,
on the card:

    python3 tools/ladder_memory.py

Builds chip_smoke.py's byte cell (configs/presets/gpt_pycorpus_tpu.yaml at
full width and depth, micro batch 64 x 512) under the ladders ``full:*``
and ``offload:0-5,full:6-11`` and runs two steps of the trainer's step
each. In the second, every parameter's gradient accumulation records the
allocator's current and peak bytes (``register_post_accumulate_grad_hook``,
in the backward's order, from the last layer down), beside the bytes held
when the backward starts. It prints, for each ladder, that starting
figure, the step's peak, and the parameter whose accumulation first saw
the peak: the part of the backward that sets it.
"""

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import yaml  # noqa: E402

import chip_smoke as cs  # noqa: E402

LADDERS = (("full", "full:*"), ("offload", "offload:0-5,full:6-11"))


def profile_ladder(tmp: Path, name: str, spec: str, smi: str) -> dict:
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.data.sampler import DeterministicSampler
    from llmtrain_tpu_torch.training.trainer import Trainer

    cfg_path = cs._smoke_config(tmp, f"memory_{name}")
    raw = yaml.safe_load(cfg_path.read_text())
    raw["model"]["extra"]["activation_tiers"] = spec
    cfg_path.write_text(yaml.safe_dump(raw, sort_keys=False))
    cfg, _, _ = load_and_validate_config(cfg_path)
    trainer = Trainer(cfg, None)
    ds = trainer._data_module.train_dataset()
    sampler = DeterministicSampler(len(ds), cfg.trainer.micro_batch_size, cfg.run.seed)
    trainer._train_step_fn(trainer.state, trainer.global_batch(sampler, ds, 1))
    batch = trainer.global_batch(sampler, ds, 2)
    marks: list[tuple[str, int, int]] = []
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: marks.append((n, torch.cuda.memory_allocated(),
                                     torch.cuda.max_memory_allocated())))
        for n, p in trainer.model.named_parameters()]
    held: list[int] = []
    real_backward = torch.Tensor.backward

    def holding(self, *args, **kwargs):
        held.append(torch.cuda.memory_allocated())
        return real_backward(self, *args, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.Tensor.backward = holding
    try:
        t0 = time.perf_counter()
        trainer._train_step_fn(trainer.state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        torch.Tensor.backward = real_backward
        for h in hooks:
            h.remove()
    peak = torch.cuda.max_memory_allocated()
    first_at_peak = next((n for n, _, top in marks if top == peak), "after the backward")
    cs.log(f"[memory] {name} ({spec}) on {smi}: held at the backward's start {held[0]} B; "
           f"step peak {peak} B ({peak / 2**30:.3f} GiB), first reached by the accumulation "
           f"of {first_at_peak!r}; step {wall:.1f} ms")
    for n, now, top in marks[:: max(1, len(marks) // 12)] + marks[-3:]:
        cs.log(f"[memory]   {name}: after {n}: {now} B allocated, peak so far {top} B")
    del trainer
    torch.cuda.empty_cache()
    return dict(held=held[0], peak=peak, first_at_peak=first_at_peak)


def main() -> int:
    t0 = time.perf_counter()
    smi = cs.phase_device(torch)
    cs.phase_build()
    with tempfile.TemporaryDirectory(prefix="ladder_memory_") as tmp:
        rows = {name: profile_ladder(Path(tmp), name, spec, smi) for name, spec in LADDERS}
    full, off = rows["full"], rows["offload"]
    cs.log(f"[memory] full - offload: held at the backward's start "
           f"{full['held'] - off['held']} B, step peak {full['peak'] - off['peak']} B")
    cs.log(f"[call] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
