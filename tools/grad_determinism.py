#!/usr/bin/env python3
"""Which gradients of the full-width train step change between reruns, on
the card:

    python3 tools/grad_determinism.py [plain|det]

Builds chip_smoke.py's phase 9 model (gpt_pycorpus_tpu at full width,
micro batch 64 x 512) and one training batch, runs the forward and
backward three times from the same parameters and prints, per parameter,
how many gradient elements differ between the reruns; then aten's
embedding backward and the tied lm-head's weight-gradient GEMM alone,
three times each. ``det`` runs everything under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and prints
the warnings it raised. With ``GRADS_OUT`` set, the first rerun's
gradients are saved there, to compare two processes:

    GRADS_OUT=chiprun_out python3 tools/grad_determinism.py plain  # twice
    python3 tools/grad_determinism.py compare chiprun_out
"""

import glob
import os
import sys
import tempfile
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


def compare(directory: str) -> None:
    a, b = (torch.load(f) for f in sorted(glob.glob(f"{directory}/grads_plain_*.pt"))[:2])
    print("[grads] across two processes, differing elements:",
          {n: int((a[n] != b[n]).sum()) for n in a if (a[n] != b[n]).any()})


def main(mode: str) -> None:
    import chip_smoke as cs
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.data.sampler import DeterministicSampler
    from llmtrain_tpu_torch.training.trainer import Trainer

    if mode == "det":
        torch.use_deterministic_algorithms(True, warn_only=True)
    warnings.simplefilter("always")
    cfg, _, _ = load_and_validate_config(cs._smoke_config(Path(tempfile.mkdtemp()), "grads"))
    trainer = Trainer(cfg, None)
    dataset = trainer._data_module.train_dataset()
    sampler = DeterministicSampler(num_examples=len(dataset),
                                   batch_size=cfg.trainer.micro_batch_size, seed=cfg.run.seed)
    micro = {k: v[0] for k, v in trainer.global_batch(sampler, dataset, 1).items()}
    model = trainer.model

    def grads() -> dict[str, torch.Tensor]:
        for p in model.parameters():
            p.grad = None
        loss_sum, tokens = trainer._adapter.compute_loss_components(
            model, micro, generator=None, deterministic=True)
        (loss_sum.sum() / tokens.sum()).backward()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    with warnings.catch_warnings(record=True) as caught:
        runs = [grads() for _ in range(3)]
    print(f"[grads] {mode}: warnings {sorted({str(w.message)[:200] for w in caught})}")
    diff = {n: [int((runs[0][n] != r[n]).sum()) for r in runs[1:]] for n in runs[0]}
    print(f"[grads] {mode}: parameters whose gradient differs between in-process reruns "
          f"(elements): {({n: d for n, d in diff.items() if any(d)})}")
    if os.environ.get("GRADS_OUT"):
        out = Path(os.environ["GRADS_OUT"]) / f"grads_{mode}_{os.getpid()}.pt"
        out.parent.mkdir(parents=True, exist_ok=True)
        torch.save({n: g.cpu() for n, g in runs[0].items()}, out)
    ids = micro["input_ids"]
    weight = model.token_embedding.weight
    gen = torch.Generator(weight.device)
    upstream = torch.randn(ids.shape + (weight.shape[1],), device=weight.device,
                           generator=gen.manual_seed(0))

    def embedding_backward() -> torch.Tensor:
        w = weight.detach().clone().requires_grad_(True)
        F.embedding(ids, w).backward(upstream)
        return w.grad

    emb = [embedding_backward() for _ in range(3)]
    print(f"[grads] {mode}: aten's embedding backward alone, differing elements:",
          [int((emb[0] != x).sum()) for x in emb[1:]])
    h = torch.randn(ids.numel(), weight.shape[1], device=weight.device, dtype=torch.bfloat16,
                    generator=gen.manual_seed(1))
    dlogits = torch.randn(ids.numel(), weight.shape[0], device=weight.device,
                          dtype=torch.bfloat16, generator=gen.manual_seed(2))
    gemm = [dlogits.t() @ h for _ in range(3)]
    print(f"[grads] {mode}: the lm-head weight-gradient GEMM alone (bf16), differing elements:",
          [int((gemm[0] != x).sum()) for x in gemm[1:]])


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "plain"
    if mode == "compare":
        compare(sys.argv[2])
    else:
        main(mode)
