#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (llmtrain_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. Device: nvidia-smi name and power limit, torch/CUDA versions; TF32 off.
2. Build: the flash kernel (llmtrain_tpu_torch/csrc/flash_attention_fwd.cu)
   with nvcc for sm_90a; register and shared-memory report from ptxas.
3. Kernel vs plain version on the card, at the serving path's shape and
   around it (f32, GQA, segment mask with padding, sliding window, ragged
   T, head_dim 128). Tolerances: O on live query rows within 2e-2 for
   bf16 inputs (one bf16 rounding of outputs of magnitude ~1) and 1e-4
   for f32 (summation order only); lse (always f32) within 1e-4 on every
   row whose query has a live key.
4. Timing at the path shape (1, 512, 12, 64) bf16 causal: CUDA events over
   100 launches after 10 warm-up launches, inputs left warm in L2 as the
   projection that produces them leaves them; kernel, plain version, and
   scaled_dot_product_attention as a yardstick (never called by the
   port); the bound from the shapes against the H100 SXM peaks.
5. Model: the GPT of configs/presets/gpt_pycorpus_tpu.yaml at full width
   and depth (768 x 12 layers, 12 heads, block 512, byte vocab), seeded
   init, params cast to bf16 as serving does. One T=512 forward through
   the kernel against the same forward through the plain version: logits
   must be finite, (1, 512, 256), and within LOGITS_ATOL (the paths
   differ only in the bf16 rounding of each layer's attention output,
   compounded over 12 residual layers). Controls: the same comparison
   with attention broken on purpose (non-causal, output zeroed, only the
   last 64 keys) must exceed LOGITS_ATOL, or the limit could not tell a
   broken kernel from a right one and the phase fails.
6. Serve: the port's simple-mode HTTP server (make_server/ServerState, as
   `serve` builds it) on 127.0.0.1:0: greedy 32+32 and sampled 32+32
   (temperature 0.8, top_k 40, seed) on the KV-cache branch, no kernel
   launch; greedy 400+160, which exceeds block_size and gets the JAX
   server's 400; and a malformed body (400).
7. Generate: generation.generate(), which the `generate` CLI and the
   server call, greedy 400+160 (total 560 > 512): the re-forward branch,
   >= 12 x 160 kernel launches. Kernel launch counts are reset just
   before phase 6 and read just after phase 7: that is the main path.
8. Profile: torch.profiler over one more greedy 400+160 generate() (warm
   from phase 7): wall time, device kernel time and busy share, kernel
   launches per token, top kernels by device time. Measurement only; the
   profiler's own overhead inflates the wall.

Then it prints the kernels line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

H100_HBM_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PATH_SHAPE = (1, 512, 12, 12, 64)  # B, T, H, Hkv, D at the serving path
ATOL_O = {"bfloat16": 2e-2, "float32": 1e-4}
ATOL_LSE = 1e-4
LOGITS_ATOL = 0.1


def log(*parts: object) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device(torch) -> str:
    smi = nvidia_smi_line()
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from llmtrain_tpu_torch.ops.kernel_build import CSRC_DIR, build_library

    r = build_library(CSRC_DIR / "flash_attention_fwd.cu")
    log(f"[build] {r.source.name}: nvcc {r.seconds:.2f}s -> {r.library.name}")
    for line in r.ptxas_report.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def _qkv(torch, gen, b, t, h, hkv, d, dtype):
    def rnd(heads):
        return torch.randn(b, t, heads, d, device="cuda", generator=gen).to(dtype)

    return rnd(h), rnd(hkv), rnd(hkv)


def phase_kernel_checks(torch) -> float:
    from llmtrain_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("path shape", PATH_SHAPE, torch.bfloat16, None, 0),
        ("f32", (2, 384, 12, 12, 64), torch.float32, None, 0),
        ("gqa 12q/4kv", (2, 256, 12, 4, 64), torch.float32, None, 0),
        ("segments+padding", (2, 256, 12, 12, 64), torch.float32, "segments", 0),
        ("window 128", (2, 512, 12, 12, 64), torch.bfloat16, None, 128),
        ("ragged T=200", (1, 200, 12, 12, 64), torch.float32, None, 0),
        ("head_dim 128", (2, 256, 8, 8, 128), torch.bfloat16, None, 0),
    ]
    path_err = None
    for name, (b, t, h, hkv, d), dtype, mask_kind, window in cases:
        q, k, v = _qkv(torch, gen, b, t, h, hkv, d, dtype)
        mask = None
        if mask_kind == "segments":
            mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
            mask[:, t // 3 :] = 2  # a second document
            mask[0, t - 37 :] = 0  # padding
        out, lse = flash_attention_fwd(q, k, v, mask, causal=True, window=window)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, mask, causal=True, window=window)
        live = torch.ones(b, t, dtype=torch.bool, device="cuda") if mask is None else mask != 0
        o_err = (out.float() - ref_out.float()).abs()[live].max().item()
        lse_err = (lse - ref_lse).view(b, h, t).transpose(1, 2)[live].abs().max().item()
        tol = ATOL_O[str(dtype).replace("torch.", "")]
        ok = o_err <= tol and lse_err <= ATOL_LSE and torch.isfinite(out[live]).all().item()
        log(f"[kernel] {name:18s} B{b} T{t} H{h}/{hkv} D{d} {str(dtype)[6:]:8s} "
            f"window={window} O err {o_err:.3e} (atol {tol:g})  lse err {lse_err:.3e} "
            f"(atol {ATOL_LSE:g})  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"flash kernel disagrees with its plain version: {name}")
        if name == "path shape":
            path_err = o_err
    return path_err


def _time_ms(torch, fn, iters: int = 100, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(b, t, h, hkv, d, elt_bytes, dtype_name, causal=True):
    """Least time for the work: (bytes moved, flops, bound ms, bound_by)."""
    moved = (2 * b * t * h * d + 2 * b * t * hkv * d) * elt_bytes + 4 * b * h * t
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4 * d * pairs * b * h
    t_bytes = moved / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
    return moved, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_timing(torch, smi: str) -> dict:
    import torch.nn.functional as F

    from llmtrain_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    b, t, h, hkv, d = PATH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = _qkv(torch, gen, b, t, h, hkv, d, torch.bfloat16)
    with torch.inference_mode():
        ms = _time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True))
        plain_ms = _time_ms(torch, lambda: flash_attention_fwd_reference(q, k, v, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = _time_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        )
    moved, flops, bound_ms, bound_by = flash_bound(b, t, h, hkv, d, 2, "bfloat16")
    log(f"[timing] flash_attention_fwd at (B,T,H,D)=({b},{t},{h},{d}) bf16 causal on {smi}:")
    log(f"[timing]   kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"sdpa (yardstick) {library_ms:.4f} ms")
    log(f"[timing]   bound {bound_ms:.6f} ms by {bound_by} ({moved} bytes at 3.35 TB/s, "
        f"{flops} flop at 989 TFLOP/s bf16); kernel at {bound_ms / ms:.2%} of the bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def build_path_model(torch):
    from llmtrain_tpu_torch.cli import prepare_decode_model
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.registry import get_model_adapter, initialize_registries
    from llmtrain_tpu_torch.utils.logging import configure_logging

    root = Path(__file__).resolve().parent
    cfg, _, _ = load_and_validate_config(root / "configs/presets/gpt_pycorpus_tpu.yaml")
    logger = configure_logging(level="WARNING", json_output=False)
    initialize_registries()
    adapter = get_model_adapter(cfg.model.name)()
    device = resolve_device(cfg.run.device)
    model = adapter.build_model(cfg, device)
    model = prepare_decode_model(model, "compute", logger)
    return cfg, adapter, model


def phase_model(torch, model) -> None:
    from unittest import mock

    from llmtrain_tpu_torch.ops import flash_attention as flash_ops

    ref = flash_ops.flash_attention_fwd_reference

    def broken(kind):
        def attend(q, k, v, mask=None, *, causal=True, window=0):
            if kind == "non-causal":
                return ref(q, k, v, mask, causal=False)
            if kind == "last 64 keys":
                return ref(q, k, v, mask, causal=True, window=64)
            out, lse = ref(q, k, v, mask, causal=causal, window=window)
            return torch.zeros_like(out), lse

        return attend

    gen = torch.Generator(device="cuda").manual_seed(2)
    ids = torch.randint(0, model.vocab_size, (1, model.block_size), device="cuda", generator=gen)

    def forward(attend=None):
        if attend is None:
            return model(ids).float()
        with mock.patch.object(flash_ops, "flash_attention_fwd", attend):
            return model(ids).float()

    with torch.inference_mode():
        logits = forward()
        plain = forward(ref)
        controls = {kind: (forward(broken(kind)) - plain).abs().max().item()
                    for kind in ("non-causal", "output zeroed", "last 64 keys")}
    torch.cuda.synchronize()
    shape_ok = tuple(logits.shape) == (1, model.block_size, model.vocab_size)
    finite = bool(torch.isfinite(logits).all().item())
    err = (logits - plain).abs().max().item()
    log(f"[model] GPT {model.n_layers}x{model.d_model} heads {model.n_heads} block "
        f"{model.block_size} vocab {model.vocab_size} dtype {str(model.dtype)[6:]}: "
        f"logits {tuple(logits.shape)} finite={finite} |max| {logits.abs().max().item():.3f} "
        f"kernel-vs-plain max abs diff {err:.4e} (atol {LOGITS_ATOL})")
    for kind, diff in controls.items():
        log(f"[model] control, attention {kind}: max abs diff from plain {diff:.4e} "
            f"(must exceed {LOGITS_ATOL})")
    if not (shape_ok and finite and err <= LOGITS_ATOL):
        raise RuntimeError("model forward through the kernel disagrees with the plain path")
    if min(controls.values()) <= LOGITS_ATOL:
        raise RuntimeError("the logits limit does not separate a broken attention from the "
                           "kernel's rounding")


def _post(url: str, body: object, timeout: float = 600.0) -> tuple[int, dict]:
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def _get(url: str) -> tuple[int, bytes]:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read()


def phase_serve(torch, cfg, model, smi: str) -> None:
    import numpy as np

    from llmtrain_tpu_torch.data.tokenizers import ByteTokenizer
    from llmtrain_tpu_torch.ops.flash_attention import flash_attention_fwd
    from llmtrain_tpu_torch.serving import ServerState, make_server
    from llmtrain_tpu_torch.telemetry.registry import MetricsRegistry

    state = ServerState(
        model=model,
        tokenizer=ByteTokenizer(),
        step=0,
        checkpoint=f"seeded init (run.seed={cfg.run.seed})",
        max_new_tokens_cap=cfg.serving.max_new_tokens_cap,
        default_max_new_tokens=cfg.serving.default_max_new_tokens,
        registry=MetricsRegistry(),
    )
    httpd = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, name="smoke-serve", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(3)
    requests = [
        ("greedy 32+32 (kv-cache)", 32, {"max_new_tokens": 32, "temperature": 0}),
        ("sampled 32+32", 32, {"max_new_tokens": 32, "temperature": 0.8, "top_k": 40,
                                "seed": 11}),
    ]
    launches = {}
    try:
        for name, prompt_len, knobs in requests:
            body = {"prompt_ids": [int(x) for x in rng.integers(0, 256, prompt_len)], **knobs}
            before = flash_attention_fwd.launches
            t0 = time.perf_counter()
            code, resp = _post(f"{base}/v1/generate", body)
            wall = time.perf_counter() - t0
            launches[name] = flash_attention_fwd.launches - before
            comp = resp.get("completion_ids", [])
            ok = (code == 200 and len(comp) == knobs["max_new_tokens"]
                  and all(0 <= c < 256 for c in comp))
            log(f"[serve] {name}: HTTP {code}, {len(comp)} tokens, latency "
                f"{resp.get('latency_ms')} ms (wall {wall * 1e3:.1f} ms), "
                f"{len(comp) / wall:.1f} tokens/s, kernel launches {launches[name]}  on {smi}")
            if not ok:
                raise RuntimeError(f"serve request {name!r} failed: {code} {resp}")
        over = {"prompt_ids": [int(x) for x in rng.integers(0, 256, 400)],
                "max_new_tokens": 160, "temperature": 0}
        code, resp = _post(f"{base}/v1/generate", over)
        log(f"[serve] greedy 400+160 (over block_size): HTTP {code} {resp}")
        if code != 400:
            raise RuntimeError("prompt + max_new_tokens > block_size was not answered with 400")
        code, resp = _post(f"{base}/v1/generate", {"prompt_ids": "not a list"})
        log(f"[serve] malformed body: HTTP {code} {resp}")
        if code != 400:
            raise RuntimeError("a malformed request was not answered with 400")
        code_h, health = _get(f"{base}/healthz")
        code_m, metrics = _get(f"{base}/metrics")
        if code_h != 200 or code_m != 200 or b"llmtrain_serve_requests_total" not in metrics:
            raise RuntimeError("/healthz or /metrics did not answer")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    log(f"[serve] healthz: {json.loads(health)['stats']}")
    if any(launches.values()):
        raise RuntimeError(f"a KV-cache request launched the flash kernel: {launches}")


REFORWARD = (400, 160)  # prompt, new tokens: total 560 > block_size 512


def phase_generate(torch, model, smi: str) -> None:
    """Greedy 400+160 through generate(): the re-forward branch."""
    import numpy as np

    from llmtrain_tpu_torch.generation import generate
    from llmtrain_tpu_torch.ops.flash_attention import flash_attention_fwd

    prompt_len, max_new = REFORWARD
    ids = np.random.default_rng(4).integers(0, 256, (1, prompt_len)).astype(np.int32)
    before = flash_attention_fwd.launches
    t0 = time.perf_counter()
    out = generate(model, ids, max_new_tokens=max_new, temperature=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = flash_attention_fwd.launches - before
    out = np.asarray(out)
    need = model.n_layers * max_new
    log(f"[generate] greedy {prompt_len}+{max_new} (re-forward): {wall * 1e3:.1f} ms, "
        f"{max_new / wall:.1f} tokens/s, kernel launches {launched} (>= {need} required)  "
        f"on {smi}")
    if out.shape != (1, prompt_len + max_new) or not (out >= 0).all() or not (out < 256).all():
        raise RuntimeError(f"generate() returned {out.shape} ids outside [0, 256)")
    if not np.array_equal(out[:, :prompt_len], ids):
        raise RuntimeError("generate() did not keep the prompt")
    if launched < need:
        raise RuntimeError("the re-forward branch did not go through the flash kernel")


def phase_profile(torch, model, smi: str) -> None:
    """torch.profiler over one more re-forward generate()."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from llmtrain_tpu_torch.generation import generate

    prompt_len, max_new = REFORWARD
    ids = np.random.default_rng(5).integers(0, 256, (1, prompt_len)).astype(np.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        generate(model, ids, max_new_tokens=max_new, temperature=0.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    log(f"[profile] re-forward {prompt_len}+{max_new} on {smi}: wall {wall_ms:.1f} ms, "
        f"device kernel time {device_ms:.1f} ms ({device_ms / wall_ms:.1%} busy), {launches} "
        f"kernel launches ({launches / max_new:.0f} per token), "
        f"{wall_ms / max_new:.2f} ms/token")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:6d}  "
            f"{e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 1
    try:
        import llmtrain_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 1
    smi = phase_device(torch)
    phase_build()
    path_err = phase_kernel_checks(torch)
    timing = phase_timing(torch, smi)
    cfg, _, model = build_path_model(torch)
    phase_model(torch, model)
    from llmtrain_tpu_torch.ops.flash_attention import flash_attention_fwd

    flash_attention_fwd.launches = 0  # the main path's count starts here
    phase_serve(torch, cfg, model, smi)
    phase_generate(torch, model, smi)
    main_path_launches = flash_attention_fwd.launches  # and ends here
    log(f"[main path] flash_attention_fwd launches: {main_path_launches}")
    if main_path_launches == 0:
        raise RuntimeError("the main path never launched the flash kernel")
    phase_profile(torch, model, smi)
    kernel = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "llmtrain_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "llmtrain_tpu/ops/pallas_attention.py:186",
        "launches": main_path_launches,
        "max_abs_err": path_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "checked": True,
        "max_err": path_err,
    }
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # noqa: BLE001 — any phase failure fails the smoke test
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
