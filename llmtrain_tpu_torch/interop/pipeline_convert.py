"""``gpt_pipeline`` ↔ ``gpt`` parameter trees (port of
``llmtrain_tpu/interop/pipeline_convert.py``).

The pipeline model stacks every block parameter with a leading layer dim
(models/gpt_pipeline.py); the plain GPT keeps a ``block_{i}`` subtree per
layer. The math is the same (pre-norm blocks, exact-GELU MLP, LayerNorm
eps 1e-6, tied head), so converting is re-indexing only, exact on numpy
arrays and torch tensors alike. Trees are JAX's: nested dicts of arrays,
what a checkpoint payload holds. ``generate``, ``serve``,
``export-checkpoint`` and ``import-checkpoint`` apply it to a pipeline
run (cli.py), decoding through the plain GPT's KV cache.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

Params = Any

# stacked leaf name -> its path in a gpt block; the attention entries
# depend on the layout: fused qkv (MHA) or split q/kv (GQA).
_COMMON_MAP: dict[str, tuple[str, ...]] = {
    "ln1_scale": ("ln_1", "scale"),
    "ln1_bias": ("ln_1", "bias"),
    "out_kernel": ("attn", "out_proj", "kernel"),
    "out_bias": ("attn", "out_proj", "bias"),
    "ln2_scale": ("ln_2", "scale"),
    "ln2_bias": ("ln_2", "bias"),
    "fc_kernel": ("mlp_fc", "kernel"),
    "fc_bias": ("mlp_fc", "bias"),
    "proj_kernel": ("mlp_proj", "kernel"),
    "proj_bias": ("mlp_proj", "bias"),
}
_MHA_MAP: dict[str, tuple[str, ...]] = {
    **_COMMON_MAP,
    "qkv_kernel": ("attn", "qkv_proj", "kernel"),
    "qkv_bias": ("attn", "qkv_proj", "bias"),
}
_GQA_MAP: dict[str, tuple[str, ...]] = {
    **_COMMON_MAP,
    "q_kernel": ("attn", "q_proj", "kernel"),
    "q_bias": ("attn", "q_proj", "bias"),
    "kv_kernel": ("attn", "kv_proj", "kernel"),
    "kv_bias": ("attn", "kv_proj", "bias"),
}


def _set_path(tree: dict, path: tuple[str, ...], value: Any) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _get_path(tree: dict, path: tuple[str, ...]) -> Any:
    node = tree
    for key in path:
        node = node[key]
    return node


def _stack(leaves: list[Any]) -> Any:
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack([np.asarray(x) for x in leaves])


def _block_map(fused: bool) -> dict[str, tuple[str, ...]]:
    return _MHA_MAP if fused else _GQA_MAP


def pipeline_params_to_gpt(params: Params) -> Params:
    """Stacked ``gpt_pipeline`` tree → per-layer ``gpt`` tree (both the
    fused-qkv and the split q/kv layouts)."""
    for required in ("token_embedding", "position_embedding"):
        if required not in params:
            raise ValueError(
                f"params have no {required!r}; not a models/gpt_pipeline.py tree"
            )
    fused = "qkv_kernel" in params
    if not fused and "q_kernel" not in params:
        raise ValueError(
            "params have neither qkv_kernel nor q_kernel; not a "
            "models/gpt_pipeline.py tree"
        )
    block_map = _block_map(fused)
    n_layers = params["qkv_kernel" if fused else "q_kernel"].shape[0]
    out: dict[str, Any] = {
        "token_embedding": dict(params["token_embedding"]),
        "position_embedding": dict(params["position_embedding"]),
        "ln_f": {"scale": params["ln_f_scale"], "bias": params["ln_f_bias"]},
    }
    if "lm_head" in params:
        out["lm_head"] = dict(params["lm_head"])
    for i in range(n_layers):
        block: dict[str, Any] = {}
        for name, path in block_map.items():
            _set_path(block, path, params[name][i])
        out[f"block_{i}"] = block
    return out


def gpt_params_to_pipeline(params: Params) -> Params:
    """Per-layer ``gpt`` tree → stacked ``gpt_pipeline`` tree (both layouts)."""
    for required in ("token_embedding", "position_embedding", "block_0"):
        if required not in params:
            raise ValueError(
                f"params have no {required!r}; not a models/gpt.py tree"
            )
    fused = "qkv_proj" in params["block_0"]["attn"]
    block_map = _block_map(fused)
    n_layers = 0
    while f"block_{n_layers}" in params:
        n_layers += 1
    out: dict[str, Any] = {
        "token_embedding": dict(params["token_embedding"]),
        "position_embedding": dict(params["position_embedding"]),
        "ln_f_scale": params["ln_f"]["scale"],
        "ln_f_bias": params["ln_f"]["bias"],
    }
    if "lm_head" in params:
        out["lm_head"] = dict(params["lm_head"])
    for name, path in block_map.items():
        out[name] = _stack([_get_path(params[f"block_{i}"], path) for i in range(n_layers)])
    return out


def is_pipeline_tree(params: Params) -> bool:
    return ("qkv_kernel" in params or "q_kernel" in params) and "block_0" not in params


__all__ = [
    "gpt_params_to_pipeline",
    "is_pipeline_tree",
    "pipeline_params_to_gpt",
]
