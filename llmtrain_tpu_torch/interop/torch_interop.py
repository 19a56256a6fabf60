"""GPT parameter conversion to/from the reference torch GPT's state dict
(port of ``llmtrain_tpu/interop/torch_interop.py``; that module's
conversion is numpy, but the port keeps its own copy).

The exported dict uses the reference model's module names, so a
reference-spec torch GPT loads it with ``strict=True``:

    token_embedding.weight, position_embedding.weight,
    blocks.{i}.ln_1.{weight,bias},
    blocks.{i}.attn.qkv_proj.{weight,bias},
    blocks.{i}.attn.out_proj.{weight,bias},
    blocks.{i}.attn.causal_mask          (persistent bool buffer),
    blocks.{i}.ln_2.{weight,bias},
    blocks.{i}.mlp_fc.{weight,bias}, blocks.{i}.mlp_proj.{weight,bias},
    ln_f.{weight,bias},
    lm_head.weight                       (always: a tied model shares the
                                          array with token_embedding)

Input and output trees are the flax GPT's param tree (nested dicts; the
port's own trees hold torch tensors, a checkpoint's numpy arrays): flax
Dense kernels are (in, out) against torch's (out, in); the fused qkv
kernel (D, 3, H, hd) flattens in C order so torch's row-chunk(3) recovers
q/k/v; out_proj (H, hd, D) contracts in the same C order.

Import accepts the same names, the tied ``lm_head.weight`` duplicate, and
ignores the ``causal_mask`` buffers; the first-generation export names
(``tok.weight``/``blocks.{i}.qkv.*``) are mapped. Every float tensor is
exported in float32.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

Params = Any  # nested dict of numpy arrays or torch tensors

_CAUSAL_MASK_RE = re.compile(r"^blocks\.\d+\.attn\.causal_mask$")

# The first export format used short names and left the attention
# projections unscoped; files saved by it are mapped on import.
_LEGACY_RENAMES = {
    "tok.weight": "token_embedding.weight",
    "pos.weight": "position_embedding.weight",
}
_LEGACY_BLOCK_RE = re.compile(r"^(blocks\.\d+)\.(qkv|out_proj)\.(weight|bias)$")


def _normalize_legacy_keys(sd: dict[str, Any]) -> dict[str, Any]:
    """Rename a legacy-format state dict (marker: ``tok.weight``) to the
    current reference names."""
    if "tok.weight" not in sd:
        return sd
    out: dict[str, Any] = {}
    for k, v in sd.items():
        m = _LEGACY_BLOCK_RE.match(k)
        if m:
            proj = "qkv_proj" if m.group(2) == "qkv" else "out_proj"
            k = f"{m.group(1)}.attn.{proj}.{m.group(3)}"
        out[_LEGACY_RENAMES.get(k, k)] = v
    return out


def _np(a: Any) -> np.ndarray:
    """A leaf as a float32 numpy array (torch bfloat16 included)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.array(a, dtype=np.float32)


def params_to_torch_state_dict(params: Params) -> dict[str, np.ndarray]:
    """Flax GPT params → reference torch state dict (float32 numpy)."""
    for required in ("token_embedding", "position_embedding", "ln_f"):
        if required not in params:
            raise ValueError(
                f"params have no {required!r}; only the models/gpt.py dense "
                "GPT tree is supported (model.name 'gpt')"
            )
    sd: dict[str, np.ndarray] = {
        "token_embedding.weight": _np(params["token_embedding"]["embedding"]),
        "position_embedding.weight": _np(params["position_embedding"]["embedding"]),
        "ln_f.weight": _np(params["ln_f"]["scale"]),
        "ln_f.bias": _np(params["ln_f"]["bias"]),
    }
    block_size, d = sd["position_embedding.weight"].shape
    # The reference registers the causal mask as a persistent buffer, so
    # strict load_state_dict expects it per block.
    causal_mask = np.triu(
        np.ones((block_size, block_size), dtype=bool), k=1
    ).reshape(1, 1, block_size, block_size)
    i = 0
    while f"block_{i}" in params:
        p = params[f"block_{i}"]
        att = p["attn"]
        if "q_proj" in att or "kv_proj" in att:
            raise ValueError(
                "GQA/MQA checkpoints (model.extra.n_kv_heads) split the "
                "attention projection into q_proj/kv_proj, which has no "
                "counterpart in the reference torch GPT's fused qkv_proj — "
                "export is only supported for full multi-head attention"
            )
        if "qkv_proj" not in att:
            raise ValueError(f"block_{i}.attn has no qkv_proj; not a models/gpt.py GPT tree")
        if "moe_mlp" in p:
            raise ValueError(
                "Mixture-of-Experts checkpoints (model.extra.n_experts) "
                "have no counterpart in the reference torch GPT's dense "
                "MLP — export is only supported for dense models"
            )
        pre = f"blocks.{i}"
        sd[f"{pre}.ln_1.weight"] = _np(p["ln_1"]["scale"])
        sd[f"{pre}.ln_1.bias"] = _np(p["ln_1"]["bias"])
        sd[f"{pre}.ln_2.weight"] = _np(p["ln_2"]["scale"])
        sd[f"{pre}.ln_2.bias"] = _np(p["ln_2"]["bias"])
        sd[f"{pre}.attn.qkv_proj.weight"] = _np(att["qkv_proj"]["kernel"]).reshape(d, 3 * d).T
        sd[f"{pre}.attn.qkv_proj.bias"] = _np(att["qkv_proj"]["bias"]).reshape(3 * d)
        sd[f"{pre}.attn.out_proj.weight"] = _np(att["out_proj"]["kernel"]).reshape(d, d).T
        sd[f"{pre}.attn.out_proj.bias"] = _np(att["out_proj"]["bias"])
        sd[f"{pre}.attn.causal_mask"] = causal_mask
        sd[f"{pre}.mlp_fc.weight"] = _np(p["mlp_fc"]["kernel"]).T
        sd[f"{pre}.mlp_fc.bias"] = _np(p["mlp_fc"]["bias"])
        sd[f"{pre}.mlp_proj.weight"] = _np(p["mlp_proj"]["kernel"]).T
        sd[f"{pre}.mlp_proj.bias"] = _np(p["mlp_proj"]["bias"])
        i += 1
    if i == 0:
        raise ValueError("params contain no block_0; not a models/gpt.py GPT tree")
    if "lm_head" in params:
        sd["lm_head.weight"] = _np(params["lm_head"]["kernel"]).T
    else:
        # Tied model: the reference still has lm_head.weight in its state
        # dict, the same tensor as the token embedding.
        sd["lm_head.weight"] = sd["token_embedding.weight"]
    return sd


def _like(a: np.ndarray, like: Any) -> Any:
    """``a`` in the dtype (and array type) of the template leaf ``like``."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(a)).to(like.dtype)
    return np.asarray(a, dtype=like.dtype)


def params_from_torch_state_dict(sd: dict[str, Any], template: Params) -> Params:
    """Reference torch state dict → flax GPT params shaped like ``template``.

    ``template`` (the param tree of a freshly built model) supplies the
    structure, dtypes and expected shapes; every template leaf must be in
    ``sd`` (missing or mismatched keys raise). The ``causal_mask`` buffers
    are ignored, and for a tied template the ``lm_head.weight`` duplicate
    is accepted iff it equals ``token_embedding.weight``.
    """
    sd = _normalize_legacy_keys(sd)
    consumed: set[str] = set()

    def put(key: str, like, transform=lambda a: a) -> Any:
        if key not in sd:
            raise ValueError(f"state dict is missing {key!r}")
        consumed.add(key)
        a = transform(_np(sd[key]))
        want = tuple(like.shape)
        if tuple(a.shape) != want:
            raise ValueError(f"{key!r}: converted shape {tuple(a.shape)} != expected {want}")
        return _like(a, like)

    d = template["token_embedding"]["embedding"].shape[1]
    out: dict[str, Any] = {
        "token_embedding": {
            "embedding": put("token_embedding.weight", template["token_embedding"]["embedding"])
        },
        "position_embedding": {
            "embedding": put(
                "position_embedding.weight", template["position_embedding"]["embedding"]
            )
        },
        "ln_f": {
            "scale": put("ln_f.weight", template["ln_f"]["scale"]),
            "bias": put("ln_f.bias", template["ln_f"]["bias"]),
        },
    }
    i = 0
    while f"block_{i}" in template:
        t = template[f"block_{i}"]
        pre = f"blocks.{i}"
        att_t = t["attn"]
        if "qkv_proj" not in att_t:
            raise ValueError(
                "template uses split q_proj/kv_proj attention (GQA/MQA, "
                "model.extra.n_kv_heads) — the reference torch GPT has no "
                "such checkpoint format; import requires full multi-head "
                "attention"
            )
        h, hd = att_t["qkv_proj"]["kernel"].shape[2:4]
        out[f"block_{i}"] = {
            "ln_1": {
                "scale": put(f"{pre}.ln_1.weight", t["ln_1"]["scale"]),
                "bias": put(f"{pre}.ln_1.bias", t["ln_1"]["bias"]),
            },
            "ln_2": {
                "scale": put(f"{pre}.ln_2.weight", t["ln_2"]["scale"]),
                "bias": put(f"{pre}.ln_2.bias", t["ln_2"]["bias"]),
            },
            "attn": {
                "qkv_proj": {
                    "kernel": put(f"{pre}.attn.qkv_proj.weight", att_t["qkv_proj"]["kernel"],
                                  lambda a: a.T.reshape(d, 3, h, hd)),
                    "bias": put(f"{pre}.attn.qkv_proj.bias", att_t["qkv_proj"]["bias"],
                                lambda a: a.reshape(3, h, hd)),
                },
                "out_proj": {
                    "kernel": put(f"{pre}.attn.out_proj.weight", att_t["out_proj"]["kernel"],
                                  lambda a: a.T.reshape(h, hd, d)),
                    "bias": put(f"{pre}.attn.out_proj.bias", att_t["out_proj"]["bias"]),
                },
            },
            "mlp_fc": {
                "kernel": put(f"{pre}.mlp_fc.weight", t["mlp_fc"]["kernel"], lambda a: a.T),
                "bias": put(f"{pre}.mlp_fc.bias", t["mlp_fc"]["bias"]),
            },
            "mlp_proj": {
                "kernel": put(f"{pre}.mlp_proj.weight", t["mlp_proj"]["kernel"], lambda a: a.T),
                "bias": put(f"{pre}.mlp_proj.bias", t["mlp_proj"]["bias"]),
            },
        }
        i += 1
    if "lm_head" in template:
        out["lm_head"] = {
            "kernel": put("lm_head.weight", template["lm_head"]["kernel"], lambda a: a.T)
        }
    elif "lm_head.weight" in sd:
        # Tied template: accept the reference's lm_head.weight only if it
        # really is the tied duplicate (compared in f32, before any cast
        # to the template's dtype).
        head = _np(sd["lm_head.weight"])
        tok = _np(sd["token_embedding.weight"])
        if head.shape != tok.shape or not np.array_equal(head, tok):
            raise ValueError(
                "state dict's lm_head.weight differs from "
                "token_embedding.weight: the source model was untied, but "
                "the target config has model.tie_embeddings=true"
            )
        consumed.add("lm_head.weight")
    # The causal-mask buffers are functions of block_size: nothing to import.
    consumed.update(k for k in sd if _CAUSAL_MASK_RE.match(k))
    extra = set(template) - set(out)
    if extra:
        raise ValueError(
            f"template has params the converter does not map: {sorted(extra)} "
            "(only the models/gpt.py dense GPT tree is supported)"
        )
    unconsumed = set(sd) - consumed
    if unconsumed:
        # Dropping weights silently would import "successfully" and then
        # give other logits than the source model.
        raise ValueError(
            f"state dict has weights the template cannot hold: "
            f"{sorted(unconsumed)[:8]}{'...' if len(unconsumed) > 8 else ''} "
            "(layer count / weight tying mismatch?)"
        )
    return out


__all__ = ["params_from_torch_state_dict", "params_to_torch_state_dict"]
