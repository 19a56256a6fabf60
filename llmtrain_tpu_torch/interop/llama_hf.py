"""Llama-family parameters ↔ the HF-transformers state dict (port of
``llmtrain_tpu/interop/llama_hf.py``; conversion only, nothing is fetched).

The family's checkpoint lingua franca is HF ``LlamaForCausalLM`` (Qwen2
adds the q/k/v biases, Gemma stores its norm deltas under the same
names):

    model.embed_tokens.weight
    model.layers.{i}.input_layernorm.weight
    model.layers.{i}.self_attn.{q,k,v,o}_proj.weight   (+ q/k/v .bias)
    model.layers.{i}.post_attention_layernorm.weight
    model.layers.{i}.mlp.{gate,up,down}_proj.weight
    model.norm.weight
    lm_head.weight     (a tied model: the shared tensor)

Both sides are the JAX param tree (what the checkpoints hold, as
interop/flax_params.py gives it): flax kernels (in, out) against torch
(out, in), head-major kernels flattened in C order. The fused-MHA
(``qkv_proj``) and split GQA (``q_proj``/``kv_proj``) trees are handled.
Export gives float32 numpy arrays; import gives tensors in the template's
dtypes. Mixture-of-Experts trees have no HF-Llama layout and raise.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

Params = Any  # nested dict of numpy arrays or torch tensors

# Older transformers versions saved per-layer rotary inv_freq buffers,
# functions of (head_dim, rope_theta): ignored on import.
_ROTARY_BUFFER_RE = re.compile(r"(^|\.)rotary_emb\.inv_freq$")


def is_llama_tree(params: Params) -> bool:
    """True for a llama-family param tree: its blocks carry ``attn_norm``
    (GPT blocks carry ``ln_1``), dense and MoE alike."""
    blk = params.get("block_0") if hasattr(params, "get") else None
    return blk is not None and "attn_norm" in blk


def _np(a: Any) -> np.ndarray:
    """A leaf as float32 numpy (torch bfloat16 included)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.array(a, dtype=np.float32)


def _shape(a: Any) -> tuple[int, ...]:
    return tuple(a.shape)


def _like(a: np.ndarray, like: Any) -> Any:
    """``a`` in the dtype (and array type) of the template leaf ``like``."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(a)).to(like.dtype)
    return np.asarray(a, dtype=like.dtype)


def llama_params_to_hf_state_dict(params: Params) -> dict[str, np.ndarray]:
    """Llama-family params → HF Llama state dict (float32 numpy)."""
    for required in ("token_embedding", "norm_f"):
        if required not in params:
            raise ValueError(
                f"params have no {required!r}; only the models/llama.py "
                "tree is supported (model.name 'llama')"
            )
    sd: dict[str, np.ndarray] = {
        "model.embed_tokens.weight": _np(params["token_embedding"]["embedding"]),
        "model.norm.weight": _np(params["norm_f"]["scale"]),
    }
    d = sd["model.embed_tokens.weight"].shape[1]
    i = 0
    while f"block_{i}" in params:
        p = params[f"block_{i}"]
        if "moe_mlp" in p:
            raise ValueError(
                "Mixture-of-Experts checkpoints (model.name llama_moe) "
                "have no counterpart in the HF LlamaForCausalLM state-dict "
                "layout — export is only supported for dense llama models"
            )
        if "mlp_gate" not in p:
            raise ValueError(f"block_{i} has no mlp_gate; not a models/llama.py tree")
        att = p["attn"]
        pre = f"model.layers.{i}."
        if "qkv_proj" in att:
            # Fused MHA tree: split the (D, 3, H, dh) kernel.
            kern = _np(att["qkv_proj"]["kernel"])
            q, k, v = kern[:, 0], kern[:, 1], kern[:, 2]
            biases = (
                tuple(_np(att["qkv_proj"]["bias"])[j] for j in range(3))
                if "bias" in att["qkv_proj"] else None
            )
        else:
            q = _np(att["q_proj"]["kernel"])
            kv = _np(att["kv_proj"]["kernel"])
            k, v = kv[:, 0], kv[:, 1]
            if "bias" in att["q_proj"]:
                kvb = _np(att["kv_proj"]["bias"])
                biases = (_np(att["q_proj"]["bias"]), kvb[0], kvb[1])
            else:
                biases = None
        sd[pre + "self_attn.q_proj.weight"] = q.reshape(d, -1).T
        sd[pre + "self_attn.k_proj.weight"] = k.reshape(d, -1).T
        sd[pre + "self_attn.v_proj.weight"] = v.reshape(d, -1).T
        if biases is not None:
            # Qwen2: 1-D biases, head-major like the kernel rows.
            for name, b in zip(("q", "k", "v"), biases):
                sd[pre + f"self_attn.{name}_proj.bias"] = b.reshape(-1)
        sd[pre + "self_attn.o_proj.weight"] = _np(att["out_proj"]["kernel"]).reshape(-1, d).T
        sd[pre + "input_layernorm.weight"] = _np(p["attn_norm"]["scale"])
        sd[pre + "post_attention_layernorm.weight"] = _np(p["mlp_norm"]["scale"])
        sd[pre + "mlp.gate_proj.weight"] = _np(p["mlp_gate"]["kernel"]).T
        sd[pre + "mlp.up_proj.weight"] = _np(p["mlp_up"]["kernel"]).T
        sd[pre + "mlp.down_proj.weight"] = _np(p["mlp_down"]["kernel"]).T
        i += 1
    if i == 0:
        raise ValueError("params contain no block_0; not a models/llama.py tree")
    if "lm_head" in params:
        sd["lm_head.weight"] = _np(params["lm_head"]["kernel"]).T
    else:
        # Tied model: HF's .bin state dicts hold the shared tensor here.
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    return sd


def llama_params_from_hf_state_dict(sd: dict[str, Any], template: Params) -> Params:
    """HF Llama state dict → llama-family params shaped like ``template``
    (the param tree of a freshly built model: structure, dtypes, shapes).
    Missing, mismatched or unconsumed keys raise; rotary ``inv_freq``
    buffers are ignored; a tied template takes a ``lm_head.weight`` only
    if it equals the embedding, and tolerates its absence."""
    consumed: set[str] = set()

    def put(key: str, like: Any, transform=lambda a: a) -> Any:
        if key not in sd:
            raise ValueError(f"state dict is missing {key!r}")
        consumed.add(key)
        a = transform(_np(sd[key]))
        want = _shape(like)
        if tuple(a.shape) != want:
            raise ValueError(f"{key!r}: converted shape {tuple(a.shape)} != expected {want}")
        return _like(a, like)

    def take_proj(key: str, shape: tuple) -> np.ndarray:
        """Torch (out, in) Linear weight → transposed, head-major reshape."""
        if key not in sd:
            raise ValueError(f"state dict is missing {key!r}")
        consumed.add(key)
        a = _np(sd[key]).T
        if a.size != int(np.prod(shape)):
            raise ValueError(f"{key!r}: shape {a.shape} cannot reshape to {shape}")
        return a.reshape(shape)

    d = _shape(template["token_embedding"]["embedding"])[1]
    out: dict[str, Any] = {
        "token_embedding": {
            "embedding": put("model.embed_tokens.weight", template["token_embedding"]["embedding"])
        },
        "norm_f": {"scale": put("model.norm.weight", template["norm_f"]["scale"])},
    }
    i = 0
    while f"block_{i}" in template:
        t = template[f"block_{i}"]
        if "moe_mlp" in t:
            raise ValueError(
                "Mixture-of-Experts configs (model.name llama_moe) have no "
                "counterpart in the HF LlamaForCausalLM state-dict layout — "
                "import is only supported for dense llama models"
            )
        att_t = t["attn"]
        pre = f"model.layers.{i}."
        if "qkv_proj" in att_t:
            like = att_t["qkv_proj"]["kernel"]
            h, hd = _shape(like)[2:4]
            qkv = np.stack([take_proj(pre + f"self_attn.{n}_proj.weight", (d, h, hd))
                            for n in ("q", "k", "v")], axis=1)
            attn = {"qkv_proj": {"kernel": _like(qkv, like)}}
            if "bias" in att_t["qkv_proj"]:
                bias = np.stack([take_proj(pre + f"self_attn.{n}_proj.bias", (h, hd))
                                 for n in ("q", "k", "v")], axis=0)
                attn["qkv_proj"]["bias"] = _like(bias, att_t["qkv_proj"]["bias"])
        else:
            h, hd = _shape(att_t["q_proj"]["kernel"])[1:3]
            like = att_t["kv_proj"]["kernel"]
            hkv = _shape(like)[2]
            kv = np.stack([take_proj(pre + f"self_attn.{n}_proj.weight", (d, hkv, hd))
                           for n in ("k", "v")], axis=1)
            attn = {
                "q_proj": {
                    "kernel": put(pre + "self_attn.q_proj.weight", att_t["q_proj"]["kernel"],
                                  lambda a: a.T.reshape(d, h, hd))
                },
                "kv_proj": {"kernel": _like(kv, like)},
            }
            if "bias" in att_t["q_proj"]:
                attn["q_proj"]["bias"] = _like(
                    take_proj(pre + "self_attn.q_proj.bias", (h, hd)), att_t["q_proj"]["bias"])
                kvb = np.stack([take_proj(pre + f"self_attn.{n}_proj.bias", (hkv, hd))
                                for n in ("k", "v")], axis=0)
                attn["kv_proj"]["bias"] = _like(kvb, att_t["kv_proj"]["bias"])
        out_hd = _shape(att_t["out_proj"]["kernel"])[1]
        attn["out_proj"] = {
            "kernel": put(pre + "self_attn.o_proj.weight", att_t["out_proj"]["kernel"],
                          lambda a: a.T.reshape(-1, out_hd, d))
        }
        out[f"block_{i}"] = {
            "attn_norm": {"scale": put(pre + "input_layernorm.weight", t["attn_norm"]["scale"])},
            "mlp_norm": {
                "scale": put(pre + "post_attention_layernorm.weight", t["mlp_norm"]["scale"])
            },
            "attn": attn,
            "mlp_gate": {"kernel": put(pre + "mlp.gate_proj.weight", t["mlp_gate"]["kernel"],
                                       lambda a: a.T)},
            "mlp_up": {"kernel": put(pre + "mlp.up_proj.weight", t["mlp_up"]["kernel"],
                                     lambda a: a.T)},
            "mlp_down": {"kernel": put(pre + "mlp.down_proj.weight", t["mlp_down"]["kernel"],
                                       lambda a: a.T)},
        }
        i += 1
    if "lm_head" in template:
        out["lm_head"] = {
            "kernel": put("lm_head.weight", template["lm_head"]["kernel"], lambda a: a.T)
        }
    elif "lm_head.weight" in sd:
        head = _np(sd["lm_head.weight"])
        tok = _np(sd["model.embed_tokens.weight"])
        if head.shape != tok.shape or not np.array_equal(head, tok):
            raise ValueError(
                "state dict's lm_head.weight differs from "
                "model.embed_tokens.weight: the source model was untied, "
                "but the target config has model.tie_embeddings=true"
            )
        consumed.add("lm_head.weight")
    consumed.update(k for k in sd if _ROTARY_BUFFER_RE.search(k))
    extra = set(template) - set(out)
    if extra:
        raise ValueError(
            f"template has params the converter does not map: {sorted(extra)} "
            "(only the models/llama.py tree is supported)"
        )
    unconsumed = set(sd) - consumed
    if unconsumed:
        raise ValueError(
            f"state dict has weights the template cannot hold: "
            f"{sorted(unconsumed)[:8]}{'...' if len(unconsumed) > 8 else ''} "
            "(layer count / head count / weight tying mismatch?)"
        )
    return out


__all__ = [
    "is_llama_tree",
    "llama_params_from_hf_state_dict",
    "llama_params_to_hf_state_dict",
]
