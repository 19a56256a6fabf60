"""JAX parameter trees ↔ the port's ``state_dict``: the GPT and llama
families (with their MoE variants), the stacked-layer ``gpt_pipeline``
and ``dummy_gpt``.

Input is the flax GPT's ``params`` as nested dicts of arrays — what
``flax.serialization.to_state_dict`` gives and what a checkpoint payload
holds (training/checkpoint.py reads it without flax). The layout
transforms are those of ``llmtrain_tpu/interop/torch_interop.py:83``,
extended to grouped-query attention:

* flax Dense kernels are (in, out); torch Linear weights are (out, in);
* the fused ``qkv_proj`` kernel is (D, 3, H, Dh) and ``kv_proj`` is
  (D, 2, Hkv, Dh): flattened in C order they give output features in the
  (qkv, head, dim) order the port's attention splits;
* ``q_proj`` is (D, H, Dh); ``out_proj`` is (H, Dh, D) and contracts in
  the same C order as the port's (B, T, H·Dh) attention output.

Floating leaves keep their dtype; ``load_state_dict`` casts them into the
model's parameter dtype. :func:`state_dict_to_flax_gpt_params` is the
inverse: the port's trained parameters back to flax names and layout, so
the JAX package's checkpoint readers take a checkpoint the port wrote.
``flax_params_to_state_dict`` / ``state_dict_to_flax_params`` dispatch
between the GPT pair and the ``dummy_gpt`` pair (flax ``_TinyLM``: the
same Dense and Embed layouts).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .pipeline_convert import is_pipeline_tree

Params = Any  # nested dict of numpy arrays or torch tensors


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))  # owned, writable copy


def _kernel(x: Any) -> torch.Tensor:
    """(in, *out) flax kernel → (prod(out), in) torch weight."""
    t = _tensor(x)
    return t.reshape(t.shape[0], -1).T.contiguous()


# Norm modules of the GPT (LayerNorm: scale and bias) and llama (RMSNorm:
# scale only) trees.
_NORMS = frozenset({"ln_1", "ln_2", "ln_f", "attn_norm", "mlp_norm", "norm_f"})


def flax_gpt_params_to_state_dict(params: Params) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from a JAX param tree of the GPT or llama
    family (gpt, gpt_moe, llama, qwen2, gemma, llama_moe): embeddings,
    norms (``scale``, and ``bias`` for LayerNorm), the attention
    projections with their biases, the dense MLP (``mlp_fc``/``mlp_proj``
    or ``mlp_gate``/``mlp_up``/``mlp_down``) or the experts (the router's
    kernel transposed, the stacked expert weights as they are), and the
    untied ``lm_head``."""
    if is_pipeline_tree(params):
        return flax_pipeline_params_to_state_dict(params)
    for required in ("token_embedding", "block_0"):
        if required not in params:
            raise ValueError(
                f"params have no {required!r}; only the GPT and llama family trees "
                "(llmtrain_tpu/models/gpt.py, llama.py) are supported"
            )
    sd: dict[str, torch.Tensor] = {
        "token_embedding.weight": _tensor(params["token_embedding"]["embedding"]),
    }
    if "position_embedding" in params:
        sd["position_embedding.weight"] = _tensor(params["position_embedding"]["embedding"])
    for norm in ("ln_f", "norm_f"):
        if norm in params:
            _norm_to_sd(sd, norm, params[norm])
    i = 0
    while f"block_{i}" in params:
        p, pre = params[f"block_{i}"], f"blocks.{i}"
        for name, node in p.items():
            if name in _NORMS:
                _norm_to_sd(sd, f"{pre}.{name}", node)
            elif name == "attn":
                _attention_to_sd(sd, f"{pre}.attn", node)
            elif name == "moe_mlp":
                for leaf, value in node.items():
                    if leaf == "router":
                        sd[f"{pre}.moe_mlp.router.weight"] = _kernel(value["kernel"])
                    else:
                        sd[f"{pre}.moe_mlp.{leaf}"] = _tensor(value)
            else:
                sd[f"{pre}.{name}.weight"] = _kernel(node["kernel"])
                if "bias" in node:
                    sd[f"{pre}.{name}.bias"] = _tensor(node["bias"])
        i += 1
    if "lm_head" in params:
        sd["lm_head.weight"] = _kernel(params["lm_head"]["kernel"])
    return sd


def _norm_to_sd(sd: dict[str, torch.Tensor], prefix: str, node: Params) -> None:
    sd[f"{prefix}.weight"] = _tensor(node["scale"])
    if "bias" in node:
        sd[f"{prefix}.bias"] = _tensor(node["bias"])


def _attention_to_sd(sd: dict[str, torch.Tensor], prefix: str, att: Params) -> None:
    for proj in ("qkv_proj", "q_proj", "kv_proj"):
        if proj in att:
            sd[f"{prefix}.{proj}.weight"] = _kernel(att[proj]["kernel"])
            if "bias" in att[proj]:
                sd[f"{prefix}.{proj}.bias"] = _tensor(att[proj]["bias"]).reshape(-1)
    out_k = _tensor(att["out_proj"]["kernel"])
    sd[f"{prefix}.out_proj.weight"] = out_k.reshape(-1, out_k.shape[-1]).T.contiguous()
    if "bias" in att["out_proj"]:
        sd[f"{prefix}.out_proj.bias"] = _tensor(att["out_proj"]["bias"])


def _flax_kernel(w: torch.Tensor, *out_shape: int) -> torch.Tensor:
    """(prod(out), in) torch weight → (in, *out) flax kernel."""
    return w.detach().T.contiguous().reshape(w.shape[1], *out_shape)


def state_dict_to_flax_gpt_params(
    sd: dict[str, torch.Tensor], *, n_heads: int, n_kv_heads: int | None = None
) -> Params:
    """The JAX param tree (nested dicts of CPU tensors, flax shapes) of a
    GPT- or llama-family ``state_dict``: the inverse of
    :func:`flax_gpt_params_to_state_dict`."""
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    d_model = sd["token_embedding.weight"].shape[1]
    head_dim = d_model // n_heads
    kv = n_kv_heads or n_heads
    params: dict[str, Any] = {"token_embedding": {"embedding": sd["token_embedding.weight"].clone()}}
    if "position_embedding.weight" in sd:
        params["position_embedding"] = {"embedding": sd["position_embedding.weight"].clone()}
    shapes = {"qkv_proj": (3, n_heads, head_dim), "q_proj": (n_heads, head_dim),
              "kv_proj": (2, kv, head_dim)}
    for name, w in sd.items():
        parts = name.split(".")
        if parts[0] != "blocks":
            if parts[0] in _NORMS:
                params.setdefault(parts[0], {})["scale" if parts[1] == "weight" else "bias"] =                     w.clone()
            elif parts[0] == "lm_head":
                params["lm_head"] = {"kernel": _flax_kernel(w, w.shape[0])}
            continue
        block = params.setdefault(f"block_{parts[1]}", {})
        module, leaf = parts[2], parts[-1]
        if module in _NORMS:
            block.setdefault(module, {})["scale" if leaf == "weight" else "bias"] = w.clone()
        elif module == "attn":
            proj = parts[3]
            node = block.setdefault("attn", {}).setdefault(proj, {})
            if proj == "out_proj":
                node["kernel" if leaf == "weight" else "bias"] = (
                    _flax_kernel(w, d_model).reshape(n_heads, head_dim, d_model)
                    if leaf == "weight" else w.clone())
            elif leaf == "weight":
                node["kernel"] = _flax_kernel(w, *shapes[proj])
            else:
                node["bias"] = w.reshape(shapes[proj]).clone()
        elif module == "moe_mlp":
            moe = block.setdefault("moe_mlp", {})
            if parts[3] == "router":
                moe["router"] = {"kernel": _flax_kernel(w, w.shape[0])}
            else:
                moe[leaf] = w.clone()
        else:
            block.setdefault(module, {})["kernel" if leaf == "weight" else "bias"] = (
                _flax_kernel(w, w.shape[0]) if leaf == "weight" else w.clone())
    return params


def flax_pipeline_params_to_state_dict(params: Params) -> dict[str, torch.Tensor]:
    """The port's ``PipelineGPT`` ``state_dict`` from the JAX ``gpt_pipeline``
    tree: the stacked leaves and ``ln_f_scale``/``ln_f_bias`` under their
    own names and layouts, the embeddings' tables, the untied head's kernel
    transposed."""
    sd = {
        "token_embedding.weight": _tensor(params["token_embedding"]["embedding"]),
        "position_embedding.weight": _tensor(params["position_embedding"]["embedding"]),
    }
    for name, value in params.items():
        if not isinstance(value, dict):
            sd[name] = _tensor(value)
    if "lm_head" in params:
        sd["lm_head.weight"] = _kernel(params["lm_head"]["kernel"])
    return sd


def state_dict_to_flax_pipeline_params(sd: dict[str, torch.Tensor]) -> Params:
    """The inverse of :func:`flax_pipeline_params_to_state_dict`."""
    params: dict[str, Any] = {}
    for name, w in sd.items():
        w = w.detach().cpu()
        if name == "lm_head.weight":
            params["lm_head"] = {"kernel": _flax_kernel(w, w.shape[0])}
        elif name.endswith("_embedding.weight"):
            params[name.split(".")[0]] = {"embedding": w.clone()}
        else:
            params[name] = w.clone()
    return params


def is_dummy_gpt_tree(params: Params) -> bool:
    """True for the ``dummy_gpt`` param tree (flax ``_TinyLM``)."""
    return "embed" in params and "mlp_in" in params


def flax_dummy_gpt_params_to_state_dict(params: Params) -> dict[str, torch.Tensor]:
    """The port's ``TinyLM`` ``state_dict`` from the JAX ``dummy_gpt`` tree
    (``embed``, ``mlp_in``, ``mlp_out``, ``ln_f``, ``lm_head``)."""
    sd = {
        "embed.weight": _tensor(params["embed"]["embedding"]),
        "ln_f.weight": _tensor(params["ln_f"]["scale"]),
        "ln_f.bias": _tensor(params["ln_f"]["bias"]),
        "lm_head.weight": _kernel(params["lm_head"]["kernel"]),
    }
    for dense in ("mlp_in", "mlp_out"):
        sd[f"{dense}.weight"] = _kernel(params[dense]["kernel"])
        sd[f"{dense}.bias"] = _tensor(params[dense]["bias"])
    return sd


def state_dict_to_flax_dummy_gpt_params(sd: dict[str, torch.Tensor]) -> Params:
    """The inverse of :func:`flax_dummy_gpt_params_to_state_dict`."""
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    params: dict[str, Any] = {
        "embed": {"embedding": sd["embed.weight"].clone()},
        "ln_f": {"scale": sd["ln_f.weight"].clone(), "bias": sd["ln_f.bias"].clone()},
        "lm_head": {"kernel": _flax_kernel(sd["lm_head.weight"], sd["lm_head.weight"].shape[0])},
    }
    for dense in ("mlp_in", "mlp_out"):
        w = sd[f"{dense}.weight"]
        params[dense] = {"kernel": _flax_kernel(w, w.shape[0]), "bias": sd[f"{dense}.bias"].clone()}
    return params


def is_lora_tree(params: Params) -> bool:
    """True for a LoRA run's ``{"base": ..., "lora": ...}`` tree."""
    return isinstance(params, dict) and set(params) == {"base", "lora"}


def _flatten_paths(tree: Params, path: tuple[str, ...] = ()) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten_paths(value, (*path, key)))
        else:
            out["/".join((*path, key))] = _tensor(value)
    return out


def lora_tree_to_state_dict(lora: Params) -> dict[str, torch.Tensor]:
    """A LoRA factor tree (``block_0/attn/qkv_proj/kernel/{a,b}``) → the
    ``lora.*`` entries of a LoraModel's ``state_dict`` (models/lora.py)."""
    return {f"lora.{path}": t for path, t in _flatten_paths(lora).items()}


def state_dict_to_lora_tree(sd: dict[str, torch.Tensor]) -> Params:
    """The inverse of :func:`lora_tree_to_state_dict` (``lora.``-prefixed
    entries; others are ignored)."""
    tree: dict[str, Any] = {}
    for name, t in sd.items():
        if not name.startswith("lora."):
            continue
        *path, leaf = name[len("lora."):].split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().cpu().clone()
    return tree


def flax_params_to_state_dict(params: Params) -> dict[str, torch.Tensor]:
    """A checkpoint's param tree → the ``state_dict`` of the model it
    belongs to: ``dummy_gpt``, a GPT/llama-family model, or a LoRA run's
    ``{base, lora}`` (a LoraModel's ``base.*`` and ``lora.*``), told apart
    by the tree."""
    if is_lora_tree(params):
        base = flax_params_to_state_dict(params["base"])
        return {**{f"base.{k}": v for k, v in base.items()},
                **lora_tree_to_state_dict(params["lora"])}
    if is_dummy_gpt_tree(params):
        return flax_dummy_gpt_params_to_state_dict(params)
    return flax_gpt_params_to_state_dict(params)


def state_dict_to_flax_params(
    sd: dict[str, torch.Tensor], *, n_heads: int, n_kv_heads: int | None = None
) -> Params:
    """A model's ``state_dict`` → the JAX param tree a checkpoint stores:
    ``dummy_gpt`` (told apart by its ``embed.weight``) or a GPT/llama-family
    model."""
    if any(k.startswith("lora.") for k in sd):
        base = {k[len("base."):]: v for k, v in sd.items() if k.startswith("base.")}
        return {"base": state_dict_to_flax_params(base, n_heads=n_heads, n_kv_heads=n_kv_heads),
                "lora": state_dict_to_lora_tree(sd)}
    if "embed.weight" in sd:
        return state_dict_to_flax_dummy_gpt_params(sd)
    if "ln_f_scale" in sd:  # a PipelineGPT's
        return state_dict_to_flax_pipeline_params(sd)
    return state_dict_to_flax_gpt_params(sd, n_heads=n_heads, n_kv_heads=n_kv_heads)


def flax_layout_views(
    named: list[tuple[str, torch.Tensor]], *, n_heads: int, n_kv_heads: int | None = None
) -> dict[str, Any]:
    """For each parameter name, a function that views a tensor of that
    parameter's shape in the JAX package's layout, without a copy (the
    transforms of :func:`state_dict_to_flax_params` as views): a Linear
    weight (out, in) as its (in, *out) kernel, a fused projection's bias
    as (qkv, head, dim). Names it does not know view as themselves."""
    shapes = dict(named)
    views: dict[str, Any] = {}
    d_model = shapes["token_embedding.weight"].shape[1] if "token_embedding.weight" in shapes \
        else None
    head_dim = d_model // n_heads if d_model else 0
    kv = n_kv_heads or n_heads
    fused = {"qkv_proj": (3, n_heads, head_dim), "q_proj": (n_heads, head_dim),
             "kv_proj": (2, kv, head_dim)}
    for name, t in named:
        parts = name.split(".")
        if parts[-1] == "weight" and t.dim() == 2 and "embed" not in name:
            out_shape = fused.get(parts[-2], (t.shape[0],))
            if parts[-2] == "out_proj":
                views[name] = lambda w: w.T.view(n_heads, head_dim, w.shape[0])
            else:
                views[name] = lambda w, s=out_shape: w.T.view(w.shape[1], *s)
        elif parts[-1] == "bias" and parts[-2] in fused:
            views[name] = lambda b, s=fused[parts[-2]]: b.view(*s)
    return views


__all__ = [
    "flax_dummy_gpt_params_to_state_dict",
    "flax_layout_views",
    "flax_gpt_params_to_state_dict",
    "flax_pipeline_params_to_state_dict",
    "is_lora_tree",
    "lora_tree_to_state_dict",
    "flax_params_to_state_dict",
    "is_dummy_gpt_tree",
    "state_dict_to_flax_dummy_gpt_params",
    "state_dict_to_flax_gpt_params",
    "state_dict_to_flax_params",
    "state_dict_to_flax_pipeline_params",
    "state_dict_to_lora_tree",
]
