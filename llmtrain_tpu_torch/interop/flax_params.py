"""JAX parameter trees ↔ the port's ``state_dict``: the dense GPT and
``dummy_gpt``.

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

Params = Any  # nested dict of numpy arrays or torch tensors


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))  # owned, writable copy


def _kernel(x: Any) -> torch.Tensor:
    """(in, *out) flax kernel → (prod(out), in) torch weight."""
    t = _tensor(x)
    return t.reshape(t.shape[0], -1).T.contiguous()


def flax_gpt_params_to_state_dict(params: Params) -> dict[str, torch.Tensor]:
    """The port's GPT ``state_dict`` from the JAX GPT's param tree."""
    if "base" in params and "lora" in params:
        raise NotImplementedError(
            "LoRA checkpoints are not yet ported to llmtrain_tpu_torch "
            "(ROADMAP.md queue A: model zoo); merge or export the base first"
        )
    if ("qkv_kernel" in params or "q_kernel" in params) and "block_0" not in params:
        raise NotImplementedError(
            "pipeline (stacked-layer) checkpoints are not yet ported to "
            "llmtrain_tpu_torch (ROADMAP.md queue A: parallelism)"
        )
    for required in ("token_embedding", "position_embedding", "ln_f", "block_0"):
        if required not in params:
            raise ValueError(
                f"params have no {required!r}; only the dense GPT tree "
                "(llmtrain_tpu/models/gpt.py) is supported"
            )
    sd: dict[str, torch.Tensor] = {
        "token_embedding.weight": _tensor(params["token_embedding"]["embedding"]),
        "position_embedding.weight": _tensor(params["position_embedding"]["embedding"]),
        "ln_f.weight": _tensor(params["ln_f"]["scale"]),
        "ln_f.bias": _tensor(params["ln_f"]["bias"]),
    }
    i = 0
    while f"block_{i}" in params:
        p, pre = params[f"block_{i}"], f"blocks.{i}"
        if "moe_mlp" in p:
            raise NotImplementedError(
                "Mixture-of-Experts checkpoints are not yet ported to "
                "llmtrain_tpu_torch (ROADMAP.md queue A: model zoo)"
            )
        for ln in ("ln_1", "ln_2"):
            sd[f"{pre}.{ln}.weight"] = _tensor(p[ln]["scale"])
            sd[f"{pre}.{ln}.bias"] = _tensor(p[ln]["bias"])
        att = p["attn"]
        for proj in ("qkv_proj", "q_proj", "kv_proj"):
            if proj in att:
                sd[f"{pre}.attn.{proj}.weight"] = _kernel(att[proj]["kernel"])
                if "bias" in att[proj]:
                    sd[f"{pre}.attn.{proj}.bias"] = _tensor(att[proj]["bias"]).reshape(-1)
        out_k = _tensor(att["out_proj"]["kernel"])
        sd[f"{pre}.attn.out_proj.weight"] = out_k.reshape(-1, out_k.shape[-1]).T.contiguous()
        if "bias" in att["out_proj"]:
            sd[f"{pre}.attn.out_proj.bias"] = _tensor(att["out_proj"]["bias"])
        for mlp in ("mlp_fc", "mlp_proj"):
            sd[f"{pre}.{mlp}.weight"] = _kernel(p[mlp]["kernel"])
            sd[f"{pre}.{mlp}.bias"] = _tensor(p[mlp]["bias"])
        i += 1
    if "lm_head" in params:
        sd["lm_head.weight"] = _kernel(params["lm_head"]["kernel"])
    return sd


def _flax_kernel(w: torch.Tensor, *out_shape: int) -> torch.Tensor:
    """(prod(out), in) torch weight → (in, *out) flax kernel."""
    return w.detach().T.contiguous().reshape(w.shape[1], *out_shape)


def state_dict_to_flax_gpt_params(
    sd: dict[str, torch.Tensor], *, n_heads: int, n_kv_heads: int | None = None
) -> Params:
    """The JAX GPT's param tree (nested dicts of CPU tensors, flax shapes)
    from the port's GPT ``state_dict``: the inverse of
    :func:`flax_gpt_params_to_state_dict`."""
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    d_model = sd["token_embedding.weight"].shape[1]
    head_dim = d_model // n_heads
    kv = n_kv_heads or n_heads
    params: dict[str, Any] = {
        "token_embedding": {"embedding": sd["token_embedding.weight"].clone()},
        "position_embedding": {"embedding": sd["position_embedding.weight"].clone()},
        "ln_f": {"scale": sd["ln_f.weight"].clone(), "bias": sd["ln_f.bias"].clone()},
    }
    i = 0
    while f"blocks.{i}.ln_1.weight" in sd:
        pre = f"blocks.{i}"
        block: dict[str, Any] = {
            ln: {"scale": sd[f"{pre}.{ln}.weight"].clone(), "bias": sd[f"{pre}.{ln}.bias"].clone()}
            for ln in ("ln_1", "ln_2")
        }
        att: dict[str, Any] = {}
        shapes = {"qkv_proj": (3, n_heads, head_dim), "q_proj": (n_heads, head_dim),
                  "kv_proj": (2, kv, head_dim)}
        for proj, shape in shapes.items():
            if f"{pre}.attn.{proj}.weight" in sd:
                att[proj] = {"kernel": _flax_kernel(sd[f"{pre}.attn.{proj}.weight"], *shape)}
                if f"{pre}.attn.{proj}.bias" in sd:
                    att[proj]["bias"] = sd[f"{pre}.attn.{proj}.bias"].reshape(shape).clone()
        att["out_proj"] = {
            "kernel": _flax_kernel(sd[f"{pre}.attn.out_proj.weight"], d_model).reshape(
                n_heads, head_dim, d_model
            )
        }
        if f"{pre}.attn.out_proj.bias" in sd:
            att["out_proj"]["bias"] = sd[f"{pre}.attn.out_proj.bias"].clone()
        block["attn"] = att
        for mlp in ("mlp_fc", "mlp_proj"):
            w = sd[f"{pre}.{mlp}.weight"]
            block[mlp] = {"kernel": _flax_kernel(w, w.shape[0]),
                          "bias": sd[f"{pre}.{mlp}.bias"].clone()}
        params[f"block_{i}"] = block
        i += 1
    if "lm_head.weight" in sd:
        w = sd["lm_head.weight"]
        params["lm_head"] = {"kernel": _flax_kernel(w, w.shape[0])}
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


def flax_params_to_state_dict(params: Params) -> dict[str, torch.Tensor]:
    """A checkpoint's param tree → the ``state_dict`` of the model it
    belongs to: ``dummy_gpt`` or the dense GPT, told apart by the tree."""
    if is_dummy_gpt_tree(params):
        return flax_dummy_gpt_params_to_state_dict(params)
    return flax_gpt_params_to_state_dict(params)


def state_dict_to_flax_params(
    sd: dict[str, torch.Tensor], *, n_heads: int, n_kv_heads: int | None = None
) -> Params:
    """A model's ``state_dict`` → the JAX param tree a checkpoint stores:
    ``dummy_gpt`` (told apart by its ``embed.weight``) or the dense GPT."""
    if "embed.weight" in sd:
        return state_dict_to_flax_dummy_gpt_params(sd)
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
    "flax_params_to_state_dict",
    "is_dummy_gpt_tree",
    "state_dict_to_flax_dummy_gpt_params",
    "state_dict_to_flax_gpt_params",
    "state_dict_to_flax_params",
]
