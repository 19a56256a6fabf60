"""Pipeline-parallel GPT, ``gpt_pipeline`` (port of
``llmtrain_tpu/models/gpt_pipeline.py``): stacked-block parameters run by
the GPipe schedule of parallel/pipeline.py.

The architecture is models/gpt.py's (learned token and position
embeddings, pre-norm blocks, exact-GELU MLP, a final LayerNorm, a tied or
untied head), built for stages: every block parameter is one tensor with a
leading layer dim, under JAX's name and in JAX's layout (``qkv_kernel``
(L, D, 3, H, Dh) head-major, or ``q_kernel``/``kv_kernel`` under GQA;
``out_kernel`` (L, H, Dh, D); ``fc_kernel`` (L, D, F) ...), so the port's
parameters are the flax leaves themselves. The block is a function of one
layer's slice (:func:`make_block_apply`), and a stage applies its layers
in order (:func:`make_stage_fn`). Its LayerNorm keeps f32 statistics with
the two-pass variance and eps 1e-6 (:func:`_layernorm`).

On a mesh whose ``pipeline`` axis is above one each rank holds its stage's
layer rows and the stack runs through ``gpipe_apply``; under ``tensor``
each rank also holds its heads and its slice of the MLP width, the block
copying its input into the tensor group and summing its two row-parallel
products (Megatron's pair, parallel/collectives.py), the biases added
once after the sum. ``fsdp`` and ``sequence`` must be 1 there. The
embeddings, ``ln_f`` and the head run on every stage.

On ``attention: flash`` each stage calls ops/flash_attention.py: the
hand-written kernels on the card (grouped-query K/V and the window
native), their plain versions on the CPU. No dropout inside the stages.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..config.schemas import RunConfig
from ..ops.chunked_ce import chunked_ce_components
from ..parallel.pipeline import BATCH_AXES, gpipe_apply, pipeline_degree
from ..registry.models import register_model
from .base import Batch, ModelAdapter, lm_loss_components, validate_lm_batch
from .gpt import DTYPES, _group, dense_attention, embed
from .moe import fill_constant, fill_normal

_INIT_STD = 0.02


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """f32-statistics LayerNorm over the trailing dim (eps 1e-6, the
    two-pass variance of ``jnp.var``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    return (y * scale.float() + bias.float()).to(x.dtype)


def make_block_apply(*, attention: str, dtype: torch.dtype, tp_group: Any = None,
                     window: int = 0):
    """The pre-norm transformer block over one layer's slice ``p`` (no
    leading layer dim) and ``h`` (B, T, D). Shapes are read from the
    parameters, so the same code runs whole or on a tensor-parallel shard;
    with ``tp_group`` the block's input is copied into the group and its
    two row-parallel products summed over it, biases after the sum."""
    from ..parallel.collectives import copy_to, reduce_from

    def column_input(hn: torch.Tensor) -> torch.Tensor:
        x = hn.to(dtype)
        return copy_to(x, tp_group) if tp_group is not None else x

    def row_sum(x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, tp_group) if tp_group is not None else x

    def block_apply(p: dict[str, torch.Tensor], h: torch.Tensor,
                    key_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = column_input(_layernorm(h, p["ln1_scale"], p["ln1_bias"]))
        if "qkv_kernel" in p:
            qkv = (torch.einsum("btd,dkhe->btkhe", x, p["qkv_kernel"].to(dtype))
                   + p["qkv_bias"].to(dtype))
            q, k, v = qkv.unbind(2)  # (B, T, Hl, Dh)
        else:
            q = torch.einsum("btd,dhe->bthe", x, p["q_kernel"].to(dtype)) + p["q_bias"].to(dtype)
            kv = (torch.einsum("btd,dkhe->btkhe", x, p["kv_kernel"].to(dtype))
                  + p["kv_bias"].to(dtype))
            k, v = kv.unbind(2)  # (B, T, Hkv_l, Dh)
        if attention == "flash":
            from ..ops.flash_attention import flash_attention

            att = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  attention_mask=key_mask, causal=True, window=window)
        else:
            if k.shape[2] != q.shape[2]:
                reps = q.shape[2] // k.shape[2]
                k = k.repeat_interleave(reps, dim=2)
                v = v.repeat_interleave(reps, dim=2)
            att = dense_attention(q, k, v, attention_mask=key_mask, window=window)
        proj = row_sum(torch.einsum("bthe,hed->btd", att.to(dtype), p["out_kernel"].to(dtype)))
        attn_out = proj + p["out_bias"].to(dtype)
        if key_mask is not None:
            # Zero padded rows' attention contribution (the mask may hold
            # segment ids).
            attn_out = attn_out * (key_mask != 0)[:, :, None].to(attn_out.dtype)
        h = h + attn_out

        x = column_input(_layernorm(h, p["ln2_scale"], p["ln2_bias"]))
        m = x @ p["fc_kernel"].to(dtype) + p["fc_bias"].to(dtype)
        m = F.gelu(m)
        mlp = row_sum(m @ p["proj_kernel"].to(dtype))
        return h + mlp + p["proj_bias"].to(dtype)

    return block_apply


def make_stage_fn(*, attention: str, dtype: torch.dtype, tp_group: Any = None, window: int = 0):
    """A stage: ``block_apply`` over the stage's layer rows in order.
    ``key_mask`` is the microbatch's (B, T) padding mask (or None)."""
    block_apply = make_block_apply(attention=attention, dtype=dtype, tp_group=tp_group,
                                   window=window)

    def stage_fn(stage_params: dict[str, torch.Tensor], h: torch.Tensor,
                 key_mask: torch.Tensor | None = None) -> torch.Tensor:
        n = next(iter(stage_params.values())).shape[0]
        for i in range(n):
            h = block_apply({k: v[i] for k, v in stage_params.items()}, h, key_mask)
        return h

    return stage_fn


class PipelineGPT(nn.Module):
    """Decoder-only GPT with a stacked, pipeline-splittable block stack.
    ``pipeline_parallel``/``tensor_parallel``: the rank's part on a mesh
    (its stage's layer rows; its heads and MLP width)."""

    stacks_layers = True

    def __init__(
        self,
        *,
        vocab_size: int,
        block_size: int,
        d_model: int,
        n_layers: int,
        n_heads: int,
        d_ff: int,
        tie_embeddings: bool = True,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        attention: str = "dense",
        n_microbatches: int = 4,
        remat: bool = True,
        n_virtual_chunks: int = 1,
        loss_impl: str = "dense",
        ce_chunk: int = 8192,
        z_loss: float = 0.0,
        assume_packed: bool = False,
        sliding_window: int = 0,
        kv_cache_dtype: str = "model",
        n_kv_heads: int = 0,
        pipeline_parallel: int = 1,
        tensor_parallel: int = 1,
        sequence_parallel: int = 1,
        expert_parallel: int = 1,
    ) -> None:
        super().__init__()
        del sequence_parallel, expert_parallel  # validate_mesh keeps both at 1
        self.vocab_size, self.block_size = vocab_size, block_size
        self.d_model, self.n_layers, self.n_heads, self.d_ff = d_model, n_layers, n_heads, d_ff
        self.tie_embeddings, self.dtype, self.param_dtype = tie_embeddings, dtype, param_dtype
        self.attention, self.n_microbatches, self.remat = attention, n_microbatches, remat
        self.n_virtual_chunks, self.loss_impl, self.ce_chunk = n_virtual_chunks, loss_impl, ce_chunk
        self.z_loss, self.assume_packed = z_loss, assume_packed
        self.sliding_window, self.kv_cache_dtype = sliding_window, kv_cache_dtype
        self.n_kv_heads = n_kv_heads or n_heads
        self.pp, self.tp = pipeline_parallel, tensor_parallel
        if n_heads % self.n_kv_heads != 0:
            raise ValueError(
                f"n_heads ({n_heads}) must be divisible by n_kv_heads ({self.n_kv_heads})"
            )
        d, hd = d_model, d_model // n_heads
        rows = n_layers // pipeline_parallel
        h, f, kvh = n_heads // tensor_parallel, d_ff // tensor_parallel, \
            self.n_kv_heads // tensor_parallel
        kw = dict(dtype=param_dtype)
        self.token_embedding = nn.Embedding(vocab_size, d, **kw)
        self.position_embedding = nn.Embedding(block_size, d, **kw)
        shapes: dict[str, tuple[int, ...]] = {"ln1_scale": (d,), "ln1_bias": (d,)}
        if self.n_kv_heads == n_heads:
            # Head-major fused qkv, so the tensor axis splits whole heads.
            shapes.update(qkv_kernel=(d, 3, h, hd), qkv_bias=(3, h, hd))
        else:
            shapes.update(q_kernel=(d, h, hd), q_bias=(h, hd),
                          kv_kernel=(d, 2, kvh, hd), kv_bias=(2, kvh, hd))
        shapes.update(out_kernel=(h, hd, d), out_bias=(d,), ln2_scale=(d,), ln2_bias=(d,),
                      fc_kernel=(d, f), fc_bias=(f,), proj_kernel=(f, d), proj_bias=(d,))
        self.block_names = tuple(shapes)
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.empty(rows, *shape, **kw)))
        self.ln_f_scale = nn.Parameter(torch.ones(d, **kw))
        self.ln_f_bias = nn.Parameter(torch.zeros(d, **kw))
        self.lm_head = None if tie_embeddings else nn.Linear(d, vocab_size, bias=False, **kw)

    def init_plan(self) -> list[tuple[str, Any]]:
        """The JAX initialization as (parameter name, fill) in draw order:
        N(0, 0.02) embeddings, projections and head, N(0,
        0.02/sqrt(2·n_layers)) for ``out_kernel`` and ``proj_kernel``, zero
        biases, unit LayerNorm scales; each stacked leaf drawn whole."""
        residual_std = _INIT_STD / math.sqrt(2 * self.n_layers)
        plan = []
        for name, _ in self.named_parameters():
            if name.endswith("bias"):
                plan.append((name, fill_constant(0.0)))
            elif name.endswith("scale"):
                plan.append((name, fill_constant(1.0)))
            elif name in ("out_kernel", "proj_kernel"):
                plan.append((name, fill_normal(residual_std)))
            else:
                plan.append((name, fill_normal(_INIT_STD)))
        return plan

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        params = dict(self.named_parameters())
        for name, fill in self.init_plan():
            fill(params[name], generator)

    def blocks(self) -> dict[str, torch.Tensor]:
        """The stacked block leaves this module holds, by name."""
        return {name: getattr(self, name) for name in self.block_names}

    def vocab_matrix(self) -> torch.Tensor:
        """The (V, d) output projection: the tied embedding or the head."""
        return self.token_embedding.weight if self.tie_embeddings else self.lm_head.weight

    def _stage_fn(self, tp_group: Any) -> Any:
        return make_stage_fn(attention=self.attention, dtype=self.dtype, tp_group=tp_group,
                             window=self.sliding_window)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor | None = None,
        *,
        deterministic: bool = True,
        generator: torch.Generator | None = None,
        return_hidden: bool = False,
    ) -> torch.Tensor:
        del deterministic, generator  # no dropout inside pipelined blocks
        if self.assume_packed:
            attention_mask = None
        batch, seqlen = input_ids.shape
        if seqlen > self.block_size:
            raise ValueError(
                f"Input sequence length {seqlen} exceeds block size {self.block_size}."
            )
        pos = torch.arange(seqlen, device=input_ids.device)[None]
        x = (embed(input_ids, self.token_embedding.weight).to(self.dtype)
             + embed(pos, self.position_embedding.weight).to(self.dtype))

        from ..distributed import active_mesh

        mesh = active_mesh()
        n_stages = pipeline_degree(mesh)
        tp_group = _group("tensor", self.tp)
        blocks = self.blocks()
        if n_stages > 1:
            nh, f, v = self.n_heads, self.d_ff, self.n_virtual_chunks
            tp = mesh.size("tensor")
            for banned in ("fsdp", "sequence"):
                if mesh.sizes[banned] != 1:
                    raise ValueError(
                        f"gpt_pipeline composes pipeline with data and tensor "
                        f"parallelism; mesh axis {banned!r} must be 1, got "
                        f"{mesh.sizes[banned]}"
                    )
            if nh % tp != 0 or f % tp != 0:
                raise ValueError(
                    f"tensor parallelism needs n_heads ({nh}) and d_ff ({f}) "
                    f"divisible by the tensor axis size ({tp})"
                )
            if self.n_layers % (n_stages * v) != 0:
                raise ValueError(
                    f"n_layers {self.n_layers} must divide evenly into "
                    f"{n_stages} pipeline stages x {v} virtual chunks"
                )
            dp = math.prod(mesh.sizes[a] for a in BATCH_AXES)
            needed = dp * self.n_microbatches
            global_batch = batch * dp
            if global_batch % needed != 0:
                # A batch-1 probe falls back to the whole stack on every
                # stage by design; a real batch must not (every stage
                # would hold all the layers).
                if global_batch > 1:
                    raise ValueError(
                        f"gpt_pipeline: batch {global_batch} is not divisible "
                        f"by data shards x microbatches ({needed}) on a "
                        f"{n_stages}-stage pipeline mesh; pad the batch with "
                        "zero-masked rows (Trainer eval does this via "
                        "ModelAdapter.batch_divisor) or adjust "
                        "model.extra.pipeline_microbatches"
                    )
                from ..parallel.collectives import gather

                group = mesh.group("pipeline")
                blocks = {n: gather(p, 0, group) for n, p in blocks.items()}
                n_stages = 1
        if n_stages > 1:
            x = gpipe_apply(self._stage_fn(tp_group), blocks, x, mesh,
                            n_microbatches=self.n_microbatches, remat_stage=self.remat,
                            virtual_chunks=self.n_virtual_chunks, mask=attention_mask)
        else:
            stage_fn = self._stage_fn(tp_group)
            args = (blocks, x) if attention_mask is None else (blocks, x, attention_mask)
            if self.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                x = checkpoint(stage_fn, *args, use_reentrant=False)
            else:
                x = stage_fn(*args)
        x = _layernorm(x, self.ln_f_scale, self.ln_f_bias)
        if return_hidden:
            return x
        return F.linear(x.to(self.dtype), self.vocab_matrix().to(self.dtype))

    @torch.no_grad()
    def to_gpt(self) -> nn.Module:
        """The plain GPT (models/gpt.py) with these weights, for KV-cache
        decoding (JAX's ``_prepare_decode_model``): same math, its window
        and decode-cache dtype kept, on this module's device."""
        from ..interop.flax_params import flax_params_to_state_dict, state_dict_to_flax_params
        from ..interop.pipeline_convert import pipeline_params_to_gpt
        from .gpt import GPT

        if self.pp != 1 or self.tp != 1:
            raise ValueError("to_gpt needs the whole model (no pipeline or tensor split)")
        device = self.token_embedding.weight.device
        with torch.device("meta"):
            gpt = GPT(vocab_size=self.vocab_size, block_size=self.block_size,
                      d_model=self.d_model, n_layers=self.n_layers, n_heads=self.n_heads,
                      d_ff=self.d_ff, tie_embeddings=self.tie_embeddings, dtype=self.dtype,
                      param_dtype=self.param_dtype, attention=self.attention,
                      n_kv_heads=self.n_kv_heads if self.n_kv_heads != self.n_heads else 0,
                      sliding_window=self.sliding_window, kv_cache_dtype=self.kv_cache_dtype)
        tree = pipeline_params_to_gpt(state_dict_to_flax_params(self.state_dict(),
                                                                n_heads=self.n_heads))
        gpt.load_state_dict(flax_params_to_state_dict(tree), strict=True, assign=True)
        return gpt.to(device).eval()


@register_model("gpt_pipeline")
class PipelineGPTAdapter(ModelAdapter):
    """Adapter for the pipeline-parallel GPT. ``model.extra``: ``tokenizer``,
    ``pipeline_microbatches`` (default 4; each rank's batch must divide by
    it on a pipeline mesh), ``pipeline_virtual_chunks`` (the interleaved
    schedule), ``loss_impl``/``ce_chunk`` (dense or chunked CE), ``z_loss``,
    ``assume_packed``, ``n_kv_heads``, ``sliding_window``, ``kv_cache_dtype``."""

    supports_pipeline = True
    _model_class = PipelineGPT
    known_extra_keys = frozenset(
        {
            "tokenizer",
            "loss_impl",
            "ce_chunk",
            "z_loss",
            "assume_packed",
            "n_kv_heads",
            "pipeline_microbatches",
            "pipeline_virtual_chunks",
            "sliding_window",
            "kv_cache_dtype",
        }
    )

    def model_kwargs(self, cfg: RunConfig) -> dict[str, Any]:
        """The validated constructor arguments (JAX ``build_model``'s checks,
        in its order)."""
        vocab_size = cfg.model.vocab_size
        if vocab_size is None:
            tokenizer = self.build_tokenizer(cfg)
            vocab_size = getattr(tokenizer, "n_vocab", None)
            if not isinstance(vocab_size, int) or vocab_size <= 0:
                raise ValueError("tokenizer must expose a positive integer n_vocab")
        if cfg.model.dropout != 0.0:
            raise ValueError(
                "gpt_pipeline does not support dropout (v1); set model.dropout to 0.0"
            )
        if cfg.model.attention not in ("dense", "flash"):
            raise ValueError(
                f"gpt_pipeline supports attention 'dense' or 'flash', "
                f"got {cfg.model.attention!r}"
            )
        loss_impl = cfg.model.extra.get("loss_impl", "dense")
        if loss_impl == "fused_ce":
            raise ValueError(
                "model.extra.loss_impl 'fused_ce' is not supported with "
                "pipeline parallelism; use 'chunked_ce'"
            )
        if loss_impl not in ("dense", "chunked_ce"):
            raise ValueError(
                f"model.extra.loss_impl {loss_impl!r} unknown; "
                "expected 'dense' or 'chunked_ce'"
            )
        z_loss = float(cfg.model.extra.get("z_loss", 0.0))
        if z_loss < 0.0:
            raise ValueError(f"model.extra.z_loss must be >= 0, got {z_loss}")
        n_kv_heads = int(cfg.model.extra.get("n_kv_heads", 0))
        if n_kv_heads < 0:
            raise ValueError(f"model.extra.n_kv_heads must be >= 0, got {n_kv_heads}")
        if n_kv_heads and cfg.model.n_heads % n_kv_heads != 0:
            raise ValueError(
                f"model.n_heads ({cfg.model.n_heads}) must be divisible by "
                f"model.extra.n_kv_heads ({n_kv_heads})"
            )
        sliding_window = int(cfg.model.extra.get("sliding_window", 0))
        if sliding_window < 0:
            raise ValueError(f"model.extra.sliding_window must be >= 0, got {sliding_window}")
        kv_cache_dtype = str(cfg.model.extra.get("kv_cache_dtype", "model"))
        if kv_cache_dtype not in ("model", "int8"):
            raise ValueError(
                f"model.extra.kv_cache_dtype {kv_cache_dtype!r} unknown; "
                "expected 'model' or 'int8'"
            )
        return dict(
            vocab_size=vocab_size,
            block_size=cfg.model.block_size,
            d_model=cfg.model.d_model,
            n_layers=cfg.model.n_layers,
            n_heads=cfg.model.n_heads,
            d_ff=cfg.model.d_ff,
            tie_embeddings=cfg.model.tie_embeddings,
            dtype=DTYPES[cfg.model.dtype],
            param_dtype=DTYPES[cfg.model.param_dtype],
            attention=cfg.model.attention,
            n_microbatches=self._positive_extra(cfg, "pipeline_microbatches", 4),
            remat=cfg.model.remat,
            n_virtual_chunks=self._positive_extra(cfg, "pipeline_virtual_chunks", 1),
            loss_impl=loss_impl,
            ce_chunk=self._positive_extra(cfg, "ce_chunk", 8192),
            z_loss=z_loss,
            assume_packed=bool(cfg.model.extra.get("assume_packed", False)),
            n_kv_heads=n_kv_heads,
            sliding_window=sliding_window,
            kv_cache_dtype=kv_cache_dtype,
        )

    def build_model(self, cfg: RunConfig, device: torch.device | None = None) -> nn.Module:
        """The module on ``device``, initialized from ``run.seed``; on a mesh
        that splits it, this rank's part (parallel/mesh_params.py)."""
        from ..distributed import active_mesh

        kwargs = self.model_kwargs(cfg)
        mesh = active_mesh()
        if mesh is not None and mesh.model_parallel:
            from ..parallel.mesh_params import build_for_mesh

            return build_for_mesh(self._model_class, kwargs, mesh, moe=False, device=device,
                                  seed=cfg.run.seed).eval()
        model = self._model_class(**kwargs)
        if device is not None:
            model = model.to(device)
        generator = torch.Generator(device=model.token_embedding.weight.device)
        generator.manual_seed(cfg.run.seed)
        model.init_weights(generator)
        return model.eval()

    def build_tokenizer(self, cfg: RunConfig) -> Any | None:
        from ..data.tokenizers import build_tokenizer

        return build_tokenizer(cfg.model.extra.get("tokenizer", "gpt2"))

    def batch_divisor(self, cfg: RunConfig, axes: dict[str, int]) -> int:
        """data shards x microbatches on a pipeline mesh: the global rows
        every applied batch must divide by for the schedule to engage."""
        if int(axes.get("pipeline", 1)) <= 1:
            return 1
        dp = math.prod(int(axes.get(a, 1)) for a in BATCH_AXES)
        return dp * self._positive_extra(cfg, "pipeline_microbatches", 4)

    def validate_mesh(self, cfg: RunConfig, axes: dict[str, int]) -> None:
        """Fail at startup when the training batch cannot engage the
        pipeline, or the K/V heads cannot split over ``tensor``. A
        ``sequence`` axis is refused: the stages hold whole sequences."""
        m = self._positive_extra(cfg, "pipeline_microbatches", 4)
        if int(axes.get("pipeline", 1)) > 1 and cfg.trainer.micro_batch_size % m != 0:
            raise ValueError(
                f"trainer.micro_batch_size ({cfg.trainer.micro_batch_size}) "
                f"must be divisible by model.extra.pipeline_microbatches "
                f"({m}) on a pipeline mesh"
            )
        n_kv_heads = int(cfg.model.extra.get("n_kv_heads", 0))
        tp = int(axes.get("tensor", 1))
        if n_kv_heads and tp > 1 and n_kv_heads % tp != 0:
            raise ValueError(
                f"model.extra.n_kv_heads ({n_kv_heads}) must be divisible "
                f"by the mesh tensor axis ({tp}) — K/V heads shard over "
                "tensor parallelism like query heads do"
            )
        if int(axes.get("sequence", 1)) > 1:
            raise ValueError(
                "gpt_pipeline composes pipeline with data and tensor "
                f"parallelism; mesh axis 'sequence' must be 1, got {axes['sequence']}"
            )

    def compute_loss_components(
        self,
        model: PipelineGPT,
        batch: Batch,
        *,
        generator: torch.Generator | None = None,
        deterministic: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        if model.loss_impl == "chunked_ce":
            input_ids, labels, attention_mask = validate_lm_batch(batch)
            hidden = model(input_ids.long(), attention_mask, return_hidden=True)
            return chunked_ce_components(hidden, model.vocab_matrix(), labels, attention_mask,
                                         chunk=model.ce_chunk, z_loss=model.z_loss)
        return lm_loss_components(model, batch, generator=generator,
                                  deterministic=deterministic)


__all__ = ["PipelineGPT", "PipelineGPTAdapter", "make_block_apply", "make_stage_fn"]
