"""CLIP as PyTorch modules: vision ViT + text transformer with staged forwards.

The towers expose the same staged methods as the JAX package's model, so that
soft prompts can later be spliced between embedding and transformer:

    vision_embed(images)             -> (B, 1+N, W) CLS+patch tokens, pos-embedded
    vision_encode_tokens(tokens[, deep_prompts])
                                     -> (B, E)      ln_pre -> transformer -> ln_post -> proj
    text_embed_ids(ids)              -> (B, T, W)   raw token embeddings (no pos emb)
    text_encode_embeddings(x, eot)   -> (B, E)      +pos -> causal transformer -> ln_final -> EOT @ proj

Numerics: parameters are stored in fp32 and cast to the compute dtype where
they are used (`precast_matmul_params` casts the matmul weights once
instead, with the same rounding).  LayerNorm (eps 1e-5) and the attention
softmax run in fp32; LayerNorm outputs are cast to the compute dtype before
the next matmul; matmuls and the residual stream run in the compute dtype.
Attention computes the fused (B, T, 3W) qkv projection and hands it to
`ops.attention.fused_attention` - the CUDA kernel on the card.

Tensor parallelism (parallel/tensor.py): given a `TensorParallel` of size
m > 1, every tower block holds model rank i's shard - H/m heads of the
fused qkv, W/m input columns of `out_proj`, 4W/m rows of `c_fc` and columns
of `c_proj` - and sums its partial products over the model group before
the output biases.  The UPT mixer, built from the same `Transformer`, is
never sharded.  At m = 1 (or None) the modules compute what they always
did, bit for bit.

Parameter names follow OpenAI CLIP's state dict (in_proj_weight, out_proj,
mlp.c_fc, ln_1, ...), with the text tower under `text.` and the patch
embedding stored as the (P*P*3, W) matmul kernel `visual.conv1_kernel` in
(p_h, p_w, channel) row order (models/convert.py maps checkpoints onto it).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from menghini_neurips23_tpu_torch.models.configs import CLIPArch
from menghini_neurips23_tpu_torch.ops.attention import fused_attention
from menghini_neurips23_tpu_torch.ops.patch_embed import patch_tokens
from menghini_neurips23_tpu_torch.parallel import tensor
from menghini_neurips23_tpu_torch.parallel.tensor import TensorParallel


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 whatever the input dtype (output fp32)."""

    def __init__(self, width: int):
        super().__init__(width, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps
        )


class MultiHeadAttention(nn.Module):
    """Self-attention with OpenAI-CLIP-compatible fused qkv parameters.

    `attention` maps the fused (B, T, 3W) qkv, the mask spec and the head
    count to the (B, T, W) output: `fused_attention` (the kernels) for the
    CLIP towers; the UPT mixer passes its own plain fp32 attention.  With
    `tp` of size m > 1 the module holds heads/m heads (its shard of the
    parameters, parallel/tensor.py) and the output is summed over the model
    group before `out_proj`'s bias."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype, attention=fused_attention,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        m = 1 if tp is None else tp.size
        self.tp = tp
        self.heads = heads // m
        self.dtype = dtype
        self.attention = attention
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width // m, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width // m))
        self.out_proj = nn.Linear(width // m, width)

    def forward(self, x: torch.Tensor, mask: Optional[str] = None) -> torch.Tensor:
        """mask is a static spec: None or "causal"."""
        dt = self.dtype
        if self.tp is None or self.tp.size == 1:
            qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
            out = self.attention(qkv, mask, self.heads)
            return _linear(out, self.out_proj, dt)
        total = tensor.reduce(self.partial(tensor.copy(x, self.tp), mask), self.tp)
        return (total + self.out_proj.bias.float()).to(dt)

    def partial(self, x: torch.Tensor, mask: Optional[str] = None) -> torch.Tensor:
        """This shard's heads through `out_proj`'s weight, without its bias:
        the term the model group sums."""
        dt = self.dtype
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        out = self.attention(qkv, mask, self.heads)
        return F.linear(out.to(dt), self.out_proj.weight.to(dt))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype, attention=fused_attention,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        hidden = 4 * width // (1 if tp is None else tp.size)
        self.tp = tp
        self.dtype = dtype
        self.ln_1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads, dtype, attention, tp)
        self.ln_2 = LayerNorm(width)
        self.mlp = nn.ModuleDict(
            {"c_fc": nn.Linear(width, hidden), "c_proj": nn.Linear(hidden, width)}
        )

    def forward(self, x: torch.Tensor, mask: Optional[str] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        if self.tp is None or self.tp.size == 1:
            y = _linear(self.ln_2(x), self.mlp["c_fc"], self.dtype)
            y = _linear(quick_gelu(y), self.mlp["c_proj"], self.dtype)
            return x + y
        total = tensor.reduce(self.mlp_partial(tensor.copy(self.ln_2(x), self.tp)), self.tp)
        return x + (total + self.mlp["c_proj"].bias.float()).to(self.dtype)

    def mlp_partial(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's MLP rows through `c_proj`'s weight, without its
        bias: the term the model group sums."""
        y = _linear(x, self.mlp["c_fc"], self.dtype)
        return F.linear(quick_gelu(y).to(self.dtype), self.mlp["c_proj"].weight.to(self.dtype))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, dtype: torch.dtype,
                 attention=fused_attention, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, dtype, attention, tp) for _ in range(layers)]
        )

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[str] = None,
        deep_prompts: Optional[torch.Tensor] = None,
        deep_start: int = 1,
    ) -> torch.Tensor:
        """deep_prompts: optional (D, L, width) per-layer prompts.  Before
        layer i (1 <= i <= D) the sequence positions [deep_start,
        deep_start+L) are REPLACED by deep_prompts[i-1], cast to the
        activation dtype - the JAX package's working deep-VPT form.  Built out
        of place, so the gradient reaches the deep prompts."""
        for i, block in enumerate(self.resblocks):
            if deep_prompts is not None and 1 <= i <= deep_prompts.shape[0]:
                L = deep_prompts.shape[1]
                dp = deep_prompts[i - 1].to(x.dtype).unsqueeze(0).expand(x.shape[0], -1, -1)
                x = torch.cat([x[:, :deep_start], dp, x[:, deep_start + L :]], dim=1)
            x = block(x, mask)
        return x


class VisionTower(nn.Module):
    def __init__(self, arch: CLIPArch, dtype: torch.dtype, tp: Optional[TensorParallel] = None):
        super().__init__()
        a = arch
        self.arch = a
        self.dtype = dtype
        patch_dim = a.vision_patch_size * a.vision_patch_size * 3
        self.conv1_kernel = nn.Parameter(torch.empty(patch_dim, a.vision_width))
        self.class_embedding = nn.Parameter(torch.empty(a.vision_width))
        self.positional_embedding = nn.Parameter(
            torch.empty(a.num_patches + 1, a.vision_width)
        )
        self.ln_pre = LayerNorm(a.vision_width)
        self.transformer = Transformer(
            a.vision_width, a.vision_layers, a.vision_heads, dtype, tp=tp
        )
        self.ln_post = LayerNorm(a.vision_width)
        self.proj = nn.Parameter(torch.empty(a.vision_width, a.embed_dim))

    def tokens_from_patches(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, W) patch tokens -> (B, 1+N, W): prepend CLS, add pos emb."""
        dt = self.dtype
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) float, CLIP-normalized -> (B, 1+N, width) tokens."""
        x = patch_tokens(images, self.conv1_kernel, self.arch.vision_patch_size, self.dtype)
        return self.tokens_from_patches(x)

    def encode_tokens(
        self, tokens: torch.Tensor, deep_prompts: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """tokens: (B, S, width) -> (B, embed_dim).  S may exceed 1+N (visual
        prompts); deep_prompts enables per-layer prompt replacement."""
        dt = self.dtype
        x = self.ln_pre(tokens).to(dt)
        x = self.transformer(x, deep_prompts=deep_prompts)
        x = self.ln_post(x[:, 0, :]).to(dt)
        return x @ self.proj.to(dt)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.encode_tokens(self.embed(images))


class TextTower(nn.Module):
    def __init__(self, arch: CLIPArch, dtype: torch.dtype, tp: Optional[TensorParallel] = None):
        super().__init__()
        a = arch
        self.dtype = dtype
        self.token_embedding = nn.Embedding(a.vocab_size, a.transformer_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(a.context_length, a.transformer_width)
        )
        self.transformer = Transformer(
            a.transformer_width, a.transformer_layers, a.transformer_heads, dtype, tp=tp
        )
        self.ln_final = LayerNorm(a.transformer_width)
        self.text_projection = nn.Parameter(torch.empty(a.transformer_width, a.embed_dim))

    def embed_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, T) int token ids -> (B, T, width) fp32 embeddings, without pos emb."""
        return self.token_embedding(ids)

    def encode_embeddings(self, x: torch.Tensor, eot_idx: torch.Tensor) -> torch.Tensor:
        """(B, T, width) token embeddings + (B,) EOT positions -> (B, embed_dim).

        T may be SHORTER than context_length (see prompts.truncate_context:
        causal attention makes dropping trailing padding positions exact)."""
        dt = self.dtype
        x = x.to(dt) + self.positional_embedding[: x.shape[1]].to(dt)
        x = self.transformer(x, "causal")
        x = self.ln_final(x).to(dt)
        x = x[torch.arange(x.shape[0], device=x.device), eot_idx]
        return x @ self.text_projection.to(dt)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.encode_embeddings(self.embed_ids(ids), ids.argmax(dim=-1))


class CLIP(nn.Module):
    """Full CLIP with staged tower access for prompt injection; with `tp`,
    this model rank's shard of the towers."""

    def __init__(self, arch: CLIPArch, dtype: torch.dtype = torch.float32,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.visual = VisionTower(arch, dtype, tp)
        self.text = TextTower(arch, dtype, tp)
        self.logit_scale = nn.Parameter(torch.empty(()))

    # --- full-tower forwards -------------------------------------------------
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        return self.text(ids)

    # --- staged forwards for prompt splicing ---------------------------------
    def vision_embed(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual.embed(images)

    def vision_encode_tokens(
        self, tokens: torch.Tensor, deep_prompts: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return self.visual.encode_tokens(tokens, deep_prompts)

    def text_embed_ids(self, ids: torch.Tensor) -> torch.Tensor:
        return self.text.embed_ids(ids)

    def text_encode_embeddings(self, x: torch.Tensor, eot_idx: torch.Tensor) -> torch.Tensor:
        return self.text.encode_embeddings(x, eot_idx)

    def get_logit_scale(self) -> torch.Tensor:
        return torch.exp(self.logit_scale)


_CAST_SUFFIXES = (
    "attn.in_proj_weight", "attn.in_proj_bias",
    "attn.out_proj.weight", "attn.out_proj.bias",
    "mlp.c_fc.weight", "mlp.c_fc.bias",
    "mlp.c_proj.weight", "mlp.c_proj.bias",
)


def precast_matmul_params(model: CLIP, dtype: torch.dtype = torch.bfloat16) -> CLIP:
    """Cast the transformer matmul weights (attention qkv/out, MLP, and the
    tower projections) to the compute dtype ONCE, in place, instead of at
    every use (a model rank's shards included).

    The same rounding by construction: every cast parameter is consumed
    through `.to(dtype)` inside a module of that compute dtype.  LayerNorm
    scales/biases (consumed in fp32), embeddings, `conv1_kernel` (folded in
    fp32 NumPy by ops/patch_embed.fold_normalization), and `logit_scale` are
    left untouched.  Halves the device memory the matmul weights take."""
    for name, p in model.named_parameters():
        if name.endswith(_CAST_SUFFIXES) or name in ("text.text_projection", "visual.proj"):
            p.data = p.data.to(dtype)
    return model


def init_clip_params(arch: CLIPArch, seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """Random CLIP weights from a seed (used when no checkpoint is supplied).

    The distributions follow the JAX package's initializers (normal with
    width^-0.5 for the patch kernel, embeddings, qkv and projections;
    1/sqrt(fan_in) for the dense layers; normal(0.02) token and normal(0.01)
    text position embeddings; unit LayerNorms; zero biases;
    logit_scale = log(1/0.07)).  The values differ: a torch.Generator does
    not reproduce jax.random."""
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in CLIP(arch).state_dict().items()}
    vw, tw = arch.vision_width, arch.transformer_width

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device) * std

    sd: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        width = vw if name.startswith("visual.") else tw
        leaf = name.rsplit(".", 1)[-1]
        if name == "logit_scale":
            sd[name] = torch.full(shape, math.log(1.0 / 0.07), device=device)
        elif ".ln_" in f".{name}" and leaf == "weight":
            sd[name] = torch.ones(shape, device=device)
        elif leaf in ("bias", "in_proj_bias"):
            sd[name] = torch.zeros(shape, device=device)
        elif name == "text.token_embedding.weight":
            sd[name] = normal(shape, 0.02)
        elif name == "text.positional_embedding":
            sd[name] = normal(shape, 0.01)
        elif leaf == "weight" and name.rsplit(".", 2)[-2] in ("out_proj", "c_fc", "c_proj"):
            sd[name] = normal(shape, shape[1] ** -0.5)  # (out, in): 1/sqrt(fan_in)
        else:  # conv1_kernel, class/positional embedding, in_proj, proj, text_projection
            sd[name] = normal(shape, width**-0.5)
    return sd


def build_clip(
    arch: CLIPArch, state_dict: Dict[str, torch.Tensor], dtype=torch.float32, device="cpu",
    tp: Optional[TensorParallel] = None,
) -> CLIP:
    """A frozen, eval-mode CLIP on `device` holding `state_dict` (fp32), or,
    with `tp`, model rank tp.rank's shard of the full `state_dict`."""
    if tp is not None:
        state_dict = tensor.shard_state_dict(state_dict, tp.size, tp.rank)
    with torch.device("meta"):
        model = CLIP(arch, dtype, tp)
    model = model.to_empty(device=device)
    sd = {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
          for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True)
    model.requires_grad_(False)
    return model.eval()
