"""Plain CLIP in PyTorch, fp32, from a state dict: the benchmark's reference.

It follows OpenAI CLIP's `clip/model.py` (ViT image tower, causal text
tower, pre-LayerNorm residual blocks with QuickGELU) with two departures
that the configurations share with the program: the patch convolution is
the (P*P*3, W) matmul kernel `visual.conv1_kernel` (rows in (p_h, p_w,
channel) order), applied to the CLIP-normalised image; and the text tower
may run fewer than 77 positions (causal attention makes the positions past
the last end-of-text token irrelevant to the features).

Soft prompts enter as the paper's methods put them: CoOp's prefix replaces
the token embeddings at positions 1..L; VPT's prefix is inserted between the
class token and the patch tokens after the position embedding.

Nothing here imports the program, and no kernel runs: every product is a
plain `torch` operation.  `precision()` switches TF32 for the control.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@contextlib.contextmanager
def precision(tf32: bool = False):
    """fp32 matmuls in full fp32 (the reference) or in TF32 (the control)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _ln(x, sd, p):
    return F.layer_norm(x, (x.shape[-1],), sd[p + ".weight"], sd[p + ".bias"], 1e-5)


def block(sd, p: str, x, heads: int, causal: bool):
    """One residual attention block: x + attn(ln_1 x), then + mlp(ln_2 x)."""
    B, T, W = x.shape
    D = W // heads
    qkv = F.linear(_ln(x, sd, p + "ln_1"), sd[p + "attn.in_proj_weight"],
                   sd[p + "attn.in_proj_bias"])
    q, k, v = (t.reshape(B, T, heads, D).transpose(1, 2) for t in qkv.split(W, dim=-1))
    s = (q @ k.transpose(-1, -2)) * D**-0.5
    if causal:
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1),
                          float("-inf"))
    o = (s.softmax(-1) @ v).transpose(1, 2).reshape(B, T, W)
    x = x + F.linear(o, sd[p + "attn.out_proj.weight"], sd[p + "attn.out_proj.bias"])
    h = F.linear(_ln(x, sd, p + "ln_2"), sd[p + "mlp.c_fc.weight"], sd[p + "mlp.c_fc.bias"])
    h = h * torch.sigmoid(1.702 * h)
    return x + F.linear(h, sd[p + "mlp.c_proj.weight"], sd[p + "mlp.c_proj.bias"])


def tower(sd, prefix: str, x, cfg: dict, causal: bool):
    layers = cfg["transformer_layers"] if prefix == "text" else cfg["vision_layers"]
    heads = cfg["transformer_heads"] if prefix == "text" else cfg["vision_heads"]
    for i in range(layers):
        x = block(sd, f"{prefix}.transformer.resblocks.{i}.", x, heads, causal)
    return x


def text_features(sd, cfg: dict, ids: torch.Tensor, prefix=None):
    """(C, T) token ids -> (C, E) unnormalised features; a CoOp `prefix`
    (L, W) replaces the embeddings at positions 1..L."""
    x = sd["text.token_embedding.weight"][ids]
    if prefix is not None:
        L = prefix.shape[0]
        x = torch.cat([x[:, :1], prefix.unsqueeze(0).expand(x.shape[0], -1, -1),
                       x[:, 1 + L:]], dim=1)
    x = x + sd["text.positional_embedding"][: ids.shape[1]]
    x = _ln(tower(sd, "text", x, cfg, causal=True), sd, "text.ln_final")
    x = x[torch.arange(x.shape[0], device=x.device), ids.argmax(-1)]
    return x @ sd["text.text_projection"]


def image_tokens(sd, cfg: dict, images_u8: torch.Tensor):
    """(B, R, R, 3) uint8 -> (B, 1+N, W) class + patch tokens, position-embedded."""
    p = cfg["vision_patch_size"]
    x = images_u8.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    x = (x - mean) / std
    B, R, _, C = x.shape
    g = R // p
    x = x.reshape(B, g, p, g, p, C).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, p * p * C)
    x = x @ sd["visual.conv1_kernel"]
    cls = sd["visual.class_embedding"].expand(B, 1, -1)
    return torch.cat([cls, x], dim=1) + sd["visual.positional_embedding"]


def image_features(sd, cfg: dict, tokens: torch.Tensor, prefix=None):
    """(B, 1+N, W) tokens -> (B, E) unnormalised features; a VPT `prefix`
    (L, W) is inserted after the class token."""
    if prefix is not None:
        tokens = torch.cat([tokens[:, :1], prefix.unsqueeze(0).expand(tokens.shape[0], -1, -1),
                            tokens[:, 1:]], dim=1)
    x = tower(sd, "visual", _ln(tokens, sd, "visual.ln_pre"), cfg, causal=False)
    return _ln(x[:, 0], sd, "visual.ln_post") @ sd["visual.proj"]


def normalize(x):
    return x / x.norm(dim=-1, keepdim=True)
