"""Prompt helpers: the prefix inits, the CoOp 'X X .. X <class>' token frame,
the prompted text and vision forwards, and context truncation.

Prompt semantics match the reference:
- textual (CoOp): class prompts are tokenized as "X X ... X <class>" and the
  learnable prefix overwrites token-embedding positions 1..L
  (reference models/clip_encoders.py:54-67);
- visual (VPT): the learnable prefix is concatenated between the CLS token
  and the patch tokens *after* positional embedding, so prompt tokens carry
  no position embedding (reference models/clip_encoders.py:146-155); deep
  VPT replaces the prompt slots before each later layer (models/clip.py
  Transformer).
The UPT parameterization arrives with its slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _draw(generator: torch.Generator, shape: Sequence[int], init: str, mean: float,
          std: float) -> torch.Tensor:
    dev = generator.device
    if init == "normal":
        return mean + std * torch.randn(*shape, generator=generator, device=dev)
    if init == "uniform":
        u = torch.rand(*shape, generator=generator, device=dev)
        return -std + 2 * std * u
    raise ValueError(f"Unknown prefix init {init!r}")


def init_prefix(
    generator: torch.Generator,
    length: int,
    dim: int,
    init: str = "normal",
    mean: float = 0.0,
    std: float = 0.02,
) -> torch.Tensor:
    """(length, dim) fp32 prefix drawn from `generator`, on its device
    (reference: normal(MEAN_INIT, VAR_INIT), config VIS_PREFIX_INIT).  A
    torch.Generator does not reproduce the JAX package's jax.random draw."""
    return _draw(generator, (length, dim), init, mean, std)


def init_deep_prefix(
    generator: torch.Generator,
    depth: int,
    length: int,
    dim: int,
    init: str = "normal",
    mean: float = 0.0,
    std: float = 0.02,
) -> torch.Tensor:
    """Per-layer deep-VPT prompts (depth, length, dim), fp32, drawn from
    `generator` as `init_prefix` draws."""
    return _draw(generator, (depth, length, dim), init, mean, std)


def build_prompt_token_ids(tokenizer, classes, prefix_len: int) -> np.ndarray:
    """Token ids for 'X X ... X <class>' prompts (reference clip_encoders.py:54-60).

    One 'X' placeholder per prefix position; the placeholder embeddings are
    overwritten by the learnable prefix at positions 1..prefix_len.
    """
    prompts = [
        " ".join([" ".join(["X"] * prefix_len).strip(), " ".join(c.split("_"))])
        for c in classes
    ]
    return tokenizer.tokenize(prompts)


def truncate_context(token_ids: np.ndarray, multiple: int = 8) -> np.ndarray:
    """Drop all-padding context positions after the batch's last EOT token.

    EXACT for CLIP's text tower: attention is causal, so no kept position
    attends to a dropped one, and the dropped rows are pure zero-padding the
    reference computes anyway (torch CLIP always runs all 77 positions,
    reference via clip.encode_text).  With a 16-token prefix and short class
    names this cuts the per-step text tower ~3x (T 77 -> ~24).  The kept
    length is rounded up to `multiple`.  Host-side (NumPy).
    """
    ids = np.asarray(token_ids)
    eot = int(ids.argmax(axis=-1).max())
    t_eff = min(ids.shape[1], -(-(eot + 1) // multiple) * multiple)
    return ids[:, :t_eff]


def coop_text_features(model, prefix: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Textual-prompt text features, differentiable in `prefix`.

    :param model: a models.clip.CLIP
    :param prefix: (L, transformer_width) learnable prefix
    :param token_ids: (C, T<=77) long ids of 'X X .. X <class>' prompts
        (possibly context-truncated after the last EOT; see truncate_context)
    :returns: (C, embed_dim) *unnormalized* text features
    """
    emb = model.text_embed_ids(token_ids)
    C, L = emb.shape[0], prefix.shape[0]
    # splice the prefix into positions 1..L (after <sot>), broadcast over
    # classes (reference clip_encoders.py:67); built out of place, so the
    # embedding table's output is never written into
    pfx = prefix.to(emb.dtype).unsqueeze(0).expand(C, -1, -1)
    emb = torch.cat([emb[:, :1], pfx, emb[:, 1 + L :]], dim=1)
    eot = token_ids.argmax(dim=-1)
    return model.text_encode_embeddings(emb, eot)


def vision_tokens_with_prefix(tokens: torch.Tensor, prefix: torch.Tensor) -> torch.Tensor:
    """Insert the visual prefix between CLS and patch tokens, out of place.

    :param tokens: (B, 1+N, width) pos-embedded CLS+patch tokens
    :param prefix: (L, width), cast to the tokens' dtype
    :returns: (B, 1+L+N, width)
    """
    pfx = prefix.to(tokens.dtype).unsqueeze(0).expand(tokens.shape[0], -1, -1)
    return torch.cat([tokens[:, :1], pfx, tokens[:, 1:]], dim=1)


def vpt_image_features(
    model,
    prefix: torch.Tensor,
    images: Optional[torch.Tensor] = None,
    tokens: Optional[torch.Tensor] = None,
    deep_prompts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Visual-prompt image features, differentiable in the prompts.

    Takes raw images or the precomputed pos-embedded CLS+patch tokens (the
    patchify + position stage is prompt-independent, so callers cache it per
    image).  deep_prompts (D, L, width) enables deep VPT.

    :param model: a models.clip.CLIP
    :returns: (B, embed_dim) *unnormalized* image features
    """
    if tokens is None:
        tokens = model.vision_embed(images)
    x = vision_tokens_with_prefix(tokens, prefix)
    return model.vision_encode_tokens(x, deep_prompts)
