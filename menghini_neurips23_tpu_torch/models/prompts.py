"""CoOp prompt helpers: the prefix init, the 'X X .. X <class>' token frame,
the prompted text forward, and context truncation.

Prompt semantics match the reference (models/clip_encoders.py:54-67): class
prompts are tokenized as "X X ... X <class>" and the learnable prefix
overwrites token-embedding positions 1..L.  The VPT and UPT
parameterizations arrive with their slices.
"""

from __future__ import annotations

import numpy as np
import torch


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
    dev = generator.device
    if init == "normal":
        return mean + std * torch.randn(length, dim, generator=generator, device=dev)
    if init == "uniform":
        u = torch.rand(length, dim, generator=generator, device=dev)
        return -std + 2 * std * u
    raise ValueError(f"Unknown prefix init {init!r}")


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
