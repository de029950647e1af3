"""CLIP architecture definitions.

Covers the two backbones the reference uses (reference scripts/run_clip.sh:4:
ViT-B/32 and ViT-L/14) plus a tiny architecture for fast CPU tests.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CLIPArch:
    name: str
    embed_dim: int
    image_resolution: int
    vision_layers: int
    vision_width: int
    vision_patch_size: int
    context_length: int
    vocab_size: int
    transformer_width: int
    transformer_heads: int
    transformer_layers: int

    @property
    def vision_heads(self) -> int:
        return max(1, self.vision_width // 64)

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


VIT_B32 = CLIPArch(
    name="ViT-B/32",
    embed_dim=512,
    image_resolution=224,
    vision_layers=12,
    vision_width=768,
    vision_patch_size=32,
    context_length=77,
    vocab_size=49408,
    transformer_width=512,
    transformer_heads=8,
    transformer_layers=12,
)

VIT_L14 = CLIPArch(
    name="ViT-L/14",
    embed_dim=768,
    image_resolution=224,
    vision_layers=24,
    vision_width=1024,
    vision_patch_size=14,
    context_length=77,
    vocab_size=49408,
    transformer_width=768,
    transformer_heads=12,
    transformer_layers=12,
)

# Tiny architecture for CPU unit tests. vocab_size=514 matches the tokenizer's
# byte-level fallback vocabulary so tests run without the BPE merges file.
TINY_TEST = CLIPArch(
    name="tiny-test",
    embed_dim=16,
    image_resolution=32,
    vision_layers=2,
    vision_width=32,
    vision_patch_size=16,
    context_length=77,
    vocab_size=514,
    transformer_width=32,
    transformer_heads=2,
    transformer_layers=2,
)

ARCHS = {a.name: a for a in (VIT_B32, VIT_L14, TINY_TEST)}


def get_arch(name: str) -> CLIPArch:
    if name not in ARCHS:
        raise KeyError(f"Unknown CLIP architecture {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
