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
  Transformer);
- multimodal (UPT): coop and vpt prompts are projected to a shared mixer
  width, mixed by a 1-layer, 1-head transformer whose sequence axis is the 2
  modalities and whose batch axis is the prompt length, projected back, then
  used as the textual and visual prefixes (reference
  models/prompts_models.py:99-152).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from menghini_neurips23_tpu_torch.models.clip import Transformer
from menghini_neurips23_tpu_torch.models.convert import (
    linear_from_flax,
    linear_to_flax,
    transformer_from_flax,
    transformer_to_flax,
)
from menghini_neurips23_tpu_torch.ops.attention import attention_reference


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


# ---------------------------------------------------------------------------
# UPT mixer (trainable; reference models/prompts_models.py:99-146)
# ---------------------------------------------------------------------------
def mixer_attention(qkv: torch.Tensor, mask: Optional[str], heads: int) -> torch.Tensor:
    """The mixer's attention: plain fp32 PyTorch, on every device, by design.
    Its head width is TRANSFORMER_DIM (128), which the attention kernels do
    not take, and its score tensor is (L, 1, 2, 2): there is nothing for a
    kernel to save.  The CLIP towers' attention is unaffected."""
    return attention_reference(qkv.float(), mask, heads)


UPT_LINEARS = ("proj_coop_pre", "proj_coop_post", "proj_vpt_pre", "proj_vpt_post")


class UPTMixer(nn.Module):
    """Projects the coop/vpt prompts to `dim`, mixes them with a 1-layer
    transformer whose sequence axis is the two modalities, projects back.
    Always fp32.

    Requires TEXT_PREFIX_SIZE == VISION_PREFIX_SIZE (the reference stacks the
    two (1, L, dim) projections on the modality axis, reference
    prompts_models.py:138, which implies equal prompt lengths).

    fp16_quirk replicates the reference's fp16 round-trip of the mixer output
    (prompts_models.py:141) for bit-closest reproduction runs; off by
    default."""

    def __init__(self, coop_dim: int, vpt_dim: int, dim: int = 128, layers: int = 1,
                 heads: int = 1, fp16_quirk: bool = False):
        super().__init__()
        self.fp16_quirk = fp16_quirk
        self.proj_coop_pre = nn.Linear(coop_dim, dim)
        self.proj_vpt_pre = nn.Linear(vpt_dim, dim)
        self.transformer = Transformer(dim, layers, heads, torch.float32, mixer_attention)
        self.proj_coop_post = nn.Linear(dim, coop_dim)
        self.proj_vpt_post = nn.Linear(dim, vpt_dim)

    def forward(self, coop: torch.Tensor, vpt: torch.Tensor):
        """(L, coop_dim), (L, vpt_dim) -> mixed (L, coop_dim), (L, vpt_dim)."""
        if coop.shape[0] != vpt.shape[0]:
            raise ValueError(
                f"UPT needs TEXT_PREFIX_SIZE == VISION_PREFIX_SIZE, got {coop.shape[0]} "
                f"and {vpt.shape[0]}"
            )
        # sequence axis = the 2 modality slots, batch axis = prompt positions
        # (the reference's (seq=2, batch=L, dim) call, batch-major here)
        seq = torch.stack([self.proj_coop_pre(coop.float()), self.proj_vpt_pre(vpt.float())],
                          dim=1)
        return self.project_back(self.transformer(seq))

    def project_back(self, out: torch.Tensor):
        """(L, 2, dim) transformer output -> the two mixed prompts, through
        the fp16 round-trip when fp16_quirk is set."""
        if self.fp16_quirk:
            out = out.half().float()
        return self.proj_coop_post(out[:, 0]), self.proj_vpt_post(out[:, 1])


def build_upt_mixer(arch, cfg, state_dict: Mapping[str, torch.Tensor], device) -> UPTMixer:
    """A `UPTMixer` for `arch` and `cfg` (TRANSFORMER_DIM, UPT_FP16_QUIRK)
    holding `state_dict`, on `device`, trainable.  Built without drawing
    from any random generator."""
    with torch.device("meta"):
        mixer = UPTMixer(arch.transformer_width, arch.vision_width, cfg.TRANSFORMER_DIM,
                         fp16_quirk=bool(getattr(cfg, "UPT_FP16_QUIRK", False)))
    mixer = mixer.to_empty(device=device)
    mixer.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32)
                           for k, v in state_dict.items()}, strict=True)
    return mixer.requires_grad_(True)


def mixer_parts(mixer: UPTMixer) -> List[dict]:
    """The mixer's parameters as the first five parts of the reference's
    8-artifact order: [transformer, proj_coop_pre, proj_coop_post,
    proj_vpt_pre, proj_vpt_post], each in the JAX package's flax layout
    (numpy; Dense kernels (in, out))."""
    sd = {k: v.detach().cpu().numpy().copy() for k, v in mixer.state_dict().items()}
    tr = {k[len("transformer."):]: v for k, v in sd.items() if k.startswith("transformer.")}
    return [transformer_to_flax(tr)] + [
        linear_to_flax({"weight": sd[f"{n}.weight"], "bias": sd[f"{n}.bias"]})
        for n in UPT_LINEARS
    ]


def mixer_state_from_parts(parts: Sequence[Mapping]) -> Dict[str, torch.Tensor]:
    """The inverse of `mixer_parts`: five flax-layout parts -> a `UPTMixer`
    state dict."""
    sd = {f"transformer.{k}": v for k, v in transformer_from_flax(parts[0]).items()}
    for name, part in zip(UPT_LINEARS, parts[1:5]):
        for k, v in linear_from_flax(part).items():
            sd[f"{name}.{k}"] = v
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def upt_from_jax_params(tree: Mapping) -> dict:
    """The JAX package's `upt_params` ({"coop", "vpt", "mixer": flax tree,
    optional "deep"}, leaves as numpy) -> this package's UPT prompt:
    {"coop", "vpt", optional "deep": fp32 tensors, "mixer": a `UPTMixer`
    state dict}.  Flax Dense kernels are transposed to nn.Linear weights.
    This is how the tests start both packages from one initial prompt: no
    torch generator reproduces flax's initializers."""
    m = tree["mixer"]["params"] if "params" in tree["mixer"] else tree["mixer"]
    out = {
        "coop": torch.from_numpy(np.array(tree["coop"], np.float32)),
        "vpt": torch.from_numpy(np.array(tree["vpt"], np.float32)),
        "mixer": mixer_state_from_parts([m["transformer"]] + [m[n] for n in UPT_LINEARS]),
    }
    if tree.get("deep") is not None:
        out["deep"] = torch.from_numpy(np.array(tree["deep"], np.float32))
    return out


def _lecun_normal(generator: torch.Generator, fan_in: int, shape) -> torch.Tensor:
    """flax's default Dense kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in (the truncation's 0.8796 std
    corrected), drawn from `generator`."""
    t = torch.empty(*shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * (fan_in**-0.5 / 0.87962566103423978)


def init_upt_params(generator: torch.Generator, cfg, arch) -> dict:
    """A fresh UPT prompt in `upt_from_jax_params`'s form, drawn from
    `generator` in this order: coop (TEXT_PREFIX_SIZE, transformer_width),
    vpt (VISION_PREFIX_SIZE, vision_width), the mixer's weights (the JAX
    package's initializers' distributions: flax Dense kernels truncated
    lecun-normal, the attention in-projection normal(dim^-0.5), zero biases,
    unit LayerNorms), then with VPT_DEEP the deep prompts (vision_layers-1,
    VISION_PREFIX_SIZE, vision_width).  Not the JAX package's values: that
    package draws from split jax.random keys."""
    if cfg.TEXT_PREFIX_SIZE != cfg.VISION_PREFIX_SIZE:
        raise ValueError(
            f"UPT needs TEXT_PREFIX_SIZE == VISION_PREFIX_SIZE, got {cfg.TEXT_PREFIX_SIZE} "
            f"and {cfg.VISION_PREFIX_SIZE}"
        )
    init = (cfg.VIS_PREFIX_INIT, cfg.MEAN_INIT, cfg.VAR_INIT)
    out = {
        "coop": init_prefix(generator, cfg.TEXT_PREFIX_SIZE, arch.transformer_width, *init),
        "vpt": init_prefix(generator, cfg.VISION_PREFIX_SIZE, arch.vision_width, *init),
    }
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in UPTMixer(
            arch.transformer_width, arch.vision_width, cfg.TRANSFORMER_DIM).state_dict().items()}
    dim = cfg.TRANSFORMER_DIM
    sd = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if ".ln_" in name and leaf == "weight":
            sd[name] = torch.ones(shape)
        elif leaf in ("bias", "in_proj_bias"):
            sd[name] = torch.zeros(shape)
        elif leaf == "in_proj_weight":
            sd[name] = torch.randn(*shape, generator=generator) * dim**-0.5
        else:  # an nn.Linear weight (out, in)
            sd[name] = _lecun_normal(generator, shape[1], shape)
    out["mixer"] = sd
    if cfg.VPT_DEEP:
        out["deep"] = init_deep_prefix(
            generator, arch.vision_layers - 1, cfg.VISION_PREFIX_SIZE, arch.vision_width, *init
        )
    return out


def upt_features(model, mixer: UPTMixer, prompt: Mapping, token_ids: torch.Tensor,
                 images: Optional[torch.Tensor] = None,
                 tokens: Optional[torch.Tensor] = None):
    """UPT forward: mix the prompts, then run both prompted towers.

    :param prompt: {"coop" (L, transformer_width), "vpt" (L, vision_width),
        optional "deep" (D, L, vision_width)}
    :returns: (text features (C, E), image features (B, E)), unnormalized
    """
    coop_o, vpt_o = mixer(prompt["coop"], prompt["vpt"])
    text = coop_text_features(model, coop_o, token_ids)
    image = vpt_image_features(model, vpt_o, images=images, tokens=tokens,
                               deep_prompts=prompt.get("deep"))
    return text, image
