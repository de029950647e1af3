"""CLIP checkpoints -> this package's state dict (models/clip.py names).

Accepts:
- an OpenAI CLIP TorchScript archive or a plain torch state_dict (.pt/.pth/.bin)
  in OpenAI key layout;
- the JAX package's .npz export (flat '/'-joined flax paths);
- the JAX package's flax parameter tree as numpy arrays (`from_jax_params`),
  which is how the tests carry one set of weights across the two packages.

Weights are returned fp32 whatever the source dtype (the OpenAI GPU
checkpoints are fp16); the compute dtype is chosen when the model is built.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from menghini_neurips23_tpu_torch.models.configs import ARCHS, CLIPArch

StateDict = Dict[str, torch.Tensor]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def infer_arch(sd: Mapping[str, np.ndarray]) -> CLIPArch:
    """Infer the architecture from OpenAI state_dict shapes."""
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_patch = sd["visual.conv1.weight"].shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    image_resolution = grid * vision_patch
    vision_layers = len(
        {k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")}
    )
    embed_dim = sd["text_projection"].shape[1]
    context_length = sd["positional_embedding"].shape[0]
    vocab_size = sd["token_embedding.weight"].shape[0]
    transformer_width = sd["ln_final.weight"].shape[0]
    transformer_layers = len(
        {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}
    )
    for arch in ARCHS.values():
        if (
            arch.vision_width == vision_width
            and arch.vision_patch_size == vision_patch
            and arch.embed_dim == embed_dim
            and arch.vision_layers == vision_layers
        ):
            return arch
    return CLIPArch(
        name=f"custom-{vision_width}x{vision_layers}p{vision_patch}",
        embed_dim=embed_dim,
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch,
        context_length=context_length,
        vocab_size=vocab_size,
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=transformer_layers,
    )


def convert_state_dict(sd: Mapping[str, np.ndarray]) -> Tuple[CLIPArch, StateDict]:
    """OpenAI CLIP state_dict (numpy) -> (arch, this package's state dict).

    Every key keeps its OpenAI name, the text tower's under `text.`, except
    conv1: `visual.conv1.weight` (W, 3, P, P) becomes the patch-matmul kernel
    `visual.conv1_kernel` (P*P*3, W) in (p_h, p_w, channel) row order."""
    arch = infer_arch(sd)
    out: StateDict = {}
    for k, v in sd.items():
        if k == "visual.conv1.weight":
            conv1 = np.asarray(v, np.float32)
            O, C, P, _ = conv1.shape
            out["visual.conv1_kernel"] = _tensor(conv1.transpose(2, 3, 1, 0).reshape(P * P * C, O))
        elif k.startswith("visual.") or k == "logit_scale":
            out[k] = _tensor(v)
        elif k.split(".")[0] in (
            "token_embedding", "positional_embedding", "transformer", "ln_final",
            "text_projection",
        ):
            out[f"text.{k}"] = _tensor(v)
        # other keys of the OpenAI archive (input_resolution, context_length,
        # vocab_size) are metadata, not weights
    return arch, out


def _jax_block(blk: Mapping, prefix: str, out: StateDict) -> None:
    """One flax ResidualAttentionBlock subtree -> OpenAI-named torch entries.
    Flax Dense kernels are (in, out); torch Linear weights are (out, in)."""
    for ln in ("ln_1", "ln_2"):
        out[f"{prefix}.{ln}.weight"] = _tensor(blk[ln]["scale"])
        out[f"{prefix}.{ln}.bias"] = _tensor(blk[ln]["bias"])
    attn = blk["attn"]
    out[f"{prefix}.attn.in_proj_weight"] = _tensor(np.asarray(attn["in_proj_kernel"]).T)
    out[f"{prefix}.attn.in_proj_bias"] = _tensor(attn["in_proj_bias"])
    out[f"{prefix}.attn.out_proj.weight"] = _tensor(np.asarray(attn["out_proj"]["kernel"]).T)
    out[f"{prefix}.attn.out_proj.bias"] = _tensor(attn["out_proj"]["bias"])
    for name in ("c_fc", "c_proj"):
        out[f"{prefix}.mlp.{name}.weight"] = _tensor(np.asarray(blk[name]["kernel"]).T)
        out[f"{prefix}.mlp.{name}.bias"] = _tensor(blk[name]["bias"])


def from_jax_params(tree: Mapping) -> StateDict:
    """The JAX package's flax parameter tree ({"params": {"visual", "text",
    "logit_scale"}}, leaves as numpy arrays) -> this package's state dict.

    The inverse of that package's `convert_state_dict`, composed with this
    package's: flax kernels (in, out) become torch weights (out, in),
    LayerNorm `scale` becomes `weight`, `resblocks_i` becomes `resblocks.i`.
    `conv1_kernel` keeps its (P*P*3, W) matmul layout."""
    p = tree["params"] if "params" in tree else tree
    v, t = p["visual"], p["text"]
    out: StateDict = {}
    for name in ("conv1_kernel", "class_embedding", "positional_embedding", "proj"):
        out[f"visual.{name}"] = _tensor(v[name])
    for ln in ("ln_pre", "ln_post"):
        out[f"visual.{ln}.weight"] = _tensor(v[ln]["scale"])
        out[f"visual.{ln}.bias"] = _tensor(v[ln]["bias"])
    for i in range(len(v["transformer"])):
        _jax_block(v["transformer"][f"resblocks_{i}"], f"visual.transformer.resblocks.{i}", out)
    out["text.token_embedding.weight"] = _tensor(t["token_embedding"]["embedding"])
    out["text.positional_embedding"] = _tensor(t["positional_embedding"])
    out["text.ln_final.weight"] = _tensor(t["ln_final"]["scale"])
    out["text.ln_final.bias"] = _tensor(t["ln_final"]["bias"])
    out["text.text_projection"] = _tensor(t["text_projection"])
    for i in range(len(t["transformer"])):
        _jax_block(t["transformer"][f"resblocks_{i}"], f"text.transformer.resblocks.{i}", out)
    out["logit_scale"] = _tensor(p["logit_scale"])
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load an OpenAI CLIP .pt (TorchScript archive or state_dict) as numpy."""
    try:
        model = torch.jit.load(path, map_location="cpu")
        sd = model.state_dict()
    except RuntimeError:  # not a TorchScript archive: a pickled state dict
        sd = torch.load(path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return {k: v.detach().cpu().float().numpy() for k, v in sd.items() if torch.is_tensor(v)}


def load_npz(path: str) -> dict:
    """Load a flat .npz (the JAX package's export) back into a nested tree."""
    flat = dict(np.load(path))
    tree: dict = {}
    for name, arr in flat.items():
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def load_clip(path: str) -> Tuple[CLIPArch, StateDict]:
    """Load CLIP weights from .pt/.pth/.bin/.npz -> (arch, state dict)."""
    if path.endswith(".npz"):
        tree = load_npz(path)
        sd_like = tree["params"]
        arch = None
        for a in ARCHS.values():
            if sd_like["visual"]["proj"].shape == (a.vision_width, a.embed_dim) and len(
                sd_like["visual"]["transformer"]
            ) == a.vision_layers:
                arch = a
                break
        if arch is None:
            raise ValueError(f"Cannot infer architecture from {path}")
        return arch, from_jax_params(tree)
    if path.endswith((".pt", ".pth", ".bin")):
        sd = load_torch_checkpoint(path)
        if any(k.startswith(("text_model.", "vision_model.")) for k in sd):
            raise ValueError(
                f"{path} holds a HuggingFace-layout CLIP; this package reads OpenAI-layout "
                "checkpoints and the JAX package's .npz export"
            )
        return convert_state_dict(sd)
    raise ValueError(f"Unsupported checkpoint format: {path}")
