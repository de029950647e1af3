"""CLIP checkpoints -> this package's state dict (models/clip.py names).

Accepts:
- an OpenAI CLIP TorchScript archive or a plain torch state_dict (.pt/.pth/.bin)
  in OpenAI key layout, or a HuggingFace `CLIPModel` state dict (separate
  q/k/v projections; `convert_hf_state_dict`);
- the JAX package's .npz export (flat '/'-joined flax paths);
- the JAX package's flax parameter tree as numpy arrays (`from_jax_params`),
  which is how the tests carry one set of weights across the two packages.

`to_jax_params` and `save_npz` write that tree back out, and the module is
the conversion tool the JAX package's is:

    python -m menghini_neurips23_tpu_torch.models.convert in.pt out.npz

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


# One flax ResidualAttentionBlock leaf <-> its OpenAI/torch state-dict suffix
# within `resblocks.i`: (flax path, torch suffix, transpose?).  Flax Dense
# kernels are (in, out); torch Linear weights are (out, in).
BLOCK_KEYS = (
    (("ln_1", "scale"), "ln_1.weight", False),
    (("ln_1", "bias"), "ln_1.bias", False),
    (("ln_2", "scale"), "ln_2.weight", False),
    (("ln_2", "bias"), "ln_2.bias", False),
    (("attn", "in_proj_kernel"), "attn.in_proj_weight", True),
    (("attn", "in_proj_bias"), "attn.in_proj_bias", False),
    (("attn", "out_proj", "kernel"), "attn.out_proj.weight", True),
    (("attn", "out_proj", "bias"), "attn.out_proj.bias", False),
    (("c_fc", "kernel"), "mlp.c_fc.weight", True),
    (("c_fc", "bias"), "mlp.c_fc.bias", False),
    (("c_proj", "kernel"), "mlp.c_proj.weight", True),
    (("c_proj", "bias"), "mlp.c_proj.bias", False),
)


def _leaf(tree: Mapping, path) -> np.ndarray:
    for k in path:
        tree = tree[k]
    return np.asarray(tree, np.float32)


def _jax_block(blk: Mapping, prefix: str, out: StateDict) -> None:
    """One flax ResidualAttentionBlock subtree -> OpenAI-named torch entries."""
    for path, suffix, transpose in BLOCK_KEYS:
        arr = _leaf(blk, path)
        out[f"{prefix}.{suffix}"] = _tensor(arr.T if transpose else arr)


def transformer_from_flax(tree: Mapping) -> Dict[str, np.ndarray]:
    """A flax Transformer subtree ({"resblocks_i": block}) -> the torch
    `Transformer.state_dict()` layout ("resblocks.i.<suffix>"), as numpy."""
    out: Dict[str, np.ndarray] = {}
    for name, blk in tree.items():
        idx = name.split("_", 1)[1]
        for path, suffix, transpose in BLOCK_KEYS:
            arr = _leaf(blk, path)
            out[f"resblocks.{idx}.{suffix}"] = np.ascontiguousarray(arr.T if transpose else arr)
    return out


def transformer_to_flax(sd: Mapping[str, np.ndarray]) -> dict:
    """The inverse of `transformer_from_flax` (numpy leaves)."""
    out: dict = {}
    for idx in sorted({k.split(".")[1] for k in sd}, key=int):
        blk: dict = {}
        for path, suffix, transpose in BLOCK_KEYS:
            arr = np.asarray(sd[f"resblocks.{idx}.{suffix}"], np.float32)
            node = blk
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = np.ascontiguousarray(arr.T if transpose else arr)
        out[f"resblocks_{idx}"] = blk
    return out


def linear_from_flax(dense: Mapping) -> Dict[str, np.ndarray]:
    """flax Dense {kernel (in, out), bias} -> nn.Linear {weight (out, in), bias}."""
    return {"weight": np.ascontiguousarray(_leaf(dense, ("kernel",)).T),
            "bias": _leaf(dense, ("bias",))}


def linear_to_flax(sd: Mapping) -> Dict[str, np.ndarray]:
    return {"kernel": np.ascontiguousarray(np.asarray(sd["weight"], np.float32).T),
            "bias": np.asarray(sd["bias"], np.float32)}


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


def is_hf_state_dict(sd: Mapping[str, np.ndarray]) -> bool:
    """Whether `sd` is in HuggingFace `CLIPModel` naming."""
    return any(k.startswith(("text_model.", "vision_model.")) for k in sd)


def convert_hf_state_dict(sd: Mapping[str, np.ndarray]) -> Tuple[CLIPArch, StateDict]:
    """HuggingFace CLIPModel state dict -> (arch, this package's state dict).

    HuggingFace keeps q, k and v as three projections and the two tower
    projections as Linear weights; they are reassembled into the fused
    OpenAI layout, which `convert_state_dict` then maps."""
    def f32(k):
        return np.asarray(sd[k], np.float32)

    out: Dict[str, np.ndarray] = {}

    def copy_blocks(hf_prefix: str, oa_prefix: str) -> None:
        n = len({k.split(".")[3] for k in sd if k.startswith(f"{hf_prefix}.layers.")})
        for i in range(n):
            h, o = f"{hf_prefix}.layers.{i}", f"{oa_prefix}.resblocks.{i}"
            for ln in ("1", "2"):
                out[f"{o}.ln_{ln}.weight"] = f32(f"{h}.layer_norm{ln}.weight")
                out[f"{o}.ln_{ln}.bias"] = f32(f"{h}.layer_norm{ln}.bias")
            for leaf in ("weight", "bias"):
                out[f"{o}.attn.in_proj_{leaf}"] = np.concatenate(
                    [f32(f"{h}.self_attn.{p}_proj.{leaf}") for p in ("q", "k", "v")])
                out[f"{o}.attn.out_proj.{leaf}"] = f32(f"{h}.self_attn.out_proj.{leaf}")
                out[f"{o}.mlp.c_fc.{leaf}"] = f32(f"{h}.mlp.fc1.{leaf}")
                out[f"{o}.mlp.c_proj.{leaf}"] = f32(f"{h}.mlp.fc2.{leaf}")

    copy_blocks("text_model.encoder", "transformer")
    copy_blocks("vision_model.encoder", "visual.transformer")
    out["token_embedding.weight"] = f32("text_model.embeddings.token_embedding.weight")
    out["positional_embedding"] = f32("text_model.embeddings.position_embedding.weight")
    out["ln_final.weight"] = f32("text_model.final_layer_norm.weight")
    out["ln_final.bias"] = f32("text_model.final_layer_norm.bias")
    # the projections are Linear weights (E, width), applied as x @ W.T
    out["text_projection"] = f32("text_projection.weight").T
    out["visual.proj"] = f32("visual_projection.weight").T
    out["visual.conv1.weight"] = f32("vision_model.embeddings.patch_embedding.weight")
    out["visual.class_embedding"] = f32("vision_model.embeddings.class_embedding")
    out["visual.positional_embedding"] = f32("vision_model.embeddings.position_embedding.weight")
    out["visual.ln_pre.weight"] = f32("vision_model.pre_layrnorm.weight")
    out["visual.ln_pre.bias"] = f32("vision_model.pre_layrnorm.bias")
    out["visual.ln_post.weight"] = f32("vision_model.post_layernorm.weight")
    out["visual.ln_post.bias"] = f32("vision_model.post_layernorm.bias")
    out["logit_scale"] = f32("logit_scale")
    return convert_state_dict(out)


def to_jax_params(sd: Mapping[str, object]) -> dict:
    """This package's state dict -> the JAX package's flax parameter tree
    ({"params": {"visual", "text", "logit_scale"}}, numpy fp32 leaves): the
    inverse of `from_jax_params`."""
    def f32(k):
        v = sd[k]
        return np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float32)

    def ln(prefix):
        return {"scale": f32(f"{prefix}.weight"), "bias": f32(f"{prefix}.bias")}

    def tower(prefix):
        start = f"{prefix}.transformer."
        return transformer_to_flax({k[len(start):]: f32(k) for k in sd if k.startswith(start)})

    visual = {name: f32(f"visual.{name}")
              for name in ("conv1_kernel", "class_embedding", "positional_embedding", "proj")}
    visual.update(ln_pre=ln("visual.ln_pre"), ln_post=ln("visual.ln_post"),
                  transformer=tower("visual"))
    text = {"token_embedding": {"embedding": f32("text.token_embedding.weight")},
            "positional_embedding": f32("text.positional_embedding"),
            "ln_final": ln("text.ln_final"), "text_projection": f32("text.text_projection"),
            "transformer": tower("text")}
    return {"params": {"visual": visual, "text": text, "logit_scale": f32("logit_scale")}}


def save_npz(params: Mapping, path: str) -> None:
    """Write a nested parameter tree as a flat .npz ('/'-joined paths), the
    JAX package's export format (`load_npz` reads it back)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, name)
            else:
                flat[name] = np.asarray(v)

    walk(params, "")
    np.savez(path, **flat)


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
        return convert_hf_state_dict(sd) if is_hf_state_dict(sd) else convert_state_dict(sd)
    raise ValueError(f"Unsupported checkpoint format: {path}")


def main(argv=None) -> int:
    """Convert a torch CLIP checkpoint (OpenAI or HuggingFace layout) to the
    JAX package's .npz: `in.pt out.npz`."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m menghini_neurips23_tpu_torch.models.convert in.pt out.npz",
              file=sys.stderr)
        return 2
    src, dst = argv
    sd = load_torch_checkpoint(src)
    arch, ours = convert_hf_state_dict(sd) if is_hf_state_dict(sd) else convert_state_dict(sd)
    save_npz(to_jax_params(ours), dst)
    print(f"converted {src} ({arch.name}) -> {dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
