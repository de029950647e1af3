"""Multimodal prompt tuning (UPT) - reference methods/*/multimodal_prompt.py
and multimodal_fpl.py, all three paradigms.

The trainable leaves are the coop prompt (TEXT_PREFIX_SIZE,
transformer_width), the vpt prompt (VISION_PREFIX_SIZE, vision_width),
with VPT_DEEP the deep prompts, and the mixer's parameters (a 1-layer,
1-head fp32 transformer at TRANSFORMER_DIM with its four projections;
reference models/prompts_models.py:99-119).  Each step mixes the two
prompts, then runs both prompted towers: the text tower over the C class
prompts at the full 77-token context (causal), and the vision tower over
the cached pos-embedded patch tokens of the batch with the mixed vpt prompt
inserted after CLS.  On the card every layer of both towers runs K1 forward
and K2 backward (ops/attention.py); the mixer's own attention is plain fp32
PyTorch by design (models/prompts.py `mixer_attention`).  The kernels take
a prompted vision sequence of any length (ViT-L/14's 1 + 256 + 4 = 261).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from menghini_neurips23_tpu_torch.models.prompts import (
    build_prompt_token_ids,
    build_upt_mixer,
    coop_text_features,
    init_upt_params,
    mixer_parts,
    mixer_state_from_parts,
    upt_features,
    vpt_image_features,
)
from menghini_neurips23_tpu_torch.training.strategy import TrainingStrategy


class MultimodalStrategy(TrainingStrategy):
    MODALITY = "multi"
    MODALITY_NAME = "UPT"

    def initialize_prompts_parameters(self):
        """A fresh UPT prompt (models/prompts.init_upt_params) from a CPU
        torch.Generator seeded with OPTIM_SEED * 1000 + reinit (the JAX
        package's key; a generator reproduces neither its jax.random draws
        nor flax's initializers)."""
        cfg = self.config
        self._reinit = getattr(self, "_reinit", -1) + 1
        gen = torch.Generator().manual_seed(cfg.OPTIM_SEED * 1000 + self._reinit)
        self._set_prompt(init_upt_params(gen, cfg, self.runtime.arch))

    def _set_prompt(self, prompt):
        """prompt: {"coop", "vpt", optional "deep", "mixer": state dict}.
        Copies onto the device as fp32 leaves that require grad (the
        optimizer updates them in place)."""
        self.prompt = {
            k: torch.tensor(np.asarray(v, np.float32), device=self.device).requires_grad_(True)
            for k, v in prompt.items() if k != "mixer"
        }
        self.mixer = build_upt_mixer(self.runtime.arch, self.config, prompt["mixer"],
                                     self.device)
        self._init_opt_state()
        self._bump_prompt_version()

    _FUSED_VAL_ROWS = 256  # the vision tower over the validation set, as _predict_logits

    def _get_prompt_tree(self):
        """coop, vpt (and deep), then the mixer's parameters as "mixer.<name>"."""
        return {**self.prompt,
                **{f"mixer.{k}": v for k, v in self.mixer.named_parameters()}}

    def _set_prompt_tree(self, tree):
        prompt = {k: v for k, v in tree.items() if not k.startswith("mixer.")}
        prompt["mixer"] = {k[len("mixer."):]: v for k, v in tree.items()
                           if k.startswith("mixer.")}
        self._set_prompt(prompt)

    @staticmethod
    def _normalized(x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x / x.norm(dim=-1, keepdim=True)

    def _logits_fn(self):
        model, mixer, norm = self.runtime.model, self.mixer, self._normalized

        def fn(tree, token_ids, tokens):
            # the mixer's structure with the tree's parameters
            params = {k[len("mixer."):]: v for k, v in tree.items() if k.startswith("mixer.")}

            def mix(coop, vpt):
                return torch.func.functional_call(mixer, params, (coop, vpt))

            tf, img = upt_features(model, mix, tree, token_ids, tokens=tokens)
            return torch.exp(model.logit_scale) * norm(img) @ norm(tf).T

        return fn

    # ------------------------------------------------------------ features
    def _encode_paths(self, paths: Sequence[str]) -> np.ndarray:
        return self.runtime.vision_tokens_from_files(paths, transform=self._active_transform)

    def _feature_item_nbytes(self) -> int:
        a = self.runtime.arch
        return (a.num_patches + 1) * a.vision_width * 4

    def _train_text_class_ids(self, class_list: Sequence[str]) -> np.ndarray:
        """Token ids of the 'X X .. X <class>' prompts at the full context.
        TEXT_TRUNCATE applies to the textual modality only, as in the JAX
        package (training/multimodal.py:88-104); under causal attention
        truncation would be exact, but the shapes stay the JAX package's."""
        return self._memoized_token_ids(
            class_list,
            lambda: build_prompt_token_ids(
                self.runtime.tokenizer, class_list, self.config.TEXT_PREFIX_SIZE
            ),
        )

    # ----------------------------------------------------------- inference
    def _predict_logits(self, paths, class_list, batch: int = 256):
        """(N, C) host fp32 logits under the current prompt.

        Memoized on (prompt version, paths, class list): finish_workflow's
        back-to-back test_predictions + evaluation over the same test set run
        the prompted towers once.  Every prompt change bumps the version (the
        optimizer's in-place steps included); an active user transform, which
        may be stochastic, never takes the memo."""
        key = (self._prompt_version, tuple(paths), tuple(class_list))
        memo = getattr(self, "_logits_memo", None)
        if memo is not None and memo[0] == key and self._active_transform is None:
            return memo[1]
        model, out = self.runtime.model, []
        with torch.no_grad():
            # the mixer and the text tower once, the vision tower per batch
            coop_o, vpt_o = self.mixer(self.prompt["coop"], self.prompt["vpt"])
            tf = self._normalized(coop_text_features(
                model, coop_o, self._class_context(class_list))).cpu().numpy()
            for s in range(0, len(paths), batch):
                toks = self._features_for_paths(paths[s : s + batch], cache=False)
                toks = torch.from_numpy(np.ascontiguousarray(toks, np.float32)).to(self.device)
                img = self._normalized(vpt_image_features(
                    model, vpt_o, tokens=toks, deep_prompts=self.prompt.get("deep")))
                out.append(self.runtime.logit_scale * img.cpu().numpy() @ tf.T)
        logits = np.concatenate(out) if out else np.empty((0, len(class_list)))
        self._logits_memo = (key, logits)  # keep the latest only
        return logits

    # ------------------------------------------------------------- persist
    def epoch_parameters(self):
        """The reference's 8-artifact order (utils/compute_metrics.py:119-143):
        [transformer, proj_coop_pre, proj_coop_post, proj_vpt_pre,
        proj_vpt_post, coop_embeddings, deep_vpt, vpt_embeddings]; the mixer
        parts in the JAX package's flax layout (numpy), deep None without
        VPT_DEEP."""
        p = {k: v.detach().cpu().numpy().copy() for k, v in self.prompt.items()}
        return mixer_parts(self.mixer) + [p["coop"], p.get("deep"), p["vpt"]]

    def load_parameters(self, params):
        def unbatch(p):
            # reference-produced artifacts carry the batched (1, L, W)
            # embeddings its UPTModel holds (prompts_models.py:88-95)
            p = np.asarray(p)
            return p[0] if p.ndim == 3 and p.shape[0] == 1 else p

        prompt = {
            "coop": unbatch(params[5]),
            "vpt": unbatch(params[7]),
            "mixer": mixer_state_from_parts(params[:5]),
        }
        if params[6] is not None:
            prompt["deep"] = np.asarray(params[6])
        self._set_prompt(prompt)
