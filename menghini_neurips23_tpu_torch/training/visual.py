"""Visual prompt tuning (VPT) - reference methods/*/visual_prompt.py and
visual_fpl.py, all three paradigms.

Text features are frozen (template prompts through the frozen text tower) and
computed once per class list (the reference recomputes them every epoch,
visual_prompt.py:111-118).  The patchify + position stage of the vision tower
is prompt-independent and cached per image ((1+N, width) fp32, 153.6 KB at
ViT-B/32), so each step runs only ln_pre -> transformer -> ln_post -> proj
over (B, 1+L+N, width), with the gradient flowing to the (L, width) prefix
and, with VPT_DEEP, to the (vision_layers-1, L, width) deep prompts.  On the
card every vision layer's attention runs K1 forward and K2 backward
(ops/attention.py).  K2 takes T <= 128, so a prompted sequence longer than
that (ViT-L/14: 1 + 256 + 16 = 273) is refused when the strategy is built.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from menghini_neurips23_tpu_torch.models.prompts import (
    init_deep_prefix,
    init_prefix,
    vpt_image_features,
)
from menghini_neurips23_tpu_torch.ops.attention import BWD_MAX_SEQ
from menghini_neurips23_tpu_torch.training.strategy import TrainingStrategy


class VisualStrategy(TrainingStrategy):
    MODALITY = "image"

    def initialize_prompts_parameters(self):
        """A fresh prompt: `prefix` (PREFIX_SIZE, vision_width) and, with
        VPT_DEEP, `deep` (vision_layers-1, PREFIX_SIZE, vision_width), fp32
        leaves that require grad, on the runtime's device.  Both are drawn, in
        that order, from one CPU torch.Generator seeded with
        OPTIM_SEED * 1000 + reinit (the JAX package splits that key into two
        jax.random keys; a generator reproduces neither draw)."""
        cfg = self.config
        arch = self.runtime.arch
        self._refuse_long_sequences()
        self._reinit = getattr(self, "_reinit", -1) + 1
        gen = torch.Generator().manual_seed(cfg.OPTIM_SEED * 1000 + self._reinit)
        init = (cfg.VIS_PREFIX_INIT, cfg.MEAN_INIT, cfg.VAR_INIT)
        prompt = {"prefix": init_prefix(gen, cfg.PREFIX_SIZE, arch.vision_width, *init)}
        if cfg.VPT_DEEP:
            # working deep VPT (the reference's deep branch is dead code; see
            # models/clip.py Transformer)
            prompt["deep"] = init_deep_prefix(
                gen, arch.vision_layers - 1, cfg.PREFIX_SIZE, arch.vision_width, *init
            )
        self._set_prompt(prompt)

    def _refuse_long_sequences(self):
        """On the card every step runs K2, which takes T <= BWD_MAX_SEQ: refuse
        a longer prompted sequence now rather than at the first backward."""
        arch = self.runtime.arch
        T = 1 + arch.num_patches + self.config.PREFIX_SIZE
        if self.device.type == "cuda" and T > BWD_MAX_SEQ:
            raise NotImplementedError(
                f"VPT at {arch.name}: the prompted vision sequence is 1 + "
                f"{arch.num_patches} patches + PREFIX_SIZE {self.config.PREFIX_SIZE} = {T} "
                f"tokens, above the attention-backward kernel's limit of {BWD_MAX_SEQ}; "
                "a tiled backward for T > 128 arrives with the ViT-L/14 slice (ROADMAP)"
            )

    def _set_prompt(self, prompt):
        # copies: the optimizer updates the leaves in place
        self.prompt = {
            k: torch.tensor(np.asarray(v, np.float32), device=self.device).requires_grad_(True)
            for k, v in prompt.items()
        }
        self._init_opt_state()
        self._bump_prompt_version()

    @property
    def prefix(self) -> torch.Tensor:
        return self.prompt["prefix"]

    def _prompt_params(self):
        return list(self.prompt.values())

    def _logits(self, class_ctx, feats):
        model = self.runtime.model
        scale = torch.exp(model.logit_scale)
        img = vpt_image_features(
            model, self.prompt["prefix"], tokens=feats, deep_prompts=self.prompt.get("deep")
        ).float()
        img = img / img.norm(dim=-1, keepdim=True)
        return scale * img @ class_ctx.T

    # ------------------------------------------------------------ features
    def _encode_paths(self, paths: Sequence[str]) -> np.ndarray:
        return self.runtime.vision_tokens_from_files(paths, transform=self._active_transform)

    def _feature_item_nbytes(self) -> int:
        a = self.runtime.arch
        return (a.num_patches + 1) * a.vision_width * 4

    def _train_text_class_ids(self, class_list: Sequence[str]) -> np.ndarray:
        """Frozen normalized text features of the template prompts, (C, E)
        fp32 (reference visual_prompt.py:53-63 define_textual_prompts +
        encode_text)."""
        return self._memoized_token_ids(
            class_list, lambda: self._zero_shot_text_features(class_list)
        )

    def _class_context(self, class_list: Sequence[str]) -> torch.Tensor:
        return torch.tensor(self._train_text_class_ids(class_list), device=self.device)

    # ----------------------------------------------------------- inference
    def image_features(self, paths: Sequence[str], batch: int = 256) -> np.ndarray:
        """Prompted, normalized image features for a file list, (N, E) fp32.

        Memoized on (prompt version, path list): prompted image features do
        not depend on the class list, so back-to-back evaluations over the
        same files (finish_workflow's test_predictions + evaluation, reference
        main_SSL.py:403+:418) run the prompted tower once.  Every prompt
        change bumps the version (the optimizer's in-place steps included)."""
        key = (self._prompt_version, tuple(paths))
        memo = getattr(self, "_img_feats_memo", None)
        # an active user transform may be stochastic (the reference re-applies
        # self.transform per access): never serve memoized features then
        if memo is not None and memo[0] == key and self._active_transform is None:
            return memo[1]
        model = self.runtime.model
        out = []
        with torch.no_grad():
            for s in range(0, len(paths), batch):
                toks = self._features_for_paths(paths[s : s + batch], cache=False)
                toks = torch.from_numpy(np.ascontiguousarray(toks, np.float32)).to(self.device)
                img = vpt_image_features(
                    model, self.prompt["prefix"], tokens=toks,
                    deep_prompts=self.prompt.get("deep"),
                ).float()
                out.append((img / img.norm(dim=-1, keepdim=True)).cpu().numpy())
        feats = np.concatenate(out) if out else np.empty((0,))
        self._img_feats_memo = (key, feats)  # keep the latest only
        return feats

    def _predict_logits(self, paths, class_list):
        tf = self._train_text_class_ids(class_list)  # frozen text features
        img = self.image_features(paths)
        return self.runtime.logit_scale * img @ tf.T

    # ------------------------------------------------------------- persist
    def epoch_parameters(self):
        return [p.detach().cpu().numpy().copy() for p in self.prompt.values()]

    def load_parameters(self, params):
        p = np.asarray(params[0])
        if p.ndim == 3 and p.shape[0] == 1:
            # tolerate a reference-produced batched prefix
            # (CustomVisionTransformer expands either rank,
            # reference clip_encoders.py:148)
            p = p[0]
        prompt = {"prefix": p}
        if len(params) > 1 and params[1] is not None:
            prompt["deep"] = np.asarray(params[1])
        self._set_prompt(prompt)
