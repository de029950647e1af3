"""Textual prompt tuning (CoOp) - reference methods/*/textual_prompt.py and
textual_fpl.py, all three paradigms.

The frozen image tower runs ONCE per image (features cached, normalized);
each train step is only the text tower over C class prompts + logits + CE +
backward on the (L, width) prefix.  On the card every text layer's attention
runs K1 forward and K2 backward (ops/attention.py).  The reference re-encodes
the frozen image batch every step (textual_prompt.py:100); that work is gone.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from menghini_neurips23_tpu_torch.models.prompts import (
    build_prompt_token_ids,
    coop_text_features,
    init_prefix,
    truncate_context,
)
from menghini_neurips23_tpu_torch.training.strategy import TrainingStrategy


class TextualStrategy(TrainingStrategy):
    MODALITY = "text"

    def initialize_prompts_parameters(self):
        """A fresh (PREFIX_SIZE, width) fp32 prefix, a leaf that requires
        grad, on the runtime's device.  The draw comes from a CPU
        torch.Generator seeded with OPTIM_SEED * 1000 + reinit (the JAX
        package's key, textual.py:35-36), so the card and the CPU start from
        the same prefix; it is not the JAX package's jax.random draw."""
        cfg = self.config
        self._reinit = getattr(self, "_reinit", -1) + 1
        gen = torch.Generator().manual_seed(cfg.OPTIM_SEED * 1000 + self._reinit)
        prefix = init_prefix(
            gen, cfg.PREFIX_SIZE, self.runtime.arch.transformer_width,
            cfg.VIS_PREFIX_INIT, cfg.MEAN_INIT, cfg.VAR_INIT,
        )
        self._set_prefix(prefix)

    def _set_prefix(self, prefix):
        # a copy: the optimizer updates the prefix in place
        self.prefix = torch.tensor(
            np.asarray(prefix, np.float32), device=self.device
        ).requires_grad_(True)
        self._init_opt_state()
        self._bump_prompt_version()

    def _get_prompt_tree(self):
        return {"prefix": self.prefix}

    def _set_prompt_tree(self, tree):
        self._set_prefix(tree["prefix"])

    def _logits_fn(self):
        model = self.runtime.model

        def fn(tree, token_ids, feats):
            scale = torch.exp(model.logit_scale)
            tf = coop_text_features(model, tree["prefix"], token_ids).float()
            tf = tf / tf.norm(dim=-1, keepdim=True)
            return scale * feats.float() @ tf.T

        return fn

    # ------------------------------------------------------------ features
    def _encode_paths(self, paths: Sequence[str]) -> np.ndarray:
        return self.runtime.encode_images_from_files(
            paths, normalize=True, transform=self._active_transform
        )

    def _feature_item_nbytes(self) -> int:
        return self.runtime.arch.embed_dim * 4

    def _train_text_class_ids(self, class_list: Sequence[str]) -> np.ndarray:
        def build():
            ids = build_prompt_token_ids(
                self.runtime.tokenizer, class_list, self.config.PREFIX_SIZE
            )
            return truncate_context(ids) if self.config.TEXT_TRUNCATE else ids

        return self._memoized_token_ids(class_list, build)

    # ----------------------------------------------------------- inference
    def text_features(self, class_list: Sequence[str]) -> np.ndarray:
        """Normalized prompted text features (the reference's self.model(classes))."""
        ids = self._class_context(class_list)
        with torch.no_grad():
            tf = coop_text_features(self.runtime.model, self.prefix, ids).float()
            tf = tf / tf.norm(dim=-1, keepdim=True)
        return tf.cpu().numpy()

    def _predict_logits(self, paths, class_list):
        tf = self.text_features(class_list)
        feats = self._features_for_paths(paths)
        return self.runtime.logit_scale * feats @ tf.T

    # ------------------------------------------------------------- persist
    def epoch_parameters(self):
        return [self.prefix.detach().cpu().numpy().copy()]

    def load_parameters(self, params):
        p = np.asarray(params[0])
        if p.ndim == 3 and p.shape[0] == 1:
            # reference-produced textual artifacts carry the batched
            # (1, L, W) prefix TextPrefixModel holds (clip_encoders.py:55-67)
            p = p[0]
        self._set_prefix(p)
