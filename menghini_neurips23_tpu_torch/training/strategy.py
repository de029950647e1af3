"""TrainingStrategy - the zero-shot part of the training driver.

The reference's abstract base class `TrainingStrategy` is missing from the
published repo; the JAX package reconstructed its contract from the call
sites.  This slice carries only what the zero-shot pseudolabel path needs:
prompt text features, the batched zero-shot probability pass over a file
list, and the CLIP head that turns features into probabilities.  Training,
validation, FPL/IFPL/GRIP and prediction arrive with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.data.templates import format_prompt
from menghini_neurips23_tpu_torch.ops.clip_head import fused_probs
from menghini_neurips23_tpu_torch.runtime import ClipRuntime


class TrainingStrategy:
    """Base trainer; this slice holds its zero-shot methods."""

    def __init__(
        self,
        config: Config,
        label_to_idx: Dict[str, int],
        classes: Sequence[str],
        seen_classes: Sequence[str],
        unseen_classes: Sequence[str],
        device=None,
        runtime: Optional[ClipRuntime] = None,
    ):
        self.config = config
        self.label_to_idx = dict(label_to_idx)
        self.classes = list(classes)
        self.seen_classes = list(seen_classes)
        self.unseen_classes = list(unseen_classes)
        self.runtime = runtime if runtime is not None else ClipRuntime(config, device=device)
        self.template = config.PROMPT_TEMPLATE

    # ----------------------------------------------------------- zero-shot
    def _zero_shot_text_features(self, class_list: Sequence[str]) -> np.ndarray:
        prompts = [format_prompt(self.template, c) for c in class_list]
        ids = self.runtime.tokenizer.tokenize(prompts)
        if self.config.TEXT_TRUNCATE:
            from menghini_neurips23_tpu_torch.models.prompts import truncate_context

            ids = truncate_context(ids)
        return self.runtime.encode_text(ids, normalize=True)

    def _zero_shot_probs(self, filepaths, class_list) -> np.ndarray:
        """Batched zero-shot CLIP probabilities (N, C) - replaces the
        reference's per-image loop (utils/clip_pseudolabels.py:31-44)."""
        text = self._zero_shot_text_features(class_list)
        img = self.runtime.encode_images_from_files(filepaths, normalize=True)
        return self._softmax_probs(img, text)

    def _softmax_probs(self, img_feats: np.ndarray, text_feats: np.ndarray) -> np.ndarray:
        """softmax(scale * img @ text.T) through the fused CLIP head
        (ops/clip_head.py): the CUDA kernel on the card, its fp32 plain
        version on the CPU."""
        if not len(img_feats):
            return np.zeros((0, len(text_feats)), np.float32)
        dev = self.runtime.device
        img = torch.from_numpy(np.ascontiguousarray(img_feats, np.float32)).to(dev)
        txt = torch.from_numpy(np.ascontiguousarray(text_feats, np.float32)).to(dev)
        return fused_probs(img, txt, self.runtime.logit_scale).cpu().numpy()
