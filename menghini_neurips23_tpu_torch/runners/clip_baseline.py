"""Zero-shot CLIP baseline (reference methods/clip_baseline.py:17-86).

One batched inference pass: template prompts -> frozen text features
(computed once), frozen image features for the whole test set, logits ->
argmax.  The reference's CLIP(img, text) per batch is the same math.
"""

from __future__ import annotations

import logging
from typing import Optional

import pandas as pd

from menghini_neurips23_tpu_torch.data.templates import format_prompt
from menghini_neurips23_tpu_torch.runtime import ClipRuntime

log = logging.getLogger(__name__)


class ClipBaseline:
    def __init__(
        self, config, label_to_idx, classes, seen_classes, unseen_classes,
        device=None, runtime: Optional[ClipRuntime] = None,
    ):
        self.config = config
        self.classes = list(classes)
        self.seen_classes = list(seen_classes)
        self.unseen_classes = list(unseen_classes)
        self.label_to_idx = label_to_idx
        self.runtime = runtime if runtime is not None else ClipRuntime(config, device=device)
        self.template = config.PROMPT_TEMPLATE

    def test_predictions(self, data):
        """Returns (df_predictions, images, predictions, logits) as the
        reference does (clip_baseline.py:44-86)."""
        prompts = [format_prompt(self.template, c) for c in self.classes]
        ids = self.runtime.tokenizer.tokenize(prompts)
        if getattr(self.config, "TEXT_TRUNCATE", True):
            from menghini_neurips23_tpu_torch.models.prompts import truncate_context

            ids = truncate_context(ids)
        text = self.runtime.encode_text(ids, normalize=True)
        img = self.runtime.encode_images_from_files(
            data.filepaths, normalize=True,
            transform=getattr(data, "transform", None),
        )
        logits = self.runtime.logit_scale * img @ text.T
        preds = [self.classes[i] for i in logits.argmax(1)]
        images = [f.split("/")[-1] for f in data.filepaths]
        df = pd.DataFrame({"id": images, "class": preds})
        return df, images, preds, logits
