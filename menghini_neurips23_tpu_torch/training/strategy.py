"""TrainingStrategy - the training loop and its data assembly.

The reference's abstract base class `TrainingStrategy` is missing from the
published repo; the JAX package reconstructed its contract from the call
sites, and this module follows that reconstruction:

- frozen-tower work is hoisted out of the epoch loop: CoOp computes the image
  features ONCE per training-set composition (the reference re-runs the
  frozen image tower every batch, textual_prompt.py:100) and keeps them as one
  device tensor, VPT likewise the pos-embedded patch tokens; each step
  gathers its batch there;
- one step = forward logits, the two-group loss / ACCUMULATION_ITER,
  `.backward()` into the prompt's `.grad` (which sums across accumulation
  steps), then, when the step applies, `torch.optim.SGD` (weight decay, then
  momentum, then lr - the reference's update) and zeroed grads;
- the paradigm deltas (SSL / UL / TRZSL) are one policy: class spaces, loss
  weights, group flags and the val metric (accuracy vs seen/unseen harmonic
  mean);
- batches are fixed-shape: the last one is padded with index 0, label -1 and
  valid 0;
- validation and prediction logits are host-side NumPy fp32, as in the JAX
  package, so argmax and best-epoch decisions are the same computation.

Training strategies (reference semantics):
- train():                 supervised prompt tuning, or FPL when an
                           unlabeled dataset is given (one pseudolabel
                           bootstrap through zero-shot CLIP and the CLIP head)
- fixed_iterative_train(): IFPL - 100/STEP_QUANTILE iterations, fixed
                           N_PSEUDOSHOTS, pseudolabels refreshed with the
                           best tuned prompts, prompts re-initialized each
                           iteration
- grip_train():            GRIP - the same loop, N_PSEUDOSHOTS grown by the
                           quantile schedule (reference
                           pseudo_iterative.py:62-75, 113-127) until the
                           whole pool is used
Each IFPL/GRIP iteration saves its prompt and pseudolabels, and a resume
state (checkpoint.py) that RESUME picks up.

The JAX package's whole-run `lax.scan` trainer (`FUSED_TRAIN`) and its
shape ladder (`FUSED_BUCKETS`, which only pads that trainer's shapes) have
no counterpart here: both options are read and have no effect, every run
takes the per-step loop above.

The zero-shot pseudolabel pass runs on the base class too: it can be built
without a prompt (`initialize_prompts_parameters` does nothing here).
"""

from __future__ import annotations

import copy
import hashlib
import logging
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import scipy.stats as st
import torch

from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.data.datasets import dataset_object
from menghini_neurips23_tpu_torch.data.templates import format_prompt
from menghini_neurips23_tpu_torch.evaluation.persist import save_parameters, save_pseudo_labels
from menghini_neurips23_tpu_torch.ops.clip_head import fused_probs
from menghini_neurips23_tpu_torch.pseudo.engine import compute_pseudo_labels, pseudolabel_top_k
from menghini_neurips23_tpu_torch.runtime import ClipRuntime
from menghini_neurips23_tpu_torch.training.losses import two_group_loss
from menghini_neurips23_tpu_torch.training.schedulers import lr_for_epoch
from menghini_neurips23_tpu_torch.utils.cache import BoundedFeatureCache

log = logging.getLogger(__name__)


def _paths_key(paths) -> str:
    """Content key for a file-path list.  Frozen-tower features per path are
    deterministic for a strategy's lifetime (the feature cache relies on the
    same invariant), so the path list identifies the feature bytes without
    hashing the feature array itself."""
    h = hashlib.blake2b(digest_size=16)
    for p in paths:
        h.update(str(p).encode())
        h.update(b"\0")
    return h.hexdigest()


class EpochData:
    """Training tensors for one training-set composition.

    features is None in STREAMING mode (training set too large to
    materialize): the loop then fetches per-batch features through the
    bounded cache instead."""

    def __init__(self, features, labels, group, paths):
        self.features = features  # (N, E) device tensor, or None when streaming
        self.labels = np.asarray(labels, np.int32)
        self.group = np.asarray(group, np.int32)
        self.paths = list(paths)

    def __len__(self):
        return len(self.labels)


class TrainingStrategy:
    """Base trainer; modality subclasses implement the prompt hooks."""

    MODALITY = "text"

    def __init__(
        self,
        config: Config,
        label_to_idx: Dict[str, int],
        classes: Sequence[str],
        seen_classes: Sequence[str],
        unseen_classes: Sequence[str],
        device=None,
        data_folder: Optional[str] = None,
        unlabeled_files: Optional[Sequence[str]] = None,
        runtime: Optional[ClipRuntime] = None,
    ):
        self.config = config
        self.label_to_idx = dict(label_to_idx)
        self.idx_to_label = {v: k for k, v in self.label_to_idx.items()}
        self.classes = list(classes)
        self.seen_classes = list(seen_classes)
        self.unseen_classes = list(unseen_classes)
        self.data_folder = data_folder
        self.check_unlabeled = list(unlabeled_files) if unlabeled_files else None
        self.runtime = runtime if runtime is not None else ClipRuntime(config, device=device)
        self.template = config.PROMPT_TEMPLATE
        self._active_transform = None  # user transform honored on the fast path
        self.val_unseen_files = None
        self.val_unseen_labs = None
        self.balance_param = 1.0
        # loss weights (w0: labeled/seen term, w1: pseudo/unseen term)
        self._w0, self._w1 = 1.0, 0.0
        self._feat_cache = BoundedFeatureCache(config.HOST_CACHE_BYTES)
        self._rng = np.random.default_rng(config.OPTIM_SEED)
        self.initialize_prompts_parameters()

    @property
    def device(self) -> torch.device:
        return self.runtime.device

    # ------------------------------------------------------------------ hooks
    def initialize_prompts_parameters(self):
        """Create the trainable prompt (modality subclasses); the zero-shot
        base has none."""

    def _prompt_params(self) -> List[torch.Tensor]:
        """The trainable leaf tensors (modality hook)."""
        raise NotImplementedError

    def _encode_paths(self, paths: Sequence[str]) -> np.ndarray:
        """Modality hook: frozen per-image representation for a file list
        (image features for CoOp, pos-embedded patch tokens for VPT)."""
        raise NotImplementedError

    def _feature_item_nbytes(self) -> int:
        """Host bytes per cached feature item (for streaming decisions)."""
        raise NotImplementedError

    def _train_text_class_ids(self, class_list: Sequence[str]) -> np.ndarray:
        """What the step needs for `class_list`, on the host (modality hook):
        token ids for CoOp, frozen text features for VPT."""
        raise NotImplementedError

    def _class_context(self, class_list: Sequence[str]) -> torch.Tensor:
        """The step's class context for `class_list` as a device tensor
        (modality hook)."""
        raise NotImplementedError

    def _bump_prompt_version(self):
        """Invalidate prompted-feature memos: called on every prompt change,
        the optimizer's in-place updates included."""
        self._prompt_version = getattr(self, "_prompt_version", 0) + 1

    def _logits(self, class_ctx: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        """(B, C) fp32 logits under the current prompt, differentiable in it
        (modality hook)."""
        raise NotImplementedError

    def _predict_logits(self, paths: Sequence[str], class_list: Sequence[str]) -> np.ndarray:
        """(N, C) logits for images under the CURRENT prompt parameters."""
        raise NotImplementedError

    def epoch_parameters(self) -> List[np.ndarray]:
        """Prompt parameters in the reference's save format."""
        raise NotImplementedError

    def load_parameters(self, params: List[np.ndarray]):
        raise NotImplementedError

    def _note_transform(self, data):
        """Honor a user-supplied dataset transform (reference
        CustomDataset.__getitem__ applies self.transform per item,
        data/dataset.py:64-79).  A non-None transform switches frozen encoding
        to the per-item PIL path; the feature cache is cleared on change so
        stale fast-path features can't leak across transforms."""
        tr = getattr(data, "transform", None)
        if tr is None:
            return
        if self._active_transform is None:
            self._active_transform = tr
            self._feat_cache.clear()
            # the prompted-feature memos (VPT, UPT) were keyed before the transform
            # became active: the same staleness as the feature cache
            self._img_feats_memo = None
            self._logits_memo = None
        elif self._active_transform is not tr:
            raise ValueError(
                "datasets carry different custom transforms; set the same "
                "transform object on every dataset of a run (the reference "
                "always threads one self.transform through all of them)"
            )

    def _features_for_paths(
        self, paths: Sequence[str], cache: bool = True, stack_memo: bool = True
    ) -> np.ndarray:
        """Cached frozen representation per image, through the byte-capped
        LRU.  Large inference pools pass cache=False and stream through.

        stack_memo=False keeps the per-path LRU fill but skips the
        stacked-result memo: the streaming train loop fetches a FRESH random
        batch composition every step, whose keys never repeat.

        With an ACTIVE user transform the LRU is bypassed entirely: the
        reference applies self.transform fresh on every dataset access
        (data/dataset.py:64-79), so a stochastic transform is re-sampled per
        pass."""
        if not paths:
            return np.empty((0,))
        if self._active_transform is not None:
            return self._encode_paths(list(paths))
        memoize = cache and stack_memo
        if memoize:
            # stacked-result memo: every repeated train() call re-prepares the
            # train set and every validation the val set
            key = _paths_key(paths)
            memo = getattr(self, "_stack_memo", None)
            if memo is None:
                memo = self._stack_memo = {}
            hit = memo.get(key)
            if hit is not None:
                return hit
        have = self._feat_cache.get_or_fill(paths, self._encode_paths, store=cache)
        out = np.stack([have[p] for p in paths])
        if memoize:
            # byte-capped FIFO; read-only so a caller mutating a memoized
            # stack faults instead of corrupting later hits
            out.setflags(write=False)
            memo[key] = out
            cap = max(int(self.config.HOST_CACHE_BYTES), out.nbytes)
            while len(memo) > 1 and sum(v.nbytes for v in memo.values()) > cap:
                memo.pop(next(iter(memo)))
        return out

    def _memoized_token_ids(self, class_list: Sequence[str], build) -> np.ndarray:
        """Memoize `build()` per class list: tokenization depends only on the
        list (+ fixed config).  Results are read-only so a caller write
        faults instead of corrupting later hits."""
        key = tuple(class_list)
        cache = getattr(self, "_ctx_ids_cache", None)
        if cache is None:
            cache = self._ctx_ids_cache = {}
        if key not in cache:
            ids = build()
            ids.setflags(write=False)
            cache[key] = ids
        return cache[key]

    # ------------------------------------------------------------- SGD step
    def _init_opt_state(self):
        """A fresh optimizer over the prompt: zero momentum, no gradient."""
        cfg = self.config
        params = self._prompt_params()
        for p in params:
            p.grad = None
        self._opt = torch.optim.SGD(
            params, lr=cfg.LR, momentum=cfg.MOMENTUM, dampening=0,
            weight_decay=cfg.DECAY,
        )

    def _apply_step(self, class_ctx: torch.Tensor, lr: float, feats: torch.Tensor,
                    labels: torch.Tensor, group: torch.Tensor, valid: torch.Tensor,
                    apply: bool = True) -> Tuple[float, float]:
        """One step on device tensors: loss / ACCUMULATION_ITER backward into
        the prompt's grad; with `apply`, one SGD update at `lr` and zeroed
        grads (the reference's manual accumulation,
        textual_prompt.py:130-135).  Returns (loss, correct count).

        The update is in place, so it bumps the prompt version that keys the
        prompted-feature memo."""
        accum = self.config.ACCUMULATION_ITER
        logits = self._logits(class_ctx, feats)
        loss = two_group_loss(logits, labels, group, valid, self._w0, self._w1)
        (loss / accum).backward()
        if apply:
            for pg in self._opt.param_groups:
                pg["lr"] = lr
            self._opt.step()
            self._opt.zero_grad(set_to_none=True)
            self._bump_prompt_version()
        with torch.no_grad():
            correct = ((logits.argmax(1) == labels) * valid).sum()
        return loss.item(), correct.item()

    # -------------------------------------------------------------- paradigm
    @property
    def paradigm(self) -> str:
        return self.config.LEARNING_PARADIGM

    def _set_loss_policy(self, n_pseudo: int, n_labeled: int):
        """Loss weights per paradigm (reference textual_fpl.py:115/123-128,
        trzsl/textual_fpl.py:109/117-122, ul/textual_fpl.py:112-128)."""
        if self.paradigm == "trzsl":
            self.balance_param = n_labeled / max(1, n_pseudo)
            self._w0, self._w1 = 1.0, self.balance_param
        elif self.paradigm == "ul":
            self.balance_param = 1.0
            self._w0, self._w1 = 1.0, 0.0
        else:  # ssl
            self.balance_param = n_pseudo / max(1, n_labeled)
            self._w0, self._w1 = self.balance_param, 1.0
        if self.MODALITY == "multi" and self.paradigm in ("ssl", "trzsl"):
            # multimodal uses sqrt of the balance in BOTH weighted paradigms
            # (reference semi_supervised_learning/multimodal_fpl.py:107,
            # transductive_zsl/multimodal_fpl.py:104)
            self.balance_param = math.sqrt(self.balance_param)
            if self.paradigm == "ssl":
                self._w0 = self.balance_param
            else:
                self._w1 = self.balance_param

    # ------------------------------------------------------- dataset assembly
    def create_training_dataset(self, train_data, unlabeled_data=None):
        """FPL training set: pseudolabels for unseen + labeled seen (reference
        textual_fpl.py:58-121 and paradigm variants)."""
        if unlabeled_data is None:
            return train_data
        self._note_transform(unlabeled_data)
        pseudo_classes = self.classes if self.paradigm == "ul" else self.unseen_classes
        cfg = self.config

        def probs_fn():
            return self._zero_shot_probs(unlabeled_data.filepaths, pseudo_classes)

        pseudolabel_top_k(
            cfg, cfg.DATASET_NAME, cfg.N_PSEUDOSHOTS, unlabeled_data,
            pseudo_classes, self.label_to_idx, probs_fn, device=self.device,
        )
        return self._merge_pseudo(train_data, unlabeled_data)

    def _merge_pseudo(self, train_data, train_unseen_dataset):
        """Merge pseudo (unseen) and labeled (seen) samples; set loss policy;
        optionally carve a pseudo-validation split (reference
        textual_fpl.py:84-121)."""
        cfg = self.config
        unseen_imgs = list(train_unseen_dataset.filepaths)
        unseen_labs = list(train_unseen_dataset.labels)

        if cfg.N_PSEUDOSHOTS >= 10:
            np.random.seed(cfg.validation_seed)
            train_indices = np.random.choice(
                range(len(unseen_imgs)),
                size=int(len(unseen_imgs) * cfg.ratio_train_val),
                replace=False,
            )
            val_indices = list(
                set(range(len(unseen_imgs))).difference(set(train_indices))
            )
            self.val_unseen_files = np.array(unseen_imgs)[val_indices]
            self.val_unseen_labs = np.array(unseen_labs)[val_indices]
            unseen_imgs = list(np.array(unseen_imgs)[train_indices])
            unseen_labs = list(np.array(unseen_labs)[train_indices])
        else:
            self.val_unseen_files = None
            self.val_unseen_labs = None

        if self.paradigm == "ul":
            # UL trains on pseudolabels only (reference ul/textual_fpl.py:106-108)
            train_data.filepaths = list(unseen_imgs)
            train_data.labels = list(unseen_labs)
            train_data.label_id = True
            self._set_loss_policy(len(unseen_imgs), 0)
            self._train_groups = [0] * len(unseen_imgs)
            self._policy_ready = True
            return train_data

        seen_imgs = list(train_data.filepaths)
        seen_labs = [self.label_to_idx[l] for l in train_data.labels]
        self._set_loss_policy(len(unseen_imgs), len(seen_imgs))
        train_data.filepaths = list(unseen_imgs) + list(seen_imgs)
        train_data.labels = list(unseen_labs) + list(seen_labs)
        train_data.label_id = True
        # group flag: 1 = pseudo/unseen term, 0 = labeled/seen term
        self._train_groups = [1] * len(unseen_imgs) + [0] * len(seen_imgs)
        self._policy_ready = True
        return train_data

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
        img = self.runtime.encode_images_from_files(
            filepaths, normalize=True, transform=self._active_transform
        )
        return self._softmax_probs(img, text)

    def _softmax_probs(self, img_feats: np.ndarray, text_feats: np.ndarray) -> np.ndarray:
        """softmax(scale * img @ text.T) through the fused CLIP head
        (ops/clip_head.py): the CUDA kernel on the card, its fp32 plain
        version on the CPU."""
        if not len(img_feats):
            return np.zeros((0, len(text_feats)), np.float32)
        dev = self.device
        img = torch.from_numpy(np.ascontiguousarray(img_feats, np.float32)).to(dev)
        txt = torch.from_numpy(np.ascontiguousarray(text_feats, np.float32)).to(dev)
        return fused_probs(img, txt, self.runtime.logit_scale).cpu().numpy()

    # ----------------------------------------------------------------- train
    def train(
        self,
        train_data,
        val_data,
        train_unseen_dataset=None,
        only_seen: bool = False,
        only_unlabelled: bool = False,
    ) -> Tuple[float, List[np.ndarray]]:
        """Reference signature: main_SSL.py:211-215 (prompt-only) and
        :292-297 (FPL).  Returns (best val accuracy, best prompt params); the
        strategy keeps the final epoch's prompt, as the reference does."""
        cfg = self.config
        self._note_transform(train_data)
        self._note_transform(val_data)
        if train_unseen_dataset is not None:
            train_data = self.create_training_dataset(train_data, train_unseen_dataset)
        elif not getattr(self, "_policy_ready", False):
            # plain supervised prompt tuning: single-term CE
            self._w0, self._w1 = 1.0, 0.0
            self._train_groups = [0] * len(train_data.filepaths)
        self._policy_ready = False  # consume (set by _merge_pseudo)

        train_classes = self.seen_classes if only_seen else self.classes
        epoch = self._prepare_epoch_data(train_data, train_classes, only_seen)
        val = self._prepare_val_data(val_data)

        best_acc = -1.0
        best_params = self.epoch_parameters()
        class_ctx = self._class_context(train_classes)
        self._init_opt_state()
        bs = self._batch_size()

        for e in range(cfg.EPOCHS):
            lr = lr_for_epoch(cfg, e)
            train_acc, loss = self._run_train_epoch(class_ctx, epoch, lr, bs)
            val_acc = self._run_validation(val)
            log.info(
                "epoch %d: loss=%.4f train_acc=%.4f val_acc=%.4f lr=%.5f",
                e, loss, train_acc, val_acc, lr,
            )
            if val_acc > best_acc:
                best_acc = val_acc
                best_params = self.epoch_parameters()
        return float(best_acc), best_params

    def _batch_size(self) -> int:
        return int(self.config.BATCH_SIZE)

    def _prepare_epoch_data(self, train_data, class_list, only_seen: bool) -> EpochData:
        paths = list(train_data.filepaths)
        raw_labels = train_data.label_ids()  # global ids
        # remap global ids into the training class-index space (the reference's
        # real_to_idx remap for only_seen, textual_prompt.py:119-121)
        lut = {self.label_to_idx[c]: i for i, c in enumerate(class_list)}
        labels = [lut[l] for l in raw_labels]
        groups = getattr(self, "_train_groups", [0] * len(paths))
        # an ACTIVE user transform is re-applied on every access (reference
        # data/dataset.py:64-79): stream instead of materializing one sample
        if self._active_transform is not None:
            return EpochData(None, labels, groups, paths)
        # training sets too large to materialize stream per-batch features
        # through the bounded cache instead
        est = len(paths) * self._feature_item_nbytes()
        if 2 * est > self.config.FUSED_MAX_BYTES:
            return EpochData(None, labels, groups, paths)
        feats = self._features_for_paths(paths)
        return EpochData(torch.tensor(feats, device=self.device), labels, groups, paths)

    def _prepare_val_data(self, val_data):
        """Validation set; FPL augments it with the pseudo-val split
        (reconstructed contract, SURVEY.md §2.9 train())."""
        paths = list(val_data.filepaths)
        if val_data.label_id:
            labels = [int(l) for l in val_data.labels]
        else:
            labels = [int(val_data.label_map[l]) for l in val_data.labels]
        if self.val_unseen_files is not None:
            paths = paths + list(self.val_unseen_files)
            labels = labels + [int(l) for l in self.val_unseen_labs]
            class_list = self.classes
        elif self.paradigm == "ul":
            # UL always validates over ALL classes (reference
            # unsupervised_learning/textual_prompt.py:172-176)
            class_list = self.classes
        else:
            class_list = self.seen_classes
        return paths, np.asarray(labels, np.int32), class_list

    def _run_train_epoch(self, class_ctx, epoch: EpochData, lr, bs):
        n = len(epoch)
        accum = max(1, self.config.ACCUMULATION_ITER)
        order = self._rng.permutation(n)
        starts = list(range(0, n, bs))
        dev = self.device
        total_correct = 0
        total = 0
        loss_val = 0.0
        for si, s in enumerate(starts):
            idx = order[s : s + bs]
            count = len(idx)
            pad = bs - count
            sel = np.concatenate([idx, np.zeros(pad, np.int64)]) if pad else idx
            if epoch.features is None:  # streaming: fetch through the cache
                feats = torch.from_numpy(np.ascontiguousarray(
                    self._features_for_paths([epoch.paths[i] for i in sel], stack_memo=False)
                )).to(dev)
            else:
                feats = epoch.features[torch.from_numpy(sel).to(dev)]
            labels = np.concatenate([epoch.labels[idx], -np.ones(pad, np.int32)])
            valid = np.concatenate([np.ones(count, np.float32), np.zeros(pad, np.float32)])
            # optimizer steps every accum batches or at epoch end (reference
            # textual_prompt.py:134-135)
            apply = ((si + 1) % accum == 0) or (si + 1 == len(starts))
            loss_val, correct = self._apply_step(
                class_ctx, lr, feats,
                torch.from_numpy(labels).to(dev),
                torch.from_numpy(epoch.group[sel]).to(dev),
                torch.from_numpy(valid).to(dev),
                apply=apply,
            )
            total_correct += int(correct)
            total += count
        return (total_correct / max(1, total)), float(loss_val)

    # ------------------------------------------------------------ validation
    def _run_validation(self, val) -> float:
        paths, labels, class_list = val
        logits = self._predict_logits(paths, class_list)
        preds = logits.argmax(1)
        global_pred = np.array([self.label_to_idx[class_list[p]] for p in preds])
        if self.paradigm == "trzsl" and self.val_unseen_files is not None:
            # seen/unseen harmonic mean (reference trzsl/textual_prompt.py:245-283)
            seen_ids = {self.label_to_idx[c] for c in self.seen_classes}
            is_seen = np.array([l in seen_ids for l in labels])
            acc_seen = (
                (global_pred[is_seen] == labels[is_seen]).mean() if is_seen.any() else 0.0
            )
            acc_unseen = (
                (global_pred[~is_seen] == labels[~is_seen]).mean()
                if (~is_seen).any()
                else 0.0
            )
            if acc_seen > 0 and acc_unseen > 0:
                return float(st.hmean([acc_seen, acc_unseen]))
            return 0.0
        return float((global_pred == labels).mean())

    # -------------------------------------------------------- FPL iterations
    def get_pseudo_labels(self, unlabeled_examples):
        """Refresh pseudolabels with the CURRENT prompts (reference
        textual_fpl.py:168-283): predict over the pool, rebuild the dataset in
        class_folder mode, re-rank with the leaderboard.

        The reference runs two full prompted-tower passes over the pool per
        refresh (test_predictions at textual_fpl.py:174, then the re-scoring
        loop at :214-230).  The class lists are identical and the
        class_folder rebuild is a host-side path permutation, so by default
        (GRIP_REFRESH="onepass") the pool is scored once and the logits are
        mapped through that permutation; GRIP_REFRESH="twopass" keeps the
        literal two-pass flow.  The probabilities are a float64 host softmax
        of the tuned logits, not the CLIP head."""
        cfg = self.config
        self._note_transform(unlabeled_examples)
        classes = self.classes if self.paradigm == "ul" else self.unseen_classes
        onepass = getattr(cfg, "GRIP_REFRESH", "onepass") != "twopass"
        if onepass:
            # test_predictions(standard_zsl=True) reduces to an argmax over
            # the same class list (UL ignores standard_zsl and uses all
            # classes - exactly `classes` above)
            logits = self._predict_logits(unlabeled_examples.filepaths, classes)
            ids = [f.split("/")[-1] for f in unlabeled_examples.filepaths]
            preds = [classes[i] for i in logits.argmax(1)]
            std_preds = pd.DataFrame({"id": ids, "class": preds})
        else:
            std_preds = self.test_predictions(unlabeled_examples, standard_zsl=True)
        pseudo_unseen = dataset_object(cfg.DATASET_NAME)(
            list(std_preds["id"]),
            self.data_folder,
            train=True,
            labels=None,
            label_map=self.label_to_idx,
            class_folder=True,
            original_filepaths=unlabeled_examples.filepaths,
        )
        perm = (
            self._refresh_permutation(unlabeled_examples.filepaths, pseudo_unseen.filepaths)
            if onepass
            else None
        )
        if perm is not None:
            probs = self._softmax64(logits[perm])
        else:
            if onepass:
                log.warning(
                    "one-pass refresh: resolved paths are ambiguous (duplicate or "
                    "unmatched basenames); falling back to the two-pass pool scoring "
                    "for this iteration"
                )
            probs = self._tuned_probs(pseudo_unseen.filepaths, classes)
        return compute_pseudo_labels(
            probs, pseudo_unseen, classes, self.label_to_idx, cfg.N_PSEUDOSHOTS,
            method=getattr(cfg, "PSEUDO_TOPK", "exact"), device=self.device,
        )

    @staticmethod
    def _refresh_permutation(pool_paths, resolved_paths) -> Optional[np.ndarray]:
        """Map class_folder-resolved paths back to pool rows: exact path match
        first (the _OriginalPathLookup datasets return pool paths verbatim),
        basename fallback for layouts that rebuild the path string (DTD,
        EuroSAT, RESICS45 - reference data/dataset.py:166-180,256-259).

        Returns None when the mapping is ambiguous (a needed basename is
        duplicated across pool rows, or absent): the caller then falls back
        to two-pass scoring rather than re-use another image's logits row."""
        by_path: Dict[str, int] = {}
        by_name: Dict[str, int] = {}
        dupes = set()
        for i, p in enumerate(pool_paths):
            by_path.setdefault(p, i)
            name = p.split("/")[-1]
            if name in by_name:
                dupes.add(name)
            else:
                by_name[name] = i
        idx = []
        for p in resolved_paths:
            j = by_path.get(p)
            if j is None:
                name = p.split("/")[-1]
                if name in dupes or name not in by_name:
                    return None
                j = by_name[name]
            idx.append(j)
        return np.asarray(idx, np.int64)

    @staticmethod
    def _softmax64(logits: np.ndarray) -> np.ndarray:
        l64 = logits.astype(np.float64)
        p = np.exp(l64 - l64.max(1, keepdims=True))
        return (p / p.sum(1, keepdims=True)).astype(np.float32)

    def _tuned_probs(self, filepaths, class_list) -> np.ndarray:
        return self._softmax64(self._predict_logits(filepaths, class_list))

    def fixed_iterative_train(self, train_data, val_data, train_unseen_dataset,
                              only_seen: bool = False):
        """IFPL (schedule from reference pseudo_iterative.py:63)."""
        return self._iterative_train(train_data, val_data, train_unseen_dataset, grow=False)

    def grip_train(self, train_data, val_data, train_unseen_dataset, only_seen: bool = False):
        """GRIP: quantile growth of N_PSEUDOSHOTS (pseudo_iterative.py:62-127)."""
        return self._iterative_train(train_data, val_data, train_unseen_dataset, grow=True)

    def _grip_pseudoshots(self, k: int, num_samples: int, n_unseen: int, pool: int) -> int:
        """GRIP quantile schedule at iteration k (reference
        pseudo_iterative.py:64-75 for k=1 and :113-125 for the growth step,
        which together give N(k) = int(k*num_samples/n_unseen) capped by the
        pool)."""
        n_per_class = int(k * num_samples / n_unseen)
        if n_per_class * n_unseen > pool:
            n_per_class = math.floor(pool / n_unseen)
        # degenerate pools (fewer samples than iterations x classes) would
        # schedule 0 pseudoshots per class and train on nothing; take at
        # least 1 (the reference's real configs never hit this regime)
        return max(1, n_per_class)

    def _iterative_train(self, train_data, val_data, unlabeled_data, grow: bool):
        """The IFPL/GRIP loop.  Iteration 1 takes zero-shot FPL pseudolabels
        (create_training_dataset); each later one refreshes them with the
        best prompt so far (get_pseudo_labels).  Every iteration starts from
        a fresh prompt, saves its prompt and pseudolabels, keeps the best,
        and with CHECKPOINT_ITER writes a resume state; RESUME restarts after
        the latest one.  MNT_FAIL_AFTER_ITER=n (environment) raises after
        iteration n, to exercise the resume."""
        from menghini_neurips23_tpu_torch.checkpoint import (
            latest_iteration_state,
            save_iteration_state,
        )

        cfg = self.config
        num_iter = int(100 / cfg.STEP_QUANTILE)
        n_unseen = len(self.classes if self.paradigm == "ul" else self.unseen_classes)
        pool_size = len(unlabeled_data.filepaths)
        num_samples = int(pool_size / num_iter)
        original_train = copy.deepcopy(train_data)
        original_unlabeled = copy.deepcopy(unlabeled_data)
        original_val = copy.deepcopy(val_data)

        best_overall = -1.0
        best_params = self.epoch_parameters()
        start_iter = 1
        if cfg.RESUME:
            state = latest_iteration_state(cfg)
            if state is not None and state["iteration"] < num_iter:
                start_iter = state["iteration"] + 1
                best_overall = state["best_metric"]
                best_params = state["best_params"]
                self.load_parameters(best_params)
                # the permutation RNG stream and the prompt re-init counter:
                # the resumed run is bit-identical to an uninterrupted one
                if state.get("rng_state") is not None:
                    self._rng.bit_generator.state = state["rng_state"]
                if state.get("reinit") is not None:
                    self._reinit = int(state["reinit"])
                log.info(
                    "resuming from checkpointed iteration %d (best=%.4f)",
                    state["iteration"], best_overall,
                )
            elif state is not None:
                log.info("run already complete at iteration %d", state["iteration"])
                self.load_parameters(state["best_params"])
                return state["best_metric"], state["best_params"]

        for niter in range(start_iter, num_iter + 1):
            if grow:
                # ALL_UNLABELED=False freezes N_PSEUDOSHOTS at the iteration-1
                # value: the reference only grows it inside
                # `if self.config.ALL_UNLABELED` (pseudo_iterative.py:113-125).
                # The shared config changes in place: the artifact and cache
                # names read it.
                k = niter if cfg.ALL_UNLABELED else 1
                cfg.N_PSEUDOSHOTS = self._grip_pseudoshots(k, num_samples, n_unseen, pool_size)
            log.info("iteration %d/%d: N_PSEUDOSHOTS=%d", niter, num_iter, cfg.N_PSEUDOSHOTS)
            if niter == 1:
                train_data = self.create_training_dataset(train_data, unlabeled_data)
            else:
                refreshed = self.get_pseudo_labels(unlabeled_data)
                train_data = self._merge_pseudo(copy.deepcopy(original_train), refreshed)
            # fresh prompts each iteration (paper section 4)
            self.initialize_prompts_parameters()
            acc, params = self.train(train_data, copy.deepcopy(original_val), None,
                                     only_seen=False)
            save_parameters(params, cfg, iteration=niter)
            save_pseudo_labels(train_data.filepaths, train_data.labels, cfg, iteration=niter)
            if acc > best_overall:
                best_overall = acc
                best_params = params
            # the next refresh scores the pool with the best prompt so far
            self.load_parameters(best_params)
            if cfg.CHECKPOINT_ITER:
                save_iteration_state(
                    cfg, niter, cfg.N_PSEUDOSHOTS, best_overall, best_params,
                    rng_state=self._rng.bit_generator.state,
                    reinit=getattr(self, "_reinit", None),
                )
            fail_after = int(os.environ.get("MNT_FAIL_AFTER_ITER", "0") or 0)
            if fail_after and niter == fail_after:
                raise RuntimeError(f"fault injection: MNT_FAIL_AFTER_ITER={fail_after}")
            # restore the full pool for the next refresh (the engine mutates it)
            unlabeled_data = copy.deepcopy(original_unlabeled)
            train_data = copy.deepcopy(original_train)
        return best_overall, best_params

    # -------------------------------------------------------------- inference
    def load_model_eval(self, iteration=None):
        """Rebuild the model for evaluation from saved prompt artifacts
        (reference load_model_eval -> define_model, textual_prompt.py:298-299)."""
        from menghini_neurips23_tpu_torch.evaluation.persist import load_saved_parameters

        self.load_parameters(load_saved_parameters(self.config, iteration))
        return self

    def test_predictions(self, data, standard_zsl: bool = False) -> pd.DataFrame:
        """Predictions dataframe (id=basename, class=name) - reference
        textual_prompt.py:226-296, with exact unpadding instead of the
        drop_duplicates heuristic.  UL always predicts over ALL classes
        (reference unsupervised_learning/textual_prompt.py:231 ignores
        standard_zsl)."""
        self._note_transform(data)
        if self.paradigm == "ul":
            class_list = self.classes
        else:
            class_list = self.unseen_classes if standard_zsl else self.classes
        logits = self._predict_logits(data.filepaths, class_list)
        preds = [class_list[i] for i in logits.argmax(1)]
        ids = [f.split("/")[-1] for f in data.filepaths]
        return pd.DataFrame({"id": ids, "class": preds})

    def evaluation(self, data):
        """(images, predictions, logits) over self.classes (reference
        textual_prompt.py:301-356)."""
        self._note_transform(data)
        logits = self._predict_logits(data.filepaths, self.classes)
        preds = [self.classes[i] for i in logits.argmax(1)]
        images = [f.split("/")[-1] for f in data.filepaths]
        return images, preds, logits
