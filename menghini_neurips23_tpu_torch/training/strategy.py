"""TrainingStrategy - the training loop and its data assembly.

The reference's abstract base class `TrainingStrategy` is missing from the
published repo; the JAX package reconstructed its contract from the call
sites, and this module follows that reconstruction:

- frozen-tower work is hoisted out of the epoch loop: CoOp computes the image
  features ONCE per training-set composition (the reference re-runs the
  frozen image tower every batch, textual_prompt.py:100), VPT and UPT the
  pos-embedded patch tokens; each step gathers its batch from them;
- one step = forward logits through the modality's functional logits hook
  (`_logits_fn`, on an explicit prompt tree), the two-group loss /
  ACCUMULATION_ITER, its gradient added into an accumulator, then, when the
  step applies, SGD by hand (weight decay, then momentum, then lr - the
  reference's `torch.optim.SGD` update) and a zeroed accumulator
  (training/fused.py `train_step`);
- the paradigm deltas (SSL / UL / TRZSL) are one policy: class spaces, loss
  weights, group flags and the val metric (accuracy vs seen/unseen harmonic
  mean);
- batches are fixed-shape: the last one is padded with index 0, label -1 and
  valid 0;
- in a process group (parallel/) each rank steps on its data group's
  host-major block of every batch, ceil(BATCH_SIZE / world) rows (world
  the data group's size; the ranks of a model group share a block and
  hold their shards of the towers), with the loss normalised by the whole
  batch's valid rows (counted on the host, or on the device from the
  permutation every rank holds), and the gradient, the loss and the
  correct count all-reduced over the data group before the update (the
  model group's gradients are already whole: parallel/tensor.py); every
  rank draws the same permutations and prompts (nothing is seeded by
  rank), validates on all rows, and so picks the same best epoch; rank 0
  alone writes.

A run takes one of two forms, as in the JAX package:
- the whole-run trainer (`FUSED_TRAIN`, on by default; `_fused_train`): all
  epochs' permutations drawn up front, the step and the epoch end run from
  static device buffers (training/fused.py) - on the card as CUDA graphs
  replayed EPOCHS x (steps + 1) times with no host sync between epochs -
  with validation and best-epoch selection on the device.  FUSED_EPOCH_CHUNK
  splits the run into chunks with one stats fetch each and, with
  CHECKPOINT_ITER, a resumable carry at every boundary; IFPL/GRIP pad their
  training sets to a FUSED_BUCKETS ladder so that few shapes are captured
  (the padding takes buffer rows; only the real batches are replayed);
- the per-step loop, which the JAX package keeps as its fallback and takes
  for the same four reasons (FUSED_TRAIN off, an empty training or
  validation set, features above FUSED_MAX_BYTES/2, an active transform):
  one step per batch with an `.item()` each, validation with host-side
  NumPy fp32 logits.  The two forms see the same batches; near-tie argmaxes
  of the validation may differ (device vs host logits), as they do in the
  JAX package.

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

The zero-shot pseudolabel pass runs on the base class too: it can be built
without a prompt (`initialize_prompts_parameters` does nothing here).
"""

from __future__ import annotations

import copy
import hashlib
import logging
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import scipy.stats as st
import torch
from torch.utils.checkpoint import checkpoint

from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.data.datasets import dataset_object
from menghini_neurips23_tpu_torch.data.templates import format_prompt
from menghini_neurips23_tpu_torch.evaluation.persist import save_parameters, save_pseudo_labels
from menghini_neurips23_tpu_torch.ops.clip_head import fused_probs
from menghini_neurips23_tpu_torch.parallel import multihost
from menghini_neurips23_tpu_torch.pseudo.engine import compute_pseudo_labels, pseudolabel_top_k
from menghini_neurips23_tpu_torch.runtime import ClipRuntime
from menghini_neurips23_tpu_torch.training.fused import FusedProgram, numpy_tree, train_step
from menghini_neurips23_tpu_torch.training.schedulers import lr_for_epoch
from menghini_neurips23_tpu_torch.utils.cache import BoundedFeatureCache

log = logging.getLogger(__name__)


def _np_key(a) -> tuple:
    """Content key for a small host array (shape, dtype and a digest)."""
    a = np.ascontiguousarray(a)
    return (a.shape, a.dtype.str, hashlib.blake2b(a.tobytes(), digest_size=16).hexdigest())


def _rank_world() -> Optional[Tuple[int, int]]:
    """(rank, size) of this rank's data group in a process group, at any
    size (the whole group without a 'model' axis); None outside one."""
    if not multihost.is_initialized():
        return None
    return multihost.data_index(), multihost.data_count()


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
    """Training arrays for one training-set composition, on the host.

    features is None in STREAMING mode (training set too large to
    materialize, or an active transform): the per-step loop then fetches
    per-batch features through the bounded cache instead."""

    def __init__(self, features, labels, group, paths):
        self.features = features  # (N, E) or (N, S, W) array, or None when streaming
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

    def _get_prompt_tree(self) -> Dict[str, torch.Tensor]:
        """The trainable leaf tensors by name (modality hook): the live
        leaves, which the per-step loop updates in place."""
        raise NotImplementedError

    def _prompt_params(self) -> List[torch.Tensor]:
        """The trainable leaf tensors, in the tree's order."""
        return list(self._get_prompt_tree().values())

    def _set_prompt_tree(self, tree):
        """Replace the prompt with `tree` (host or device arrays by the names
        `_get_prompt_tree` gives); re-initializes the optimizer state and
        bumps the prompt version (modality hook)."""
        raise NotImplementedError

    def _logits_fn(self):
        """A pure function (prompt tree, class context, features) -> (B, C)
        fp32 logits, differentiable in the tree (modality hook; the JAX
        package's `_logits_fn`)."""
        raise NotImplementedError

    # rows per validation chunk in the whole-run trainer (None: all at once)
    _FUSED_VAL_ROWS: Optional[int] = None

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

    def _ctx_host(self, class_list) -> np.ndarray:
        """The step's class context for `class_list` on the host: int64
        token ids (CoOp, UPT) or fp32 frozen text features (VPT)."""
        x = np.asarray(self._train_text_class_ids(class_list))
        return x.astype(np.int64 if np.issubdtype(x.dtype, np.integer) else np.float32)

    def _class_context(self, class_list: Sequence[str]) -> torch.Tensor:
        """The step's class context for `class_list` as a device tensor."""
        return torch.tensor(self._ctx_host(class_list), device=self.device)

    def _bump_prompt_version(self):
        """Invalidate prompted-feature memos: called on every prompt change,
        the optimizer's in-place updates included."""
        self._prompt_version = getattr(self, "_prompt_version", 0) + 1

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
        """A fresh optimizer state over the prompt: zero momentum and a zero
        gradient accumulator per leaf."""
        tree = self._get_prompt_tree()
        self._mom = {k: torch.zeros_like(v) for k, v in tree.items()}
        self._gacc = {k: torch.zeros_like(v) for k, v in tree.items()}

    def _apply_step(self, class_ctx: torch.Tensor, lr: float, feats: torch.Tensor,
                    labels: torch.Tensor, group: torch.Tensor, valid: torch.Tensor,
                    apply: bool = True, counts=None) -> Tuple[float, float]:
        """One step of the per-step loop on device tensors, through the same
        `train_step` as the whole-run trainer: the gradient of loss /
        ACCUMULATION_ITER into the accumulator; with `apply`, one SGD update
        at `lr` (the reference's manual accumulation,
        textual_prompt.py:130-135).  Returns (loss, correct count), which
        syncs with the host.  `counts`: in a process group, the whole
        batch's valid rows per group (these rows being the rank's block);
        the loss and the count returned are then the whole batch's.

        The update is in place, so it bumps the prompt version that keys the
        prompted-feature memo."""
        cfg = self.config
        loss, correct = train_step(
            self._logits_fn(), self._get_prompt_tree(), self._mom, self._gacc, class_ctx,
            feats, labels, group, valid, self._w0, self._w1, lr, apply,
            max(1, cfg.ACCUMULATION_ITER), cfg.DECAY, cfg.MOMENTUM, counts,
        )
        if apply:
            self._bump_prompt_version()
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

        fused = self._fused_train(epoch, val, train_classes)
        if fused is not None:
            return fused

        best_acc = -1.0
        best_params = self.epoch_parameters()
        class_ctx = self._class_context(train_classes)
        self._init_opt_state()
        bs = self._batch_size()
        feats = None if epoch.features is None else torch.tensor(epoch.features,
                                                                 device=self.device)

        for e in range(cfg.EPOCHS):
            lr = lr_for_epoch(cfg, e)
            train_acc, loss = self._run_train_epoch(class_ctx, epoch, feats, lr, bs)
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
        return EpochData(self._features_for_paths(paths), labels, groups, paths)

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

    # ---------------------------------------------------- whole-run trainer
    def _fused_train(self, epoch: EpochData, val, train_classes):
        """Run the whole training - every epoch's steps, its validation and
        the best-epoch selection - as the program of training/fused.py and
        return (best metric, best params); or return None, with the JAX
        package's logged reason, to take the per-step loop (JAX
        strategy.py:629-766).  The strategy keeps the final epoch's prompt,
        as the reference does, with a fresh optimizer state and a new prompt
        version; the returned params are the best epoch's."""
        cfg = self.config
        reason = None
        if not cfg.FUSED_TRAIN:
            reason = "FUSED_TRAIN disabled"
        elif len(epoch) == 0:
            reason = "empty training set"
        elif len(val[0]) == 0:
            reason = "empty validation set (per-epoch metric drives best-val selection)"
        elif epoch.features is None:
            if self._active_transform is not None:
                reason = (
                    "an active dataset transform must be re-applied every epoch (reference "
                    "data/dataset.py:64-79); the host loop re-encodes per batch"
                )
            else:
                est = len(epoch) * self._feature_item_nbytes()
                reason = (
                    f"training features (~{est/1e9:.1f} GB) exceed FUSED_MAX_BYTES/2 "
                    f"({cfg.FUSED_MAX_BYTES/2e9:.1f} GB); the host loop streams them per batch"
                )
        if reason is not None:
            log.warning(
                "fused training unavailable (%s): falling back to the dispatch-per-step "
                "host loop - expect a large slowdown on high-latency device links",
                reason,
            )
            return None
        t0 = time.perf_counter()
        inp = self._fused_train_inputs(epoch, val)
        chunk = cfg.FUSED_EPOCH_CHUNK
        pad = (-cfg.EPOCHS) % chunk if 0 < chunk < cfg.EPOCHS else 0
        perms = np.concatenate([inp["perms"], -np.ones((pad, inp["perms"].shape[1]), np.int64)])
        lrs = np.concatenate([inp["lrs"], np.zeros(pad, np.float32)])
        tree = self._get_prompt_tree()
        ctx, ctx_val = self._ctx_host(train_classes), self._ctx_host(inp["val_class_list"])
        key = (
            inp["bs"], len(perms), inp["n_slot"], inp["feats"].shape[1:], ctx.shape,
            ctx_val.shape, len(inp["val_labels"]), inp["trzsl_hmean"],
            tuple((k, tuple(v.shape)) for k, v in tree.items()),
        )
        prog = self._fused_program(key, inp, len(perms))
        pad_row = -np.ones((1, perms.shape[1]), np.int64)  # the warm-up's batch
        self._memo_seq_n = getattr(self, "_memo_seq_n", 0) + 1
        w = np.asarray([self._w0, self._w1], np.float32)
        val_is_seen = np.isin(inp["val_labels"], inp["seen_ids"]).astype(np.float32)
        flat = {
            "labels": inp["labels"], "groups": inp["groups"], "lrs": np.append(lrs, np.float32(0)),
            "apply_flags": inp["apply_flags"], "val_labels": inp["val_labels"],
            "val_global": inp["val_global"], "val_is_seen": val_is_seen, "w": w,
            "n_real": np.asarray(inp["n"], np.float32),
            "n_epochs": np.asarray(cfg.EPOCHS, np.int64),
            "ctx_train": ctx, "ctx_val": ctx_val,
        }
        prog.memo_put({
            **{name: (_np_key(a), a) for name, a in flat.items()},
            # frozen-tower features per path are fixed for the strategy's
            # lifetime (an active transform never reaches here)
            "feats": (_paths_key(epoch.paths), inp["feats"], inp["n_slot"]),
            "val_feats": (_paths_key(val[0]), inp["val_feats"], len(inp["val_labels"])),
            # fresh every call (new draws from the RNG stream): never memoized
            "perms": (("seq", self._memo_seq_n), np.concatenate([perms, pad_row])),
        })
        fresh = prog.graphs is None
        zeros = {k: np.zeros(tuple(v.shape), np.float32) for k, v in tree.items()}
        # best-so-far: -inf and the initial prompt (any real epoch's metric
        # strictly beats -inf, so it is never returned)
        stats, best_np, final_np = self._fused_chunked_call(
            prog, (tree, zeros, zeros, -np.inf, tree), perms, lrs, cfg.EPOCHS, inp["real_steps"])
        metrics, train_accs, losses = stats
        for e in range(cfg.EPOCHS):
            log.info("epoch %d: loss=%.4f train_acc=%.4f val_acc=%.4f lr=%.5f",
                     e, losses[e], train_accs[e], metrics[e], lrs[e])
        best = int(np.argmax(metrics))
        self._set_prompt_tree(best_np)
        best_params = self.epoch_parameters()
        self._set_prompt_tree(final_np)
        log.info(
            "fused train: %d epochs, best epoch %d val=%.4f (final train_acc=%.4f loss=%.4f)",
            cfg.EPOCHS, best, metrics[best], float(train_accs[-1]),
            self._jax_logged_loss(float(losses[-1]), prog.steps, inp["real_steps"]),
        )
        self._fused_info = {
            "epochs": cfg.EPOCHS, "steps_per_epoch": inp["real_steps"],
            "slot_steps": prog.steps, "graphs": prog.graphs is not None,
            "captured": fresh and prog.graphs is not None, "capture_s": prog.capture_s,
            "pool_bytes": prog.pool_bytes,
            # [K1, K2] a replay launches, and of those the streamed ones (T > 320)
            "launches_per_step": prog.per_step and prog.per_step[:2],
            "launches_per_epoch_end": prog.per_epoch_end and prog.per_epoch_end[:2],
            "streamed_launches_per_step": prog.per_step and prog.per_step[2:4],
            "all_reduces_per_step": prog.per_step and prog.per_step[4],
            "model_all_reduces_per_step": prog.per_step and prog.per_step[5],
            "all_reduces_per_epoch_end": prog.per_epoch_end and prog.per_epoch_end[4],
            "stats": stats, "run_s": time.perf_counter() - t0,
        }
        if not getattr(self, "_fused_keep", False):
            self._fused_free()
        return float(metrics[best]), best_params

    @staticmethod
    def _jax_logged_loss(last_real: float, slot_steps: int, real_steps: int) -> float:
        """The final loss the JAX fused trainer logs: its scan's last slot
        step's (JAX strategy.py:865).  A slot padded by a batch or more (a
        GRIP FUSED_BUCKETS rung) ends in an all-padding batch, whose loss is
        masked_mean's 0.0; otherwise it is the last real batch's, which the
        stats hold.  The padding batches are not replayed to find it."""
        return 0.0 if slot_steps > real_steps else last_real

    def _fused_program(self, key, inp, epochs_padded: int) -> FusedProgram:
        """The program for shape `key`: the cached one, or a new one after
        the last shape's graphs and buffers are freed (one shape at a time:
        IFPL/GRIP keep theirs across iterations, `train()` frees it at its
        end otherwise)."""
        cfg = self.config
        cache = getattr(self, "_fused_cache", None)
        if cache is None:
            cache = self._fused_cache = {}
        key = key + (cfg.ACCUMULATION_ITER, cfg.DECAY, cfg.MOMENTUM, cfg.FUSED_REMAT,
                     _rank_world())
        prog = cache.get(key)
        if prog is not None:
            return prog
        cache.clear()
        logits_fn = train_fn = self._logits_fn()
        if cfg.FUSED_REMAT and self.MODALITY != "text":
            # recompute the towers in the backward (the JAX package's
            # jax.checkpoint); CLIP draws no random numbers, and reading the
            # RNG state is illegal during capture
            def train_fn(tree, ctx, feats):
                return checkpoint(logits_fn, tree, ctx, feats, use_reentrant=False,
                                  preserve_rng_state=False)
        cache[key] = prog = FusedProgram(
            self.device, logits_fn, train_fn, steps=inp["steps"], bs=inp["bs"],
            n_slot=inp["n_slot"], epochs_padded=epochs_padded, trzsl=inp["trzsl_hmean"],
            val_rows=self._FUSED_VAL_ROWS, accum=max(1, cfg.ACCUMULATION_ITER),
            wd=cfg.DECAY, momentum=cfg.MOMENTUM,
            capture=self.device.type == "cuda" and not getattr(self, "_fused_eager", False),
            rank_world=_rank_world(),
        )
        self._fused_builds = getattr(self, "_fused_builds", 0) + 1
        return prog

    def _fused_free(self):
        """Drop the cached program: its graphs, their pool and its buffers."""
        getattr(self, "_fused_cache", {}).clear()

    def _fused_train_inputs(self, epoch: EpochData, val):
        """Host-side assembly for the whole-run trainer (JAX
        strategy.py:924-1025): every epoch's permutation, drawn up front from
        self._rng in the per-step loop's stream order (so both forms see the
        same batches), per-epoch lrs, labels and groups padded to `n_slot`
        (label -1, group 0), the apply-flag cadence and the validation
        arrays.  The features stay unpadded: their buffer pads itself.

        With `self._fused_bucket_ladder` (IFPL/GRIP), the training set is
        padded to the smallest rung that holds it, and validation to
        `self._fused_val_bucket`, so that the iterations share a few shapes;
        only the `real_steps` batches that hold a real row are run."""
        cfg = self.config
        n = len(epoch)
        bs = self._batch_size()
        bucket = getattr(self, "_fused_bucket", None)
        ladder = getattr(self, "_fused_bucket_ladder", None)
        if ladder:
            bucket = next((b for b in ladder if b >= n), ladder[-1])
        n_slot = max(n, bucket) if bucket else n
        steps = int(np.ceil(n_slot / bs))
        pad_n = steps * bs
        # permutation memo keyed by the RNG POSITION: a repeat call at the
        # same stream position reuses the drawn matrix and fast-forwards the
        # stream to the post-draw state, so the stream is the same either way
        rng_pos = repr(self._rng.bit_generator.state)
        pkey = (n, pad_n, cfg.EPOCHS, rng_pos)
        pmemo = getattr(self, "_perm_memo", None)
        if pmemo is not None and pmemo[0] == pkey:
            perms = pmemo[1]
            self._rng.bit_generator.state = copy.deepcopy(pmemo[2])
        else:
            perms = np.full((cfg.EPOCHS, pad_n), -1, np.int64)
            for e in range(cfg.EPOCHS):
                perms[e, :n] = self._rng.permutation(n)
            perms.setflags(write=False)
            self._perm_memo = (pkey, perms, copy.deepcopy(self._rng.bit_generator.state))
        lrs = np.asarray([lr_for_epoch(cfg, e) for e in range(cfg.EPOCHS)], np.float32)
        labels = np.concatenate([epoch.labels, -np.ones(n_slot - n, np.int32)])
        groups = np.concatenate([epoch.group, np.zeros(n_slot - n, np.int32)])

        val_paths, val_labels, val_class_list = val
        val_feats = self._features_for_paths(val_paths)
        val_labels = np.asarray(val_labels, np.int32)
        # validation gets a fixed slot too: the FPL pseudo-val split grows
        # with the GRIP schedule; padded rows carry label -1
        val_bucket = getattr(self, "_fused_val_bucket", None)
        if bucket and val_bucket and val_bucket > len(val_labels):
            val_labels = np.concatenate([val_labels, -np.ones(val_bucket - len(val_labels),
                                                              np.int32)])
        # val-class argmax -> global label id
        val_global = np.asarray([self.label_to_idx[c] for c in val_class_list], np.int64)
        trzsl_hmean = self.paradigm == "trzsl" and self.val_unseen_files is not None
        seen_ids = np.asarray(sorted(self.label_to_idx[c] for c in self.seen_classes), np.int32)
        # optimizer-apply cadence: every ACCUMULATION_ITER real batches and at
        # the last real batch of the epoch, as in the per-step loop; trailing
        # all-pad bucket batches never apply
        accum = max(1, cfg.ACCUMULATION_ITER)
        real_steps = int(np.ceil(n / bs))
        apply_flags = np.zeros(steps, np.float32)
        for si in range(real_steps):
            if ((si + 1) % accum == 0) or (si + 1 == real_steps):
                apply_flags[si] = 1.0
        return {
            "apply_flags": apply_flags, "steps": steps, "real_steps": real_steps, "bs": bs,
            "n": n, "n_slot": n_slot,
            "feats": epoch.features, "labels": labels, "groups": groups, "perms": perms,
            "lrs": lrs, "val_feats": val_feats, "val_labels": val_labels,
            "val_class_list": val_class_list, "val_global": val_global,
            "trzsl_hmean": trzsl_hmean, "seen_ids": seen_ids,
        }

    def _fused_chunked_call(self, prog: FusedProgram, carry0, perms, lrs, epochs: int,
                            steps: int):
        """Run the program's `steps` steps a epoch over all epochs at once,
        or in FUSED_EPOCH_CHUNK-epoch chunks (JAX strategy.py:1027-1139):
        `perms` and `lrs` are padded with all-pad epochs to a whole number
        of chunks, as the JAX package pads them, but those epochs are not
        run (they would change nothing); each chunk ends in one stats
        fetch.

        With CHECKPOINT_ITER the carry (prompt, momentum, gacc, best metric,
        best prompt) and the stats so far are saved at every chunk boundary,
        keyed by a fingerprint of (perms, lrs, epochs, chunk, initial carry):
        with RESUME a run whose restored RNG stream and prompt re-init counter
        reproduce those inputs picks the carry up, bit-identical to an
        uninterrupted run; any other misses the key.  MNT_FAIL_AFTER_CHUNK=n
        (environment) raises after chunk n.  In a process group rank 0
        alone writes and clears the chunk state, and every rank resumes at
        rank 0's point (JAX strategy.py:1081-1102): a rank that cannot read
        a state rank 0 read raises (the checkpoint directory must be shared).

        :returns: (stats (3, epochs), best-prompt host tree, final-prompt
            host tree)"""
        cfg = self.config
        chunk = cfg.FUSED_EPOCH_CHUNK
        prog.load_carry(carry0)
        if chunk <= 0 or chunk >= epochs:
            prog.run(0, epochs, steps)
            stats = prog.fetch_stats(0, epochs)
            return (stats, *prog.fetch_prompts())
        from menghini_neurips23_tpu_torch.checkpoint import (
            chunk_fingerprint,
            clear_chunk_state,
            load_chunk_state,
            save_chunk_state,
        )

        total = len(perms)
        start, outs = 0, []
        fp = None
        if cfg.CHECKPOINT_ITER:
            prompt, mom, gacc, bm, best = carry0
            fp = chunk_fingerprint(perms, lrs, epochs, chunk, (
                numpy_tree(prompt), mom, gacc, np.float32(bm), numpy_tree(best)))
            state = load_chunk_state(cfg, fp) if cfg.RESUME else None
            if cfg.RESUME and multihost.is_initialized():
                agreed = multihost.broadcast_int(state["next_start"] if state else -1)
                if agreed >= 0 and state is None:
                    raise RuntimeError(
                        "rank 0 has a fused-chunk checkpoint but this rank cannot read it; "
                        "the checkpoint directory must be on a shared filesystem"
                    )
                if agreed < 0:
                    state = None
            if state is not None:
                start, outs = state["next_start"], list(state["outs_list"])
                prog.load_carry(state["carry"])
                log.info("resuming fused training at epoch %d/%d from chunk checkpoint",
                         start, epochs)
        fail_after = int(os.environ.get("MNT_FAIL_AFTER_CHUNK", "0") or 0)
        for ci, s in enumerate(range(start, total, chunk), 1):
            stop = min(s + chunk, epochs)
            prog.run(s, stop, steps)
            outs.append(prog.fetch_stats(s, stop))
            if fp is not None and s + chunk < total:
                save_chunk_state(cfg, fp, s + chunk, prog.carry_numpy(), outs)
            if fail_after and ci == fail_after:
                raise RuntimeError(f"fault injection: MNT_FAIL_AFTER_CHUNK={fail_after}")
        if fp is not None:
            clear_chunk_state(cfg, fp)
        stats = np.concatenate(outs, axis=1)
        return (stats, *prog.fetch_prompts())

    def _run_train_epoch(self, class_ctx, epoch: EpochData, features, lr, bs):
        """One epoch of the per-step loop; `features` is the epoch's features
        on the device, or None to stream them per batch."""
        n = len(epoch)
        accum = max(1, self.config.ACCUMULATION_ITER)
        order = self._rng.permutation(n)
        starts = list(range(0, n, bs))
        dev = self.device
        rank_world = _rank_world()
        total_correct = 0
        total = 0
        loss_val = 0.0
        for si, s in enumerate(starts):
            idx = order[s : s + bs]
            count = len(idx)
            pad = bs - count
            sel = np.concatenate([idx, np.zeros(pad, np.int64)]) if pad else idx
            labels = np.concatenate([epoch.labels[idx], -np.ones(pad, np.int32)])
            valid = np.concatenate([np.ones(count, np.float32), np.zeros(pad, np.float32)])
            group = epoch.group[sel]
            if features is None:  # streaming: the batch's features through the cache
                # (in a process group every rank asks for the whole batch: the
                # frozen pass splits its decode over the ranks and gathers it)
                feats = torch.from_numpy(np.ascontiguousarray(
                    self._features_for_paths([epoch.paths[i] for i in sel], stack_memo=False)
                )).to(dev)
            counts = None
            if rank_world is not None:
                # the whole batch's valid rows per group, then the rank's block
                counts = tuple(torch.tensor(float(valid[group == g].sum()), device=dev)
                               for g in (0, 1))
                rank, world = rank_world
                per = -(-bs // world)
                lo = min(rank * per, bs)
                hi = min(lo + per, bs)
                fill = per - (hi - lo)
                rows = np.minimum(np.arange(lo, lo + per), bs - 1)
                sel, labels, valid, group = (
                    np.concatenate([x[lo:hi], np.full(fill, f, x.dtype)])
                    for x, f in ((sel, 0), (labels, -1), (valid, 0), (group, 0)))
                if features is None:
                    feats = feats[torch.from_numpy(rows).to(dev)]
            if features is not None:
                feats = features[torch.from_numpy(sel).to(dev)]
            # optimizer steps every accum batches or at epoch end (reference
            # textual_prompt.py:134-135)
            apply = ((si + 1) % accum == 0) or (si + 1 == len(starts))
            loss_val, correct = self._apply_step(
                class_ctx, lr, feats,
                torch.from_numpy(labels).to(dev),
                torch.from_numpy(group).to(dev),
                torch.from_numpy(valid).to(dev),
                apply=apply, counts=counts,
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

        # the GRIP shape ladder (JAX strategy.py:1310-1342): each iteration's
        # training set is padded to the smallest of FUSED_BUCKETS rungs, a
        # linear ladder up to the full pool plus the labeled shots, so the
        # growing sets share at most FUSED_BUCKETS shapes - on the card, that
        # many captures.  The padding is masked, so the math is unchanged,
        # and costs no compute: a run replays only its real batches.
        # FUSED_BUCKETS=0, IFPL and GRIP without ALL_UNLABELED (whose sets
        # hardly change size) take each iteration's exact shape.  Validation
        # gets a fixed slot (its pseudo-val share grows with the schedule).
        max_bucket = pool_size + len(train_data.filepaths)
        n_buckets = int(getattr(cfg, "FUSED_BUCKETS", 2))
        if not grow or n_buckets <= 0 or not cfg.ALL_UNLABELED:
            self._fused_bucket_ladder = None
            self._fused_bucket = None
        else:
            self._fused_bucket_ladder = [
                int(math.ceil(max_bucket * j / n_buckets)) for j in range(1, n_buckets + 1)
            ]
            self._fused_bucket = max_bucket
        max_pseudo_val = pool_size - int(pool_size * cfg.ratio_train_val)
        self._fused_val_bucket = (
            None if self._fused_bucket is None
            else len(val_data.filepaths) + max_pseudo_val + 1
        )
        # the whole-run trainer's program (its graphs on the card) stays
        # cached across iterations while its shape holds
        self._fused_keep = True
        try:
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
        finally:
            self._fused_bucket = None
            self._fused_bucket_ladder = None
            self._fused_val_bucket = None
            self._fused_keep = False
            self._fused_free()

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
