"""File-list datasets with per-dataset path layouts.

Replaces reference data/dataset.py (CustomDataset + 7 near-identical
subclasses) with one `FileListDataset` plus a path-resolver registry - the
only thing the reference subclasses override is filepath resolution
(reference data/dataset.py:128, :166-180, :256-259, :296-307, :344-355,
:393-404).

A dataset here is purely host-side metadata (resolved paths + labels); image
bytes move through `menghini_neurips23_tpu_torch.data.loader` in fixed-size batches.
The mutation protocol of the reference (pseudolabel engines overwrite
`.filepaths`/`.labels`/`.label_id` in place, e.g. utils/clip_pseudolabels.py:
111-112) is preserved so training strategies compose the same way.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence


def _train_test_prefix(root: str, filepaths: Sequence[str], train: bool) -> List[str]:
    sub = "train" if train else "test"
    return [f"{root}/{sub}/{f}" for f in filepaths]


class FileListDataset:
    """Host-side dataset: resolved absolute filepaths + optional labels.

    :param filepaths: raw file names/relative paths (pre-resolution)
    :param root: dataset root directory
    :param train: whether paths live under root/train or root/test (base rule)
    :param labels: class labels (strings unless label_id)
    :param label_id: True when labels are already int ids
    :param label_map: class name -> int id
    """

    dataset_name = "custom"

    def __init__(
        self,
        filepaths: Sequence[str],
        root: str,
        transform=None,
        augmentations=None,
        train: bool = True,
        labels: Optional[Sequence] = None,
        label_id: bool = False,
        label_map: Optional[Dict[str, int]] = None,
        class_folder: bool = False,
        original_filepaths: Optional[Sequence[str]] = None,
    ):
        self.root = root
        self.train = train
        self.transform = transform
        self.augmentations = augmentations
        # aug1/aug2 transform hooks (reference data/dataset.py:40-46; always
        # None in every reference run, but part of the dataset surface)
        if augmentations:
            self.aug1_transform, self.aug2_transform = augmentations[0], augmentations[1]
        else:
            self.aug1_transform = None
            self.aug2_transform = None
        self.labels = list(labels) if labels is not None else None
        self.label_id = label_id
        self.label_map = label_map
        self.filepaths = self._resolve(
            list(filepaths), root, train, class_folder, original_filepaths
        )

    # Default: root/{train|test}/file (reference data/dataset.py:36-39)
    def _resolve(self, filepaths, root, train, class_folder, original_filepaths):
        return _train_test_prefix(root, filepaths, train)

    def __len__(self) -> int:
        return len(self.filepaths)

    def __getitem__(self, index: int):
        """Reference-compatible per-item access (reference data/dataset.py:
        55-88): (img, aug_1, aug_2[, label], basename).  The batch pipeline
        (data/loader.py) never uses this - it exists for API parity and for
        the aug1/aug2 transform hooks, which fall back to the base transform
        exactly as the reference does."""
        from PIL import Image

        img = Image.open(self.filepaths[index]).convert("RGB")
        aug_1 = self.aug1_transform(img) if self.aug1_transform is not None else None
        aug_2 = self.aug2_transform(img) if self.aug2_transform is not None else None
        if self.transform is not None:
            base = self.transform(img)
        else:
            base = img
        if aug_1 is None:
            aug_1 = base
        if aug_2 is None:
            aug_2 = base
        name = self.filepaths[index].split("/")[-1]
        if self.labels is not None:
            label = (
                int(self.labels[index])
                if self.label_id
                else int(self.label_map[self.labels[index]])
            )
            return base, aug_1, aug_2, label, name
        return base, aug_1, aug_2, name

    def label_ids(self) -> List[int]:
        """Labels as int ids (applying label_map unless already ids)."""
        if self.labels is None:
            raise ValueError("dataset has no labels")
        if self.label_id:
            return [int(l) for l in self.labels]
        return [int(self.label_map[l]) for l in self.labels]

    def basenames(self) -> List[str]:
        return [f.split("/")[-1] for f in self.filepaths]


class EuroSAT(FileListDataset):
    dataset_name = "EuroSAT"

    # root/{ClassDir}/{file}; class dir is the filename prefix before '_'
    # (reference data/dataset.py:128)
    def _resolve(self, filepaths, root, train, class_folder, original_filepaths):
        return [f"{root}/{f.split('_')[0]}/{f}" for f in filepaths]


class DTD(FileListDataset):
    dataset_name = "DTD"

    # root/{split}/{class}/{file}; class_folder mode re-resolves bare names by
    # scanning train/ and val/ class dirs (reference data/dataset.py:166-180)
    def _resolve(self, filepaths, root, train, class_folder, original_filepaths):
        if class_folder:
            paths = []
            for f in filepaths:
                cl = f.split("_")[0]
                tr_files = os.listdir(f"{root}/train/{cl}")
                val_files = os.listdir(f"{root}/val/{cl}")
                if f in tr_files:
                    paths.append(f"{root}/train/{cl}/{f}")
                elif f in val_files:
                    paths.append(f"{root}/val/{cl}/{f}")
            return paths
        return [f"{root}/{f}" for f in filepaths]


class CUB(FileListDataset):
    dataset_name = "CUB"

    def _resolve(self, filepaths, root, train, class_folder, original_filepaths):
        return [f"{root}/{f}" for f in filepaths]


class RESICS45(FileListDataset):
    dataset_name = "RESICS45"

    # root/{class_folder}/{file}; folder name = filename minus trailing index
    # (reference data/dataset.py:256-259)
    def _resolve(self, filepaths, root, train, class_folder, original_filepaths):
        out = []
        for f in filepaths:
            folder = "_".join(f.split("_")[:-1])
            out.append(f"{root}/{folder}/{f}")
        return out


class _OriginalPathLookup(FileListDataset):
    """Shared resolver: root/{split}/... normally; in class_folder mode,
    re-resolve bare basenames against an original filepath list (reference
    data/dataset.py:296-307 - note it preserves original_filepaths ORDER,
    not the order of `filepaths`)."""

    def _resolve(self, filepaths, root, train, class_folder, original_filepaths):
        if class_folder:
            wanted = set(filepaths)
            return [f for f in original_filepaths if f.split("/")[-1] in wanted]
        return [f"{root}/{f}" for f in filepaths]


class FGVCAircraft(_OriginalPathLookup):
    dataset_name = "FGVCAircraft"


class MNIST(_OriginalPathLookup):
    dataset_name = "MNIST"


class Flowers102(_OriginalPathLookup):
    dataset_name = "Flowers102"


DATASET_CLASSES: Dict[str, Callable] = {
    "EuroSAT": EuroSAT,
    "DTD": DTD,
    "CUB": CUB,
    "RESICS45": RESICS45,
    "FGVCAircraft": FGVCAircraft,
    "MNIST": MNIST,
    "Flowers102": Flowers102,
}


def dataset_object(name: str):
    """Name -> dataset class (reference utils/utils.py:11-33, minus the
    dangling aPY/AwA2/SUN397 entries that would ImportError there)."""
    if name not in DATASET_CLASSES:
        raise KeyError(f"Unknown dataset {name!r}; known: {sorted(DATASET_CLASSES)}")
    return DATASET_CLASSES[name]
