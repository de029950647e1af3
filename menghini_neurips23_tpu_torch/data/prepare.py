"""Class-name and file-list preparation for the FRAMED datasets.

Host-side counterpart of reference utils/prepare_data.py.  The seeded NumPy
RNG calls are kept **bit-identical** to the reference (same seed placement,
same np.random.choice invocations) so seen/unseen class splits, few-shot
selections and train/val splits - and therefore accuracy comparisons - match
the PyTorch reference exactly (SURVEY.md hard part #3).
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np

FRAMED = ("EuroSAT", "DTD", "RESICS45", "FGVCAircraft", "MNIST", "Flowers102")

# aPY class-name corrections (reference prepare_data.py:32-37)
APY_CORRECTIONS = {
    "diningtable": "dining table",
    "tvmonitor": "tv monitor",
    "jetski": "jet ski",
    "pottedplant": "potted plant",
}

# AwA2 class-name corrections (reference prepare_data.py:62-73)
AWA2_CORRECTIONS = {
    "grizzly+bear": "grizzly bear",
    "killer+whale": "killer whale",
    "persian+cat": "persian cat",
    "german+shepherd": "german shepherd",
    "blue+whale": "blue whale",
    "siamese+cat": "siamese cat",
    "spider+monkey": "spider monkey",
    "humpback+whale": "humpback whale",
    "giant+panda": "giant panda",
    "polar+bear": "polar bear",
}

# EuroSAT class-name -> directory correction (reference prepare_data.py:287-298)
EUROSAT_DIRS = {
    "annual crop land": "AnnualCrop",
    "brushland or shrubland": "HerbaceousVegetation",
    "highway or road": "Highway",
    "industrial buildings or commercial buildings": "Industrial",
    "pasture land": "Pasture",
    "permanent crop land": "PermanentCrop",
    "residential buildings or homes or apartments": "Residential",
    "lake or sea": "SeaLake",
    "river": "River",
    "forest": "Forest",
}


def _read_lines(path: str) -> List[str]:
    # exact reference behavior (prepare_data.py:88-90): every line, stripped -
    # including any blank lines, which become "" classes there too
    with open(path, "r") as f:
        return [l.strip() for l in f]


def _read_class_file(dataset: str, path: str, filename: str) -> List[str]:
    """Class-name list for a FRAMED dataset: read it from DATASET_DIR exactly
    like the reference (reference utils/prepare_data.py:88-90), falling back
    to the copy bundled with this package (the reference ships the same files
    under data/class_files/) so a real-data run needs only images + index
    files."""
    import os

    primary = f"{path}/{filename}"
    if os.path.exists(primary):
        return _read_lines(primary)
    bundled = os.path.join(
        os.path.dirname(__file__), "class_files", dataset, filename
    )
    if os.path.exists(bundled):
        return _read_lines(bundled)
    raise FileNotFoundError(
        f"no class file for {dataset}: neither {primary} nor bundled {bundled}"
    )


def _seeded_62pct_split(classes: Sequence[str], seed: int) -> Tuple[List[str], List[str]]:
    """62% seen / 38% unseen via np.random.choice - bit-identical to
    reference prepare_data.py:92-99 (same seed call, same argument forms)."""
    np.random.seed(seed)
    seen_indices = np.random.choice(
        range(len(classes)), size=int(len(classes) * 0.62), replace=False
    )
    unseen_indices = list(set(range(len(classes))).difference(set(seen_indices)))
    seen = list(np.array(classes)[seen_indices])
    unseen = list(np.array(classes)[unseen_indices])
    return seen, unseen


def get_class_names(dataset: str, dataset_dir: str, seed: int = 500):
    """Returns (classes, seen_classes, unseen_classes).

    Mirrors reference utils/prepare_data.py:12-206 for the FRAMED datasets
    (class list file per dataset + seeded 62% split).  CUB's fixed
    trainval/test class files are also supported (reference :187-204).
    """
    path = f"{dataset_dir}/{dataset}"
    if dataset == "aPY":
        # legacy branch (reference prepare_data.py:19-45): fixed proposed split
        p = f"{path}/proposed_split"
        seen = [APY_CORRECTIONS.get(c, c) for c in _read_lines(f"{p}/trainvalclasses.txt")]
        unseen = [APY_CORRECTIONS.get(c, c) for c in _read_lines(f"{p}/testclasses.txt")]
        return seen + unseen, seen, unseen
    if dataset == "Animals_with_Attributes2":
        # legacy branch (reference prepare_data.py:47-82)
        seen = [AWA2_CORRECTIONS.get(c, c) for c in _read_lines(f"{path}/trainvalclasses.txt")]
        unseen = [AWA2_CORRECTIONS.get(c, c) for c in _read_lines(f"{path}/testclasses.txt")]
        return seen + unseen, seen, unseen
    if dataset in ("EuroSAT", "DTD", "Flowers102"):
        classes = _read_class_file(dataset, path, "class_names.txt")
    elif dataset in ("FGVCAircraft", "MNIST"):
        classes = _read_class_file(dataset, path, "labels.txt")
    elif dataset == "RESICS45":
        # Reference prepare_data.py:101-111 reads the category list from the
        # COCO-style train.json; fall back to the bundled category list (same
        # order, recovered from the reference's data_splits/RESICS45.json by
        # inverting the seeded split) when the index file is absent.
        index = f"{path}/train.json"
        if os.path.exists(index):
            with open(index, "r") as f:
                data = json.load(f)
            classes = [d["name"].replace("_", " ") for d in data["categories"]]
        else:
            classes = _read_class_file(dataset, path, "categories.txt")
    elif dataset == "CUB":
        seen_classes = [
            l.split(".")[-1].strip().replace("_", " ").lower()
            for l in _read_lines(f"{path}/trainvalclasses.txt")
        ]
        unseen_classes = [
            l.split(".")[-1].strip().replace("_", " ").lower()
            for l in _read_lines(f"{path}/testclasses.txt")
        ]
        return seen_classes + unseen_classes, seen_classes, unseen_classes
    else:
        raise ValueError(f"Unknown dataset {dataset!r}")

    seen, unseen = _seeded_62pct_split(classes, seed)
    return classes, seen, unseen


def get_labeled_and_unlabeled_data(
    dataset: str,
    data_folder: str,
    seen_classes: Sequence[str],
    unseen_classes: Sequence[str],
    classes: Sequence[str] | None = None,
):
    """Parse ELEVATER-style index files into (labeled, unlabeled, test) lists
    of (filename, classname).  Mirrors reference prepare_data.py:209-604 per
    dataset; 'labeled' covers seen classes, 'unlabeled' unseen classes.
    """
    if dataset == "Animals_with_Attributes2":
        # legacy branch (reference prepare_data.py:271-284 + the generic
        # 80/20 split tail :586-604): no index files, 20% held out as test
        labeled_files, labels_files, unlabeled_files, unlabeled_labs = [], [], [], []
        for c in seen_classes:
            for f in os.listdir(f"{data_folder}/JPEGImages/{c.replace(' ', '+')}"):
                labeled_files.append(f)
                labels_files.append(c)
        for c in unseen_classes:
            for f in os.listdir(f"{data_folder}/JPEGImages/{c.replace(' ', '+')}"):
                unlabeled_files.append(f)
                unlabeled_labs.append(c)
        tr_f, tr_l, te_sf, te_sl = split_data(0.8, labeled_files, labels_files)
        un_f, un_l, te_uf, te_ul = split_data(0.8, unlabeled_files, unlabeled_labs)
        labeled = list(zip(tr_f, tr_l))
        unlabeled = list(zip(un_f, un_l))
        test = list(zip(te_sf, te_sl)) + list(zip(te_uf, te_ul))
        return labeled, unlabeled, test

    if dataset == "aPY":
        # legacy branch (reference prepare_data.py:222-269 + generic tail)
        import pandas as pd

        image_data = pd.read_csv(f"{data_folder}/image_data.csv", sep=",")
        broken = {"yahoo_test_images/bag_227.jpg", "yahoo_test_images/mug_308.jpg"}
        names = [
            "broken" if row in broken else f"{i}.jpg"
            for i, row in enumerate(image_data["image_path"])
        ]
        image_data["file_names"] = names
        image_data["label"] = image_data["label"].apply(
            lambda x: APY_CORRECTIONS.get(x, x)
        )
        image_data["seen"] = image_data["label"].apply(
            lambda x: 1 if x in seen_classes else 0
        )
        ok = image_data["file_names"] != "broken"
        labeled_files = list(image_data[(image_data["seen"] == 1) & ok]["file_names"])
        labels_files = list(image_data[(image_data["seen"] == 1) & ok]["label"])
        unlabeled_files = list(image_data[(image_data["seen"] == 0) & ok]["file_names"])
        unlabeled_labs = list(image_data[(image_data["seen"] == 0) & ok]["label"])
        tr_f, tr_l, te_sf, te_sl = split_data(0.8, labeled_files, labels_files)
        un_f, un_l, te_uf, te_ul = split_data(0.8, unlabeled_files, unlabeled_labs)
        labeled = list(zip(tr_f, tr_l))
        unlabeled = list(zip(un_f, un_l))
        test = list(zip(te_sf, te_sl)) + list(zip(te_uf, te_ul))
        return labeled, unlabeled, test

    if dataset == "EuroSAT":
        labeled, unlabeled = [], []
        for c in seen_classes:
            for f in os.listdir(f"{data_folder}/{EUROSAT_DIRS[c]}"):
                labeled.append((f, c))
        for c in unseen_classes:
            for f in os.listdir(f"{data_folder}/{EUROSAT_DIRS[c]}"):
                unlabeled.append((f, c))
        test = []
        with open(f"{data_folder}/test.txt", "r") as fh:
            for l in fh:
                line = l.split(" ")
                fname = line[0].strip().split("@")[-1].split("/")[-1]
                test.append((fname, classes[int(line[1].strip())]))
        return labeled, unlabeled, test

    if dataset == "DTD":
        labeled, unlabeled = [], []
        for split in ("train", "val"):
            with open(f"{data_folder}/{split}.txt", "r") as fh:
                for l in fh:
                    line = l.split(" ")
                    cl = classes[int(line[1].strip())]
                    entry = (f"{split}/{line[0].strip().split('@')[-1]}", cl)
                    if cl in seen_classes:
                        labeled.append(entry)
                    elif cl in unseen_classes:
                        unlabeled.append(entry)
                    else:
                        raise ValueError(f"class {cl} is neither seen nor unseen")
        test = []
        with open(f"{data_folder}/test.txt", "r") as fh:
            for l in fh:
                line = l.split(" ")
                test.append(
                    (f"test/{line[0].strip().split('@')[-1]}", classes[int(line[1].strip())])
                )
        return labeled, unlabeled, test

    if dataset == "RESICS45":
        labeled, unlabeled = [], []
        for split in ("train", "val"):
            with open(f"{data_folder}/{split}.json", "r") as fh:
                data = json.load(fh)
            for d in data["images"]:
                file_name = d["file_name"].split("@")[-1]
                cl = file_name.split("/")[0].replace("_", " ")
                img = file_name.split("/")[-1]
                if cl in seen_classes:
                    labeled.append((img, cl))
                elif cl in unseen_classes:
                    unlabeled.append((img, cl))
                else:
                    raise ValueError(f"class {cl} is neither seen nor unseen")
        test = []
        with open(f"{data_folder}/test.json", "r") as fh:
            data = json.load(fh)
        for d in data["images"]:
            file_name = d["file_name"].split("@")[-1]
            cl = file_name.split("/")[0].replace("_", " ")
            test.append((file_name.split("/")[-1], cl))
        return labeled, unlabeled, test

    if dataset == "FGVCAircraft":
        labeled, unlabeled = [], []
        for split in ("train", "val"):
            with open(f"{data_folder}/{split}.txt", "r") as fh:
                for l in fh:
                    img = " ".join(l.split(" ")[:-1]).split("@")[-1].strip()
                    cl = img.split("/")[0].strip()
                    if cl in seen_classes:
                        labeled.append((f"{split}/{img}", cl))
                    elif cl in unseen_classes:
                        unlabeled.append((f"{split}/{img}", cl))
                    else:
                        raise ValueError(f"class {cl} is neither seen nor unseen")
        test = []
        with open(f"{data_folder}/test.txt", "r") as fh:
            for l in fh:
                img = " ".join(l.split(" ")[:-1]).split("@")[-1].strip()
                test.append((f"test/{img}", img.split("/")[0].strip()))
        return labeled, unlabeled, test

    if dataset == "MNIST":
        labeled, unlabeled = [], []
        with open(f"{data_folder}/train.txt", "r") as fh:
            for l in fh:
                img = l.split(" ")[0].split("@")[-1].strip()
                cl = img.split("/")[0].strip()
                if cl in seen_classes:
                    labeled.append((f"train/{img}", cl))
                elif cl in unseen_classes:
                    unlabeled.append((f"train/{img}", cl))
                else:
                    raise ValueError(f"class {cl} is neither seen nor unseen")
        test = []
        with open(f"{data_folder}/test.txt", "r") as fh:
            for l in fh:
                img = l.split(" ")[0].split("@")[-1].strip()
                test.append((f"test/{img}", img.split("/")[0].strip()))
        return labeled, unlabeled, test

    if dataset == "Flowers102":
        labeled, unlabeled = [], []
        for split in ("train", "val"):
            with open(f"{data_folder}/{split}.txt", "r") as fh:
                for l in fh:
                    line = l.split(" ")
                    img = line[0].split("@")[-1].strip()
                    cl = classes[int(line[1].strip())]
                    if cl in seen_classes:
                        labeled.append((f"{split}/{img}", cl))
                    elif cl in unseen_classes:
                        unlabeled.append((f"{split}/{img}", cl))
                    else:
                        raise ValueError(f"class {cl} is neither seen nor unseen")
        test = []
        with open(f"{data_folder}/test.txt", "r") as fh:
            for l in fh:
                line = l.split(" ")
                img = line[0].split("@")[-1].strip()
                test.append((f"test/{img}", classes[int(line[1].strip())]))
        return labeled, unlabeled, test

    if dataset == "CUB":
        labeled, unlabeled = [], []
        with open(f"{data_folder}/train.txt", "r") as fh:
            for l in fh:
                line = l.strip()
                cl = line.split("/")[0].split(".")[-1].strip().replace("_", " ").lower()
                entry = (f"CUB_200_2011/images/{line}", cl)
                if cl in seen_classes:
                    labeled.append(entry)
                elif cl in unseen_classes:
                    unlabeled.append(entry)
                else:
                    raise ValueError(f"class {cl} is neither seen nor unseen")
        test = []
        with open(f"{data_folder}/test.txt", "r") as fh:
            for l in fh:
                line = l.strip()
                cl = line.split("/")[0].split(".")[-1].strip().replace("_", " ").lower()
                test.append((f"CUB_200_2011/images/{line}", cl))
        return labeled, unlabeled, test

    raise ValueError(f"Unknown dataset {dataset!r}")


def split_data(ratio: float, files: Sequence, labels: Sequence):
    """Seeded 80/20 split (reference prepare_data.py:607-620; fixed seed 500)."""
    np.random.seed(500)
    train_indices = np.random.choice(
        range(len(files)), size=int(len(files) * ratio), replace=False
    )
    val_indices = list(set(range(len(files))).difference(set(train_indices)))
    files = np.array(files)
    labels = np.array(labels)
    return files[train_indices], labels[train_indices], files[val_indices], labels[val_indices]


def train_val_split(files: Sequence, labels: Sequence, ratio: float, seed: int):
    """Seeded train/val split used by every driver (reference main_SSL.py:133-145)."""
    np.random.seed(seed)
    train_indices = np.random.choice(
        range(len(files)), size=int(len(files) * ratio), replace=False
    )
    val_indices = list(set(range(len(files))).difference(set(train_indices)))
    files = np.array(files)
    labels = np.array(labels)
    return (
        files[train_indices],
        labels[train_indices],
        files[val_indices],
        labels[val_indices],
    )


def sample_few_shots(labeled_files, labeles, classes, n_label: int, seed: int):
    """Few-shot sampling per class - bit-identical RNG placement to reference
    main_SSL.py:100-113 (np.random.seed is re-applied *inside* the class loop)."""
    labeled_files = np.array(labeled_files)
    labeles = np.array(labeles)
    few_files: list = []
    few_labs: list = []
    for c in classes:
        np.random.seed(seed)
        indices = np.random.choice(
            np.where(labeles == c)[0], size=n_label, replace=False
        )
        few_files += list(labeled_files[indices])
        few_labs += list(labeles[indices])
    return few_files, few_labs
