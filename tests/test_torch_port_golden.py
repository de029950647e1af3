"""Golden pins of the port's data-layer copies: `tests/golden/generate.py`'s
sections rebuilt from menghini_neurips23_tpu_torch's own `data/prepare.py`,
`evaluation/persist._prompt_file_name` and `pseudo/engine.py`, diffed
against `tests/golden/golden.json` (read only), and the port's
`data/splits.generate_split_json` against the JAX package's bundled
`data/data_splits/*.json`.

These are the surfaces the reference fixes bit for bit: the seeded NumPy
call sequences (the seed re-applied inside the class loop), the
leaderboard's arrival-order quirk and the artifact file names.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

GOLDEN = Path(__file__).parent / "golden" / "golden.json"
SPLIT_DIR = Path(__file__).resolve().parents[1] / "menghini_neurips23_tpu" / "data" / "data_splits"


def build_port_golden() -> dict:
    """The sections of tests/golden/generate.py's `build_golden`, each from
    the port's copy of the function."""
    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.data.prepare import (
        _seeded_62pct_split,
        sample_few_shots,
        split_data,
        train_val_split,
    )
    from menghini_neurips23_tpu_torch.evaluation.persist import _prompt_file_name
    from menghini_neurips23_tpu_torch.pseudo.engine import leaderboard_top_k, pseudolabel_cache_path

    out: dict = {}
    classes = [f"class{i:02d}" for i in range(20)]
    out["seeded_62pct_split"] = {
        str(seed): dict(zip(("seen", "unseen"), _seeded_62pct_split(classes, seed)))
        for seed in (500, 0, 200)
    }
    files = [f"f{i:03d}.png" for i in range(40)]
    labs = [f"class{i % 5:02d}" for i in range(40)]
    shots_files, shots_labs = sample_few_shots(files, labs, [f"class{i:02d}" for i in range(5)],
                                               2, 0)
    out["sample_few_shots"] = {"files": list(shots_files), "labels": list(shots_labs)}
    for name, split in (("train_val_split", train_val_split(files, labs, 0.8, 0)),
                        ("split_data", split_data(0.8, files, labs))):
        tf, tl, vf, vl = split
        out[name] = {"train_files": list(tf), "train_labels": list(tl),
                     "val_files": list(vf), "val_labels": list(vl)}
    rng = np.random.default_rng(123)
    probs = np.round(rng.dirichlet(np.ones(5) * 0.5, size=40).astype(np.float32), 6)
    probs = probs.astype(np.float32)
    paths = [f"pool/img{i:03d}.png" for i in range(40)]
    sel_files, sel_labels = leaderboard_top_k(probs, paths, 3, [10, 11, 12, 13, 14])
    out["leaderboard"] = {"probs": [[float(x) for x in row] for row in probs], "k": 3,
                          "class_ids": [10, 11, 12, 13, 14], "filepaths": sel_files,
                          "labels": sel_labels}
    all_files, all_labels = leaderboard_top_k(probs, paths, 10000000, [10, 11, 12, 13, 14])
    out["leaderboard_label_all"] = {"filepaths": all_files, "labels": all_labels}
    cfg = Config(DATASET_NAME="Flowers102", LEARNING_PARADIGM="ssl", MODEL="grip_textual",
                 VIS_ENCODER="ViT-B/32", OPTIM_SEED=1, SPLIT_SEED=500, ARTIFACT_DIR=".")
    out["filenames"] = {
        "prompt": _prompt_file_name(cfg),
        "prompt_iter3": _prompt_file_name(cfg, iteration=3),
        "pseudolabel_cache": pseudolabel_cache_path(".", "Flowers102", "ViT-B/32", "ssl",
                                                    "grip_textual", 16, 500),
    }
    return out


@pytest.fixture(scope="module")
def port_golden():
    # through JSON, as golden.json was written (tuples become lists)
    return json.loads(json.dumps(build_port_golden(), sort_keys=True))


@pytest.fixture(scope="module")
def stored():
    return json.loads(GOLDEN.read_text())


def test_port_golden_has_every_section(port_golden, stored):
    assert sorted(port_golden) == sorted(stored)


@pytest.mark.parametrize("section", ["seeded_62pct_split", "sample_few_shots",
                                     "train_val_split", "split_data", "leaderboard",
                                     "leaderboard_label_all", "filenames"])
def test_port_golden_section_matches(port_golden, stored, section):
    assert port_golden[section] == stored[section], (
        f"the port's {section!r} drifted from tests/golden/golden.json: an RNG-parity or "
        "file-name invariant of its data-layer copy broke")


@pytest.mark.parametrize("dataset", ["EuroSAT", "DTD", "Flowers102", "FGVCAircraft", "MNIST",
                                     "RESICS45"])
def test_port_split_json_matches_the_bundled_one(dataset):
    from menghini_neurips23_tpu_torch.data.splits import generate_split_json

    with open(os.path.join(SPLIT_DIR, f"{dataset}.json")) as f:
        bundled = json.load(f)
    assert generate_split_json(dataset, "/nonexistent") == bundled
