"""Seen/unseen split JSON artifacts.

The reference ships data/data_splits/*.json documenting the seen/unseen class
lists per split seed (split_500/split_0/split_200) but regenerates splits from
the seeded RNG at runtime; the JSONs are documentation.  This module produces
the same artifact from the same RNG so the two stay consistent.
"""

from __future__ import annotations

import json

from menghini_neurips23_tpu_torch.data.prepare import get_class_names

DEFAULT_SEEDS = (500, 0, 200)


def generate_split_json(dataset: str, dataset_dir: str, seeds=DEFAULT_SEEDS) -> dict:
    out = {}
    for seed in seeds:
        _, seen, unseen = get_class_names(dataset, dataset_dir, seed)
        out[f"split_{seed}"] = {"seen": seen, "unseen": unseen}
    return out


def write_split_json(dataset: str, dataset_dir: str, path: str, seeds=DEFAULT_SEEDS):
    with open(path, "w") as f:
        json.dump(generate_split_json(dataset, dataset_dir, seeds), f, indent=1)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    write_split_json(args.dataset, args.dataset_dir, args.out)
