from menghini_neurips23_tpu_torch.pseudo.engine import (  # noqa: F401
    LABEL_ALL,
    compute_pseudo_labels,
    leaderboard_top_k,
    pseudolabel_cache_path,
    pseudolabel_top_k,
)
