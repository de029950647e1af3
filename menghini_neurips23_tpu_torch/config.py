"""Typed run configuration.

Replaces the reference's three-layer config system (YAML -> attr-bag ->
env-var overrides; reference utils/utils.py:42-45 and methods/main_SSL.py:447-473)
with one dataclass that has explicit override precedence:

    defaults < YAML file < environment variables < explicit kwargs

All reference YAML keys (reference methods_config/*.yml) are supported with the
same names and semantics.  Dead reference keys (ALPHA, CLASSES_SPLIT - never
read by reference code) are accepted but unused, for config-file compatibility.
`yaml` is imported only by `from_yaml`, so code that builds a Config directly
does not need PyYAML.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

# Env vars the reference launcher scripts export (reference scripts/run_prompts_ssl.sh:9-23)
_ENV_KEYS = {
    # the reference's launcher protocol (scripts/run_prompts_ssl.sh:9-23)
    "OPTIM_SEED": int,
    "VIS_ENCODER": str,
    "DATASET_NAME": str,
    "DATASET_DIR": str,
    "MODEL": str,
    "SPLIT_SEED": int,
    # this framework's operational assets/knobs (REPRODUCE.md exports these;
    # without env pickup a real-assets run would silently use random weights)
    "CLIP_CKPT": str,
    "BPE_PATH": str,
    "PROFILE_DIR": str,
    "COMPILE_CACHE_DIR": str,
    # artifact root (trained_prompts/, pseudolabels/, evaluation/, results
    # JSONL): the launcher scripts run from the repo root (the reference's
    # protocol), so deployments with a read-only checkout redirect artifact
    # writes here
    "ARTIFACT_DIR": str,
}


@dataclasses.dataclass
class Config:
    # Experiment identity
    DATASET_NAME: str = ""
    DATASET_DIR: str = ""
    MODEL: str = ""
    # text | image | multi; "" derives from MODEL in __post_init__, so a
    # Config built with only MODEL (the launcher protocol) carries the right
    # modality BEFORE ClipRuntime construction - the bf16 precast gate keys
    # off it (runtime.py), and a stale default would silently re-enable the
    # measured UPT layout cliff for prebuilt-runtime flows
    MODALITY: str = ""
    VIS_ENCODER: str = "ViT-B/32"
    LEARNING_PARADIGM: str = "ssl"  # ssl | ul | trzsl
    PROMPT_TEMPLATE: str = "a photo of a {}"

    # Seeds / splits
    OPTIM_SEED: int = 1
    SPLIT_SEED: int = 500
    validation_seed: int = 0
    ratio_train_val: float = 0.8

    # SSL shots and pseudolabels
    N_LABEL: int = 2
    N_PSEUDOSHOTS: int = 16
    STEP_QUANTILE: int = 10
    ALL_UNLABELED: bool = True

    # Prompt shapes
    PREFIX_SIZE: int = 16
    TEXT_PREFIX_SIZE: int = 4
    VISION_PREFIX_SIZE: int = 4
    TRANSFORMER_DIM: int = 128
    VPT_DEEP: bool = False
    VIS_PREFIX_INIT: str = "normal"
    MEAN_INIT: float = 0.0
    VAR_INIT: float = 0.02

    # Optimization
    BATCH_SIZE: int = 16
    EPOCHS: int = 150
    SCHEDULER: str = "cosine"
    WARMUP_EPOCHS: int = 5
    WARMUP_LR: float = 1e-4
    ACCUMULATION_ITER: int = 1
    OPTIM: str = "SGD"
    LR: float = 0.1
    DECAY: float = 0.1
    STEP_SIZE: int = 1
    MOMENTUM: float = 0.0  # torch.optim.SGD default (reference never sets it)

    # Dead reference keys kept for YAML compatibility
    ALPHA: float = 0.3
    CLASSES_SPLIT: str = ""
    t_EPOCHS: int = 0
    s_EPOCHS: int = 0

    # Framework knobs (no reference equivalent).  The same names as the JAX
    # package's Config, so one YAML file configures both; knobs that only the
    # training slice reads are kept for that compatibility.
    COMPUTE_DTYPE: str = "float32"  # float32 | bfloat16
    CACHE_FEATURES: bool = True  # precompute frozen-tower features
    FUSED_TRAIN: bool = True  # training slice: whole-run training loop
    CHECKPOINT_ITER: bool = True  # training slice: checkpoint each IFPL/GRIP iteration
    RESUME: bool = True  # training slice: resume IFPL/GRIP from the latest checkpoint
    PROFILE_DIR: str = ""  # no counterpart in this package yet: main_template raises when set
    COMPILE_CACHE_DIR: str = ""  # no counterpart in this package yet: main_template raises when set
    PSEUDO_TOPK: str = "exact"  # exact (reference leaderboard) | device (not in this package yet)
    GRIP_REFRESH: str = "onepass"  # training slice: onepass | twopass GRIP refresh
    FUSED_MAX_BYTES: int = 6_000_000_000  # training slice: feature-size cap of the fused loop
    HOST_CACHE_BYTES: int = 4_000_000_000  # byte cap for the per-image host feature LRU
    DECODE_CACHE_BYTES: int = 2_000_000_000  # byte cap for decoded uint8 images (0 = off); GRIP refreshes re-read the pool every iteration
    FUSED_REMAT: bool = False  # training slice: recompute the vision tower in fused steps
    FUSED_ATTENTION: str = "auto"  # read for compatibility; on CUDA the attention kernel always runs
    FUSED_EPOCH_CHUNK: int = 0  # training slice: epochs per fused program
    FUSED_BUCKETS: int = 2  # training slice: GRIP train-set shape ladder depth
    TEXT_TRUNCATE: bool = True  # drop text-context positions after the last EOT (exact under causal attention). False = always run all 77 positions like the reference
    PRECAST_WEIGHTS: bool = True  # bf16 compute only: cast the transformer matmul weights to bf16 once at load (the same rounding as casting at every use)
    UPT_FP16_QUIRK: bool = False  # training slice: the reference UPTModel's fp16 round-trip of the mixer output
    MESH_SHAPE: str = ""  # multi-device layout; this package runs on one device
    ARTIFACT_DIR: str = "."  # root for trained_prompts/, pseudolabels/, ...
    ARTIFACT_FORMAT: str = "numpy"  # numpy | torch (reference-compatible layout)
    BPE_PATH: str = ""  # path to CLIP bpe_simple_vocab_16e6.txt.gz (optional)
    CLIP_CKPT: str = ""  # path to CLIP weights (optional; random init if "")

    extras: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path: str, env: Mapping[str, str] | None = None, **overrides: Any) -> "Config":
        import yaml

        with open(path, "r") as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw, env=env, **overrides)

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any], env: Mapping[str, str] | None = None, **overrides: Any) -> "Config":
        env = os.environ if env is None else env
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs: dict[str, Any] = {}
        extras: dict[str, Any] = {}
        for k, v in raw.items():
            # Reference YAMLs hold "$VAR" placeholders that are *not* expanded from
            # YAML; the reference overwrites them from os.environ after load
            # (reference methods/main_SSL.py:453-467). Same precedence here.
            if isinstance(v, str) and v.startswith("$"):
                continue
            if k in fields and k != "extras":
                kwargs[k] = v
            else:
                extras[k] = v
        for k, cast in _ENV_KEYS.items():
            if k in env:
                kwargs[k] = cast(env[k])
        for k, v in overrides.items():
            if k in fields and k != "extras":
                kwargs[k] = v
            else:
                extras[k] = v
        cfg = cls(extras=extras, **kwargs)
        # Flowers102 forces 2 shots per class (reference main_SSL.py:460-461)
        if cfg.DATASET_NAME == "Flowers102":
            cfg.N_LABEL = 2
        return cfg

    def __post_init__(self):
        if not self.MODALITY:
            m = self.MODEL
            if "multimodal" in m:
                self.MODALITY = "multi"
            elif "visual" in m:
                self.MODALITY = "image"
            else:
                self.MODALITY = "text"

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("extras", None)
        return d
