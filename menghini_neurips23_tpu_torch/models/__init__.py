from menghini_neurips23_tpu_torch.models.clip import (  # noqa: F401
    CLIP,
    TextTower,
    Transformer,
    VisionTower,
    build_clip,
    init_clip_params,
    precast_matmul_params,
    quick_gelu,
)
from menghini_neurips23_tpu_torch.models.configs import (  # noqa: F401
    ARCHS,
    CLIPArch,
    TINY_TEST,
    VIT_B32,
    VIT_L14,
    get_arch,
)
from menghini_neurips23_tpu_torch.models.convert import (  # noqa: F401
    convert_hf_state_dict,
    convert_state_dict,
    from_jax_params,
    infer_arch,
    is_hf_state_dict,
    load_clip,
    load_npz,
    save_npz,
    to_jax_params,
)
from menghini_neurips23_tpu_torch.models.prompts import truncate_context  # noqa: F401
