from menghini_neurips23_tpu_torch.ops.attention import (  # noqa: F401
    attention_reference,
    fused_attention,
)
from menghini_neurips23_tpu_torch.ops.clip_head import (  # noqa: F401
    fused_probs,
    fused_probs_reference,
)
from menghini_neurips23_tpu_torch.ops.patch_embed import (  # noqa: F401
    fold_normalization,
    patch_tokens,
)
from menghini_neurips23_tpu_torch.ops.twophase_attention import (  # noqa: F401
    twophase_attention,
    twophase_attention_reference,
)
