"""The port's ops API: the names of ``btia_tpu/ops/__init__.py``."""

from btia_tpu_torch.ops.attention import (  # noqa: F401
    get_attention_impl,
    mha,
    mha_bshd,
    mha_reference,
    set_attention_impl,
)
from btia_tpu_torch.ops.bicross import (  # noqa: F401
    bicross_attention,
    bicross_bshd,
    bicross_reference,
)
from btia_tpu_torch.ops.fused_attn import (  # noqa: F401
    disable_fused,
    fused_dense_attention,
    fused_mesh,
    fused_static_q_attention,
)
from btia_tpu_torch.ops.ingest import normalize_images, preprocess_images  # noqa: F401
from btia_tpu_torch.ops.norms import layernorm  # noqa: F401
from btia_tpu_torch.ops.quant import int8_matmul, quantize_weight  # noqa: F401
