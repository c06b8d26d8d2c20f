"""Mixed-precision policy (the port of ``btia_tpu/core/dtypes.py``).

Parameters are stored in fp32; activations and matrix products run in the
compute dtype (bf16 on the serving path, fp32 on the parity path); softmax,
LayerNorm statistics and logits accumulate in fp32. ``int8`` serves the FFN
matrix products through the fused int8 kernel (K8, ``ops/quant.py``):
inference only; training and the fp32 parity path run the plain product.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32
    int8: bool = False


def default_policy(mixed: bool = True) -> DTypePolicy:
    if mixed:
        return DTypePolicy()
    return DTypePolicy(compute_dtype=torch.float32)


FP32_POLICY = DTypePolicy(compute_dtype=torch.float32)
BF16_POLICY = DTypePolicy()
