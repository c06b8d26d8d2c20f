"""btia_tpu_torch — the PyTorch / CUDA port of ``btia_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package imports ``torch`` and
nothing of JAX or of ``btia_tpu``. Every Pallas kernel on the serving path is
a hand-written CUDA kernel here (``csrc/``), built at first use.

    from btia_tpu_torch import build_model, get_config, predict, Predictor, StreamingServer
"""

__version__ = "0.1.0"

from btia_tpu_torch.configs import get_config, list_configs  # noqa: F401
from btia_tpu_torch.infer.predict import Predictor, predict  # noqa: F401
from btia_tpu_torch.infer.streaming import StreamingServer  # noqa: F401
from btia_tpu_torch.models.model import BTIAADNet, build_model  # noqa: F401
