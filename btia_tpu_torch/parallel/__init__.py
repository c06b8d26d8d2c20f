from btia_tpu_torch.parallel.mesh import MeshConfig, make_mesh  # noqa: F401
from btia_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    param_shardings,
    replicated,
    shard_batch,
)
