from carel_tpu_torch.parallel.mesh import (Mesh, local_device_count,  # noqa: F401
                                           make_mesh)
from carel_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    replicated_sharding,
    shard_batch,
    shard_params,
    shard_stacked,
)
from carel_tpu_torch.parallel.tp import shard_params_tp  # noqa: F401
