from fvp_torch.parallel.mesh import make_mesh, pick_mesh_shape  # noqa: F401
from fvp_torch.parallel.sharding import (  # noqa: F401
    make_sharded_eval_step,
    shard_batch,
)
