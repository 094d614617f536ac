from fvp_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_pipeline_mesh,
    make_spatial_mesh,
    pick_mesh_shape,
    spatial_size,
)
from fvp_torch.parallel.sharding import (  # noqa: F401
    make_sharded_eval_step,
    make_sharded_train_step,
    shard_batch,
    shard_data,
)
from fvp_torch.parallel.spatial import (  # noqa: F401
    make_spatial_eval_step,
    sharded_nms_topk_2d,
    spatial_centernet,
)
