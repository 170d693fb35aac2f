from vln_imagine_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
)
