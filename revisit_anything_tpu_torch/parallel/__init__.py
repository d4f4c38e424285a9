from revisit_anything_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, auto_data_mesh, batch_sharding, make_mesh, pad_to_multiple,
    replicated, resolve_mesh)
from revisit_anything_tpu_torch.parallel.sharded_knn import (  # noqa: F401
    merge_candidates, sharded_knn_l2)
from revisit_anything_tpu_torch.parallel.data_parallel import (  # noqa: F401
    data_parallel_apply)
from revisit_anything_tpu_torch.parallel.distributed import (  # noqa: F401
    host_shard, initialize_multihost, process_info)
from revisit_anything_tpu_torch.parallel.collectives import (  # noqa: F401
    MeshAxis, owned_ranges)
