from menghini_neurips23_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_parallelism,
    mesh_from_config,
    pad_to_multiple,
)
from menghini_neurips23_tpu_torch.parallel.multihost import (  # noqa: F401
    all_gather_rows,
    all_reduce_sum_,
    barrier,
    broadcast_int,
    initialize_distributed,
    initialize_from_env,
    is_main_process,
    process_count,
    process_index,
    shard_filelist_for_batch,
)
