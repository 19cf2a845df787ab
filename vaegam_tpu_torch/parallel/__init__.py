"""Data parallelism over torch.distributed process groups."""

from .mesh import (
    DataMesh,
    all_gather_rows,
    all_reduce_grads,
    all_reduce_max,
    all_reduce_sum,
    all_reduce_total,
    barrier,
    batch_rows,
    global_batch_from_rows,
    global_value,
    init_multihost,
    is_main_process,
    is_multiprocess,
    leave,
    make_data_mesh,
    put_replicated,
    replica_digests,
)

__all__ = ["DataMesh", "all_gather_rows", "all_reduce_grads", "all_reduce_max",
           "all_reduce_sum", "all_reduce_total", "barrier", "batch_rows",
           "global_batch_from_rows", "global_value", "init_multihost",
           "is_main_process", "is_multiprocess", "leave", "make_data_mesh",
           "put_replicated", "replica_digests"]
