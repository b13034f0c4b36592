from .mesh import make_mesh, data_parallel_mesh, config_mesh, replicate, shard_batch, \
    shard_leading, gather

__all__ = ["make_mesh", "data_parallel_mesh", "config_mesh", "replicate", "shard_batch",
           "shard_leading", "gather"]
