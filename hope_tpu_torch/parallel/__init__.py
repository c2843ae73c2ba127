from .mesh import (Mesh, agree, all_reduce_sum, barrier, gather_replicated, gather_to_root,
                   initialize_multihost, make_mesh, replicate, shard_batch, shutdown)

__all__ = ["Mesh", "agree", "all_reduce_sum", "barrier", "gather_replicated", "gather_to_root",
           "initialize_multihost", "make_mesh", "replicate", "shard_batch", "shutdown"]
