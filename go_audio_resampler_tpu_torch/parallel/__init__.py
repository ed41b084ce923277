"""Multi-card scaling: stream-batch data parallelism over
``torch.distributed``."""

from .mesh import (make_mesh, sharded_oneshot, sharded_stream_step,
                   global_stream_stats, ShardedEngineCore,
                   ShardedVariableRateResampler)

__all__ = ["make_mesh", "sharded_oneshot", "sharded_stream_step",
           "global_stream_stats", "ShardedEngineCore",
           "ShardedVariableRateResampler"]
