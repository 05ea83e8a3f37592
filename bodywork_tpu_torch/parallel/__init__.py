"""The device mesh on torch (the port of ``bodywork_tpu.parallel``):
data- and tensor-parallel serving, sharded MLP training and the
multi-process join."""
from bodywork_tpu_torch.parallel.mesh import (
    make_mesh,
    multihost_init,
    multihost_shutdown,
    split_devices,
)
from bodywork_tpu_torch.parallel.sharding import (
    DataParallelPredictor,
    ShardedMLPPredictor,
    make_data_parallel_predict,
    mlp_param_sharding,
)
from bodywork_tpu_torch.parallel.train_step import train_mlp_sharded

__all__ = [
    "make_mesh",
    "multihost_init",
    "multihost_shutdown",
    "split_devices",
    "DataParallelPredictor",
    "ShardedMLPPredictor",
    "make_data_parallel_predict",
    "mlp_param_sharding",
    "train_mlp_sharded",
]
