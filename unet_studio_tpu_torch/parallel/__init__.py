from .mesh import Mesh, all_reduce_sum, local_rows, make_mesh, replicate, shard_batch
from .spatial import make_spatial_infer, make_spatial_train_step, spatial_sharding
