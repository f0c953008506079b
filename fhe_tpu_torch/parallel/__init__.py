"""Multi-device distribution on ``torch.distributed`` — counterpart of
``fhe_tpu/parallel/``: RNS prime-axis sharding (``shard_scheme.py``,
``sharded.py``) and the distributed coefficient-block NTT
(``distributed_ntt.py``), SPMD with one process per rank (``mesh.py``;
``launch.py`` starts a world of ranks)."""

from .mesh import make_mesh, rns_sharding
from .distributed_ntt import dist_ntt_forward, dist_ntt_inverse
from .sharded import ShardedFHE, shard_batch
from .shard_scheme import keyswitch_delta_psum, multiply_relin_shardmap

__all__ = ["make_mesh", "rns_sharding", "dist_ntt_forward", "dist_ntt_inverse",
           "ShardedFHE", "shard_batch", "multiply_relin_shardmap",
           "keyswitch_delta_psum"]
