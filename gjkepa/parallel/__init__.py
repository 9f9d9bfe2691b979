"""Device-mesh parallelism for the pair axis."""
from .sharding import (contact_count_sharded, gjkepa_batch_sharded, pair_mesh,
                       shard_pairs)

__all__ = ["contact_count_sharded", "gjkepa_batch_sharded", "pair_mesh",
           "shard_pairs"]
