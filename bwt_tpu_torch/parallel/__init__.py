"""Multi-device paths over ``torch.distributed``, one process a device:
dp serving and the tp-sharded index (``mesh``: ``shard_index``,
``tp_view``, ``fmi_spec_tree``, ``tp_locate``; ``peer``: a view's blocks
shared between the ranks' cards) and the sharded suffix sort
(``suffix_dist``)."""

from bwt_tpu_torch.parallel.mesh import (
    Mesh,
    fmi_spec_tree,
    gather_hits,
    host_fetch,
    init_distributed,
    make_mesh,
    release_view,
    replicate_index,
    shard_index,
    shard_patterns,
    sharded_search_step,
    tp_locate,
    tp_view,
)
from bwt_tpu_torch.parallel.suffix_dist import (
    build_index_sharded,
    sharded_suffix_array,
)

__all__ = [
    "build_index_sharded",
    "gather_hits",
    "init_distributed",
    "make_mesh",
    "release_view",
    "replicate_index",
    "shard_index",
    "sharded_search_step",
    "shard_patterns",
    "sharded_suffix_array",
    "fmi_spec_tree",
    "tp_locate",
    "tp_view",
]
