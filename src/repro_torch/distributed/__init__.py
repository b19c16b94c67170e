"""The distributed attention layer: meshes of ranks, the ring primitives and
the ``"sharded"`` backend (counterpart of ``repro.distributed``'s
attention half; see ``sharded_backend.py``)."""

from repro_torch.distributed.sharding import (  # noqa: F401
    axis_rules,
    constrain,
    current_rules,
    logical_to_spec,
)
from repro_torch.distributed.ring import (  # noqa: F401
    SegmentPlan,
    axis_layout,
    lpt_partition,
    plan_segments,
    ring_flash,
    ring_perm,
    ring_selection,
    round_robin_partition,
)
from repro_torch.distributed.sharded_backend import (  # noqa: F401
    ShardedBackend,
    current_mesh_axis,
    mesh_context,
)
