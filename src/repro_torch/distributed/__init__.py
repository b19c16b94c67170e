"""The distributed layer: meshes of ranks, the ring primitives, the
``"sharded"`` backend, the parameter layouts and the pipeline (counterpart
of ``repro.distributed``; see ``sharded_backend.py`` and ``params.py``).

The names below load their module on first use, so that importing one
submodule (the models import ``sharding``) loads neither the ring nor the
``"sharded"`` backend, which ``core.backend`` registers on first use.
"""

import importlib

_HOME = {
    "axis_rules": "sharding", "constrain": "sharding", "current_rules": "sharding",
    "logical_to_spec": "sharding", "mesh_context": "sharding",
    "current_mesh_axis": "sharding",
    "SegmentPlan": "ring", "axis_layout": "ring", "lpt_partition": "ring",
    "plan_segments": "ring", "ring_flash": "ring", "ring_perm": "ring",
    "ring_selection": "ring", "round_robin_partition": "ring",
    "ShardedBackend": "sharded_backend",
}

__all__ = sorted(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
