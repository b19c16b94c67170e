"""Optimizer pieces of the port (counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm, global_norm  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
