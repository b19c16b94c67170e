"""Training runtime of the port (counterpart of ``repro.runtime``)."""
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: F401
from repro_torch.runtime.watchdog import Watchdog  # noqa: F401
