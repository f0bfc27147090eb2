"""The optimizer of the port's training path (``repro.optim``)."""
from repro_torch.optim.adamw import (
    OptConfig,
    init_opt_state,
    apply_updates,
    learning_rate,
    global_norm,
)

__all__ = [
    "OptConfig", "init_opt_state", "apply_updates", "learning_rate",
    "global_norm",
]
