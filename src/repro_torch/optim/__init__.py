"""AdamW (f32 or int8 moments) and the LR schedule."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                                     global_norm)
from repro_torch.optim.schedules import warmup_cosine  # noqa: F401
