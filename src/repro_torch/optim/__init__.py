from repro_torch.optim.adamw import (AdamWConfig, AdamWState,  # noqa: F401
                                     adamw_init, adamw_init_specs,
                                     adamw_update, global_norm)
from repro_torch.optim.schedules import cosine_warmup  # noqa: F401
