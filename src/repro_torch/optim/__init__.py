from repro_torch.optim.adamw import (AdamW, clip_by_global_norm,
                                     cosine_schedule, param_groups)
