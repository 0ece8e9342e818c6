from repro_torch.configs.archs import (ARCHS, ASSIGNED, MINIMALIST_LM_360M,
                                      MINIMALIST_LM_HW,
                                      MINIMALIST_SMNIST_DIMS, get_config,
                                      reduced)
from repro_torch.configs.base import (LayerSpec, ModelConfig, SamplingParams,
                                      ServeConfig)
