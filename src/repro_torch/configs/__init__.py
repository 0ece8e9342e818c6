from repro_torch.configs.archs import (ARCHS, ASSIGNED, DECODE_OK,
                                      LONG_CONTEXT_OK, MINIMALIST_LM_360M,
                                      MINIMALIST_LM_HW,
                                      MINIMALIST_SMNIST_DIMS, get_config,
                                      input_specs, reduced, shape_supported)
from repro_torch.configs.base import (SHAPES, LayerSpec, ModelConfig,
                                      SamplingParams, ServeConfig)
