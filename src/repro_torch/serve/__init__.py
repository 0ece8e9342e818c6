from repro_torch.serve.engine import EngineStats, ServeEngine
from repro_torch.serve.paged import PagedConfig, PagePool, PrefixCache
from repro_torch.serve.prefill import chunked_prefill
from repro_torch.serve.protocol import (DecoderStepModel, MinimalistStepModel,
                                        StepModel, masked_update)
from repro_torch.serve.scheduler import (POLICIES, EDFPolicy, FIFOPolicy,
                                         PriorityPolicy, SchedulingPolicy,
                                         SJFPolicy, make_policy)
from repro_torch.serve.spec import DraftStepModel, heterogeneous_k
from repro_torch.serve.state import Request, SlotTable
from repro_torch.serve.telemetry import NULL_TELEMETRY, Telemetry
