from repro_torch.train.fault_tolerance import (FailureInjector,
                                               PreemptionHandler,
                                               StragglerMonitor)
from repro_torch.train.loop import TrainConfig, Trainer, build_train_step
