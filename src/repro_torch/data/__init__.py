from repro_torch.data.pipeline import ShardedLoader, SyntheticLMDataset
from repro_torch.data.smnist import SequentialMNISTLike, load_smnist
