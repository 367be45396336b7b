from repro_torch.data.pipeline import (EOS, DataConfig, DataLoader,
                                       global_batch_at, shard_batch)

__all__ = ["EOS", "DataConfig", "DataLoader", "global_batch_at",
           "shard_batch"]
