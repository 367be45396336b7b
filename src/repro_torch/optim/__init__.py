from repro_torch.optim.adamw import (AdamWConfig, AdamWState, apply,
                                     global_norm, init)
from repro_torch.optim.compression import (ErrorFeedback,
                                           compress_decompress,
                                           compressed_psum,
                                           init_error_feedback,
                                           wire_bytes_saved)
from repro_torch.optim.schedule import constant_with_warmup, warmup_cosine

__all__ = ["AdamWConfig", "AdamWState", "apply", "global_norm", "init",
           "ErrorFeedback", "compress_decompress", "compressed_psum",
           "init_error_feedback", "wire_bytes_saved",
           "constant_with_warmup", "warmup_cosine"]
