"""Device resolution shared by every entry point of the port.

Entry points run on the CUDA card unless the caller names the CPU.  A
missing card is an error, never a silent move to the CPU: a number
measured on the host must not pass for a device measurement.  The
meta device (shapes and dtypes, no storage) is accepted too: the dry run
builds its abstract state and caches on it.
"""
from __future__ import annotations

import torch


def resolve_device(device: "torch.device | str | None" = None
                   ) -> torch.device:
    """`None` means the CUDA card; raises if it is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev
