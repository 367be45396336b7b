"""PyTorch/CUDA port of the Shuhai HBM-benchmark reproduction.

Mirrors the `repro` package module for module: `repro_torch.core` holds
the spec, timing-model, engine, sweep and experiment layers, and
`repro_torch.kernels` the RST engines as hand-written CUDA kernels for
Hopper (sm_90a), each with a plain PyTorch version beside it.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
