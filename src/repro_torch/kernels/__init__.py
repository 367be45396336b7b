"""The RST engines as hand-written CUDA kernels for Hopper (sm_90a).

`rst_read` and `rst_write` launch their kernels from ``csrc/rst.cu`` on a
CUDA tensor and run their plain PyTorch versions on a CPU tensor; `ops`
packs operands, allocates working buffers and measures bandwidth; `ref`
holds the NumPy oracles.  No module here imports `triton` or builds a
kernel at import time.
"""
