"""Runnable examples of the port, in the shape of the reference's
``examples/``: ``python -m repro_torch.examples.shuhai_campaign`` and
``python -m repro_torch.examples.autotune_layout``."""
