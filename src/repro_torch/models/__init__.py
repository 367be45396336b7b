"""The LM substrate's models, as plain functions on tensors: the
parameter tree (nested dicts and lists of tensors with the reference's
keys) is the interface, as in ``repro.models``."""
