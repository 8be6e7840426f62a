"""Tensor ops: norms, rope, plain attention, host packing."""
