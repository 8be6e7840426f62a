"""Shared machinery of the benchmark: its data, the device, the weights,
the tokenizer, statistics, the traced window and the isolation check."""
