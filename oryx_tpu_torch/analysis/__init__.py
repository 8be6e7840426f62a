"""The port's runtime sanitizers (`analysis/sanitizers.py`): the lock-order
sanitizer and race detector behind `named_lock`, the CUDA-graph capture
watchdog and the in-place guard. The static half (oryxlint) stays repo
tooling in the JAX package and walks this package too."""
