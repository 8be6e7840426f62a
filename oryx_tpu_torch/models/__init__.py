"""Model modules: Qwen2 decoder, OryxViT, Dynamic Compressor, splice,
generation, and the JAX-parameter converter."""
