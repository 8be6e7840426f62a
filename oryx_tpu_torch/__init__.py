"""PyTorch/CUDA port of oryx_tpu: the image/video QA path (OryxViT ->
Dynamic Compressor -> splice -> Qwen2 greedy decode) on hand-written Hopper
kernels. Entry point: `oryx_tpu_torch.serve.pipeline.Pipeline`."""
