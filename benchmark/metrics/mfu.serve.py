"""Model FLOPs of the work done in the traced window (benchmark/count.py:
the tower, the compressor, prefill and decode tokens, attention over
visible pairs; for training 6 N a token, remat not counted) over the
window times the card's published bf16 peak, in %."""

from benchmark import count


def read(run):
    if not run.get("model_flops") or not run.get("window_s"):
        return None
    return 100.0 * run["model_flops"] / (run["window_s"]
                                         * count.PEAK_BF16_FLOPS)
