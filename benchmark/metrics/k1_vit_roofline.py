"""K1 (csrc/flash_attention.cu) at the vision tower's and the compressor's
calls: the sum of each call's least time (benchmark/count.py, over the
segment-visible pairs and real rows the traffic needs) over the device
time of K1's forward-kernel records in the traced window, in %."""


def read(run):
    if not run.get("k1_fwd_s") or not run.get("k1_bound_s"):
        return None
    return 100.0 * run["k1_bound_s"] / run["k1_fwd_s"]
