"""K1-lse + K5a + K5b (csrc/flash_attention.cu, flash_attention_bwd.cu) in
the traced training steps: the least time of the attention forward and
backward the steps' rows need (benchmark/count.py; decoder rows causal
over their real tokens, the tower and compressor over segment-visible
pairs; remat's second forward is no work) over the device time of the K1
and K5 records, in %."""


def read(run):
    fam = run.get("family_s") or {}
    dev = fam.get("K1", 0.0) + fam.get("K5", 0.0)
    if not dev or not run.get("k5_bound_s"):
        return None
    return 100.0 * run["k5_bound_s"] / dev
