"""The benchmark of `oryx_tpu_torch` on an NVIDIA H100: one command runs
one cell once (`python3 benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`)."""
