"""The benchmark of rnnt_tpu_torch on an NVIDIA H100: ``python3
benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
"""
