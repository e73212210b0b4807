"""The benchmark of xbitops_tpu_torch; ``python3 benchmark/run.py --help``."""
