"""Benchmark of gpr_calculator_tpu_torch on one NVIDIA H100 (see
README.md); run one cell with ``python3 bench_port/run.py``."""
