"""Runnable workloads of the port (``python -m gpr_calculator_tpu_torch.examples.<name>``)."""
