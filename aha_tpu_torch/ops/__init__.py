"""Tensor ops of the port (counterparts of aha_tpu/ops)."""
