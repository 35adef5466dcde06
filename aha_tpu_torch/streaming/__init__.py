"""Streaming inference of the port (counterparts of aha_tpu/streaming)."""
