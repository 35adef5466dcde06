"""Benchmark drivers of the port (counterparts of aha_tpu/drivers, trimmed
to the streaming-QA datasets of ``infer``)."""
