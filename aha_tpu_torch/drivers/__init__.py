"""Benchmark drivers of the port (counterparts of aha_tpu/drivers): the
tvsum / hisum / streaming-QA / offline drivers of ``infer`` and its dataset."""
