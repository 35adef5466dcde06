"""The evaluation and calibration chain of the port (counterparts of
aha_tpu/eval, numpy on the host): score traces (``scoring``), the TVSum,
Mr.HiSum, grounding, QVHighlights and dense-captioning metrics, the
calibration grid search and the highlight reel."""
