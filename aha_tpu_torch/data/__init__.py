"""Host-side data of the port: video decoding and the prefetching iterator
(counterparts of aha_tpu/data, trimmed to what ``infer`` reads)."""
