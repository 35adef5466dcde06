"""aha_tpu_torch: the streaming-inference path of aha_tpu in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

Layout mirrors ``aha_tpu`` so each module has a named counterpart:

  bridge            - JAX param tree -> dict of tensors
  ops               - RoPE, letterbox, pooling, int8 weights, ring-buffer
                      KV cache, cached attention
  ops/kernels       - the CUDA kernels' wrappers, their plain versions,
                      and the nvcc build (sources in ``csrc/``)
  models            - SigLIP tower, Qwen2 decoder, Aha heads
  streaming         - engine and StreamSession (single stream, widths 1)

The port imports torch and never jax; from ``aha_tpu`` it uses only
``aha_tpu.config`` and ``aha_tpu.tokenization``, which are framework-free.
"""
