"""aha_tpu_torch: the streaming-inference path of aha_tpu in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

Layout mirrors ``aha_tpu`` so each module has a named counterpart:

  config            - model shapes, presets, InferConfig
  tokenization      - stream chat template and tokenizer backends
  bridge            - JAX param tree (numpy leaves) -> dict of tensors
  ops               - RoPE, letterbox, pooling, int8 / packed-int4 weights,
                      ring-buffer KV cache, cached and speculative
                      attention, speculative-decode planning
  ops/kernels       - the CUDA kernels' wrappers, their plain versions,
                      and the nvcc build (sources in ``csrc/``)
  models            - SigLIP tower, Qwen2 decoder, Aha heads
  streaming         - engine and StreamSession (single stream; fused frame
                      scoring, the chunked trigger loops of inference(),
                      speculative generation)
  data, drivers     - cv2 decoding, prefetching, the streaming-QA dataset and
                      driver of ``infer``
  cli               - ``python -m aha_tpu_torch.cli infer``

The port imports torch and never jax, and nothing of ``aha_tpu``: what it
needs of that package's framework-free modules it keeps as its own copy
(``config``, ``tokenization``). Its entry points run on the card unless the
caller passes ``device="cpu"``.
"""
