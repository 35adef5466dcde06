"""Hand-written CUDA kernels: each wrapper launches its kernel on CUDA
tensors and runs its plain PyTorch version on CPU tensors.

``LAUNCHES`` counts kernel launches by wrapper name (``int8_matmul``,
``int8_matmul_a8``, ``quant_matmul``, ``int4_matmul``, ``int4_matmul_a8``,
``int4_matmul_t``, ``quantize_rows``, ``split_bf16x3``, ``decode_attention``,
``flash_attention_fwd``, ``flash_attention_bwd``): a wrapper adds one where
it launches its kernel and nowhere else, so a run can show which kernels its
path went through. The plain versions do not count. ``PATH_LAUNCHES`` counts
the launches of the quantised products and of ``decode_attention`` by
wrapper, path and operand types (``"int8_matmul/wgmma/f32"``: f32 x on the
tensor cores; ``"decode_attention/wgmma/f32-bf16"``: f32 q against a bf16
cache on the tensor cores), so a run can show which path of a kernel it took.
"""

import collections

LAUNCHES: collections.Counter = collections.Counter()
PATH_LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
    PATH_LAUNCHES.clear()
