"""Port of deeplearning_cfn_tpu.ops: attention (the CUDA kernels' wrappers)
and the detection ops (plain PyTorch, ``ops/detection.py``)."""

from .attention import attention_reference, flash_attention_forward, \
    fused_attention  # noqa: F401
