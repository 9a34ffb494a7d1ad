"""Port of deeplearning_cfn_tpu.ops (attention only in this slice)."""

from .attention import attention_reference, flash_attention_forward, \
    fused_attention  # noqa: F401
