"""Port of deeplearning_cfn_tpu.ops (attention only)."""

from .attention import attention_reference, flash_attention_forward, \
    fused_attention  # noqa: F401
