"""Command line of the port (``python -m deeplearning_cfn_tpu_torch.cli``)."""
