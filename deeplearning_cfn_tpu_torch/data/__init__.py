"""Data pipelines of the port: ``wmt_en_de``, ``cifar10`` and ``imagenet``."""

from .pipeline import (ArraySource, DataPipeline, DevicePrefetcher,  # noqa
                       build_pipeline)
