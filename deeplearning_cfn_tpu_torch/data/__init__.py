"""Data pipelines of the port: ``wmt_en_de``, ``wikipedia_mlm``,
``cifar10``, ``imagenet`` and ``coco``."""

from .pipeline import (ArraySource, DataPipeline, DevicePrefetcher,  # noqa
                       build_pipeline)
