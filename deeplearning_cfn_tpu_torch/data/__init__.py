"""Data pipelines of the port (the NMT slice: ``wmt_en_de``)."""

from .pipeline import (ArraySource, DataPipeline, DevicePrefetcher,  # noqa
                       build_pipeline)
