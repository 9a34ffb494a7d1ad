"""Runtime helpers for the port: device selection."""

from .platform import resolve_device  # noqa: F401
