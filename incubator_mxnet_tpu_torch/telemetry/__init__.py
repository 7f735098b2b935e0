"""Runtime telemetry of the port: so far the metrics registry
(`registry`), which the serving engine reports through."""
from . import registry

__all__ = ["registry"]
