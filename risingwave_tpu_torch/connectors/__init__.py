from .nexmark import NexmarkConfig, NexmarkGenerator

__all__ = ["NexmarkConfig", "NexmarkGenerator"]
