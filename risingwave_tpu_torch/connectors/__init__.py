from .nexmark import NexmarkConfig, NexmarkGenerator
from .tpch import TPCH_SCHEMAS, TpchGenerator

__all__ = ["NexmarkConfig", "NexmarkGenerator", "TPCH_SCHEMAS",
           "TpchGenerator"]
