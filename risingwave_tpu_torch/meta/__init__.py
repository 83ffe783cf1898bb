from .barrier_manager import BarrierCoordinator

__all__ = ["BarrierCoordinator"]
