from .device import resolve_device
from .logging import get_logger
from .scaler import StandardScaler

__all__ = ["StandardScaler", "get_logger", "resolve_device"]
