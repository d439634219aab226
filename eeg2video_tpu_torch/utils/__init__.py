from . import profiling
from .device import resolve_device
from .logging import get_logger
from .scaler import StandardScaler
from .timing import Accumulator, Timer

__all__ = ["Accumulator", "StandardScaler", "Timer", "get_logger", "profiling",
           "resolve_device"]
