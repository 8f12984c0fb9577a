from .ranges import RangeSet
from .idalloc import IdAllocator, hash_string
from .logger import get_logger, init_logs, security_logger

__all__ = [
    "RangeSet",
    "IdAllocator",
    "hash_string",
    "get_logger",
    "init_logs",
    "security_logger",
]
