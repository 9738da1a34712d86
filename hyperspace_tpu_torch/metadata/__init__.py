from hyperspace_tpu_torch.metadata.log_entry import (
    Content,
    CoveringIndex,
    FileInfo,
    Fingerprint,
    IndexLogEntry,
    LogEntry,
    Source,
)
from hyperspace_tpu_torch.metadata.log_manager import IndexLogManager
from hyperspace_tpu_torch.metadata.data_manager import IndexDataManager
from hyperspace_tpu_torch.metadata.path_resolver import PathResolver

__all__ = [
    "Content",
    "CoveringIndex",
    "FileInfo",
    "Fingerprint",
    "IndexLogEntry",
    "LogEntry",
    "Source",
    "IndexLogManager",
    "IndexDataManager",
    "PathResolver",
]
