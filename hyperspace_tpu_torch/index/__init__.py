from .index_config import IndexConfig  # noqa: F401
from .log_entry import (  # noqa: F401
    Content,
    CoveringIndexProperties,
    Directory,
    FileInfo,
    IndexLogEntry,
    LogEntry,
    LogicalPlanFingerprint,
    Relation,
    Signature,
    Source,
    SourcePlanProperties,
)
from .log_manager import IndexLogManager, IndexLogManagerImpl  # noqa: F401
from .data_manager import IndexDataManager, IndexDataManagerImpl  # noqa: F401
from .path_resolver import PathResolver  # noqa: F401
