"""Plan analysis: the explain subsystem, `explain(analyze=True)`, plan
fingerprints and the planner's decision path (counterpart of
`hyperspace_tpu/plananalysis`)."""

from .buffer_stream import BufferStream  # noqa: F401
from .display_mode import ConsoleMode, DisplayMode, HTMLMode, PlainTextMode, create_display_mode  # noqa: F401
from .op_analyzer import PhysicalOperatorComparison, compare_operators, count_operators  # noqa: F401
from .analyze import explain_analyze_string  # noqa: F401
from .fingerprint import plan_fingerprint  # noqa: F401
from .plan_analyzer import explain_string  # noqa: F401
