from .data_skipping_rule import DataSkippingFilterRule  # noqa: F401
from .filter_index_rule import FilterIndexRule  # noqa: F401
from .join_index_rule import JoinIndexRule  # noqa: F401
