"""State + execution tier (reference state/, SURVEY.md §2.6)."""

from .state import State, median_time, state_from_genesis  # noqa: F401
from .store import StateStore, ABCIResponses  # noqa: F401
from .execution import BlockExecutor  # noqa: F401
from .validation import validate_block  # noqa: F401
