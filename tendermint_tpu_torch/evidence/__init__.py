"""Evidence subsystem (reference evidence/, SURVEY.md §2.9)."""

from .pool import EvidencePool  # noqa: F401
from .verify import verify_duplicate_vote, verify_evidence  # noqa: F401
