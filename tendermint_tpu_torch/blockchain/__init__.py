"""Block sync ("fast sync") — download committed blocks from peers and replay
them with windowed, batched commit verification (reference blockchain/v0/,
SURVEY.md §2.7).
"""

from .pool import BlockPool  # noqa: F401
from .reactor import BlockchainReactor  # noqa: F401
