"""ABCI: the application boundary (reference abci/, SURVEY.md §2.6).

13 methods over 4 logical connections (consensus/mempool/query/snapshot).
"""

from .types import *  # noqa: F401,F403
from .application import Application  # noqa: F401
