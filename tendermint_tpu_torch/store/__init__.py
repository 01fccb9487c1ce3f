"""Block storage (reference store/store.go)."""

from .block_store import BlockStore, BlockStoreState  # noqa: F401
