"""Light client (reference light/): pure verifier, bisection client,
divergence detector, providers, trusted store, and the serving plane
(``serve``: the verify coalescer, the header cache, per-client admission).
All commit verification rides the batched device verifier through
ValidatorSet.verify_commit_light*. The light proxy (``light/proxy.py`` of
the reference package) waits for the port's RPC server."""

from .verifier import (  # noqa: F401
    verify,
    verify_adjacent,
    verify_backwards,
    verify_non_adjacent,
    header_expired,
)
from .client import LightClient, TrustOptions  # noqa: F401
