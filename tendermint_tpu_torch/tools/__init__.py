"""Running the port on the card: seeded commits (commits.py) and the
verify-path profiler (profile_verify.py)."""
