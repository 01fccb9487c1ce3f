"""Consensus (the reference's consensus/ tier). The state machine, its
reactor and WAL are not ported yet; this package holds the pieces of it
that the ported planes already use."""
