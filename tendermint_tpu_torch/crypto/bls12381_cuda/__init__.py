"""The BLS12-381 aggregate-pubkey round on an NVIDIA Hopper card.

Counterpart of K10 of ``tendermint_tpu/crypto/bls12381/vec.py``
(``_g2_add_round``). ``csrc/`` holds the hand-written kernel
``bls_g2_add_round`` (Montgomery Fq in ``fq.cuh``, Fq2 and the Jacobian
G2 addition in ``g2.cuh``); g2.py wraps it, holds its plain PyTorch
version and converts points in and out of Montgomery limbs; build.py
compiles it at first use. The tree around it is ``crypto/bls12381/vec.py``.
"""

from .g2 import g2_add_round, g2_add_round_plain  # noqa: F401
