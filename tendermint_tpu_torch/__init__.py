"""PyTorch/CUDA port of tendermint_tpu.

A second package beside the JAX one, with the same layout and names so each
module's counterpart is easy to find. It imports ``torch`` and never ``jax``,
and nothing of ``tendermint_tpu``: the jax-free modules it needs are its own
copies. The device kernels are CUDA C++ written for Hopper (``sm_90a``)
under ``crypto/ed25519_cuda/csrc`` (commit verification) and
``crypto/merkle_cuda/csrc`` (the SHA-256 of the merkle app hash); each has
a plain PyTorch version beside it that runs on CPU tensors (the tests) and
serves as the card's reference.

Entry points run on the card: the default device is ``cuda`` unless the
caller asks for the CPU with :func:`device.set_default_device`.
"""
