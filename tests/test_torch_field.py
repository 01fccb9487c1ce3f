"""The port's GF(2^255-19) arithmetic (plain PyTorch version of K1) against
the JAX package's field.py and against Python integers, exactly.

Both packages' limbs go through Python ints: the port holds 10 limbs of
26/25 bits, the JAX package 17 limbs of 15 bits.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto.ed25519_jax import field as JF
from tendermint_tpu_torch import device
from tendermint_tpu_torch.crypto.ed25519_cuda import field as TF

P = 2**255 - 19
EDGE = [0, 1, 2, P - 1, P, P + 1, 2**255 - 1, 2**255 - 20, 19, 2**254]


@pytest.fixture(autouse=True)
def _port_state():
    device.set_default_device("cpu")
    yield
    device.set_default_device(None)


def _values(n, seed):
    rng = random.Random(seed)
    return EDGE + [rng.randrange(2**255) for _ in range(n)]


def _jax_limbs(xs):
    return jnp.asarray(np.stack([JF.int_to_limbs(x % 2**255) for x in xs], 1))


def _jax_ints(a):
    a = np.asarray(a)
    return [JF.limbs_to_int(a[:, i]) for i in range(a.shape[1])]


def test_limb_roundtrip_and_layout():
    xs = _values(20, 1)
    assert TF.to_ints(TF.from_ints(xs)) == [x % 2**255 for x in xs]
    assert TF.OFFSETS[-1] + TF.WIDTHS[-1] == 255
    assert TF.int_to_limbs(P) == [(1 << 26) - 19] + [
        (1 << w) - 1 for w in TF.WIDTHS[1:]]


def test_mul_sqr_freeze_match_jax_and_ints():
    xs = _values(22, 2)
    ys = xs[::-1]
    a, b = TF.from_ints(xs), TF.from_ints(ys)
    got_mul = TF.to_ints(TF.freeze(TF.mul(a, b)))
    got_sqr = TF.to_ints(TF.freeze(TF.sqr(a)))
    got_frz = TF.to_ints(TF.freeze(a))
    ja, jb = _jax_limbs(xs), _jax_limbs(ys)
    jmul, jsqr, jfrz = jax.jit(
        lambda u, v: (JF.freeze(JF.mul(u, v)), JF.freeze(JF.sqr(u)),
                      JF.freeze(u)))(ja, jb)
    assert got_mul == _jax_ints(jmul) == [x * y % P for x, y in zip(xs, ys)]
    assert got_sqr == _jax_ints(jsqr) == [x * x % P for x in xs]
    assert got_frz == _jax_ints(jfrz) == [x % P for x in xs]


def test_inverse_pow_p58_match_jax_and_ints():
    xs = _values(6, 3)
    a = TF.from_ints(xs)
    got_inv = TF.to_ints(TF.freeze(TF.inverse(a)))
    got_p58 = TF.to_ints(TF.freeze(TF.pow_p58(a)))
    jinv, jp58 = jax.jit(lambda u: (JF.freeze(JF.inverse(u)),
                                    JF.freeze(JF.pow_p58(u))))(_jax_limbs(xs))
    assert got_inv == _jax_ints(jinv) == [pow(x, P - 2, P) for x in xs]
    assert got_p58 == _jax_ints(jp58) == [pow(x, (P - 5) // 8, P) for x in xs]


def test_add_sub_neg_and_carried_bound():
    xs = _values(30, 4)
    ys = xs[5:] + xs[:5]
    a, b = TF.from_ints(xs), TF.from_ints(ys)
    for out, want in ((TF.add(a, b), [x + y for x, y in zip(xs, ys)]),
                      (TF.sub(a, b), [x - y for x, y in zip(xs, ys)]),
                      (TF.neg(a), [-x for x in xs]),
                      (TF.mul(a, b), [x * y for x, y in zip(xs, ys)])):
        assert [v % P for v in TF.to_ints(out)] == [w % P for w in want]
        # the carried invariant every multiply input relies on
        widths = np.array(TF.WIDTHS).reshape(10, 1)
        assert (out.numpy() < (1 << widths) + (1 << (widths - 6))).all()
        assert (out.numpy() >= 0).all()


def test_worst_case_limbs():
    """Limbs at the carried bound (not a canonical encoding) still multiply
    and freeze exactly."""
    top = [(1 << w) + (1 << (w - 6)) - 1 for w in TF.WIDTHS]
    a = torch.tensor(top, dtype=torch.int64).reshape(10, 1)
    v = TF.limbs_to_int(top)
    assert TF.to_ints(TF.freeze(a)) == [v % P]
    assert TF.to_ints(TF.freeze(TF.mul(a, a))) == [v * v % P]


def test_bytes_roundtrip_edges():
    xs = _values(12, 5)
    raw = torch.tensor([list(x.to_bytes(32, "little")) for x in xs],
                       dtype=torch.int64).T
    limbs = TF.from_bytes(raw)
    assert TF.to_ints(limbs) == [x & (2**255 - 1) for x in xs]
    back = [bytes(r) for r in TF.to_bytes(limbs).T.tolist()]
    assert back == [((x & (2**255 - 1)) % P).to_bytes(32, "little")
                    for x in xs]
    assert TF.is_zero(TF.from_ints([0, P, 1])).tolist() == [True, True, False]
    assert TF.parity(TF.from_ints([2, P + 1, P + 2])).tolist() == [0, 1, 0]
