"""The port stands alone: every module of tendermint_tpu_torch, and
chip_smoke.py, imports in a process where ``jax`` and the JAX package
``tendermint_tpu`` cannot be imported (a meta-path finder refuses the exact
top-level names, so ``tendermint_tpu_torch`` itself still imports)."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_CHILD = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = {"jax", "jaxlib", "tendermint_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, sys.argv[1])

    import tendermint_tpu_torch
    names = ["tendermint_tpu_torch"]
    for info in pkgutil.walk_packages(tendermint_tpu_torch.__path__,
                                      "tendermint_tpu_torch."):
        names.append(info.name)
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401  (its __main__ block does not run)
    leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print(" ".join(names))
""")


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT / "tendermint_tpu_torch"), env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    imported = set(out.stdout.split())
    for name in ("tendermint_tpu_torch.convert",
                 "tendermint_tpu_torch.consensus.aggregated",
                 "tendermint_tpu_torch.crypto.batch",
                 "tendermint_tpu_torch.crypto.bls12381",
                 "tendermint_tpu_torch.crypto.bls12381.pairing",
                 "tendermint_tpu_torch.crypto.bls12381.vec",
                 "tendermint_tpu_torch.crypto.bls12381_cuda.build",
                 "tendermint_tpu_torch.crypto.bls12381_cuda.g2",
                 "tendermint_tpu_torch.crypto.cuda_build",
                 "tendermint_tpu_torch.crypto.ed25519_cuda.verify",
                 "tendermint_tpu_torch.crypto.ed25519_cuda.build",
                 "tendermint_tpu_torch.crypto.ed25519_cuda.multidevice",
                 "tendermint_tpu_torch.crypto.ed25519_cuda.sharded",
                 "tendermint_tpu_torch.crypto.ed25519_cuda.stub",
                 "tendermint_tpu_torch.entry",
                 "tendermint_tpu_torch.crypto.merkle",
                 "tendermint_tpu_torch.crypto.merkle_fast",
                 "tendermint_tpu_torch.crypto.merkle_cuda.sha256",
                 "tendermint_tpu_torch.crypto.merkle_cuda.build",
                 "tendermint_tpu_torch.libs.db",
                 "tendermint_tpu_torch.libs.fail",
                 "tendermint_tpu_torch.types.block",
                 "tendermint_tpu_torch.types.evidence",
                 "tendermint_tpu_torch.types.genesis",
                 "tendermint_tpu_torch.types.part_set",
                 "tendermint_tpu_torch.types.priv_validator",
                 "tendermint_tpu_torch.types.proposal",
                 "tendermint_tpu_torch.types.validator_set",
                 "tendermint_tpu_torch.types.vote_set",
                 "tendermint_tpu_torch.tools.commits",
                 "tendermint_tpu_torch.tools.device_profile",
                 "tendermint_tpu_torch.tools.g2_lanes",
                 "tendermint_tpu_torch.abci.client",
                 "tendermint_tpu_torch.abci.example.kvstore",
                 "tendermint_tpu_torch.proxy",
                 "tendermint_tpu_torch.state.execution",
                 "tendermint_tpu_torch.state.store",
                 "tendermint_tpu_torch.state.validation",
                 "tendermint_tpu_torch.store.block_store",
                 "tendermint_tpu_torch.config",
                 "tendermint_tpu_torch.libs.peerscore",
                 "tendermint_tpu_torch.light",
                 "tendermint_tpu_torch.light.client",
                 "tendermint_tpu_torch.light.provider",
                 "tendermint_tpu_torch.light.serve",
                 "tendermint_tpu_torch.light.store",
                 "tendermint_tpu_torch.light.verifier",
                 "tendermint_tpu_torch.rpc",
                 "tendermint_tpu_torch.rpc.json_enc",
                 "tendermint_tpu_torch.libs.pubsub",
                 "tendermint_tpu_torch.types.events",
                 "tendermint_tpu_torch.types.event_bus",
                 "tendermint_tpu_torch.evidence",
                 "tendermint_tpu_torch.evidence.verify",
                 "tendermint_tpu_torch.evidence.pool",
                 "tendermint_tpu_torch.crypto.vote_batcher",
                 "tendermint_tpu_torch.libs.metrics",
                 "tendermint_tpu_torch.libs.txlife",
                 "tendermint_tpu_torch.mempool",
                 "tendermint_tpu_torch.mempool.clist_mempool",
                 "tendermint_tpu_torch.mempool.ingest",
                 "tendermint_tpu_torch.abci.example.counter",
                 "tendermint_tpu_torch.abci.application",
                 "tendermint_tpu_torch.p2p",
                 "tendermint_tpu_torch.p2p.base",
                 "tendermint_tpu_torch.blockchain",
                 "tendermint_tpu_torch.blockchain.msgs",
                 "tendermint_tpu_torch.blockchain.pool",
                 "tendermint_tpu_torch.blockchain.reactor",
                 "tendermint_tpu_torch.state.parallel",
                 "tendermint_tpu_torch.p2p.switch",
                 "tendermint_tpu_torch.p2p.inproc",
                 "tendermint_tpu_torch.consensus",
                 "tendermint_tpu_torch.consensus.config",
                 "tendermint_tpu_torch.consensus.round_state",
                 "tendermint_tpu_torch.consensus.msgs",
                 "tendermint_tpu_torch.consensus.wal",
                 "tendermint_tpu_torch.consensus.timeline",
                 "tendermint_tpu_torch.consensus.state",
                 "tendermint_tpu_torch.consensus.replay",
                 "tendermint_tpu_torch.consensus.reactor",
                 "tendermint_tpu_torch.mempool.reactor",
                 "tendermint_tpu_torch.evidence.reactor",
                 "tendermint_tpu_torch.tools.validator_stubs"):
        assert name in imported


def test_blocker_really_blocks():
    """The same finder refuses ``tendermint_tpu`` itself (the check above
    is not vacuous)."""
    child = _CHILD.replace("import tendermint_tpu_torch\n",
                           "import tendermint_tpu_torch\n"
                           "import tendermint_tpu\n", 1)
    out = subprocess.run([sys.executable, "-c", child, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT / "tendermint_tpu_torch"))
    assert out.returncode != 0
    assert "blocked import: tendermint_tpu" in out.stderr
