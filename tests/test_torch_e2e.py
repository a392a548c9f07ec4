"""End to end on the CPU: the PyTorch package's Stratum session mines
shares that the reference's validating pool and its own accept; the
command line's bench finds the genesis nonce; and no module of the
package (or chip_smoke.py) imports JAX or the JAX package."""

import ast
import asyncio
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bitcoin_miner_tpu.core.sha256 import sha256d
from bitcoin_miner_tpu.testing import mock_pool as ref_pool
from bitcoin_miner_tpu_torch import cli
from bitcoin_miner_tpu_torch.backends.cuda import TileCudaHasher
from bitcoin_miner_tpu_torch.miner.runner import StratumMiner
from bitcoin_miner_tpu_torch.testing import mock_pool as port_pool


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes,
    and a thread pool per worker would oversubscribe the cores that the
    timing-sensitive tests of other files share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "bitcoin_miner_tpu_torch"
EASY_DIFF = 1 / (1 << 24)  # ~2^-8 per nonce


def _pool_job(pool_module, job_id="j1"):
    return pool_module.PoolJob(
        job_id=job_id,
        prevhash_internal=sha256d(b"prev block " + job_id.encode()),
        coinb1=bytes.fromhex("01000000") + b"\x11" * 30,
        coinb2=b"\x22" * 30 + bytes.fromhex("00000000"),
        merkle_branch=[sha256d(b"tx1"), sha256d(b"tx2")],
        version=0x20000000,
        nbits=0x1D00FFFF,
        ntime=0x655F2B2C,
    )


@pytest.mark.parametrize("pool_module", [ref_pool, port_pool],
                         ids=["reference_pool", "own_pool"])
def test_stratum_session_shares_accepted(pool_module):
    async def main():
        pool = pool_module.MockStratumPool(difficulty=EASY_DIFF,
                                           version_mask=0x1FFFE000)
        await pool.start()
        await pool.announce_job(_pool_job(pool_module))
        miner = StratumMiner(
            "127.0.0.1", pool.port, "w",
            hasher=TileCudaHasher(batch_size=1 << 12, device="cpu"),
            n_workers=2, batch_size=1 << 12,
        )
        run_task = asyncio.create_task(miner.run())
        stats = miner.dispatcher.stats
        try:
            deadline = asyncio.get_running_loop().time() + 120
            while stats.shares_accepted < 3:
                assert asyncio.get_running_loop().time() < deadline, (
                    f"{stats.summary()} pool={pool.shares[:5]}")
                assert not run_task.done(), run_task
                await asyncio.sleep(0.05)
        finally:
            miner.stop()
            await asyncio.gather(run_task, return_exceptions=True)
            await pool.stop()
        assert pool.shares and all(s.accepted for s in pool.shares), [
            s.reason for s in pool.shares if not s.accepted]
        assert stats.hw_errors == 0 and stats.shares_rejected == 0
        # The pool negotiated version rolling; every share carries in-mask
        # bits of the job's own version.
        assert all(s.version_bits == 0x20000000 & 0x1FFFE000
                   for s in pool.shares)

    asyncio.run(asyncio.wait_for(main(), 180))


def test_bench_finds_genesis_on_cpu(capsys):
    rc = cli.main(["--bench", "--device", "cpu", "--batch-bits", "13",
                   "--bench-nonces", str(1 << 14)])
    assert rc == 0
    assert "FOUND+VERIFIED" in capsys.readouterr().out


def test_make_miner_builds_the_default_session():
    """``--pool`` with the defaults: the tile hasher behind a ring of 2,
    8 workers and the adaptive scheduler on the hasher's dispatch grid."""
    args = cli.build_parser().parse_args(
        ["--pool", "stratum+tcp://127.0.0.1:3333", "--device", "cpu"])
    dispatcher = cli.make_miner(args).dispatcher
    assert isinstance(dispatcher.hasher, TileCudaHasher)
    assert dispatcher.hasher.batch_size == 1 << cli.DEFAULT_BATCH_BITS
    assert dispatcher.n_workers == 8 and dispatcher.stream_depth == 2
    assert dispatcher.scheduler.granularity == dispatcher.hasher.batch_size
    pinned = cli.build_parser().parse_args(
        ["--pool", "127.0.0.1:3333", "--device", "cpu", "--batch-bits", "12"])
    assert cli.make_miner(pinned).dispatcher.scheduler is None


def test_run_bench_reports_dispatches():
    out = cli.run_bench(TileCudaHasher(batch_size=1 << 12, device="cpu"),
                        1 << 13, batch_size=1 << 12)
    assert out["verified"] and out["dispatches"] == 2
    assert out["hashes"] == 1 << 13


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_reference_imports(path):
    # The reference's benchmark scripts import as top-level modules once
    # benchmarks/ is on sys.path (vpu_probe, llo_probe, ...).
    forbidden = {"jax", "jaxlib", "bitcoin_miner_tpu", "benchmarks",
                 *(p.stem for p in (ROOT / "benchmarks").glob("*.py"))}
    assert {"vpu_probe", "llo_probe"} <= forbidden
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in forbidden, (
            f"{path.relative_to(ROOT)} imports {name}")


def test_package_imports_with_jax_unavailable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['bitcoin_miner_tpu'] = None\n"
        "import bitcoin_miner_tpu_torch.cli, bitcoin_miner_tpu_torch.backends.cuda\n"
        "import bitcoin_miner_tpu_torch.miner.runner\n"
        "import bitcoin_miner_tpu_torch.testing.mock_pool\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a card the smoke test exits non-zero and prints no result;
    alone in a directory (without the package) likewise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH="")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
