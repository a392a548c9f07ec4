"""getwork and getblocktemplate on the CPU: the PyTorch package's copies of
the transaction and getwork codecs, the template → job path, the
dispatcher's roll axes and checkpoint, and the two solo-mining sessions,
each held against the JAX package's on the same seeded inputs.

Blocks and solves must be accepted by the reference's fake node and by the
package's own; the package's node must give the reference's verdicts. The
sessions mine with the tile hasher's plain version (``device="cpu"``) or
the package's hashlib oracle, over a few thousand nonces."""

import asyncio
import dataclasses
import itertools
import json
import struct

import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.backends.cpu import CpuHasher as RefCpuHasher
from bitcoin_miner_tpu.backends.tpu import PallasTpuHasher
from bitcoin_miner_tpu.core import header as ref_header
from bitcoin_miner_tpu.core import tx as ref_tx
from bitcoin_miner_tpu.miner import dispatcher as ref_dispatcher
from bitcoin_miner_tpu.miner import job as ref_job
from bitcoin_miner_tpu.miner import runner as ref_runner
from bitcoin_miner_tpu.protocol import getwork as ref_getwork
from bitcoin_miner_tpu.testing import fake_node as ref_node
from bitcoin_miner_tpu.utils import checkpoint as ref_checkpoint
from bitcoin_miner_tpu_torch.backends.cpu import CpuHasher
from bitcoin_miner_tpu_torch.backends.cuda import TileCudaHasher
from bitcoin_miner_tpu_torch.core import header as port_header
from bitcoin_miner_tpu_torch.core import tx as port_tx
from bitcoin_miner_tpu_torch.core.sha256 import sha256d
from bitcoin_miner_tpu_torch.core.target import nbits_to_target
from bitcoin_miner_tpu_torch.miner import dispatcher as port_dispatcher
from bitcoin_miner_tpu_torch.miner import job as port_job
from bitcoin_miner_tpu_torch.miner import runner as port_runner
from bitcoin_miner_tpu_torch.protocol import getwork as port_getwork
from bitcoin_miner_tpu_torch.testing import fake_node as port_node
from bitcoin_miner_tpu_torch.utils import checkpoint as port_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


REGTEST_NBITS = 0x207FFFFF
REGTEST = nbits_to_target(REGTEST_NBITS)


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _rng(seed):
    return np.random.default_rng(seed)


def _bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _tx_blobs(seed, n):
    rng = _rng(seed)
    return [b"\x01\x00\x00\x00" + _bytes(rng, int(rng.integers(40, 120)))
            for _ in range(n)]


# --------------------------------------------------------------- codecs
VARINT_EDGES = [0, 1, 0xFC, 0xFD, 0xFE, 0xFF, 0xFFFF, 0x10000, 0xFFFFFFFF,
                1 << 32, (1 << 64) - 1]


class TestTxCodec:
    def test_varints_byte_identical(self):
        rng = _rng(1)
        values = VARINT_EDGES + [int(v) for v in rng.integers(
            0, 1 << 62, 200, dtype=np.int64)] + [int(v) for v in rng.integers(
                0, 1 << 17, 200)]
        for n in values:
            enc = port_tx.varint(n)
            assert enc == ref_tx.varint(n), n
            padded = b"\x99" * 3 + enc + b"\x77"
            assert port_tx.decode_varint(padded, 3) == ref_tx.decode_varint(
                padded, 3) == (n, len(enc))
        for mod in (port_tx, ref_tx):
            with pytest.raises(ValueError):
                mod.varint(-1)

    def test_bip34_heights_byte_identical(self):
        heights = [0, 1, 16, 127, 128, 255, 256, 32767, 32768, 65535, 65536,
                   840_000, 8_388_607, 8_388_608, (1 << 31) - 1]
        heights += [int(h) for h in _rng(2).integers(0, 1 << 31, 100)]
        for h in heights:
            assert port_tx.bip34_height_push(h) == ref_tx.bip34_height_push(h)
        assert port_tx.bip34_height_push(128) == b"\x02\x80\x00"
        for mod in (port_tx, ref_tx):
            with pytest.raises(ValueError):
                mod.bip34_height_push(-1)

    def test_script_push_refusals_match(self):
        for data in (b"", b"\x00" * 0x4C):
            for mod in (port_tx, ref_tx):
                with pytest.raises(ValueError):
                    mod.script_push(data)
        assert port_tx.script_push(b"ab") == ref_tx.script_push(b"ab")

    @pytest.mark.parametrize("witness", [False, True])
    @pytest.mark.parametrize("e2_size", [0, 1, 4, 8])
    def test_coinbase_split_byte_identical(self, witness, e2_size):
        rng = _rng(3 + e2_size)
        for _ in range(5):
            height = int(rng.integers(0, 1 << 24))
            value = int(rng.integers(0, 50 * 10**8))
            spk = _bytes(rng, int(rng.integers(1, 40)))
            wc = _bytes(rng, 38) if witness else None
            port = port_tx.build_coinbase_split(height, value, e2_size, spk,
                                                witness_commitment=wc)
            ref = ref_tx.build_coinbase_split(height, value, e2_size, spk,
                                              witness_commitment=wc)
            assert (port.coinb1, port.coinb2, port.has_witness) == (
                ref.coinb1, ref.coinb2, ref.has_witness)
            e2 = _bytes(rng, e2_size)
            assert port.serialize(e2) == ref.serialize(e2)
            assert port.serialize_for_block(e2) == ref.serialize_for_block(e2)
            assert port.txid(e2) == ref.txid(e2)
            header80 = _bytes(rng, 80)
            blobs = [port.serialize_for_block(e2)] + _tx_blobs(height, 3)
            assert port_tx.serialize_block(header80, blobs) == \
                ref_tx.serialize_block(header80, blobs)

    def test_refusals_match(self):
        for mod in (port_tx, ref_tx):
            with pytest.raises(ValueError):
                mod.build_coinbase_split(1, 1, 30, tag=b"t" * 75)
            with pytest.raises(ValueError):
                mod.serialize_block(b"\x00" * 79, [])
            with pytest.raises(ValueError):
                mod.build_coinbase_split(1, 1, 4).serialize(b"\x00" * 3)


class TestHeaderHelpers:
    def test_unpack_header_matches(self):
        rng = _rng(5)
        for _ in range(50):
            raw = _bytes(rng, 80)
            assert dataclasses.astuple(port_header.unpack_header(raw)) == \
                dataclasses.astuple(ref_header.unpack_header(raw))

    @pytest.mark.parametrize("n", range(1, 10))
    def test_merkle_root_and_branch_match(self, n):
        rng = _rng(100 + n)
        txids = [_bytes(rng, 32) for _ in range(n)]
        assert port_header.merkle_root_from_txids(txids) == \
            ref_header.merkle_root_from_txids(txids)
        assert port_header.merkle_branch_for_coinbase(txids[1:]) == \
            ref_header.merkle_branch_for_coinbase(txids[1:])
        # The branch folds the coinbase txid to the whole tree's root.
        branch = port_header.merkle_branch_for_coinbase(txids[1:])
        assert port_header.merkle_root_from_branch(txids[0], branch) == \
            port_header.merkle_root_from_txids(txids)


class TestGetworkCodec:
    def test_codec_byte_identical(self):
        rng = _rng(7)
        for _ in range(50):
            header80 = _bytes(rng, 80)
            blob = port_getwork.encode_getwork_submit(header80)
            assert blob == ref_getwork.encode_getwork_submit(header80)
            assert len(blob) == 256
            assert port_getwork.decode_getwork_data(blob) == \
                ref_getwork.decode_getwork_data(blob) == header80
            target_hex = _bytes(rng, 32).hex()
            assert port_getwork.decode_getwork_target(target_hex) == \
                ref_getwork.decode_getwork_target(target_hex)

    def test_refusals(self):
        for mod in (port_getwork, ref_getwork):
            with pytest.raises(ValueError):
                mod.decode_getwork_data("00" * 127)
            with pytest.raises(ValueError):
                mod.encode_getwork_submit(b"\x00" * 79)


# ------------------------------------------------------------ templates
def _template(seed, n_txs, witness, workid):
    rng = _rng(seed)
    blobs = _tx_blobs(seed, n_txs)
    template = {
        "version": 0x20000000 | int(rng.integers(0, 1 << 13)),
        "previousblockhash": _bytes(rng, 32).hex(),
        "height": int(rng.integers(1, 1 << 22)),
        "coinbasevalue": int(rng.integers(0, 50 * 10**8)),
        "curtime": int(rng.integers(1_600_000_000, 1_800_000_000)),
        "bits": f"{REGTEST_NBITS:08x}",
        "transactions": [{"data": b.hex(), "txid": sha256d(b)[::-1].hex(),
                          "hash": sha256d(b + b"w")[::-1].hex()}
                         for b in blobs],
    }
    if witness:
        template["default_witness_commitment"] = (
            b"\x6a\x24\xaa\x21\xa9\xed" + _bytes(rng, 32)).hex()
    if workid:
        template["workid"] = f"wid-{seed}"
    return template


TEMPLATE_CASES = [(seed, n, w, wid) for seed, (n, w, wid) in enumerate(
    [(0, False, False), (1, False, True), (3, True, False), (5, True, True),
     (2, False, False), (7, True, False)])]


class TestTemplates:
    @pytest.mark.parametrize("seed,n_txs,witness,workid", TEMPLATE_CASES)
    def test_job_from_template_matches(self, seed, n_txs, witness, workid):
        template = _template(seed, n_txs, witness, workid)
        port = port_getwork.job_from_template(template, "t1")
        ref = ref_getwork.job_from_template(template, "t1")
        assert port.job.merkle_branch == ref.job.merkle_branch
        assert port.job.sweep_key == ref.job.sweep_key
        assert port.coinbase.has_witness == witness
        rng = _rng(1000 + seed)
        for _ in range(4):
            e2 = _bytes(rng, 4)
            header76 = port.job.header76(e2)
            assert header76 == ref.job.header76(e2)
            header80 = header76 + _bytes(rng, 4)
            assert port.block_hex(e2, header80) == ref.block_hex(e2, header80)

    def test_share_target_and_script(self):
        template = _template(9, 2, False, False)
        kw = dict(extranonce2_size=2, script_pubkey=b"\x00\x14" + b"\x11" * 20,
                  share_target=1 << 200)
        port = port_getwork.job_from_template(template, "t", **kw)
        ref = ref_getwork.job_from_template(template, "t", **kw)
        assert port.job.share_target == ref.job.share_target == 1 << 200
        assert port.job.header76(b"\x01\x02") == ref.job.header76(b"\x01\x02")

    def test_fixed_merkle_job_matches(self):
        rng = _rng(11)
        fields = dict(job_id="g", prevhash_display_hex=_bytes(rng, 32).hex(),
                      merkle_root_internal=_bytes(rng, 32), version=2,
                      nbits=0x1D00FFFF, ntime=1_700_000_000)
        port = port_job.job_from_template_fields(**fields)
        ref = ref_job.job_from_template_fields(**fields)
        assert port.extranonce2_size == 0
        assert port.share_target == ref.share_target
        assert port.sweep_key == ref.sweep_key
        for ntime in (None, 1_700_000_005):
            assert port.header76(b"", ntime=ntime) == ref.header76(b"",
                                                                   ntime=ntime)
        with pytest.raises(ValueError):
            port.header76(b"\x00")


# ----------------------------------------------------- dispatcher items
def _ref_hasher():
    return RefCpuHasher()


def _fixed_job(mod):
    return mod.job_from_template_fields(
        "fm", "ab" * 32, sha256d(b"fixed merkle"), 0x20000000, 0x1D00FFFF,
        1_700_000_000)


def _one_byte_job(mod):
    rng = _rng(21)
    return mod.Job("e1", _bytes(rng, 32), _bytes(rng, 20), _bytes(rng, 20),
                   b"\xaa\xbb", 1, [_bytes(rng, 32)], 0x20000000, 0x1D00FFFF,
                   1_700_000_000, 1 << 240)


def _dispatchers(**kw):
    return (port_dispatcher.Dispatcher(CpuHasher(), n_workers=3, **kw),
            ref_dispatcher.Dispatcher(_ref_hasher(), n_workers=3, **kw))


def _items(dispatcher, job, n=None):
    job = dispatcher.set_job(job)
    items = dispatcher._iter_items(job)
    return [(i.extranonce2, i.ntime, i.version, i.nonce_start, i.nonce_count,
             i.header76) for i in itertools.islice(items, n)]


class TestDispatcherItems:
    def test_fixed_merkle_ntime_roll(self):
        async def main():
            port, ref = _dispatchers(ntime_roll=2)
            got = _items(port, _fixed_job(port_job))
            assert got == _items(ref, _fixed_job(ref_job))
            # Size-0 extranonce2: one empty value per pass, three passes.
            assert len(got) == 9 and {g[0] for g in got} == {b""}
            assert [g[1] - 1_700_000_000 for g in got[::3]] == [0, 1, 2]

        run(main())

    def test_one_byte_stride_and_ntime(self):
        async def main():
            port, ref = _dispatchers(ntime_roll=1, extranonce2_start=1,
                                     extranonce2_step=3)
            got = _items(port, _one_byte_job(port_job))
            assert got == _items(ref, _one_byte_job(ref_job))
            e2s = [g[0][0] for g in got[::3]]
            assert e2s == list(range(1, 256, 3)) * 2
            assert len(got) == 2 * 85 * 3

        run(main())

    def test_version_axis_then_ntime(self):
        async def main():
            port, ref = _dispatchers(ntime_roll=1)
            jobs = [dataclasses.replace(_fixed_job(mod), version_mask=0x6000)
                    for mod in (port_job, ref_job)]
            got = _items(port, jobs[0])
            assert got == _items(ref, jobs[1])
            assert len({(g[1], g[2]) for g in got}) == 8  # 2 ntimes × 4

        run(main())

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_resume_from_the_other_packages_checkpoint(self, tmp_path,
                                                       writer):
        """A checkpoint written while one package mined resumes the other
        at the same item, mid-ntime-roll."""
        async def main():
            path = str(tmp_path / "sweep.json")
            mods = {"port": (port_dispatcher, port_job, port_checkpoint,
                             CpuHasher),
                    "reference": (ref_dispatcher, ref_job, ref_checkpoint,
                                  _ref_hasher)}
            first = mods[writer]
            other = mods["reference" if writer == "port" else "port"]
            kw = dict(n_workers=2, ntime_roll=3, extranonce2_start=1,
                      extranonce2_step=2)
            d1 = first[0].Dispatcher(first[3](), checkpoint=first[2]
                                     .SweepCheckpoint(path), **kw)
            mined = _items(d1, _one_byte_job(first[1]), 2 * 200)
            with open(path) as f:
                on_disk = json.load(f)
            assert on_disk["format"] == 2 and len(on_disk["jobs"]) == 1
            (index,) = on_disk["jobs"].values()
            assert index > 128  # past the first ntime pass of 128 values
            d2 = other[0].Dispatcher(other[3](), checkpoint=other[2]
                                     .SweepCheckpoint(path), **kw)
            resumed = _items(d2, _one_byte_job(other[1]), 4)
            # Both packages resume at the same item, which the first one
            # had mined.
            d3 = first[0].Dispatcher(first[3](), checkpoint=first[2]
                                     .SweepCheckpoint(path), **kw)
            assert resumed == _items(d3, _one_byte_job(first[1]), 4)
            assert resumed[0] in mined
            assert resumed[0][1] == 1_700_000_001  # inside ntime pass 1

        run(main())

    def test_reset_clears_the_checkpoint(self, tmp_path):
        async def main():
            path = str(tmp_path / "sweep.json")
            d = port_dispatcher.Dispatcher(
                CpuHasher(), n_workers=2,
                checkpoint=port_checkpoint.SweepCheckpoint(path))
            _items(d, _one_byte_job(port_job), 100)
            assert json.load(open(path))["jobs"]
            d.reset_sweep_positions()
            assert json.load(open(path)) == {"format": 2, "jobs": {}}
            assert d._sweep_pos == {}

        run(main())

    def test_submit_blocks_only_drops_share_hits(self):
        """A hit under the share target but over the block target is
        neither counted nor handed on in the blocks-only mode, as in the
        reference."""
        async def main():
            job = dataclasses.replace(_fixed_job(port_job),
                                      share_target=(1 << 256) - 1)
            ref = dataclasses.replace(_fixed_job(ref_job),
                                      share_target=(1 << 256) - 1)
            for blocks_only in (False, True):
                d = port_dispatcher.Dispatcher(
                    CpuHasher(), submit_blocks_only=blocks_only)
                r = ref_dispatcher.Dispatcher(
                    _ref_hasher(), submit_blocks_only=blocks_only)
                got = [_verify(d, job, n) for n in range(8)]
                want = [_verify(r, ref, n) for n in range(8)]
                assert got == want
                assert d.stats.shares_found == r.stats.shares_found
                assert (d.stats.shares_found == 0) == blocks_only

        run(main())


def _verify(dispatcher, job, nonce):
    job = dispatcher.set_job(job)
    item = next(dispatcher._iter_items(job))
    share = dispatcher._verify_hit(item, nonce)
    return None if share is None else (share.nonce, share.is_block)


class TestCheckpointFile:
    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_files_interchange(self, tmp_path, writer):
        path = str(tmp_path / "c.json")
        mods = (port_checkpoint, ref_checkpoint)
        src, dst = mods if writer == "port" else mods[::-1]
        ck = src.SweepCheckpoint(path, max_entries=3)
        rng = _rng(31)
        keys = [f"job{i}:{_bytes(rng, 8).hex()}" for i in range(5)]
        for i, key in enumerate(keys):
            ck.set_progress(key, 10 * i + 1)
        ck.save()
        back = dst.SweepCheckpoint(path, max_entries=3)
        assert [back.get_resume_index(k) for k in keys] == [
            None, None, 21, 31, 41]
        assert open(path).read() == json.dumps(
            {"format": 2, "jobs": {k: 10 * i + 1
                                   for i, k in enumerate(keys)
                                   if i >= 2}})

    def test_other_format_is_discarded(self, tmp_path):
        path = tmp_path / "c.json"
        path.write_text(json.dumps({"format": 1, "jobs": {"a": 5}}))
        assert port_checkpoint.SweepCheckpoint(str(path)).get_resume_index(
            "a") is None
        path.write_text("{not json")
        assert port_checkpoint.SweepCheckpoint(str(path)).get_resume_index(
            "a") is None


# -------------------------------------------------------- slice parity
@pytest.mark.parametrize("seed", [0, 3])
def test_gbt_header_scan_matches_pallas_hasher(seed):
    """One GBT job's header76 at the regtest target, through the tile
    hasher's plain version and the reference's Pallas hasher in interpret
    mode: the same ScanResult (nonces, uncapped count, hashes)."""
    template = _template(seed, 3, seed % 2 == 1, False)
    gbt = port_getwork.job_from_template(template, "p")
    header76 = gbt.job.header76(b"\x05\x00\x00\x00")
    assert header76 == ref_getwork.job_from_template(
        template, "p").job.header76(b"\x05\x00\x00\x00")
    port = TileCudaHasher(batch_size=4096, inner_tiles=1, device="cpu")
    ref = PallasTpuHasher(batch_size=4096, sublanes=8, inner_tiles=1,
                          interpret=True, unroll=8)
    start, count = 777 * (seed + 1), 4096 + 1000
    got = port.scan(header76, start, count, gbt.job.block_target)
    want = ref.scan(header76, start, count, gbt.job.block_target)
    assert (got.nonces, got.total_hits, got.hashes_done) == (
        want.nonces, want.total_hits, want.hashes_done)
    assert got.total_hits > count // 4


# --------------------------------------------------------- fake nodes
NODES = [ref_node, port_node]
NODE_IDS = ["reference_node", "own_node"]


def _mine(header76, target, hasher=None):
    res = (hasher or CpuHasher()).scan(header76, 0, 512, target)
    assert res.nonces
    return header76 + res.nonces[0].to_bytes(4, "little")


def _verdicts(node_mod, client_mod):
    """The verdicts of one node on a matrix of submissions built by one
    package's GBT client: valid blocks (plain, segwit, with workid) and
    the ways a block goes wrong."""
    async def main():
        out = {}
        txs = _tx_blobs(41, 3)
        for label, kw in [("plain", {}), ("segwit", dict(
                witness_commitment=True)), ("workid", dict(workid="w9"))]:
            node = node_mod.FakeNode(nbits=REGTEST_NBITS, transactions=txs,
                                     **kw)
            await node.start()
            client = client_mod.GbtClient(node.url)
            gbt = await client.fetch_job()
            e2 = b"\x07\x00\x00\x00"
            header76 = gbt.job.header76(e2)
            header80 = _mine(header76, gbt.job.block_target)
            out[label] = await client.submit_block(gbt, e2, header80)
            out[label + "-bad-merkle"] = await client.submit_block(
                gbt, b"\x01\x00\x00\x00", header80)
            high = next(header76 + n.to_bytes(4, "little") for n in
                        range(1000) if int.from_bytes(sha256d(
                            header76 + n.to_bytes(4, "little")), "little")
                        > gbt.job.block_target)
            out[label + "-high-hash"] = await client.submit_block(gbt, e2,
                                                                  high)
            stale = header80[:4] + b"\x11" * 32 + header80[36:]
            out[label + "-prevblk"] = await client.submit_block(gbt, e2,
                                                                stale)
            bits = header80[:72] + struct.pack("<I", 0x207FFFFE) + \
                header80[76:]
            out[label + "-diffbits"] = await client.submit_block(gbt, e2,
                                                                 bits)
            block = gbt.block_hex(e2, header80)
            if label == "segwit":
                legacy = (header80 + port_tx.varint(4)
                          + gbt.coinbase.serialize(e2)
                          + b"".join(gbt.tx_blobs)).hex()
                out["segwit-legacy-coinbase"] = await client.rpc.call(
                    "submitblock", [legacy])
            if label == "plain":
                flagged = dataclasses.replace(gbt.coinbase, has_witness=True)
                witness = (header80 + port_tx.varint(4)
                           + flagged.serialize_for_block(e2)
                           + b"".join(gbt.tx_blobs)).hex()
                out["plain-witness-coinbase"] = await client.rpc.call(
                    "submitblock", [witness])
                out["plain-truncated"] = await client.rpc.call(
                    "submitblock", [block[:150]])
            if label == "workid":
                out["workid-missing"] = await client.rpc.call(
                    "submitblock", [block])
            out[label + "-accepted"] = [b.accepted for b in node.blocks]
            await node.stop()
        return out

    return run(main())


class TestFakeNodeVerdicts:
    @pytest.mark.parametrize("client_mod", [port_getwork, ref_getwork],
                             ids=["own_client", "reference_client"])
    def test_own_node_gives_the_reference_verdicts(self, client_mod):
        want = _verdicts(ref_node, client_mod)
        got = _verdicts(port_node, client_mod)
        assert got == want
        assert want["plain"] is None and want["segwit"] is None
        assert want["workid"] is None
        assert want["plain-bad-merkle"] == "bad-txnmrklroot"
        assert want["segwit-legacy-coinbase"] == "bad-witness-nonce-size"
        assert want["plain-witness-coinbase"] == "unexpected-witness"
        assert want["plain-high-hash"] == "high-hash"
        assert want["plain-prevblk"] == "inconclusive-not-best-prevblk"
        assert want["plain-diffbits"] == "bad-diffbits"
        assert want["workid-missing"] == "workid-mismatch"

    def test_getwork_verdicts_and_rolled_ntime(self):
        async def main():
            verdicts = []
            for mod, kw in ((ref_node, {}), (port_node, {}),
                            (port_node, dict(getwork_ntime_roll=600))):
                node = mod.FakeNode(nbits=REGTEST_NBITS, **kw)
                await node.start()
                client = port_getwork.GetworkClient(node.url)
                job, header76 = await client.fetch_work()
                assert job.share_target == REGTEST
                row = [await client.submit(_mine(header76, REGTEST))]
                bad = next(header76 + n.to_bytes(4, "little") for n in
                           range(1000) if int.from_bytes(sha256d(
                               header76 + n.to_bytes(4, "little")),
                               "little") > REGTEST)
                row.append(await client.submit(bad))
                for roll in (1, 600, 601, -1):
                    rolled = job.header76(b"", ntime=job.ntime + roll)
                    row.append(await client.submit(_mine(rolled, REGTEST)))
                verdicts.append(row)
                await node.stop()
            return verdicts

        ref, own, rolling = run(main())
        assert own == ref == [True, False, False, False, False, False]
        assert rolling == [True, False, True, True, False, False]


# ----------------------------------------------------------- sessions
async def _until(task, done, seconds, what):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + seconds
    while not done():
        assert loop.time() < deadline, what()
        assert not task.done(), task
        await asyncio.sleep(0.05)


@pytest.mark.parametrize("node_mod", NODES, ids=NODE_IDS)
def test_gbt_miner_8_workers_blocks_accepted(node_mod):
    """The package's GbtMiner, 8 workers on the tile hasher's plain
    version: blocks accepted by either package's fake node."""
    async def main():
        node = node_mod.FakeNode(nbits=REGTEST_NBITS,
                                 transactions=_tx_blobs(51, 2))
        await node.start()
        miner = port_runner.GbtMiner(
            node.url, hasher=TileCudaHasher(batch_size=1 << 10,
                                            device="cpu"),
            n_workers=8, batch_size=1 << 10, poll_interval=0.1)
        task = asyncio.create_task(miner.run())
        try:
            await _until(task, lambda: miner.blocks_accepted >= 1, 90,
                         lambda: [b.reason for b in node.blocks])
        finally:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
            await node.stop()
        assert any(b.accepted for b in node.blocks)
        assert miner.dispatcher.stats.hw_errors == 0
        assert miner.blocks_rejected == 0, miner.reject_reasons

    run(main())


def test_gbt_miner_follows_an_advancing_tip():
    """Against a node that takes every accepted block as its new tip, the
    miner switches jobs and mines on each new tip; blocks that reach the
    node after it moved on are stale, not rejected."""
    async def main():
        node = port_node.FakeNode(nbits=REGTEST_NBITS, advance_tip=True)
        await node.start()
        miner = port_runner.GbtMiner(
            node.url, hasher=CpuHasher(), n_workers=8, batch_size=64,
            poll_interval=0.1)
        task = asyncio.create_task(miner.run())
        try:
            await _until(task, lambda: len(node.tips) >= 3
                         and miner.blocks_accepted >= 3, 90,
                         lambda: [b.reason for b in node.blocks])
        finally:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
            await node.stop()
        assert node.template["height"] >= 4
        assert miner.blocks_accepted >= 3
        assert miner.blocks_rejected == 0, miner.reject_reasons
        assert all(b.reason == "inconclusive-not-best-prevblk"
                   for b in node.blocks if not b.accepted)
        assert miner.dispatcher.stats.hw_errors == 0

    run(main())


def test_reference_gbt_miner_against_own_node():
    async def main():
        node = port_node.FakeNode(nbits=REGTEST_NBITS,
                                  transactions=_tx_blobs(61, 3),
                                  witness_commitment=True, workid="x1")
        await node.start()
        miner = ref_runner.GbtMiner(node.url, hasher=_ref_hasher(),
                                    n_workers=8, batch_size=1 << 6,
                                    poll_interval=0.1)
        task = asyncio.create_task(miner.run())
        try:
            await _until(task, lambda: miner.blocks_accepted >= 1, 90,
                         lambda: [b.reason for b in node.blocks])
        finally:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
            await node.stop()
        assert all(b.accepted for b in node.blocks), [
            b.reason for b in node.blocks]

    run(main())


@pytest.mark.parametrize("node_mod", NODES, ids=NODE_IDS)
def test_getwork_miner_solves_accepted(node_mod):
    async def main():
        node = node_mod.FakeNode(nbits=REGTEST_NBITS)
        await node.start()
        miner = port_runner.GetworkMiner(
            node.url, hasher=TileCudaHasher(batch_size=1 << 10,
                                            device="cpu"),
            n_workers=4, batch_size=1 << 10, poll_interval=0.1)
        task = asyncio.create_task(miner.run())
        try:
            await _until(task, lambda: miner.solves_accepted >= 2, 90,
                         miner.dispatcher.stats.summary)
        finally:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
            await node.stop()
        stats = miner.dispatcher.stats
        assert stats.hw_errors == 0 and stats.shares_rejected == 0
        assert miner.dispatcher.ntime_roll == 600

    run(main())


def test_getwork_ntime_bump_keeps_the_job():
    """Servers bump ntime on every getwork: the work identity leaves it
    out, so polls do not restart the sweep (the reference's rule)."""
    class Bumping:
        calls = 0

        async def fetch_work(self):
            self.calls += 1
            job = port_job.job_from_template_fields(
                f"gw-{self.calls}", "00" * 32, sha256d(b"m"), 1, 0x1D00FFFF,
                1_700_000_000 + self.calls)
            return job, job.header76(b"")

    async def main():
        miner = port_runner.GetworkMiner("http://127.0.0.1:1",
                                         hasher=CpuHasher(),
                                         poll_interval=0.02)
        miner.client = Bumping()
        poll = asyncio.create_task(miner._poll_loop())
        await asyncio.sleep(0.3)
        miner._stopping = True
        poll.cancel()
        await asyncio.gather(poll, return_exceptions=True)
        assert miner.client.calls >= 3
        assert miner.dispatcher.current_generation == 1

    run(main(), 30)


def test_gbt_longpoll_switches_on_a_fee_bump():
    async def main():
        node = port_node.FakeNode(nbits=0x1D00FFFF)
        await node.start()
        miner = port_runner.GbtMiner(node.url, hasher=CpuHasher(),
                                     n_workers=2, batch_size=1 << 8,
                                     poll_interval=5.0)
        task = asyncio.create_task(miner.run())
        try:
            await _until(task, lambda: miner.dispatcher.current_generation,
                         30, lambda: "no job")
            gen = miner.dispatcher.current_generation
            assert miner.client.last_longpollid is not None
            node.update_template(transactions=_tx_blobs(71, 1),
                                 coinbasevalue=50 * 10**8 + 1)
            await _until(task, lambda: miner.dispatcher.current_generation
                         > gen, 10, lambda: "no switch")
            assert len(miner._current.tx_blobs) == 1
        finally:
            miner.stop()
            await asyncio.gather(task, return_exceptions=True)
            await node.stop()

    run(main())
