"""The int32 throughput probe of the PyTorch package against the reference's
``benchmarks/vpu_probe.py``, on the CPU: the plain version against the
Pallas kernel in interpret mode bit for bit (uint32, tolerance 0), the
harness's keys and op count against the reference's, the command line, and
the SASS classifier on a canned ``cuobjdump -sass`` listing. The kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py::test_int_probe_matches_plain``)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")
sys.path.insert(0, BENCH)

import jax.numpy as jnp  # noqa: E402
import vpu_probe  # noqa: E402

from bitcoin_miner_tpu_torch.ops import int_probe  # noqa: E402
from bitcoin_miner_tpu_torch.ops.sha256_torch import pipe_bound_ms  # noqa: E402
from bitcoin_miner_tpu_torch.probes import int_probe as harness  # noqa: E402
from bitcoin_miner_tpu_torch.probes import sass  # noqa: E402


def _seed(kind: str) -> np.ndarray:
    if kind == "arange":  # the reference's own seed
        return np.arange(1024, dtype=np.uint32).reshape(8, 128)
    rng = np.random.default_rng(20260)
    return rng.integers(0, 1 << 32, (8, 128), dtype=np.uint32)


def _reference(seed: np.ndarray, groups: int, ilp: int, steps: int):
    call = vpu_probe.build_call(groups, ilp, steps, interpret=True)
    return np.asarray(call(jnp.asarray(seed)))


@pytest.mark.parametrize("seed_kind", ["arange", "random"])
@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("groups", [1, 16])
@pytest.mark.parametrize("ilp", [1, 2, 4, 8, 16])
def test_plain_matches_reference(ilp, groups, steps, seed_kind):
    seed = _seed(seed_kind)
    want = _reference(seed, groups, ilp, steps)
    x = torch.from_numpy(seed.astype(np.int64)).to(torch.uint32)
    tiles = int_probe.probe_tiles(x, groups, ilp, steps)
    assert tiles.dtype == torch.uint32
    assert tuple(tiles.shape) == (steps, 8, 128)
    got = tiles.to(torch.int64).numpy().astype(np.uint32)
    for tile in got:
        np.testing.assert_array_equal(tile, want)
    np.testing.assert_array_equal(
        int_probe.probe(x, groups, ilp, steps).to(torch.int64).numpy(), want)


def test_constants_match_reference():
    assert (int_probe.SUBLANES, int_probe.LANES,
            int_probe.OPS_PER_CHAIN_GROUP) == (
        vpu_probe.SUBLANES, vpu_probe.LANES, vpu_probe.OPS_PER_CHAIN_GROUP)


@pytest.mark.parametrize("ilp", [1, 16])
def test_run_config_on_cpu_has_the_reference_keys(ilp):
    groups, steps = 16, 4
    got = harness.run_config(groups, ilp, steps, device="cpu")
    want = vpu_probe.run_config(groups, ilp, steps, interpret=True)
    assert set(want) <= set(got)
    assert {k: got[k] for k in ("groups", "ilp", "steps")} == {
        k: want[k] for k in ("groups", "ilp", "steps")}
    ops = int_probe.probe_ops(groups, ilp, steps)
    assert ops == (steps * groups * ilp * vpu_probe.OPS_PER_CHAIN_GROUP
                   * vpu_probe.SUBLANES * vpu_probe.LANES)
    assert got["tops_int32"] == pytest.approx(ops / got["seconds"] / 1e12)
    assert got["device"] == "cpu"


def test_main_cpu_prints_one_line_per_ilp(capsys):
    assert harness.main(["--cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["ilp"] for line in lines] == [1, 2, 4, 8, 16]
    for line in lines:
        assert (line["groups"], line["steps"]) == (16, 4)
        assert line["seconds"] > 0 and line["tops_int32"] > 0


def test_main_without_a_card_fails_and_never_runs_the_plain_version(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    calls = []
    plain = int_probe.probe_plain
    try:
        int_probe.probe_plain = lambda *a: calls.append(a) or plain(*a)
        assert harness.main(["--steps", "1", "--groups", "1"]) == 1
    finally:
        int_probe.probe_plain = plain
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["ilp"] for line in lines] == [1, 2, 4, 8, 16]
    assert all("error" in line for line in lines) and not calls


@pytest.mark.parametrize("bad", [dict(ilp=3), dict(groups=-1),
                                 dict(steps=0)])
def test_probe_refuses_bad_arguments(bad):
    kw = {"groups": 1, "ilp": 1, "steps": 1, **bad}
    with pytest.raises(ValueError):
        int_probe.probe_tiles(torch.zeros((8, 128), dtype=torch.uint32), **kw)


def test_bound_is_the_two_pipe_model():
    # 4 instructions per lane-group, 2 on the integer pipe, at the card's
    # peak 64 and 128 lanes per SM and clock: 1/32 clock on either pipe.
    n = 4096 * 4096 * 1024
    for ilp, want_ms in ((1, 2.054), (16, 32.87)):
        got = int_probe.probe_bound_ms(4096, ilp, 4096, 132, 1.98e9)
        assert got == pytest.approx(n * ilp / 32 / (132 * 1.98e9) * 1e3)
        assert got == pytest.approx(want_ms, rel=1e-3)


def test_pipe_bound_takes_the_slower_pipe():
    # 10 integer-pipe of 30 instructions a lane: dispatch (30/128) binds;
    # 20 of 30: the integer pipe (20/64).
    assert pipe_bound_ms(10, 30, 1, 1e3) == pytest.approx(30 / 128)
    assert pipe_bound_ms(20, 30, 1, 1e3) == pytest.approx(20 / 64)


@pytest.mark.parametrize("alu,all_,pipe", [(266, 516, "alu"),
                                           (50, 122, "dispatch"),
                                           (64, 128, "dispatch")])
def test_binding_pipe(alu, all_, pipe):
    assert harness.binding_pipe({"alu": alu, "all": all_}) == pipe


# A cuobjdump -sass listing: one function with label branches (the form of
# current toolkits), one with address branches; each ends in the closing
# self-branch, which is not a loop.
LISTING = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_116int_probe_kernelILi2EEEvPKjiPj
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
                                                                                 /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                          /* 0x0000000000007919 */
        /*0020*/                   ISETP.GE.AND P0, PT, R2, 0x8, PT ;          /* 0x000000080200780c */
        /*0030*/              @!P0 BRA `(.L_x_0) ;                             /* 0x0000000000208947 */
.L_x_1:
        /*0040*/                   IADD3 R4, R4, -0x61c88647, RZ ;             /* 0x9e3779b904047810 */
        /*0050*/                   IMAD.SHL.U32 R6, R4, 0x2000, RZ ;           /* 0x0000200004067824 */
        /*0060*/                   LOP3.LUT R4, R4, R6, RZ, 0x3c, !PT ;        /* 0x0000000604047212 */
        /*0070*/                   LEA.HI R4, R4, R4, RZ, 0x19 ;               /* 0x0000000404047211 */
        /*0080*/                   IADD3 R2, R2, 0x8, RZ ;                     /* 0x0000000802027810 */
        /*0090*/                   ISETP.GT.AND P0, PT, R2, R3, PT ;           /* 0x000000030200720c */
        /*00a0*/               @P0 BRA `(.L_x_1) ;                             /* 0xfffffffc00e40947 */
.L_x_0:
        /*00b0*/                   STG.E desc[UR4][R8.64], R4 ;                /* 0x0000000408007986 */
        /*00c0*/                   EXIT ;                                      /* 0x000000000000794d */
.L_x_2:
        /*00d0*/                   BRA `(.L_x_2);                              /* 0xfffffffc00fc7947 */
        /*00e0*/                   NOP;                                        /* 0x0000000000007918 */
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_116int_probe_kernelILi1EEEvPKjiPj
        /*0000*/                   MOV R1, c[0x0][0x28] ;                      /* 0x00000a0000017a02 */
        /*0010*/                   SHF.R.U32.HI R5, RZ, 0x7, R4 ;              /* 0x0000000704057819 */
        /*0020*/                   IADD3 R4, R4, R5, -0x61c88647 ;             /* 0x0000000504047210 */
        /*0030*/                   SHF.L.U32 R6, R4, 0xd, RZ ;                 /* 0x0000000d04067819 */
        /*0040*/                   LOP3.LUT R4, R4, R6, RZ, 0x3c, !PT ;        /* 0x0000000604047212 */
        /*0050*/               @P0 BRA 0x10 ;                                  /* 0xfffffffc00e40947 */
        /*0060*/                   EXIT ;                                      /* 0x000000000000794d */
        /*0070*/                   BRA 0x70;                                   /* 0xfffffffc00fc7947 */
"""


def test_sass_functions_and_loop_body():
    fns = sass.functions(LISTING)
    assert len(fns) == 2
    two = fns["_ZN12_GLOBAL__N_116int_probe_kernelILi2EEEvPKjiPj"]
    assert [i.op for i in two[:3]] == ["LDC", "S2R", "ISETP.GE.AND"]
    assert two[3].target == 0xb0 and two[3].base == "BRA"
    body = sass.loop_body(two)
    assert (body[0].addr, body[-1].addr) == (0x40, 0xa0)
    assert sass.pipe_counts(body) == {"alu": 5, "fma": 1, "other": 1, "all": 7}
    assert sass.opcode_counts(body)["IADD3"] == 2
    one = sass.loop_body(fns["_ZN12_GLOBAL__N_116int_probe_kernelILi1EEEvPKjiPj"])
    assert [i.addr for i in one] == [0x10, 0x20, 0x30, 0x40, 0x50]
    assert sass.pipe_counts(one) == {"alu": 4, "fma": 0, "other": 1, "all": 5}
    assert sass.loop_body(two[-3:]) == []


@pytest.mark.parametrize("op, pipe", [
    ("IADD3", "alu"), ("LOP3.LUT", "alu"), ("SHF.L.W.U32.HI", "alu"),
    ("LEA.HI.X", "alu"), ("ISETP.NE.U32.AND", "alu"), ("PRMT", "alu"),
    ("IMAD.SHL.U32", "fma"), ("IMAD.MOV.U32", "fma"), ("IMAD.IADD", "fma"),
    ("VIADD", "fma"),
    ("MOV", "other"), ("BRA", "other"), ("UIADD3", "other"),
    ("LDG.E", "other"), ("S2R", "other")])
def test_pipe_of(op, pipe):
    assert sass.pipe_of(op) == pipe


def test_loop_counts_per_chain_group():
    counts = harness.loop_counts(LISTING)
    assert sorted(counts) == [1, 2]
    two = counts[2]
    assert two["loop"]["all"] == 7 and two["groups_per_iteration"] == 8
    assert two["per_chain_group"]["alu"] == pytest.approx(5 / 16)


def test_loop_overhead_fits_the_line():
    # 3 instructions of overhead per iteration, 4 per chain-group (2 ALU, 2
    # FMA) over 8 groups an iteration.
    static = {ilp: {"loop": {"alu": 2 + 16 * ilp, "fma": 16 * ilp,
                             "other": 1, "all": 3 + 32 * ilp}}
              for ilp in (1, 2, 4, 8, 16)}
    fit = harness.loop_overhead(static)
    assert fit["all"]["per_iteration"] == pytest.approx(3)
    assert fit["all"]["per_chain_group"] == pytest.approx(4)
    assert fit["alu"]["per_iteration"] == pytest.approx(2)
    assert fit["other"]["per_chain_group"] == pytest.approx(0)


def test_lanes_per_sm_clock():
    # 16 groups at 8 an iteration: 2 iterations in each of 2 steps' 2048
    # lanes, over 1 ms of 2 SMs at 1000 MHz.
    res = {"groups": 16, "ilp": 2, "steps": 2, "seconds": 1e-3,
           "sm_clock_mhz": 1000.0}
    sms = 2
    loop = {"alu": 4096, "fma": 0, "other": 0, "all": 8192}
    got = harness.lanes_per_sm_clock(res, loop, sms)
    clocks = 1e-3 * 1e9 * sms
    assert got["alu"] == pytest.approx(4096 * 2 * 2048 / clocks)
    assert got["issued"] == pytest.approx(2 * got["alu"])
    assert got["fma"] == 0
    assert got["ops"] == pytest.approx(16 * 2 * 2 * 1024 * 5 / clocks)


def test_ptxas_registers():
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_116int_probe_kernelILi4EEEvPKjiPj' for 'sm_90a'\n"
           "ptxas info    : Function properties for x\n"
           "ptxas info    : Used 12 registers, 372 bytes cmem[0]\n")
    assert sass.ptxas_registers(log) == {
        "_ZN12_GLOBAL__N_116int_probe_kernelILi4EEEvPKjiPj": 12}
