"""The int32 throughput probe: its CUDA kernel and its plain PyTorch version.

Counterpart of ``_probe_kernel`` and ``build_call`` in
``benchmarks/vpu_probe.py``: per lane of an (8, 128) uint32 seed tile,
``ilp`` independent chains from ``seed + i``, each running ``groups``
iterations of ``v += 0x9E3779B9; v ^= v << (13 + (i & 3)); v += v >> 7``,
XOR-folded into one word. :func:`probe` runs the plain version
(:func:`probe_plain`) for a CPU tensor and the kernel of
``csrc/int_probe.cu`` for a CUDA one, ``steps`` tiles per launch. The
harness is ``bitcoin_miner_tpu_torch/probes/int_probe.py``.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import csrc
from .sha256_torch import MASK32, pipe_bound_ms

SUBLANES = 8
LANES = 128
#: Algorithmic operations per group and chain (add; shl, xor; shr, add),
#: the numerator of ``tops_int32`` as in the reference.
OPS_PER_CHAIN_GROUP = 5
#: The instructions a group of a chain needs on Hopper, the numerator of
#: the bound: the ``+ C`` (VIADD) and the shift by a constant (IMAD.SHL, a
#: multiply by 2^s) can issue to the FMA pipe; the xor (LOP3) and the
#: shift-and-add ``v + (v >> 7)`` (LEA.HI) only to the integer pipe.
INSNS_PER_CHAIN_GROUP = 4
ALU_PER_CHAIN_GROUP = 2
#: The chains per lane the kernel is built for, one entry point each.
ILPS = (1, 2, 4, 8, 16)
#: Groups per iteration of the kernel's group loop (``kUnroll`` in
#: ``csrc/int_probe.cu``).
UNROLL = 8
_STEP = 0x9E3779B9

LIBRARY = csrc.register("int_probe", "int_probe.cu")
#: Launches of each entry point of ``csrc/int_probe.cu``.
LAUNCHES: Dict[int, csrc.LaunchCounter] = {
    ilp: csrc.launch_counter(f"int_probe_ilp{ilp}") for ilp in ILPS}


def _check(groups: int, ilp: int, steps: int = 1) -> None:
    if ilp not in ILPS:
        raise ValueError(f"ilp must be one of {ILPS}, got {ilp}")
    if groups < 0 or steps < 1:
        raise ValueError(f"need groups >= 0 and steps >= 1, got {groups}, "
                         f"{steps}")


def probe_plain(seed: torch.Tensor, groups: int, ilp: int) -> torch.Tensor:
    """One step of the probe: the (8, 128) uint32 tile of XOR-folded chains
    from the (8, 128) uint32 ``seed``, on its device. All chains run as one
    (ilp, 1024) int64 tensor masked to 32 bits after every add and shift
    (this torch's CPU uint32 has no ``+`` and no shifts)."""
    _check(groups, ilp)
    device = seed.device
    lanes = seed.reshape(-1).cpu().to(torch.int64).to(device)
    chains = torch.arange(ilp, dtype=torch.int64, device=device)[:, None]
    shifts = 13 + (chains & 3)
    v = (lanes[None, :] + chains) & MASK32
    for _ in range(groups):
        v = (v + _STEP) & MASK32
        v = v ^ ((v << shifts) & MASK32)
        v = (v + (v >> 7)) & MASK32
    acc = v[0]
    for i in range(1, ilp):
        acc = acc ^ v[i]
    return acc.reshape(SUBLANES, LANES).cpu().to(torch.uint32).to(device)


def probe_tiles(seed: torch.Tensor, groups: int, ilp: int,
                steps: int) -> torch.Tensor:
    """Every step's tile, (steps, 8, 128) uint32. A CPU ``seed`` takes the
    plain version (every step computes the same tile); a CUDA one (uint32,
    contiguous, (8, 128)) launches ``int_probe_kernel<ilp>`` on the current
    stream, four blocks of 256 threads per step, without synchronising."""
    _check(groups, ilp, steps)
    device = seed.device
    if device.type == "cpu":
        tile = probe_plain(seed, groups, ilp).to(torch.int64)
        return tile.expand(steps, SUBLANES, LANES).clone().to(torch.uint32)
    csrc.check_tensor(seed, device, torch.uint32, (SUBLANES, LANES))
    out = torch.empty((steps, SUBLANES, LANES), dtype=torch.uint32,
                      device=device)
    launch = getattr(csrc.load(LIBRARY), f"int_probe_ilp{ilp}_launch")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        csrc.check(launch(seed.data_ptr(), groups, steps, out.data_ptr(),
                          stream), f"int_probe_ilp{ilp}")
        LAUNCHES[ilp].add()
    return out


def probe(seed: torch.Tensor, groups: int, ilp: int,
          steps: int) -> torch.Tensor:
    """The probe's result, step 0's (8, 128) tile, of a run of ``steps``
    steps (:func:`probe_tiles`).

    Replaces ``benchmarks/vpu_probe.py::build_call``'s ``pallas_call``
    (``_probe_kernel``, ``:35``), whose grid steps all write the one
    output block. Bound: operations (:func:`probe_bound_ms`)."""
    return probe_tiles(seed, groups, ilp, steps)[0]


def chain_groups(groups: int, ilp: int, steps: int) -> int:
    """Groups of one chain run over all lanes of every step."""
    return steps * groups * ilp * SUBLANES * LANES


def probe_ops(groups: int, ilp: int, steps: int) -> int:
    """The algorithmic operations of a run: 5 per group, chain and lane of
    every step (``vpu_probe.run_config``'s numerator of ``tops_int32``)."""
    return OPS_PER_CHAIN_GROUP * chain_groups(groups, ilp, steps)


def probe_bound_ms(groups: int, ilp: int, steps: int, sms: int,
                   sm_clock_hz: float) -> float:
    """The least time of a run: the instructions the function needs
    (:data:`INSNS_PER_CHAIN_GROUP`, :data:`ALU_PER_CHAIN_GROUP` of them on
    the integer pipe) at the card's peak rates
    (``sha256_torch.pipe_bound_ms``). Both pipes bind alike: 2/64 and
    4/128 clocks per group, chain and lane."""
    n = chain_groups(groups, ilp, steps)
    return pipe_bound_ms(ALU_PER_CHAIN_GROUP * n, INSNS_PER_CHAIN_GROUP * n,
                         sms, sm_clock_hz)
