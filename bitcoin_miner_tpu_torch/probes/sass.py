"""Static counts of a kernel library's SASS, by the pipe each instruction
issues to.

The counterpart, for the card, of what ``benchmarks/llo_probe.py`` reads
from the TPU compiler's schedule: ``cuobjdump -sass`` lists each kernel's
instructions, :func:`functions` parses them, :func:`loop_body` takes the
kernel's largest loop (its steady state) and :func:`pipe_counts` sorts its
instructions into

- ``alu``: the 64-lane integer pipe (IADD3, LOP3, SHF, LEA, ISETP, ...);
- ``fma``: the FMA pipe (IMAD and its forms, IMUL, VIADD, the float FMA
  ops). VIADD, Hopper's two-input integer add, is not on the integer
  pipe: in the int32 probe's loop LOP3 and LEA.HI alone hold that pipe at
  63 lanes per SM and clock (of 64) while the loop issues 122 (NVIDIA H100
  80GB HBM3, 700 W), which leaves no room there for its VIADDs, one per
  group and chain like the LOP3s;
- ``other``: everything else (branches, moves, loads, stores, uniform and
  special-register instructions).

Every instruction, whatever its pipe, takes one slot of instruction
dispatch.
"""

from __future__ import annotations

import os
import re
import subprocess
from collections import Counter
from typing import Dict, List, NamedTuple, Optional

from ..ops import csrc

PIPES = ("alu", "fma", "other")
_ALU = frozenset((
    "IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL", "SHR",
    "LEA", "ISETP", "ICMP", "IABS", "IMNMX", "VIMNMX", "SEL", "PRMT", "PLOP3",
    "ISCADD", "BMSK", "SGXT", "P2R", "R2P"))
_FMA = frozenset((
    "IMAD", "IMAD32I", "IMUL", "IMUL32I", "IMADSP", "VIADD", "FFMA",
    "FFMA32I", "FMUL", "FMUL32I", "FADD", "FADD32I"))

_FUNCTION = re.compile(r"Function : (\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*)")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


class Insn(NamedTuple):
    """One SASS instruction: its address, its opcode with modifiers
    (``IMAD.SHL.U32``) and, for a branch, the address it jumps to."""

    addr: int
    op: str
    target: Optional[int] = None

    @property
    def base(self) -> str:
        """The opcode without modifiers (``IMAD``)."""
        return self.op.split(".")[0]


def pipe_of(op: str) -> str:
    """The pipe an opcode (with or without modifiers) issues to."""
    base = op.split(".")[0]
    if base in _ALU:
        return "alu"
    return "fma" if base in _FMA else "other"


def functions(listing: str) -> Dict[str, List[Insn]]:
    """Each kernel's instructions in a ``cuobjdump -sass`` listing, by its
    mangled name. A branch's target is resolved from a label
    (`` `(.L_x_3) ``) or an address (``0x1f0``)."""
    out: Dict[str, List[Insn]] = {}
    insns: Optional[List[Insn]] = None
    labels: Dict[str, int] = {}
    pending: List[str] = []  # labels waiting for their instruction
    raw: List[tuple] = []  # (list, index, target text) to resolve
    for line in listing.splitlines():
        fn = _FUNCTION.search(line)
        if fn:
            insns = out.setdefault(fn.group(1), [])
            continue
        label = _LABEL.match(line)
        if label:
            pending.append(label.group(1))
            continue
        m = _INSN.match(line)
        if insns is None or not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        op = m.group(2)
        if op.split(".")[0] == "BRA":
            t = _TARGET.search(m.group(3))
            if t:
                raw.append((insns, len(insns), t.group(1) or int(t.group(2), 16)))
        insns.append(Insn(addr, op))
    for lst, i, target in raw:
        addr = labels.get(target) if isinstance(target, str) else target
        lst[i] = lst[i]._replace(target=addr)
    return out


def loop_body(insns: List[Insn]) -> List[Insn]:
    """The instructions of the largest loop: from the target of a backward
    branch to the branch, the longest such range (a kernel's closing
    self-branch is not a loop). Empty when there is no loop."""
    best: List[Insn] = []
    index = {insn.addr: i for i, insn in enumerate(insns)}
    for i, insn in enumerate(insns):
        if insn.target is None or insn.target >= insn.addr:
            continue
        start = index.get(insn.target)
        if start is not None and i + 1 - start > len(best):
            best = insns[start:i + 1]
    return best


def pipe_counts(insns: List[Insn]) -> Dict[str, int]:
    """Instructions per pipe, and ``all`` of them."""
    counts = dict.fromkeys(PIPES, 0)
    for insn in insns:
        counts[pipe_of(insn.op)] += 1
    counts["all"] = len(insns)
    return counts


def opcode_counts(insns: List[Insn]) -> Dict[str, int]:
    """Instructions per opcode with modifiers, most frequent first."""
    return dict(Counter(insn.op for insn in insns).most_common())


def cuobjdump() -> str:
    """``cuobjdump`` beside the CUDA compiler."""
    return os.path.join(os.path.dirname(csrc.nvcc()), "cuobjdump")


def listing(path) -> str:
    """``cuobjdump -sass`` of a built library."""
    return subprocess.run([cuobjdump(), "-sass", str(path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout


def ptxas_registers(log: str) -> Dict[str, int]:
    """Registers per kernel (mangled name) in a ``-Xptxas -v`` build log."""
    out: Dict[str, int] = {}
    kernel = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = entry.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if kernel is not None and regs:
            out[kernel] = int(regs.group(1))
    return out
