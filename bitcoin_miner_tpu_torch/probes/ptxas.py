"""ptxas' ``-v`` logs of the kernel libraries, read into rows.

``ops/csrc.build`` keeps each library's compiler log (``-Xptxas -v``)
beside it. :func:`ptxas_table` reads such logs into one row per library
and entry function: registers, spill bytes and static shared memory.
``chip_smoke.py``, ``sweep_pairs.py --ptxas`` and the layout ranker
(``probes/frontier.py``) read them through this one parser. It needs
neither torch nor a card.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def kernel_of(mangled: str) -> Tuple[str, Optional[str]]:
    """(kernel, mode) of a mangled kernel name: the ``..._kernel`` function
    and word7/exact from its ``bool WORD7`` template argument, or the int32
    probe's ILP from its ``int ILP`` one."""
    probe = re.search(r"int_probe_kernelILi(\d+)E", mangled)
    if probe:
        return "int_probe_kernel", f"ilp{probe.group(1)}"
    kernel = re.search(r"(scan_tile_(?:param_|staged_)?kernel"
                       r"|scan_hitbuf_kernel|rescan_steps_kernel)",
                       mangled).group(1)
    mode = re.search(r"Lb([01])E", mangled)
    return kernel, (("word7" if mode.group(1) == "1" else "exact")
                    if mode else None)


def entries(log: str) -> Dict[str, dict]:
    """Each entry function of one ``-v`` log, by its mangled name: its
    ``registers``, ``spill_stores``/``spill_loads`` bytes and
    ``static_smem`` bytes, as far as the log states them."""
    out: Dict[str, dict] = {}
    fields = None
    for line in log.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            fields = out.setdefault(entry.group(1), {})
            continue
        if fields is None:
            continue
        spill = _SPILL.search(line)
        regs = _REGS.search(line)
        smem = _SMEM.search(line)
        if spill:
            fields["spill_stores"] = int(spill.group(1))
            fields["spill_loads"] = int(spill.group(2))
        if regs:
            fields["registers"] = int(regs.group(1))
        if smem:
            fields["static_smem"] = int(smem.group(1))
    return out


def ptxas_table(logs: Dict[str, str]) -> List[dict]:
    """Registers, spill bytes and static shared memory of every kernel in
    ptxas' ``-v`` logs (library name → log), one row per library and
    entry function."""
    rows = []
    for lib, log in logs.items():
        for mangled, fields in entries(log).items():
            kernel, mode = kernel_of(mangled)
            rows.append({"library": lib, "kernel": kernel, "mode": mode,
                         **fields})
    return rows
