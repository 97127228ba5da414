#!/usr/bin/env python3
"""Count what the hand-written kernels compiled to, on a machine with nvcc:
the tool for judging a kernel's instruction budget before cutting its
arithmetic.

    python3 kernel_sass.py [REGEX]

Builds the kernels if needed (``pop2_tpu_torch._cuda_build.lib``), then for
every kernel instance whose mangled name matches REGEX (default: all):
ptxas's registers, spill stores and stack frame from the build log, and the
SASS instructions of its k loop (the longest backward branch in
``cuobjdump -sass`` of the built library) with the most frequent opcodes.
Prints one JSON object a line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

from pop2_tpu_torch import _cuda_build as cb

INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);")
BRANCH = re.compile(r"BRA\s+0x([0-9a-f]+)")


def ptxas_by_instance(log: str) -> dict:
    """{mangled name: {registers, spill_store_bytes, stack_frame_bytes}}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("stack_frame_bytes", r"(\d+) bytes stack frame")):
            m = re.search(pat, line)
            if m and cur is not None:
                cur[key] = int(m.group(1))
    return out


def loop_of(body: str):
    """(instructions of the longest backward branch's span, its opcodes)."""
    ins = [(int(m.group(1), 16), m.group(2))
           for m in map(INSTR.match, body.splitlines()) if m]
    span = (0, 0)
    for addr, text in ins:
        m = BRANCH.search(text)
        if m and int(m.group(1), 16) < addr:
            target = int(m.group(1), 16)
            if addr - target > span[1] - span[0]:
                span = (target, addr)
    ops = {}
    for addr, text in ins:
        if span[0] <= addr <= span[1]:
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]
            ops[op] = ops.get(op, 0) + 1
    return sum(ops.values()), sorted(ops.items(), key=lambda x: -x[1])


def main():
    pattern = re.compile(sys.argv[1] if len(sys.argv) > 1 else ".")
    lib = cb.lib()
    so = Path(lib._name)
    cuobjdump = os.path.join(os.path.dirname(cb._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    ptxas = ptxas_by_instance(cb.build_log())
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if not pattern.search(name):
            continue
        n_loop, ops = loop_of(body)
        print(json.dumps({"kernel": name, **ptxas.get(name, {}),
                          "loop_instructions": n_loop,
                          "loop_opcodes": dict(ops[:12])}), flush=True)


if __name__ == "__main__":
    main()
