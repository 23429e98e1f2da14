"""Disassemble the port's CUDA kernels and count their SASS instructions.

Builds the named kernels (all of petsctpu_torch/csrc when none is named)
with petsctpu_torch.ops._build, runs `cuobjdump -sass` on each library
and prints, for every kernel function in it, the instruction count and
a histogram of opcodes (memory, arithmetic, control). With --out DIR it
also writes each library's full listing to DIR/<kernel>.sass.

Needs the CUDA toolkit (nvcc, cuobjdump); no card is needed. Run from
the repository root:

    python3 scripts/dump_sass.py [--out DIR] [kernel ...]
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from petsctpu_torch.ops import _build  # noqa: E402

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def cuobjdump() -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise SystemExit("dump_sass: cuobjdump not found")
    return tool


def functions(listing: str) -> dict:
    """{function name: [opcode with modifiers, ...]} in listing order."""
    out, cur = {}, None
    for line in listing.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append(m.group(1))
    return out


def summary(ops: list) -> str:
    """The opcode histogram, grouped by the opcode's stem."""
    hist = collections.Counter(ops)
    stems = collections.Counter(op.split(".")[0] for op in ops)
    mem = {op: n for op, n in hist.items()
           if op.split(".")[0] in ("LDG", "STG", "LDS", "STS", "LD", "ST",
                                   "LDC", "ULDC", "SHFL", "RED", "ATOM")}
    lines = [f"  {len(ops)} instructions; by stem: "
             + ", ".join(f"{s} {n}" for s, n in stems.most_common())]
    lines.append("  memory: " + ", ".join(f"{op} {n}" for op, n in
                                         sorted(mem.items())))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the full listings")
    ap.add_argument("kernels", nargs="*")
    args = ap.parse_args(argv)
    names = args.kernels or _build.kernel_names()
    _build.build_all(names)
    tool = cuobjdump()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for name in names:
        listing = subprocess.run([tool, "-sass", str(_build.lib_path(name))],
                                 capture_output=True, text=True, check=True,
                                 timeout=120).stdout
        if args.out:
            with open(os.path.join(args.out, f"{name}.sass"), "w") as f:
                f.write(listing)
        for fn, ops in functions(listing).items():
            print(f"{name}: {fn}")
            print(summary(ops))


if __name__ == "__main__":
    main()
