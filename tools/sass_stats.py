#!/usr/bin/env python3
"""Instruction counts of the port's CUDA kernels, from their SASS.

    python3 tools/sass_stats.py NAME [NAME ...]

Builds the kernel library of this checkout (`_build.build()`), disassembles
it with `cuobjdump -sass` and, for each kernel whose mangled name holds a
NAME, prints one JSON line: its instruction count, and for each stretch
between two block barriers (`BAR`) the count of each opcode, its FFMAs, its
loads from the constant bank that holds `__constant__` data (`c[0x3]`) and
how many of those come after the stretch's 200th FFMA. Kernels here are
fully unrolled where it matters, so a stretch's counts are what one pass
through it issues. Needs the CUDA toolkit (the card's machine).
"""

import collections
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ecamp_tpu_torch.kernels import _build  # noqa: E402

_INSN = re.compile(r"/\*[0-9a-f]{4,5}\*/\s+([^;]*);")


def _opcode(text: str) -> str:
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def stretches(sass: str) -> list:
    """Per stretch between barriers: opcode counts, FFMAs, constant-bank
    loads and those after the 200th FFMA."""
    insns = [m.group(1).strip() for m in _INSN.finditer(sass)]
    cuts = [i for i, t in enumerate(insns) if _opcode(t).startswith("BAR")]
    out = []
    for lo, hi in zip([0] + cuts, cuts + [len(insns)]):
        part = insns[lo:hi]
        ffma = [i for i, t in enumerate(part) if _opcode(t).startswith("FFMA")]
        const = [i for i, t in enumerate(part) if "c[0x3]" in t]
        late = ffma[199] if len(ffma) >= 200 else len(part)
        out.append({"instructions": len(part), "ffma": len(ffma),
                    "constant_loads": len(const),
                    "constant_loads_after_200th_ffma":
                        sum(i > late for i in const),
                    "opcodes": dict(collections.Counter(
                        _opcode(t) for t in part).most_common())})
    return out


def main() -> int:
    names = sys.argv[1:]
    if not names:
        print(__doc__, file=sys.stderr)
        return 2
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    found = 0
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        mangled = func.split("\n", 1)[0].strip()
        if any(n in mangled for n in names):
            found += 1
            parts = stretches(func)
            print(json.dumps({"kernel": mangled,
                              "instructions": sum(p["instructions"]
                                                  for p in parts),
                              "stretches": parts}), flush=True)
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
