"""Report the FMA loops of a built kernel library: their instruction mix
and their register-bank pairs.

Needs ``cuobjdump`` (the CUDA toolkit); run on the machine that built the
library, from the repository root::

    python3 exsr_torch/scripts/sass_loops.py \\
        build/exsr_torch_kernels/rdb-*.so --kernel rdb_fma_kernel

For each function whose name contains ``--kernel``, it finds the loops (a
branch back to an earlier address with no ``BSSY`` inside, so innermost)
that hold at least ``--min-ffma`` FFMAs and prints, one JSON line each,
their instructions, FFMAs, shared loads and the FFMAs that read two of
their source registers, neither marked ``.reuse``, from one bank
(register number mod 2): each such read costs the issue a clock.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys

INSN = re.compile(r'/\*([0-9a-f]{4,6})\*/\s+(.*?);')
FUNC = re.compile(r'\n\t\tFunction : (\S+)')


def opcode(text: str) -> str:
    word = text.split()[1] if text.startswith('@') else text.split()[0]
    return word.split('.')[0]


def same_bank(text: str) -> bool:
    """An FFMA whose non-reused source registers share a bank."""
    regs = [int(m.group(1)) for op in text.split(',')[1:]
            for m in [re.match(r'\s*-?\|?R(\d+)(\.reuse)?', op)]
            if m and not m.group(2)]
    banks = [r % 2 for r in regs]
    return len(banks) != len(set(banks))


def loops(sass: str, min_ffma: int):
    insns = [(int(m.group(1), 16), m.group(2).strip())
             for m in INSN.finditer(sass)]
    where = {a: i for i, (a, _) in enumerate(insns)}
    for i, (addr, text) in enumerate(insns):
        m = re.search(r'BRA .*?0x([0-9a-f]+)', text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [t for _, t in insns[where.get(int(m.group(1), 16), i):i + 1]]
        mix = collections.Counter(opcode(t) for t in body)
        if mix['FFMA'] >= min_ffma and not mix['BSSY']:
            yield dict(start=hex(int(m.group(1), 16)), end=hex(addr),
                       instructions=len(body), ffma=mix['FFMA'],
                       lds=mix['LDS'], same_bank_ffma=sum(
                           same_bank(t) for t in body
                           if opcode(t) == 'FFMA'))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('libraries', nargs='+')
    parser.add_argument('--kernel', default='fma_kernel')
    parser.add_argument('--min-ffma', type=int, default=100)
    args = parser.parse_args()
    for lib in args.libraries:
        sass = subprocess.run(['cuobjdump', '-sass', lib], capture_output=True,
                              text=True, check=True).stdout
        starts = [(m.start(), m.group(1)) for m in FUNC.finditer(sass)]
        for (start, name), (end, _) in zip(starts, starts[1:] + [(len(sass),
                                                                  '')]):
            if args.kernel in name:
                for rec in loops(sass[start:end], args.min_ffma):
                    print(json.dumps(dict(library=lib, function=name,
                                          **rec)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
