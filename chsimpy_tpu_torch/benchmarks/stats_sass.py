#!/usr/bin/env python
"""What does the statistics kernel's compiled loop issue per element?
Static counts by pipe from ``cuobjdump -sass`` of the built library.

    python -m chsimpy_tpu_torch.benchmarks.stats_sass

For every instantiation of ``stats_kernel`` (K3, K3_members, K7,
K7_members and the fold mode; float32 and float64, vector width V; the
body, and the parent body it replaced: ``prev``) the kernel's row loops
(one row of V columns a thread) are cut out of the SASS and their
instructions counted by pipe: FP64, FP32, MUFU and conversions,
with each pipe's time at its rate on an H100 SM for N=4096 (132 SMs at
1.98 GHz, the rates of the CUDA C++ Programming Guide's throughput table
for compute capability 9.0), beside the registers a thread takes
(``cuobjdump -res-usage``: with 256 threads a block, 64 registers let 4
blocks share an SM, 72 only 3).  The parent body has one row loop (two
in the fold mode, whose bands on one side of N/2 step through their
stored rows and whose band at the seam maps each row); the body has the
interior loop (no edge in its arithmetic, pointers stepped a row) and
the loop over the block's last rows (the field's last row chosen per
row), and the fold mode its stepped and seam loops; the field's first
row and, in the fold, its last run outside the loops.  The last lines
set each body beside the parent body of the same form, type and width,
and each fold instantiation beside the natural one.

These are static counts: every instruction of the loop body counts once,
predicated-off ones, the one-sided edge branches an interior element
never takes and the loop control included.  Only the copies of the true
division an interior element does not run are taken out: beyond the two
of the parent body, and all of the body's (its float64 divisions run the
true division only outside their range, its float32 ones never).  They
bound what the compiled code issues from above, not what the function
needs: the kernel's roofline bound stays its bytes and its arithmetic
(``benchmarks/roofline.py`` ``OPS_PER_ELEM``).  It needs the CUDA toolkit's
``cuobjdump`` and ``nvcc``, not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess

from ..ops import cuda_build

# the pipes, their SASS opcodes and their rates (instructions a clock on
# an SM)
PIPES = (('fp64', ('DADD', 'DMUL', 'DFMA', 'DSETP'), 64),
         ('fp32', ('FADD', 'FMUL', 'FFMA', 'FSETP'), 128),
         ('mufu', ('MUFU',), 16),
         ('conversion', ('F2F', 'F2I', 'I2F', 'I2FP'), 16))
SMS = 132
CLOCK_HZ = 1.98e9
FIELD = 4096 * 4096          # the elements the times are given for


def _opcode(text: str) -> str:
    return re.sub(r'^@!?U?P\w+\s+', '', text).split()[0].split('.')[0]


def _counts(lines) -> dict:
    ops = [_opcode(t) for _, t in lines]
    out = {pipe: sum(o in names for o in ops) for pipe, names, _ in PIPES}
    out['all'] = len(ops)
    return out


def _loops(ins):
    """(first, last) index of every loop of ``ins`` (a backward branch and
    its target)."""
    at = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, t) in enumerate(ins):
        m = re.search(r'\bBRA\b.*?0x([0-9a-f]+)', t)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in at:
            loops.append((at[int(m.group(1), 16)], i))
    return loops


def row_loops(ins):
    """The (first, last) index of the function's row loops, in address
    order: the longest loop and every other at least half its length
    (the fold mode has two)."""
    loops = _loops(ins)
    longest = max(e - b for b, e in loops)
    return sorted((b, e) for b, e in loops if 2 * (e - b) >= longest)


def loop_counts(ins, vec: int, span=None, runs: int = 2):
    """(per element, loop body): the static counts of one loop of the
    function (``span``: its (first, last) index; by default the longest;
    ``ins``: (address, text) of its SASS) by pipe, and per element.  The
    parent body holds one copy of the true division for each branch of
    the one-sided differences; an interior element runs ``runs`` a column
    (the parent's: its row and its column difference; the body's: none),
    so the per-element count takes out the copies beyond ``runs`` V, each
    counted from its reciprocal (MUFU) to the end of its slow-path branch
    (the CALL that marks it and the BSYNC after)."""
    b, e = span or max(_loops(ins), key=lambda be: be[1] - be[0])
    body = ins[b:e + 1]
    static = _counts(body)
    divs = []
    for i, (_, t) in enumerate(body):
        if _opcode(t) == 'CALL':
            d0 = max(k for k in range(i) if _opcode(body[k][1]) == 'MUFU')
            d1 = next(k for k in range(i, len(body))
                      if _opcode(body[k][1]) == 'BSYNC')
            divs.append(_counts(body[d0:d1 + 1]))
    extra = len(divs) - runs * vec
    per = {p: (static[p] - (extra * statistics.mean(d[p] for d in divs)
                            if extra else 0)) / vec for p in static}
    return per, static


def registers(text: str) -> dict:
    """Function name -> registers a thread, from ``cuobjdump -res-usage``
    output."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r'Function (\S+?):?\s*\n\s*REG:(\d+)', text)}


def stats_sass(lib_path: str) -> list:
    """One row for every instantiation of stats_kernel in the library."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.find_nvcc()),
                             'cuobjdump')

    def run(flag):
        return subprocess.run([cuobjdump, flag, lib_path],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
    text = run('-sass')
    regs = registers(run('-res-usage'))
    rows = []
    for part in re.split(r'\n\s*Function : ', text)[1:]:
        name, body = part.split('\n', 1)
        m = re.search(r'stats_kernelI([fd])Li(\d)ELb(\d)ELb(\d)ELb(\d)E',
                      name)
        if not m:
            continue
        ins = [(int(a, 16), t.strip()) for a, t in re.findall(
            r'/\*([0-9a-f]{4,})\*/\s+([^;]*);', body)]
        vec = int(m.group(2))
        prev = m.group(5) == '1'
        runs = 2 if prev else 0
        per, static = loop_counts(ins, vec, runs=runs)
        clocks_ms = FIELD / (SMS * CLOCK_HZ) * 1e3
        rows.append({
            'dtype': 'float32' if m.group(1) == 'f' else 'float64',
            'V': vec, 'halo': m.group(3) == '1', 'fold': m.group(4) == '1',
            'prev': prev, 'registers': regs.get(name.strip()),
            'static_per_element': per, 'loop_body': static,
            'row_loops_per_element': [
                loop_counts(ins, vec, sp, runs)[0] for sp in row_loops(ins)],
            'row_loops_all_per_element': [
                loop_counts(ins, vec, sp, runs)[0]['all']
                for sp in row_loops(ins)],
            'pipe_ms_at_4096': {p: per[p] / rate * clocks_ms
                                for p, _, rate in PIPES}})
    return rows


def body_beside_parent(rows) -> list:
    """For each instantiation of the body, the parent body's of the same
    form, type and width: instructions an element by pipe of each row
    loop and registers a thread."""
    parent = {(r['dtype'], r['V'], r['halo'], r['fold']): r for r in rows
              if r['prev']}
    out = []
    for r in rows:
        p = None if r['prev'] else parent.get(
            (r['dtype'], r['V'], r['halo'], r['fold']))
        if p is not None:
            out.append({'body_beside_parent': (
                            f"{r['dtype']} V={r['V']}"
                            + ' halo' * r['halo'] + ' fold' * r['fold']),
                        'per_element': {'parent': p['row_loops_per_element'],
                                        'body': r['row_loops_per_element']},
                        'registers': {'parent': p['registers'],
                                      'body': r['registers']}})
    return out


def fold_beside_natural(rows) -> list:
    """For each fold instantiation, the natural K3 one of the same type
    and width beside it: instructions an element of each row loop and
    registers a thread."""
    natural = {(r['dtype'], r['V'], r.get('prev', False)): r for r in rows
               if not r['fold'] and not r['halo']}
    out = []
    for r in rows:
        n = (natural.get((r['dtype'], r['V'], r.get('prev', False)))
             if r['fold'] else None)
        if n is not None:
            out.append({'fold_beside_natural': (
                            f"{r['dtype']} V={r['V']}"
                            + ' (parent body)' * r.get('prev', False)),
                        'all_per_element': {
                            'natural': n['row_loops_all_per_element'],
                            'fold': r['row_loops_all_per_element']},
                        'registers': {'natural': n['registers'],
                                      'fold': r['registers']}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m chsimpy_tpu_torch.benchmarks.stats_sass',
        description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    rows = stats_sass(cuda_build.build()['path'])
    for row in rows + body_beside_parent(rows) + fold_beside_natural(rows):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
