"""Registers and spills of the port's CUDA kernels, from ``nvcc -Xptxas -v``.

Compiles each ``src/repro_torch/kernels/csrc/*.cu`` (a source listed in
``_build.PARTS`` once a part) with the build's own flags plus ``-Xptxas
-v`` into a scratch directory, one nvcc a compile, all at once, and prints
one line a kernel instantiation whose demangled name contains every
``--match`` string: registers, spill stores and loads, the tensor-core
instructions in its SASS (``cuobjdump -sass``: HMMA, mma.sync's; HGMMA,
wgmma's), and the name. Needs nvcc and cuobjdump (the card's machine); the
library that the kernels run from is not touched.

    python scripts/torch_ptxas.py --match "80"          # the D = 80 instantiations
    python scripts/torch_ptxas.py --match bwd           # flash attention's backward
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_FUNC = re.compile(r"Function : (\S+)")


def tensor_ops(obj: Path) -> dict:
    """{mangled kernel name: (HMMA count, HGMMA count)} from the object's SASS."""
    nvcc_dir = Path(_build._nvcc()).parent
    tool = nvcc_dir / "cuobjdump"
    out = subprocess.run([str(tool if tool.exists() else "cuobjdump"), "-sass", str(obj)],
                         capture_output=True, text=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = m.group(1)
            counts[cur] = [0, 0]
        elif cur is not None:
            counts[cur][0] += " HMMA." in line
            counts[cur][1] += " HGMMA." in line
    return {k: tuple(v) for k, v in counts.items()}


def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
        return dict(zip(names, out))
    except (OSError, subprocess.CalledProcessError):
        return {n: n for n in names}


def report(log: str):
    """(mangled name, registers, spill stores, spill loads) of each entry."""
    rows, cur, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur, spill = m.group(1), (0, 0)
            continue
        m = _SPILL.search(line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = _REGS.search(line)
        if m and cur:
            rows.append((cur, int(m.group(1)), *spill))
            cur = None
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--match", action="append", default=[],
                    help="keep kernels whose demangled name holds this (repeatable)")
    args = ap.parse_args()
    nvcc = _build._nvcc()
    srcs = sorted(_build.CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for src in srcs:
            n = _build.PARTS.get(src.name)
            for part in range(n) if n else [None]:
                define = [] if part is None else [f"-DH2EAL_PART={part}"]
                obj = Path(tmp) / f"{src.stem}{'' if part is None else part}.o"
                cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", *define, "-c", str(src),
                       "-o", str(obj)]
                procs.append((src.name, part, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        rows, failed, tc, warned = [], [], {}, []
        for name, part, obj, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{name} part {part}:\n{out}")
                continue
            rows += [(name, *r) for r in report(out)]
            tc.update(tensor_ops(obj))
            # ptxas serialises wgmma where it cannot keep its registers in flight
            warned += [f"{name}: {line.strip()}" for line in out.splitlines()
                       if "wgmma" in line and "serializ" in line]
    names = _demangle([r[1] for r in rows])
    worst = 0
    for src, mangled, regs, st, ld in rows:
        full = names[mangled]
        if all(m in full for m in args.match):
            hmma, hgmma = tc.get(mangled, (0, 0))
            print(f"{src:28s} regs {regs:3d} spill_st {st:4d} spill_ld {ld:4d} "
                  f"HMMA {hmma:5d} HGMMA {hgmma:5d}  {full}")
            worst = max(worst, st + ld)
    print(f"spill bytes, most of one matched kernel: {worst}")
    for line in warned:
        print(line)
    if failed:
        print("\n".join(failed), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
