"""Report: registers and spills of every kernel instantiation, by ptxas.

    python3 chip_probes/ptxas_report.py [--against DIR]   (from the repository root)

Compiles every source of ``webgpufft_tpu_torch/csrc`` (K1, K2) and
``csrc/probes`` with the package's nvcc flags plus ``-Xptxas -v`` (all at
once, objects thrown away) and prints one line per kernel: registers, spill
stores and loads, stack frame.  With ``--against DIR``, a second ``csrc``
directory (another commit's, unpacked anywhere) is compiled the same way and
every kernel of K1 and K2 is printed side by side, ending in a count of the
kernels whose registers or spills differ: the check that a change to the
shared headers left the plans' kernels as they were.  Needs nvcc, no GPU.
"""

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from webgpufft_tpu_torch import _build  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '(\S+)'")
USED = re.compile(r"Used (\d+) registers")
SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
# the anonymous namespace's name carries a hash of the file: not part of the kernel
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")


def demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        out = names
    return [ANON.sub("anon", n) for n in out]


def parse(log):
    """{kernel: (registers, spill stores, spill loads, stack)} from ptxas -v."""
    rows, name, spill = {}, None, (0, 0, 0)
    for line in log.splitlines():
        if m := ENTRY.search(line):
            name = m.group(1)
        elif m := SPILL.search(line):
            spill = tuple(map(int, m.groups()))
        elif (m := USED.search(line)) and name:
            rows[name] = (int(m.group(1)), spill[1], spill[2], spill[0])
            name = None
    return dict(zip(demangle(list(rows)), rows.values()))


def compile_all(csrc: Path):
    """ptxas -v of every source under ``csrc`` and ``csrc/probes``, by file."""
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for src in sorted(csrc.glob("*.cu")) + sorted((csrc / "probes").glob("*.cu")):
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-Xptxas", "-v", "-c", "-o",
                   str(Path(tmp) / f"{src.stem}.o"), str(src)]
            jobs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        out = {}
        for src, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            out[src.relative_to(csrc).as_posix()] = parse(log)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="another csrc directory to compare K1/K2 with")
    args = ap.parse_args()
    ours = compile_all(_build.CSRC)
    for src, rows in ours.items():
        for kernel, (regs, st, ld, stack) in rows.items():
            print(f"{src}: {regs} registers, spill {st} stored / {ld} loaded, stack {stack}: "
                  f"{kernel}")
    if args.against is None:
        return
    theirs = compile_all(args.against)
    differ = total = 0
    for src in ("fused_lines.cu", "fused_cols.cu"):
        for kernel, row in ours[src].items():
            other = theirs[src].get(kernel)
            total += 1
            differ += other != row
            print(f"{src} {kernel}: here {row}, there {other}"
                  f"{'' if other == row else '   <-- differs'}")
    print(f"K1/K2: {total} kernels, {differ} differ in (registers, spill stores, spill loads, "
          f"stack) from {args.against}")


if __name__ == "__main__":
    main()
