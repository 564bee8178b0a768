"""The path kernel's loops in its machine code (SASS), on the card's
toolkit.

    python -m mitsuba2_tpu_torch.tools.sass_loops [--nc 3,4,1] [--lobes 0]
        [--flags 0,15] [--against DIR]

Builds csrc/path_kernel.cu's library of each color mode of ``--nc`` with
the lobes flag as ``--lobes`` says, disassembles it with ``cuobjdump
-sass`` and prints, for each instantiation of ``--flags``, every loop (a
backward branch) of more than 20 instructions: its address range, its
instructions, shared-memory loads (LDS) and division checks (FCHK, one a
correctly rounded division). ``--against DIR`` (another checkout's
``mitsuba2_tpu_torch/_build``, its libraries built) compares every
instantiation of each library, addresses and encodings aside, with the
same library there and prints which differ. Exits non-zero without
cuobjdump.
"""

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path


def cuobjdump():
    """cuobjdump beside nvcc, or None."""
    from ..ops import build
    nvcc = build.find_nvcc()
    cands = [Path(nvcc).parent / "cuobjdump"] if nvcc else []
    on_path = shutil.which("cuobjdump")
    if on_path:
        cands.append(Path(on_path))
    return next((str(c) for c in cands if c.is_file()), None)


def functions(sass):
    """cuobjdump -sass text -> {(flags, nc): [(address, instruction)]} of
    the path_kernel instantiations (keyed by template arguments: the
    mangled names carry a hash of the source file)."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"path_kernelILi(\d+)ELi(\d+)E",
                      part.split("\n", 1)[0])
        if m:
            out[(int(m.group(1)), int(m.group(2)))] = [
                (int(a.group(1), 16), a.group(2).strip())
                for a in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                     part)]
    return out


def loops(ins, least=20):
    """[(start, end, instructions, LDS, FCHK)] of the backward branches
    of one function spanning more than ``least`` instructions."""
    out = []
    for addr, text in ins:
        m = re.search(r"BRA (?:!?U?P\d, )?(0x[0-9a-f]+)", text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        start = int(m.group(1), 16)
        body = [t for a, t in ins if start <= a <= addr]
        if len(body) > least:
            out.append((start, addr, len(body),
                        sum(t.startswith("LDS") or " LDS" in t
                            for t in body),
                        sum("FCHK" in t for t in body)))
    return out


def library(build_dir, nc, lobes):
    """The path kernel library of (nc, lobes) in ``build_dir`` (not a
    profiled build), or None."""
    libs = [p for p in Path(build_dir).glob(
        f"path_kernel-pk_lobes{lobes}-pk_nc{nc}-*.so")
        if "pk_profile" not in p.name and ".tmp." not in p.name]
    return libs[0] if len(libs) == 1 else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nc", default="3,4,1")
    ap.add_argument("--lobes", default="0", help="0, 1 or 0,1")
    ap.add_argument("--flags", default="0,15",
                    help="instantiations whose loops to print")
    ap.add_argument("--against", default="",
                    help="another checkout's _build directory")
    args = ap.parse_args(argv)
    tool = cuobjdump()
    if tool is None:
        print("sass_loops: no cuobjdump", file=sys.stderr)
        return 2
    from ..ops import build, path_kernel as pk
    ncs = [int(x) for x in args.nc.split(",")]
    lobes = [int(x) for x in args.lobes.split(",")]
    jobs = [("path_kernel", pk.library_defines(nc, bool(lb)))
            for nc in ncs for lb in lobes]
    build.build_all(jobs)
    flags = {int(x) for x in args.flags.split(",") if x}
    for _, d in jobs:
        nc, lb = d["PK_NC"], d["PK_LOBES"]
        lib = build.library_path("path_kernel", d)
        funcs = functions(subprocess.run(
            [tool, "-sass", str(lib)], capture_output=True, text=True,
            check=True).stdout)
        for inst, ins in sorted(funcs.items()):
            if (inst[0] & ~pk.HAS_LOBES) not in flags:
                continue
            print(f"{pk.kernel_name(*inst)}: {len(ins)} instructions",
                  flush=True)
            for start, end, n, lds, fchk in loops(ins):
                print(f"  loop {start:#x}-{end:#x}: {n} instructions, "
                      f"{lds} LDS, {fchk} FCHK")
        if args.against:
            other = library(args.against, nc, lb)
            if other is None:
                print(f"pk_nc{nc} lobes {lb}: no library in "
                      f"{args.against}")
                continue
            theirs = functions(subprocess.run(
                [tool, "-sass", str(other)], capture_output=True,
                text=True, check=True).stdout)
            insts = sorted(set(funcs) | set(theirs))
            changed = [pk.kernel_name(*i) for i in insts
                       if [t for _, t in funcs.get(i, [])]
                       != [t for _, t in theirs.get(i, [])]]
            print(f"pk_nc{nc} lobes {lb}: {len(insts)} instantiations, "
                  f"{len(changed)} differ from {os.path.basename(other)}: "
                  + (", ".join(changed) or "none"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
