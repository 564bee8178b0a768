"""The path kernel's and the volumetric kernel's loops in their machine
code (SASS), on the card's toolkit.

    python -m mitsuba2_tpu_torch.tools.sass_loops [--nc 3,4,1] [--lobes 0]
        [--flags 0,15] [--volpath 1] [--splat] [--isect] [--against DIR]

Builds csrc/path_kernel.cu's library of each color mode of ``--nc`` with
the lobes flag as ``--lobes`` says (``--nc ''`` builds none), disassembles
it with ``cuobjdump -sass`` and prints, for each instantiation of
``--flags``, every loop (a backward branch) of more than 20 instructions:
its address range, its instructions, shared-memory loads (LDS) and
division checks (FCHK, one a correctly rounded division), and its
instructions by kind (``KINDS``: float, integer, MUFU, loads, other).
``--volpath`` does the same for the instantiations it names of
csrc/volpath_kernel.cu's library (flag bits, ops/volpath_kernel.py;
``--volpath ''`` none). ``--splat`` prints, for every kernel of
csrc/splat_kernel.cu's library, its instructions by kind and its loops
(a turn of the tile pass's sample loop: four samples, its integer
instructions mostly their TEA rounds). ``--isect`` does the same for the
entries of csrc/intersect_kernel.cu's library (K2: the scene's faces and
the shared instances), and with ``--against`` names the entries the other
build lacks. ``--against DIR`` (another
checkout's ``mitsuba2_tpu_torch/_build``, its libraries built) compares
every instantiation of each library, addresses and encodings aside, with
the same library there and prints which differ. Exits non-zero without
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


# instruction kinds by opcode prefix (the first that matches)
KINDS = (("mufu", ("MUFU",)),
         ("load", ("LDG", "LDS", "LDL", "LDC", "LD.", "ULDC")),
         ("float", ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL",
                    "FCHK", "FRND", "F2I", "I2F", "FSET")),
         ("integer", ("IMAD", "IADD", "LOP", "SHF", "ISETP", "IMNMX",
                      "LEA", "SEL", "PRMT", "IABS", "POPC", "FLO",
                      "UIADD", "UIMAD", "ULOP", "USHF", "ISCADD", "IMUL")))


def kind(text):
    """The kind of one instruction (predicate aside), 'other' if none."""
    op = re.sub(r"^@!?U?P\w+\s+", "", text).split(" ", 1)[0]
    return next((k for k, ops in KINDS if op.startswith(ops)), "other")


def functions(sass, kernel="path_kernel"):
    """cuobjdump -sass text -> {template arguments: [(address,
    instruction)]} of ``kernel``'s instantiations: (flags, nc) of the path
    kernel, (flags,) of the volumetric one (keyed by template arguments:
    the mangled names carry a hash of the source file)."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(kernel + r"ILi(\d+)E(?:Li(\d+)E)?",
                      part.split("\n", 1)[0])
        if m:
            out[tuple(int(g) for g in m.groups() if g is not None)] = [
                (int(a.group(1), 16), a.group(2).strip())
                for a in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                     part)]
    return out


def count_kinds(texts):
    """{kind: count} of instructions."""
    kinds = {k: 0 for k, _ in KINDS}
    kinds["other"] = 0
    for t in texts:
        kinds[kind(t)] += 1
    return kinds


def loops(ins, least=20):
    """[(start, end, instructions, LDS, FCHK, {kind: count})] of the
    backward branches of one function spanning more than ``least``
    instructions."""
    out = []
    for addr, text in ins:
        m = re.search(r"BRA (?:!?U?P\d, )?(0x[0-9a-f]+)", text)
        if not m or int(m.group(1), 16) >= addr:
            continue
        start = int(m.group(1), 16)
        body = [t for a, t in ins if start <= a <= addr]
        if len(body) > least:
            kinds = count_kinds(body)
            out.append((start, addr, len(body),
                        sum(t.startswith("LDS") or " LDS" in t
                            for t in body),
                        sum("FCHK" in t for t in body), kinds))
    return out


def splat_functions(sass):
    """cuobjdump -sass text -> {kernel: [(address, instruction)]} of the
    splat library's kernels, named as ``time_paths.splat_ptxas`` names
    them."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        head = part.split("\n", 1)[0]
        m = re.search(r"(splat_[a-z]+)((?:ILi\d+E(?:Li\d+E)*E)?)E", head)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2))
            out[m.group(1) + (f"<{', '.join(args)}>" if args else "")] = [
                (int(a.group(1), 16), a.group(2).strip())
                for a in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                     part)]
    return out


ISECT_ENTRIES = {("isect_kernel", "0"): "isect_closest",
                 ("isect_kernel", "1"): "isect_any",
                 ("isect_inst_kernel", "0"): "isect_closest_inst",
                 ("isect_inst_kernel", "1"): "isect_any_inst"}


def isect_functions(sass):
    """cuobjdump -sass text -> {entry: [(address, instruction)]} of the
    intersection library's kernels, by entry point (``ISECT_ENTRIES``)."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"(isect_(?:inst_)?kernel)ILb([01])E",
                      part.split("\n", 1)[0])
        if m:
            out[ISECT_ENTRIES[m.groups()]] = [
                (int(a.group(1), 16), a.group(2).strip())
                for a in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                     part)]
    return out


def print_loops(name, ins):
    print(f"{name}: {len(ins)} instructions", flush=True)
    for start, end, n, lds, fchk, kinds in loops(ins):
        print(f"  loop {start:#x}-{end:#x}: {n} instructions, {lds} LDS, "
              f"{fchk} FCHK; " + ", ".join(f"{k} {v}"
                                           for k, v in kinds.items()))


def differ(tool, funcs, other, name, kernel="path_kernel"):
    """-> (instantiations, the names by ``name`` of those whose machine
    code differs from library ``other``'s)."""
    theirs = functions(subprocess.run(
        [tool, "-sass", str(other)], capture_output=True, text=True,
        check=True).stdout, kernel)
    insts = sorted(set(funcs) | set(theirs))
    return len(insts), [name(*i) for i in insts
                        if [t for _, t in funcs.get(i, [])]
                        != [t for _, t in theirs.get(i, [])]]


def library(build_dir, nc=None, lobes=None):
    """The path kernel library of (nc, lobes) in ``build_dir``, or without
    them the volumetric kernel's (not a profiled build), or None."""
    pattern = ("volpath_kernel-*.so" if nc is None
               else f"path_kernel-pk_lobes{lobes}-pk_nc{nc}-*.so")
    libs = [p for p in Path(build_dir).glob(pattern)
            if "profile" not in p.name and ".tmp." not in p.name]
    return libs[0] if len(libs) == 1 else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nc", default="3,4,1")
    ap.add_argument("--lobes", default="0", help="0, 1 or 0,1")
    ap.add_argument("--flags", default="0,15",
                    help="instantiations whose loops to print")
    ap.add_argument("--volpath", default="1",
                    help="volumetric instantiations whose loops to print")
    ap.add_argument("--splat", action="store_true",
                    help="the splat kernel's instructions and loops")
    ap.add_argument("--isect", action="store_true",
                    help="the intersection kernel's entries")
    ap.add_argument("--against", default="",
                    help="another checkout's _build directory")
    args = ap.parse_args(argv)
    tool = cuobjdump()
    if tool is None:
        print("sass_loops: no cuobjdump", file=sys.stderr)
        return 2
    from ..ops import build, path_kernel as pk
    from ..ops import volpath_kernel as vk
    ncs = [int(x) for x in args.nc.split(",") if x]
    lobes = [int(x) for x in args.lobes.split(",")]
    jobs = [("path_kernel", pk.library_defines(nc, bool(lb)))
            for nc in ncs for lb in lobes]
    vflags = {int(x) for x in args.volpath.split(",") if x}
    if args.splat:
        from ..ops import splat as sp
        jobs_splat = sp.libraries()
    else:
        jobs_splat = []
    jobs_isect = [("intersect_kernel", {})] if args.isect else []
    build.build_all(jobs + (vk.libraries() if vflags else []) + jobs_splat
                    + jobs_isect)
    flags = {int(x) for x in args.flags.split(",") if x}

    def sass(lib):
        return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout

    for _, d in jobs:
        nc, lb = d["PK_NC"], d["PK_LOBES"]
        funcs = functions(sass(build.library_path("path_kernel", d)))
        for inst, ins in sorted(funcs.items()):
            if (inst[0] & ~pk.HAS_LOBES) in flags:
                print_loops(pk.kernel_name(*inst), ins)
        if args.against:
            other = library(args.against, nc, lb)
            if other is None:
                print(f"pk_nc{nc} lobes {lb}: no library in "
                      f"{args.against}")
                continue
            n, changed = differ(tool, funcs, other, pk.kernel_name)
            print(f"pk_nc{nc} lobes {lb}: {n} instantiations, "
                  f"{len(changed)} differ from {os.path.basename(other)}: "
                  + (", ".join(changed) or "none"), flush=True)
    if vflags:
        funcs = functions(sass(build.library_path("volpath_kernel")),
                          "volpath_kernel")
        for inst, ins in sorted(funcs.items()):
            if inst[0] in vflags:
                print_loops(vk.kernel_name(*inst), ins)
        other = args.against and library(args.against)
        if other:
            n, changed = differ(tool, funcs, other, vk.kernel_name,
                                "volpath_kernel")
            print(f"volpath_kernel: {n} instantiations, {len(changed)} "
                  f"differ from {os.path.basename(other)}: "
                  + (", ".join(changed) or "none"), flush=True)
    if args.splat:
        funcs = splat_functions(sass(build.library_path("splat_kernel")))
        for name, ins in sorted(funcs.items()):
            print_loops(name, ins)
            print("  all: " + ", ".join(
                f"{k} {v}" for k, v in count_kinds(t for _, t in ins).items()),
                  flush=True)
    if args.isect:
        funcs = isect_functions(sass(build.library_path("intersect_kernel")))
        for name, ins in sorted(funcs.items()):
            print_loops(name, ins)
            print("  all: " + ", ".join(
                f"{k} {v}" for k, v in count_kinds(t for _, t in ins).items()),
                  flush=True)
        others = list(Path(args.against).glob("intersect_kernel-*.so")) \
            if args.against else []
        others = [p for p in others if ".tmp." not in p.name]
        if len(others) == 1:
            theirs = isect_functions(sass(others[0]))
            for name, ins in sorted(funcs.items()):
                if name not in theirs:
                    state = "new (not in the other build)"
                elif [t for _, t in ins] == [t for _, t in theirs[name]]:
                    state = "the same machine code"
                else:
                    state = "differs"
                print(f"{name}: {state} against {others[0].name}",
                      flush=True)
        elif args.against:
            print(f"intersect_kernel: no library in {args.against}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
