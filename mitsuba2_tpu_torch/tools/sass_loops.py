"""The path kernel's and the volumetric kernel's loops in their machine
code (SASS), on the card's toolkit.

    python -m mitsuba2_tpu_torch.tools.sass_loops [--nc 3,4,1] [--lobes 0]
        [--flags 0,15] [--volpath 1] [--splat] [--isect] [--sweep]
        [--against DIR]

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
build lacks. ``--sweep`` prints, for both face instantiations of
csrc/sweep_kernel.cu's library (the face-test ceiling), the face loop's
instructions a pair by ``SWEEP_KINDS`` (a pair's division check, FCHK,
counts the pairs a turn of the loop), for both box instantiations (the
box-test ceiling) the box loop's instructions a box test by ``BOX_KINDS``
(six FMUL count a box test), and the issue floor each sets against the
FLOP bound; with ``--against`` the same for the other build's, and
whether each face and box instantiation keeps that build's machine code.
``--against DIR`` (another
checkout's ``mitsuba2_tpu_torch/_build``, its libraries built) compares
every instantiation of each library, addresses and encodings aside, with
the same library there and prints which differ; for the instantiations
``--flags`` names, and with ``--splat`` for every splat kernel, it prints
the instructions that differ (``canonical``: registers, addresses and the
choice among integer adds aside) in the function and in each of its loops
of more than 20 instructions. Exits non-zero without cuobjdump.
"""

import argparse
import difflib
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


def opcode(text):
    """The opcode of one instruction, its predicate aside."""
    return re.sub(r"^@!?U?P\w+\s+", "", text).split(" ", 1)[0]


def kind(text):
    """The kind of one instruction (predicate aside), 'other' if none."""
    return next((k for k, ops in KINDS if opcode(text).startswith(ops)),
                "other")


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


def named_functions(sass, pattern, names):
    """cuobjdump -sass text -> {names[groups]: [(address, instruction)]}
    of the functions whose mangled name matches ``pattern`` (its groups
    the key of ``names``)."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(pattern, part.split("\n", 1)[0])
        if m:
            out[names[m.groups()]] = [
                (int(a.group(1), 16), a.group(2).strip())
                for a in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);",
                                     part)]
    return out


def isect_functions(sass):
    """cuobjdump -sass text -> {entry: [(address, instruction)]} of the
    intersection library's kernels, by entry point (``ISECT_ENTRIES``)."""
    return named_functions(sass, r"(isect_(?:inst_)?kernel)ILb([01])E",
                           ISECT_ENTRIES)


SWEEP_FUNCS = {("sweep", "1"): "sweep_kernel[shared]",
               ("sweep", "0"): "sweep_kernel[global]",
               ("box", "1"): "sweep_kernel[boxes, shared]",
               ("box", "0"): "sweep_kernel[boxes, global]"}

# the face sweep's instructions by kind (the first that matches)
SWEEP_KINDS = (("fp32", ("FFMA", "FMUL", "FADD", "MUFU")),
               ("load", ("LDS", "LDG", "LD.", "LDC", "ULDC")),
               ("compare and select", ("FSETP", "ISETP", "FSEL", "SEL",
                                       "PLOP3", "FMNMX", "IMNMX", "FCHK",
                                       "FSET", "VIMNMX")),
               ("branch", ("BRA", "CALL", "BSSY", "BSYNC", "RET", "EXIT")))


def sweep_kind(text):
    return next((k for k, ops in SWEEP_KINDS
                 if opcode(text).startswith(ops)), "other")


def sweep_functions(sass):
    """cuobjdump -sass text -> {name: [(address, instruction)]} of the
    sweep library's face and box instantiations (``SWEEP_FUNCS``)."""
    return named_functions(sass, r"(sweep|box)_kernelILb([01])E",
                           SWEEP_FUNCS)


def face_loops(ins):
    """[(start, end, instructions, pairs, {kind: count})] of the innermost
    loops of a face instantiation that test pairs (a pair one FCHK), the
    main loop first; the kinds count the fast path, without the
    instructions a forward branch skips to a CALL (the division's slow
    path, taken where FCHK fails)."""
    found = [(s, e) for s, e, _, _, fchk, _ in loops(ins, 0) if fchk]
    inner = [(s, e) for s, e in found
             if not any((s, e) != o and s <= o[0] and o[1] <= e
                        for o in found)]
    out = []
    for s, e in inner:
        body = [(a, t) for a, t in ins if s <= a <= e]
        slow = set()
        for a, t in body:
            m = re.search(r"BRA (?:!?U?P\d, )?(0x[0-9a-f]+)", t)
            if m and a < int(m.group(1), 16) <= e:
                skipped = [(x, u) for x, u in body
                           if a < x < int(m.group(1), 16)]
                if any("CALL" in u for _, u in skipped):
                    slow.update(x for x, _ in skipped)
        kinds = {k: 0 for k, _ in SWEEP_KINDS}
        kinds["other"] = 0
        for a, t in body:
            if a not in slow:
                kinds[sweep_kind(t)] += 1
        out.append((s, e, len(body), sum("FCHK" in t for _, t in body),
                    kinds))
    return sorted(out, key=lambda x: -x[3])


def print_face_loops(name, ins, pair_slots):
    """Each pair-testing loop's fast-path instructions a pair by kind, and
    the share of the FLOP bound the issue of the main loop allows
    (``pair_slots``: the bound's issue slots a pair, its FLOPs with an FMA
    2, over 2)."""
    for i, (s, e, n_all, pairs, kinds) in enumerate(face_loops(ins)):
        n = sum(kinds.values())
        print(f"  {name} {'main' if i == 0 else 'other'} loop {s:#x}-{e:#x}: "
              f"{n_all} instructions, {n} on the fast path, {pairs} pairs, "
              f"{n / pairs:.2f} a pair ("
              + ", ".join(f"{k} {v / pairs:.2f}" for k, v in kinds.items())
              + ")" + (f"; issue floor {n / pairs:.2f} slots a pair against "
                       f"the bound's {pair_slots:g}: at most "
                       f"{100 * pair_slots * pairs / n:.2f}% of bound"
                       if i == 0 else ""), flush=True)


# the box sweep's instructions by kind (the first that matches)
BOX_KINDS = (("fp32", ("FFMA", "FMUL", "FADD")),
             ("load", ("LDS", "LDG", "LD.", "LDC", "ULDC")),
             ("min/max", ("FMNMX", "IMNMX", "VIMNMX")),
             ("compare and select", ("FSETP", "ISETP", "FSEL", "SEL",
                                     "PLOP3", "FSET", "P2R", "R2P")),
             ("integer", KINDS[3][1] + ("VIADD",)),
             ("branch", ("BRA", "CALL", "BSSY", "BSYNC", "RET", "EXIT")))


def box_kind(text):
    return next((k for k, ops in BOX_KINDS if opcode(text).startswith(ops)),
                "other")


def box_loops(ins):
    """[(start, end, instructions, boxes, {kind: count})] of the innermost
    loops of a box instantiation that test boxes (a box test six FMUL: the
    slab's three near and three far products), the main loop (the most
    boxes a turn) first."""
    found = [(s, e) for s, e, *_ in loops(ins, 0)
             if any(opcode(t).startswith("FMUL")
                    for a, t in ins if s <= a <= e)]
    inner = [(s, e) for s, e in found
             if not any((s, e) != o and s <= o[0] and o[1] <= e
                        for o in found)]
    out = []
    for s, e in inner:
        body = [t for a, t in ins if s <= a <= e]
        kinds = {k: 0 for k, _ in BOX_KINDS}
        kinds["other"] = 0
        for t in body:
            kinds[box_kind(t)] += 1
        fmul = sum(opcode(t).startswith("FMUL") for t in body)
        out.append((s, e, len(body), fmul // 6, kinds))
    return sorted(out, key=lambda x: -x[3])


def print_box_loops(name, ins, box_slots):
    """Each box-testing loop's instructions a box test by kind, and for the
    main loop the share of the FLOP bound its issue allows (``box_slots``:
    the bound's issue slots a box test, its FLOPs over 2)."""
    for i, (s, e, n, boxes, kinds) in enumerate(box_loops(ins)):
        print(f"  {name} {'main' if i == 0 else 'other'} loop {s:#x}-{e:#x}: "
              f"{n} instructions, {boxes:g} box tests, {n / boxes:.2f} a "
              "box (" + ", ".join(f"{k} {v / boxes:.2f}"
                                  for k, v in kinds.items()) + ")"
              + (f"; issue floor {n / boxes:.2f} slots a box against the "
                 f"bound's {box_slots:g}: at most "
                 f"{100 * box_slots * boxes / n:.2f}% of bound"
                 if i == 0 else ""), flush=True)


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


# the integer adds the compiler picks among by register pressure
ADDS = ("VIADD", "IADD3", "IMAD.IADD")


def canonical(text):
    """One instruction with its registers, predicates and barriers
    renamed (R, UR, P, B), branch and call targets dropped, and the
    integer adds one opcode, so that a change of the register allocation
    or of the code's addresses leaves it as it was."""
    text = re.sub(r"\b(U?R|U?P|B)\d+\b", r"\1", text)
    pred = re.match(r"@!?U?P\s+", text)
    pred = pred.group(0) if pred else ""
    op = text[len(pred):].split(" ", 1)[0]
    if op.startswith(("BRA", "BSSY", "CALL", "JMP", "BRX")):
        text = re.sub(r"0x[0-9a-f]+", "<target>", text)
    if op.startswith(ADDS):
        text = pred + "ADD"
    return text


def print_diff(name, ins, theirs):
    """The instructions of one function that differ from ``theirs`` (the
    same function of another build), each ``canonical``, and for each loop
    of more than 20 instructions those that differ inside it, the loops
    paired in address order."""
    mine = [canonical(t) for _, t in ins]
    other = [canonical(t) for _, t in theirs]
    ops = [op for op in difflib.SequenceMatcher(
        None, other, mine, autojunk=False).get_opcodes() if op[0] != "equal"]
    added = sum(j2 - j1 for _, _, _, j1, j2 in ops)
    removed = sum(i2 - i1 for _, i1, i2, _, _ in ops)
    print(f"{name}: {len(mine)} instructions, {added} added and {removed} "
          f"removed against the other build's {len(other)}", flush=True)
    for _, i1, i2, j1, j2 in ops[:12]:
        for t in other[i1:i2]:
            print(f"  - {t}")
        for t in mine[j1:j2]:
            print(f"  + {t}")
    for (s0, e0, n0, *_), (s1, e1, n1, *_) in zip(loops(ins),
                                                  loops(theirs)):
        a = [canonical(t) for x, t in ins if s0 <= x <= e0]
        b = [canonical(t) for x, t in theirs if s1 <= x <= e1]
        moved = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in
                    difflib.SequenceMatcher(None, b, a, autojunk=False)
                    .get_opcodes() if tag != "equal")
        print(f"  loop {s0:#x}-{e0:#x} ({n0} instructions, the other's "
              f"{n1}): {moved} differ")


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
    ap.add_argument("--sweep", action="store_true",
                    help="the face and box sweeps' loops, instructions a "
                    "pair and a box test")
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
    jobs_sweep = [("sweep_kernel", {})] if args.sweep else []
    build.build_all(jobs + (vk.libraries() if vflags else []) + jobs_splat
                    + jobs_isect + jobs_sweep)
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
            theirs = functions(sass(other))
            for inst, ins in sorted(funcs.items()):
                if (inst[0] & ~pk.HAS_LOBES) in flags and inst in theirs:
                    print_diff(pk.kernel_name(*inst), ins, theirs[inst])
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
        others = [p for p in Path(args.against).glob("splat_kernel-*.so")
                  if ".tmp." not in p.name] if args.against else []
        theirs = splat_functions(sass(others[0])) if len(others) == 1 \
            else {}
        for name, ins in sorted(funcs.items()):
            print_loops(name, ins)
            print("  all: " + ", ".join(
                f"{k} {v}" for k, v in count_kinds(t for _, t in ins).items()),
                  flush=True)
            if name in theirs:
                print_diff(name, ins, theirs[name])
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
    if args.sweep:
        from ..core import profiler as prof
        slots = prof.SWEEP_PAIR_FLOPS / 2
        box_slots = prof.BOX_FLOPS / 2
        funcs = sweep_functions(sass(build.library_path("sweep_kernel")))
        others = [p for p in Path(args.against).glob("sweep_kernel-*.so")
                  if ".tmp." not in p.name] if args.against else []
        theirs = sweep_functions(sass(others[0])) if len(others) == 1 \
            else {}
        if args.against and not theirs:
            print(f"sweep_kernel: no library in {args.against}")
        for name, ins in sorted(funcs.items()):
            print(f"{name}: {len(ins)} instructions", flush=True)
            show = print_box_loops if "boxes" in name else print_face_loops
            per = box_slots if "boxes" in name else slots
            show("this build's", ins, per)
            if name in theirs:
                show("the other build's", theirs[name], per)
                same = [t for _, t in ins] == [t for _, t in theirs[name]]
                state = "the same machine code" if same else "differs"
                print(f"{name}: {state} against {others[0].name}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
