"""The port's public surface against the JAX package's: every public
top-level function, class and constant of every module of
``mitsuba2_tpu`` (but ``ops/``, ``native/`` and ``__main__.py``), and every
public method of those classes, is read with ``ast`` and asked of the
counterpart module of ``mitsuba2_tpu_torch`` (or of its class) with
``hasattr``, so that inherited and re-exported names count. Only the
names the port replaced on purpose may be missing."""

import ast
import importlib
import pathlib

JAX_ROOT = pathlib.Path(__file__).resolve().parents[1] / "mitsuba2_tpu"

# the names the port replaced on purpose: the TPU peaks and reports of the
# profiler (the port's profiler has the H100's own ceilings), the JAX
# pytree carriers (the port has its own tables), and the merged-BSDF
# module (ROADMAP: ported only if the card shows it pays)
ALLOWED_MISSING = {
    ("core.profiler", "PEAK_MXU_BF16"),
    ("core.profiler", "PEAK_MXU_K4"),
    ("core.profiler", "PEAK_MXU_K4_MODEL"),
    ("core.profiler", "PEAK_VPU"),
    ("core.profiler", "PEAK_HBM"),
    ("core.profiler", "megakernel_flop_count"),
    ("core.profiler", "megakernel_mfu_report"),
    ("render.film", "ImageBlockState"),
    ("render.scene", "GeometryTables"),
    ("models.merged", "<module>"),
}


def _modules():
    for path in sorted(JAX_ROOT.rglob("*.py")):
        rel = path.relative_to(JAX_ROOT)
        if rel.parts[0] in ("ops", "native") or rel.name == "__main__.py":
            continue
        parts = rel.with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _public_names(tree):
    """(name, method names or None) of the module's public top-level
    functions, classes and assigned constants."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names = [(node.name, None)]
        elif isinstance(node, ast.ClassDef):
            names = [(node.name, [
                sub.name for sub in node.body
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not sub.name.startswith("_")])]
        elif isinstance(node, ast.Assign):
            names = [(t.id, None) for t in node.targets
                     if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            names = [(node.target.id, None)]
        else:
            names = []
        for name, methods in names:
            if not name.startswith("_"):
                yield name, methods


def missing_names():
    missing = set()
    for mod, path in _modules():
        try:
            port = importlib.import_module(
                "mitsuba2_tpu_torch" + (f".{mod}" if mod else ""))
        except ModuleNotFoundError:
            missing.add((mod, "<module>"))
            continue
        for name, methods in _public_names(ast.parse(path.read_text())):
            if not hasattr(port, name):
                missing.add((mod, name))
                continue
            cls = getattr(port, name)
            for meth in methods or ():
                if not hasattr(cls, meth):
                    missing.add((mod, f"{name}.{meth}"))
    return missing


def test_modules_listed():
    mods = dict(_modules())
    assert len(mods) > 60
    assert "core.warp" in mods and "render.scene" in mods
    assert not any(m.startswith(("ops", "native")) for m in mods)


def test_only_the_replaced_names_are_missing():
    assert missing_names() == ALLOWED_MISSING
