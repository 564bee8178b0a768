"""The port's plugin reference, from the plugins' docstrings (the role of
the reference's docs/generate_plugin_doc.py and of the JAX package's
docs/generate_plugin_docs.py).

    python -m mitsuba2_tpu_torch.tools.plugin_docs OUT.md

Writes every registered plugin, by category and name, with its class's
docstring, to OUT.md (a path the caller names; nothing else is written).
"""

from __future__ import annotations

import argparse
import os


def registry() -> dict[str, list]:
    """{category: [(name, class), ...]} of every registered plugin, both
    sorted."""
    from ..core.object import _REGISTRY, _ensure_loaded
    _ensure_loaded()
    by_cat: dict[str, list] = {}
    for (cat, name), cls in sorted(_REGISTRY.items()):
        by_cat.setdefault(cat, []).append((name, cls))
    return by_cat


def plugin_docs() -> str:
    """The reference page: a section a category, a heading and the
    docstring a plugin."""
    lines = ["# Plugin reference (mitsuba2_tpu_torch)", "",
             "Generated from plugin docstrings "
             "(`python -m mitsuba2_tpu_torch.tools.plugin_docs OUT.md`).",
             ""]
    for cat, plugins in registry().items():
        lines += [f"## {cat}s", ""]
        for name, cls in plugins:
            lines += [f"### `{name}`", ""]
            doc = (cls.__doc__ or "").strip()
            if doc:
                lines.append(doc)
            lines.append("")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mitsuba2_tpu_torch.tools.plugin_docs",
        description="write the port's plugin reference")
    ap.add_argument("out", help="the Markdown file to write")
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    text = plugin_docs()
    with open(out, "w") as f:
        f.write(text)
    cats = registry()
    print(f"wrote {args.out}: {len(cats)} categories, "
          f"{sum(len(v) for v in cats.values())} plugins")


if __name__ == "__main__":
    main()
