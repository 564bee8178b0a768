"""Scene dict -> Mitsuba XML writer (parity: src/python/python/xml.py
WriteXML, the writer of exporters such as the Blender add-on, and
``mitsuba2_tpu.python.xml``): the same text for the same dict, letter for
letter -- floats as ``%.6g``, a transform as its 16 matrix values, a
plugin's tag its registered category."""

from __future__ import annotations

import numpy as np

from ..core.transform import Transform

_CATEGORY_BY_NAME_CACHE = None


def _category_of(type_name):
    global _CATEGORY_BY_NAME_CACHE
    if _CATEGORY_BY_NAME_CACHE is None:
        from ..core.object import _REGISTRY, _ensure_loaded
        _ensure_loaded()
        _CATEGORY_BY_NAME_CACHE = {n: c for (c, n) in _REGISTRY}
    return _CATEGORY_BY_NAME_CACHE.get(type_name, "shape")


def _fmt(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        return " ".join(_fmt(x) for x in np.asarray(v).ravel())
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _emit(key, value, indent):
    pad = "    " * indent
    lines = []
    if isinstance(value, dict):
        t = value.get("type")
        if t == "rgb":
            lines.append(f'{pad}<rgb name="{key}" value='
                         f'"{_fmt(value["value"])}"/>')
        elif t == "spectrum":
            v = value["value"]
            if isinstance(v, (int, float)):
                lines.append(f'{pad}<spectrum name="{key}" value="{v}"/>')
            else:
                pairs = ", ".join(f"{a}:{b}" for a, b in v)
                lines.append(f'{pad}<spectrum name="{key}" '
                             f'value="{pairs}"/>')
        elif t == "ref":
            lines.append(f'{pad}<ref id="{value["id"]}"'
                         + (f' name="{key}"' if key else "") + "/>")
        else:
            cat = _category_of(t)
            attrs = f' type="{t}"'
            if value.get("id"):
                attrs += f' id="{value["id"]}"'
            if key and not key.startswith("_"):
                attrs += f' name="{key}"'
            lines.append(f"{pad}<{cat}{attrs}>")
            for k, v in value.items():
                if k in ("type", "id"):
                    continue
                lines.extend(_emit(k, v, indent + 1))
            lines.append(f"{pad}</{cat}>")
    elif isinstance(value, Transform):
        lines.append(f'{pad}<transform name="{key}">')
        mat = " ".join(_fmt(x) for x in np.asarray(value.matrix).ravel())
        lines.append(f'{pad}    <matrix value="{mat}"/>')
        lines.append(f"{pad}</transform>")
    elif isinstance(value, bool):
        lines.append(f'{pad}<boolean name="{key}" value="{_fmt(value)}"/>')
    elif isinstance(value, int):
        lines.append(f'{pad}<integer name="{key}" value="{value}"/>')
    elif isinstance(value, float):
        lines.append(f'{pad}<float name="{key}" value="{_fmt(value)}"/>')
    elif isinstance(value, str):
        lines.append(f'{pad}<string name="{key}" value="{value}"/>')
    elif isinstance(value, (list, tuple, np.ndarray)):
        lines.append(f'{pad}<vector name="{key}" value="{_fmt(value)}"/>')
    else:
        raise TypeError(f"cannot serialize {key}={type(value)}")
    return lines


def dict_to_xml(scene_dict: dict, filename: str | None = None) -> str:
    """A scene dict (``load_dict``'s form) as Mitsuba XML, written to
    ``filename`` when given."""
    if scene_dict.get("type") != "scene":
        body = _emit("", dict(scene_dict), 0)
        text = "\n".join(line.replace(' name=""', "") for line in body)
        text = text.replace(">", ' version="2.0.0">', 1)
    else:
        lines = ['<scene version="2.0.0">']
        for k, v in scene_dict.items():
            if k == "type":
                continue
            lines.extend(_emit(k, v, 1))
        lines.append("</scene>")
        text = "\n".join(lines)
    if filename:
        with open(filename, "w") as f:
            f.write(text)
    return text


# the reference's name
WriteXML = dict_to_xml
