"""Mitsuba XML scene loader.

Parity: src/libcore/xml.cpp and ``mitsuba2_tpu.core.xml_impl``: tag
dispatch (xml.cpp:37-41), ``$key`` parameter substitution (the command
line's -D), ``<default>``, ``<include>``, ``<alias>``, ``<ref>`` named
references, the transform sub-tags (translate, rotate, scale, matrix,
lookat; each left-multiplies), ``<rgb>`` and ``<spectrum>`` (a value, a
curve of wavelength:value pairs, or a spectrum plugin; xml.cpp:774-850)
and the upgrade of pre-2.0 scenes (camelCase property names to
underscore_case, xml.cpp:350-360). Parsed trees go through the dict
loader's construction path (``Properties``, ``create_object``).
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from .fresolver import file_resolver
from .object import create_object
from .properties import Properties
from .transform import Transform

_PLUGIN_TAGS = {
    "bsdf", "emitter", "sensor", "shape", "integrator", "sampler", "film",
    "rfilter", "texture", "medium", "phase", "volume",
}


class XMLParseError(RuntimeError):
    pass


def load_file(path, params=None):
    """The scene or plugin of an XML file; the file's directory joins the
    file resolver's search paths, so that meshes and textures named
    relative to it resolve."""
    path = file_resolver().resolve(path)
    with open(path, "r") as f:
        text = f.read()
    file_resolver().append(os.path.dirname(os.path.abspath(path)))
    return load_string(text, params)


def load_string(text, params=None):
    """The scene or plugin of an XML string; ``params`` maps ``$key``
    names to their values."""
    root = ET.fromstring(text)
    version = root.get("version", "2.0.0")
    ctx = _Context(dict(params or {}), int(version.split(".")[0]) < 2)
    return _build(root, ctx)


class _Context:
    def __init__(self, params, upgrade):
        self.params = params      # $key substitutions
        self.refs = {}            # id -> instantiated object
        self.upgrade = upgrade


_SUB_RE = re.compile(r"\$(\w+)")


def _subst(value: str, ctx: _Context) -> str:
    def repl(mt):
        key = mt.group(1)
        if key not in ctx.params:
            raise XMLParseError(f"undefined parameter ${key}")
        return str(ctx.params[key])
    return _SUB_RE.sub(repl, value)


def _attr(node, name, ctx, default=None):
    v = node.get(name)
    if v is None:
        return default
    return _subst(v, ctx)


_CAMEL_RE = re.compile(r"(?<!^)(?=[A-Z])")


def _upgrade_name(name: str, upgrade: bool) -> str:
    """camelCase -> underscore_case for version < 2.0 (xml.cpp upgrade)."""
    if not upgrade:
        return name
    return _CAMEL_RE.sub("_", name).lower()


def _parse_vec(text: str) -> np.ndarray:
    return np.asarray([float(x) for x in text.replace(",", " ").split()],
                      np.float32)


def _vec_from_node(node, ctx, default=0.0):
    v = _attr(node, "value", ctx)
    if v is not None:
        arr = _parse_vec(v)
        if arr.size == 1:
            arr = np.full(3, arr[0], np.float32)
        return arr
    return np.asarray([float(_attr(node, a, ctx, default) or default)
                       for a in "xyz"], np.float32)


def _parse_transform(node, ctx) -> Transform:
    """(xml.cpp Tag::Transform and its sub-tags) each child
    left-multiplies."""
    trafo = Transform.identity()
    for child in node:
        tag = child.tag.lower()
        if tag == "translate":
            t = Transform.translate(_vec_from_node(child, ctx))
        elif tag == "scale":
            v = _attr(child, "value", ctx)
            if v is not None:
                arr = _parse_vec(v)
                t = Transform.scale(arr if arr.size > 1 else float(arr[0]))
            else:
                t = Transform.scale([
                    float(_attr(child, a, ctx, 1.0) or 1.0) for a in "xyz"])
        elif tag == "rotate":
            t = Transform.rotate(_vec_from_node(child, ctx),
                                 float(_attr(child, "angle", ctx, 0.0)))
        elif tag == "matrix":
            vals = _parse_vec(_attr(child, "value", ctx))
            if vals.size == 16:
                mat = vals.reshape(4, 4)
            elif vals.size == 9:
                mat = np.eye(4, dtype=np.float32)
                mat[:3, :3] = vals.reshape(3, 3)
            else:
                raise XMLParseError("matrix must have 9 or 16 entries")
            t = Transform.from_matrix(mat)
        elif tag == "lookat":
            up_attr = _attr(child, "up", ctx)
            t = Transform.look_at(
                _parse_vec(_attr(child, "origin", ctx)),
                _parse_vec(_attr(child, "target", ctx)),
                _parse_vec(up_attr) if up_attr
                else np.asarray([0, 1, 0], np.float32))
        else:
            raise XMLParseError(f"unknown transform sub-tag <{tag}>")
        trafo = t @ trafo
    return trafo


def _build(node, ctx):
    """The object tree rooted at a scene or plugin tag."""
    tag = node.tag.lower()
    if tag == "scene":
        from ..render.scene import Scene
        props = Properties("scene")
        _fill(node, props, ctx)
        return Scene(props)
    if tag in _PLUGIN_TAGS:
        return _build_plugin(node, ctx)
    raise XMLParseError(f"cannot load a <{tag}> as a top-level object")


def _build_plugin(node, ctx):
    tag = node.tag.lower()
    type_name = _attr(node, "type", ctx)
    if type_name is None:
        raise XMLParseError(f"<{tag}> is missing the type attribute")
    props = Properties(type_name)
    props.id = _attr(node, "id", ctx, "")
    _fill(node, props, ctx)
    obj = create_object(tag, props)
    if props.id:
        ctx.refs[props.id] = obj
    return obj


def _fill(node, props: Properties, ctx: _Context):
    from .dictio import ColorValue
    anon = 0
    for child in node:
        tag = child.tag.lower()
        name = _attr(child, "name", ctx)
        name = _upgrade_name(name, ctx.upgrade) if name else name
        if tag == "default":
            key = _attr(child, "name", ctx)
            if key not in ctx.params:
                ctx.params[key] = _attr(child, "value", ctx)
            continue
        if tag == "include":
            filename = file_resolver().resolve(_attr(child, "filename", ctx))
            _fill(ET.parse(filename).getroot(), props, ctx)
            continue
        if tag == "alias":
            ctx.refs[_attr(child, "as", ctx)] = ctx.refs[
                _attr(child, "id", ctx)]
            continue
        if tag == "ref":
            rid = _attr(child, "id", ctx)
            if rid not in ctx.refs:
                raise XMLParseError(f"unresolved reference '{rid}'")
            props[name or f"_ref_{anon}"] = ctx.refs[rid]
            anon += 1
            continue
        if tag == "boolean":
            props[name] = _attr(child, "value", ctx).lower() == "true"
        elif tag == "integer":
            props[name] = int(float(_attr(child, "value", ctx)))
        elif tag == "float":
            props[name] = float(_attr(child, "value", ctx))
        elif tag == "string":
            props[name] = _attr(child, "value", ctx)
        elif tag in ("point", "vector"):
            props[name] = _vec_from_node(child, ctx)
        elif tag == "rgb":
            val = _parse_vec(_attr(child, "value", ctx))
            if val.size == 1:
                val = np.full(3, val[0], np.float32)
            props[name] = ColorValue("rgb", val)
        elif tag == "spectrum":
            if _attr(child, "type", ctx) is not None:
                # the plugin form: <spectrum type="d65" ...>
                props[name or f"_arg_{anon}"] = _build_plugin(child, ctx)
                anon += 1
                continue
            raw = _attr(child, "value", ctx)
            if ":" in raw:
                pairs = [p.split(":") for p in raw.split(",")]
                props[name] = ColorValue(
                    "spectrum-curve",
                    [(float(a), float(b)) for a, b in pairs])
            else:
                vals = _parse_vec(raw)
                if vals.size != 1:
                    raise XMLParseError(
                        "spectrum arrays require wavelength:value pairs")
                props[name] = ColorValue("spectrum-uniform", float(vals[0]))
        elif tag == "transform":
            props[name] = _parse_transform(child, ctx)
        elif tag in _PLUGIN_TAGS:
            key = name or _attr(child, "id", ctx) or f"_arg_{anon}"
            anon += 1
            props[key] = _build_plugin(child, ctx)
        elif tag == "null":
            props[name] = None
        else:
            raise XMLParseError(f"unknown tag <{child.tag}>")
