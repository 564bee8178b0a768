"""Dict scene loader.

Parity: mitsuba.core.xml.load_dict (src/libcore/python/xml_v.cpp:56,100-226):
a nested dict with "type" keys instantiates plugins; "rgb" sub-dicts become
colors, "spectrum" sub-dicts with a number uniform spectra and with
(wavelength, value) pairs curves (mitsuba2_tpu/core/dictio.py:68-78); "id" +
{"type": "ref", "id": ...} are named references.
"""

from __future__ import annotations

import numpy as np

from .object import create_object
from .properties import Properties

_CATEGORIES = ["bsdf", "emitter", "sensor", "shape", "integrator", "sampler",
               "film", "rfilter", "texture", "spectrum", "medium", "phase",
               "volume"]


def _category_of(type_name: str) -> str:
    from .object import _REGISTRY, _ensure_loaded
    _ensure_loaded()
    for c in _CATEGORIES:
        if (c, type_name) in _REGISTRY:
            return c
    raise ValueError(f"unknown plugin type '{type_name}'")


class ColorValue:
    """Marks an rgb dict so Properties.texture* can special-case emitter vs
    reflectance wrapping (xml.cpp:774-850)."""

    def __init__(self, kind, payload):
        self.kind = kind        # 'rgb' | 'spectrum-uniform' | 'spectrum-curve'
        self.payload = payload


def load_dict(d: dict):
    """Instantiate a plugin/scene from a dict."""
    return _instantiate(d, {})


def _instantiate(d: dict, refs: dict):
    if "type" not in d:
        raise ValueError("dict is missing the 'type' key")
    type_name = d["type"]

    if type_name == "scene":
        from ..render.scene import Scene
        props = Properties("scene")
        _fill_props(props, d, refs, skip=("type",))
        return Scene(props)

    if type_name == "rgb":
        return ColorValue("rgb", np.asarray(d["value"], np.float32))
    if type_name == "spectrum":
        value = d["value"]
        if isinstance(value, (int, float)):
            return ColorValue("spectrum-uniform", float(value))
        # (wavelength, value) pairs, or the string "400:0.1, 500:0.2"
        if isinstance(value, str):
            value = [p.split(":") for p in value.split(",")]
        return ColorValue("spectrum-curve",
                          [(float(a), float(b)) for a, b in value])
    if type_name == "ref":
        rid = d["id"]
        if rid not in refs:
            raise ValueError(f"unresolved reference '{rid}'")
        return refs[rid]

    category = _category_of(type_name)
    props = Properties(type_name)
    props.id = d.get("id", "")
    _fill_props(props, d, refs, skip=("type", "id"))
    obj = create_object(category, props)
    if props.id:
        refs[props.id] = obj
    return obj


def _fill_props(props: Properties, d: dict, refs: dict, skip=()):
    for k, v in d.items():
        if k in skip:
            continue
        if isinstance(v, dict):
            child = _instantiate(v, refs)
            props[k] = child
            if getattr(child, "id", ""):
                refs[child.id] = child
        else:
            props[k] = v
