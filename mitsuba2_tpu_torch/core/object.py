"""Object model + plugin registry.

Parity: include/mitsuba/core/object.h (Object, traverse(),
parameters_changed(), expand()) and plugin.h/class.h (PluginManager,
Class::for_name/construct); mitsuba2_tpu/core/object.py:38-90. dlopen'ed
shared libraries become a Python registry mapping (category, name) ->
class.
"""

from __future__ import annotations

from .properties import Properties


class TraversalCallback:
    """(object.h:271) collects an object's differentiable parameters and
    children."""

    def put_parameter(self, name: str, value):
        raise NotImplementedError

    def put_object(self, name: str, obj: "Object"):
        raise NotImplementedError


class Object:
    plugin_name: str = ""

    def __init__(self, props: Properties | None = None):
        self.id = props.id if props is not None else ""

    def expand(self) -> list["Object"]:
        """Split into multiple objects at load time (object.h:62)."""
        return [self]

    def traverse(self, cb: TraversalCallback) -> None:
        """Expose differentiable parameters and children (object.h:75)."""

    def parameters_changed(self, keys: list[str] | None = None) -> None:
        """Notification after parameters were written (object.h:96)."""

    # -- parameter write-back (backs ParameterMap.update and .bind) ---------
    # traverse() names that differ from the attribute path they write
    PARAM_ATTRS: dict = {}

    def get_parameter(self, name: str):
        obj, leaf = self._resolve_attr(self.PARAM_ATTRS.get(name, name))
        return getattr(obj, leaf)

    def set_parameter(self, name: str, value) -> None:
        """Writes the attribute behind ``name``, drops the device copies
        the owning object cached from its old value
        (models/textures.py ``on_device``) and bumps the parameter
        epoch."""
        bump_param_epoch()
        obj, leaf = self._resolve_attr(self.PARAM_ATTRS.get(name, name))
        setattr(obj, leaf, _host_like(getattr(obj, leaf, None), value))
        obj.__dict__.pop("_device_cache", None)
        self.__dict__.pop("_device_cache", None)

    def _resolve_attr(self, path: str):
        obj = self
        parts = path.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        return obj, parts[-1]

    def class_name(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return f"{self.class_name()}[id={self.id!r}]"


# ----------------------------------------------------------------------------
# Plugin registry (role of PluginManager + Class registry)
# ----------------------------------------------------------------------------

def _host_like(old, value):
    """A concrete tensor written over a host attribute (a float, a numpy
    array) takes the attribute's host type, so that what reads the
    attribute on the host (the kernels' table packing) keeps working; a
    tensor that requires grad is installed as it is."""
    import numpy as np
    import torch
    if isinstance(value, torch.Tensor) and not value.requires_grad:
        if isinstance(old, float):
            return float(value)
        if isinstance(old, np.ndarray):
            return value.detach().cpu().numpy().astype(old.dtype)
    return value


# bumped on every parameter write: what packs plugin values into device
# tables (the scene's kernel tables, each integrator's kernel object) keys
# on it, so ParameterMap.update() reaches the next kernel render
_PARAM_EPOCH = 0


def param_epoch() -> int:
    return _PARAM_EPOCH


def bump_param_epoch() -> None:
    global _PARAM_EPOCH
    _PARAM_EPOCH += 1


_REGISTRY: dict[tuple[str, str], type] = {}


def register_plugin(category: str, name: str):
    """Class decorator: register a plugin under (category, name)."""

    def wrap(cls):
        cls.plugin_name = name
        cls.plugin_category = category
        _REGISTRY[(category, name)] = cls
        return cls

    return wrap


def plugin_class(category: str, name: str) -> type:
    _ensure_loaded()
    try:
        return _REGISTRY[(category, name)]
    except KeyError:
        raise ValueError(
            f"Plugin '{name}' not found in category '{category}'. "
            f"Available: {sorted(n for c, n in _REGISTRY if c == category)}")


def create_object(category: str, props: Properties):
    """Instantiate a plugin (plugin.h create_object). Checks unqueried
    properties afterwards like the XML loader (xml.cpp:1040-1060)."""
    cls = plugin_class(category, props.plugin_name)
    obj = cls(props)
    obj.id = props.id or obj.id
    leftover = props.unqueried()
    if leftover:
        raise RuntimeError(
            f"Unreferenced property {leftover} in plugin "
            f"'{props.plugin_name}' ({category})")
    return obj


def registered_plugins(category: str | None = None):
    _ensure_loaded()
    return sorted(n for (c, n) in _REGISTRY
                  if category is None or c == category)


_loaded = False


def _ensure_loaded():
    """Import the plugin library once (role of dlopen in plugin.cpp)."""
    global _loaded
    if _loaded:
        return
    _loaded = True
    from ..models import ALL_PLUGIN_MODULES  # noqa: F401
