"""Object model + plugin registry.

Parity: include/mitsuba/core/object.h (Object) and plugin.h/class.h
(PluginManager, Class::for_name/construct). dlopen'ed shared libraries
become a Python registry mapping (category, name) -> class.
"""

from __future__ import annotations

from .properties import Properties


class Object:
    plugin_name: str = ""

    def __init__(self, props: Properties | None = None):
        self.id = props.id if props is not None else ""

    def expand(self) -> list["Object"]:
        """Split into multiple objects at load time (object.h:62)."""
        return [self]

    def class_name(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return f"{self.class_name()}[id={self.id!r}]"


# ----------------------------------------------------------------------------
# Plugin registry (role of PluginManager + Class registry)
# ----------------------------------------------------------------------------

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
