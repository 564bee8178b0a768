"""Properties: typed key->value bag passed to every plugin constructor.

Parity: include/mitsuba/core/properties.h:38 — typed getters, unqueried-
property tracking (the loader errors on unused properties,
xml.cpp:1040-1060) and texture auto-wrapping (properties.h:281-343).
"""

from __future__ import annotations

from typing import Any

import numpy as np


class NamedReference(str):
    """A reference to another scene object by its id (properties.h:41)."""


class Properties:
    def __init__(self, plugin_name: str = "", values: dict | None = None):
        self.plugin_name = plugin_name
        self.id = ""
        self._values: dict[str, Any] = dict(values or {})
        self._queried: set[str] = set()

    # -- dict-like ------------------------------------------------------------
    def __contains__(self, k):
        return k in self._values

    def has_property(self, k):
        return k in self._values

    def __setitem__(self, k, v):
        self._values[k] = v

    def __getitem__(self, k):
        self._queried.add(k)
        return self._values[k]

    def get(self, k, default=None):
        self._queried.add(k)
        return self._values.get(k, default)

    def keys(self):
        return self._values.keys()

    def items(self):
        return self._values.items()

    def mark_queried(self, k):
        self._queried.add(k)

    def unqueried(self) -> list[str]:
        return [k for k in self._values if k not in self._queried]

    # -- typed getters (properties.h bool_/int_/float_/string/...) ------------
    def bool_(self, k, default=None):
        v = self.get(k, default)
        if v is None:
            raise KeyError(f"property '{k}' missing")
        if isinstance(v, str):
            return v.lower() == "true"
        return bool(v)

    def int_(self, k, default=None):
        v = self.get(k, default)
        if v is None:
            raise KeyError(f"property '{k}' missing")
        return int(v)

    def float_(self, k, default=None):
        v = self.get(k, default)
        if v is None:
            raise KeyError(f"property '{k}' missing")
        return float(v)

    def long_(self, k, default=None):
        """64-bit integer (properties.h int64; the Blender bridge passes raw
        pointers so, blender.cpp:105-107)."""
        v = self.get(k, default)
        if v is None:
            raise KeyError(f"property '{k}' missing")
        return int(v)

    def property_names(self):
        """Every property's name, queried or not, in insertion order."""
        return list(self._values.keys())

    def string(self, k, default=None):
        v = self.get(k, default)
        if v is None:
            raise KeyError(f"property '{k}' missing")
        return str(v)

    def vector3(self, k, default=None):
        v = self.get(k, default)
        if v is None:
            raise KeyError(f"property '{k}' missing")
        return np.asarray(v, np.float32).reshape(3)

    def transform(self, k, default=None):
        from .transform import Transform
        v = self.get(k, default)
        if v is None:
            raise KeyError(f"property '{k}' missing")
        if isinstance(v, Transform):
            return v
        return Transform.from_matrix(np.asarray(v, np.float32))

    # -- plugin helpers (properties.h texture<>()) ----------------------------
    def texture(self, k, default_value=None):
        """Fetch a texture property; scalars/colors auto-wrap into constant
        textures like the reference (properties.h:281-343)."""
        from ..models import textures as _tex
        v = self.get(k, None)
        if v is None:
            if default_value is None:
                raise KeyError(f"texture property '{k}' missing")
            v = default_value
        return _tex.as_texture(v)

    def texture_d65(self, k, default_value=None):
        """Emitter radiance: as ``texture``, but rgb values become
        D65-weighted spectra in spectral variants (xml.cpp
        create_texture_from_rgb with within_emitter=true)."""
        from ..models import textures as _tex
        v = self.get(k, None)
        if v is None:
            if default_value is None:
                raise KeyError(f"texture property '{k}' missing")
            v = default_value
        return _tex.as_texture(v, within_emitter=True)

    def volume(self, k, default_value=None):
        """Fetch a volume property; numbers and colors wrap into constant
        volumes (``models/media.py as_volume``)."""
        from ..models import media as _media
        v = self.get(k, None)
        if v is None:
            if default_value is None:
                raise KeyError(f"volume property '{k}' missing")
            v = default_value
        return _media.as_volume(v)

    def objects(self, mark=True):
        """All nested plugin-object properties as (key, object) pairs."""
        from .object import Object
        out = []
        for k, v in self._values.items():
            if isinstance(v, Object):
                if mark:
                    self._queried.add(k)
                out.append((k, v))
        return out

    def copy(self) -> "Properties":
        p = Properties(self.plugin_name, dict(self._values))
        p.id = self.id
        return p

    def __repr__(self):
        return f"Properties[{self.plugin_name!r}, {self._values!r}]"
