"""XML scene loading entry points (parity: ``mitsuba2_tpu.core.xmlio``,
the reference's xml.h:33-39): thin wrappers of core/xml_impl.py with the
JAX package's signatures; ``variant`` and ``update`` are accepted and
unused, as there."""

from __future__ import annotations


def load_file(path, variant=None, params=None, update=False):
    from .xml_impl import load_file as _impl
    return _impl(path, params=params)


def load_string(s, variant=None, params=None):
    from .xml_impl import load_string as _impl
    return _impl(s, params=params)
