"""Scene parameter traversal (parity: src/python/python/util.py and
mitsuba2_tpu/python/util.py: ``traverse(scene) -> ParameterMap``,
``params.keep/update``, object.h:271 TraversalCallback).

Values are tensors on the scene's device (a plugin's float becomes a 0-d
tensor). ``ParameterMap.update()`` writes the pending values into their
plugins and notifies each written plugin and the objects above it
(``parameters_changed``); every write bumps the parameter epoch, on which
the scene's kernel tables and the integrators' kernel objects key, so the
next kernel render re-packs them. ``ParameterMap.bind(values)`` installs
tensors that require grad for the length of a differentiable render
(python/autodiff.py) and restores the old values after it, also when the
render raises: the role of Enoki's ``set_requires_gradient`` markers.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.object import Object, TraversalCallback


class _Collect(TraversalCallback):
    def __init__(self):
        self.params, self.children = [], []

    def put_parameter(self, name, value):
        self.params.append((name, value))

    def put_object(self, name, obj):
        self.children.append((name, obj))


class SceneTraversal:
    """Walks ``traverse`` from ``root``: ``entries`` maps each key (the
    names on the way down, joined by dots) to (owner, local name, value),
    ``parents`` each object's id to the objects that reached it. An
    object reached twice keeps its first key."""

    def __init__(self, root, name=""):
        self.entries = {}
        self.parents = {}
        self._visited = set()
        self._walk(root, name, None)

    def _walk(self, obj, prefix, parent):
        if parent is not None:
            self.parents.setdefault(id(obj), []).append(parent)
        if id(obj) in self._visited:
            return
        self._visited.add(id(obj))
        cb = _Collect()
        obj.traverse(cb)
        for name, value in cb.params:
            key = f"{prefix}.{name}" if prefix else name
            self.entries[key] = (obj, name, value)
        for name, child in cb.children:
            self._walk(child, f"{prefix}.{name}" if prefix else name, obj)


def _as_tensor(value, device):
    """A parameter value as a float32 tensor on ``device``, never sharing
    memory with the plugin's host array."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device=device, dtype=torch.float32).clone()
    return torch.tensor(np.asarray(value, np.float32), device=device)


class ParameterMap:
    """(util.py:14) a dict-like view of a scene's differentiable
    parameters."""

    def __init__(self, entries, root=None, device=None, parents=None):
        self._root = root
        self._parents = parents or {}
        self._entries = {k: (owner, name, _as_tensor(v, device))
                         for k, (owner, name, v) in entries.items()}
        self._dirty = set()

    # -- dict interface -----------------------------------------------------
    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def __iter__(self):
        return iter(self._entries)

    def keys(self):
        return self._entries.keys()

    def items(self):
        return ((k, v[2]) for k, v in self._entries.items())

    def __getitem__(self, key):
        return self._entries[key][2]

    def __setitem__(self, key, value):
        owner, name, old = self._entries[key]
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value, np.float32),
                                    device=old.device)
        self._entries[key] = (owner, name, value)
        self._dirty.add(key)

    def keep(self, keys):
        """Restrict the map to ``keys`` (a key or a list); a key the map
        lacks raises ``KeyError`` and leaves the map as it was."""
        if isinstance(keys, str):
            keys = [keys]
        missing = set(keys) - set(self._entries)
        if missing:
            raise KeyError(f"parameters not found: {sorted(missing)}")
        self._entries = {k: v for k, v in self._entries.items()
                         if k in keys}
        return self

    def update(self):
        """Writes the pending values into their plugins, then calls
        ``parameters_changed`` on each written plugin and the objects
        above it, each once, lowest first (util.py:115-127)."""
        touched = []
        for key in sorted(self._dirty):
            owner, name, value = self._entries[key]
            owner.set_parameter(name, value)
            if all(owner is not o for o in touched):
                touched.append(owner)
        self._dirty.clear()
        seen = set()
        while touched:
            obj = touched.pop(0)
            if id(obj) in seen:
                continue
            seen.add(id(obj))
            obj.parameters_changed()
            touched.extend(self._parents.get(id(obj), []))

    # -- autodiff -----------------------------------------------------------
    def to_dict(self):
        return {k: v[2] for k, v in self._entries.items()}

    @contextlib.contextmanager
    def bind(self, values: dict):
        """Installs ``values`` (key -> tensor, e.g. ones that require
        grad) into their plugins for the body of the ``with``, and puts
        the old values back after it, also when the body raises."""
        saved = []
        try:
            for key, val in values.items():
                owner, name, _ = self._entries[key]
                saved.append((owner, name, owner.get_parameter(name)))
                owner.set_parameter(name, val)
            yield
        finally:
            for owner, name, old in reversed(saved):
                owner.set_parameter(name, old)

    def __repr__(self):
        lines = [f"ParameterMap[{len(self._entries)}]:"]
        for k, (_, _, v) in sorted(self._entries.items()):
            lines.append(f"  {k} {tuple(v.shape)}")
        return "\n".join(lines)


def traverse(obj: Object) -> ParameterMap:
    """(util.py:140) the differentiable parameters reachable from ``obj``
    (a scene or any plugin), as tensors on its device: the scene's, else
    the one ``set_device`` chose."""
    from ..variants import device
    t = SceneTraversal(obj)
    return ParameterMap(t.entries, obj, getattr(obj, "device", None)
                        or device(), t.parents)
