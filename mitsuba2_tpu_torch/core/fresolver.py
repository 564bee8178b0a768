"""File resolver: ordered search-path list for scene-relative assets
(reference: include/mitsuba/core/fresolver.h, thread-local there;
process-global here, as in ``mitsuba2_tpu.core.fresolver``: scene loading
is host-side and single-threaded)."""

from __future__ import annotations

import os


class FileResolver:
    def __init__(self):
        self.paths: list[str] = [os.getcwd()]

    def append(self, path: str):
        if path and path not in self.paths:
            self.paths.append(path)

    def prepend(self, path: str):
        if path:
            self.paths.insert(0, path)

    def resolve(self, filename: str) -> str:
        """The first existing path of ``filename`` (as given if absolute,
        else joined to each search path in order); ``filename`` unchanged
        when none exists."""
        if os.path.isabs(filename) and os.path.exists(filename):
            return filename
        for p in self.paths:
            candidate = os.path.join(p, filename)
            if os.path.exists(candidate):
                return candidate
        return filename

    def __repr__(self):
        return f"FileResolver{self.paths!r}"


_resolver = FileResolver()


def file_resolver() -> FileResolver:
    return _resolver
