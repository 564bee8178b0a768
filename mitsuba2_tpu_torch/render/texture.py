"""Texture base (reference: include/mitsuba/render/texture.h:23-189)."""

from __future__ import annotations

from ..core.object import Object


class Texture(Object):
    def mean(self) -> float:
        raise NotImplementedError

    def is_spatially_varying(self) -> bool:
        return False
