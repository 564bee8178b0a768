"""Variant system and device selection.

A variant is a runtime configuration: color representation, polarization
and precision (reference: resources/mitsuba.conf.template:95-278). Names
parse as in ``mitsuba2_tpu.variants``; the rgb, spectral and mono color
modes render, in float32 with or without ``_double``, and with or without
``_polarized`` as the unpolarized variant, as the reference's wavefronts
do (the kernels' gates refuse both flags; the ``stokes`` integrator
carries Stokes vectors in any variant).

The torch device every scene table and buffer lives on is ``cuda`` unless
the caller names another with ``set_device`` (the CPU tests ask for
``cpu``); it is never detected, so on a machine without a card a scene
load that did not ask for the CPU fails. Both settings are thread-local,
like the reference's variant (src/python/__init__.py:120-180).
"""

from __future__ import annotations

import dataclasses
import threading

import torch

__all__ = [
    "Variant", "set_variant", "variant", "variants", "variant_config",
    "current", "set_device", "device",
]

_COLOR_MODES = ("mono", "rgb", "spectral")
# Hero-wavelength count in spectral mode (spectrum.h:15).
SPECTRUM_SAMPLES = 4


@dataclasses.dataclass(frozen=True)
class Variant:
    """Configuration replacing the reference's template variants."""

    color_mode: str = "rgb"            # mono | rgb | spectral
    polarized: bool = False
    double_precision: bool = False

    def __post_init__(self):
        if self.color_mode not in _COLOR_MODES:
            raise ValueError(f"unknown color mode {self.color_mode!r}")

    @property
    def dtype(self):
        """The float type renders run in: float32 in every variant. The
        reference's ``_double`` variants render in float32 too, since
        nothing there enables 64-bit floats (mitsuba2_tpu/variants.py:49);
        the kernels' gates refuse them, the wavefronts render them."""
        return torch.float32

    @property
    def n_channels(self) -> int:
        """Channels of a Color/Spectrum value."""
        return {"mono": 1, "rgb": 3,
                "spectral": SPECTRUM_SAMPLES}[self.color_mode]

    @property
    def is_spectral(self) -> bool:
        return self.color_mode == "spectral"

    @property
    def is_monochromatic(self) -> bool:
        return self.color_mode == "mono"

    @property
    def is_rgb(self) -> bool:
        return self.color_mode == "rgb"

    @property
    def name(self) -> str:
        n = "scalar_" + self.color_mode
        if self.polarized:
            n += "_polarized"
        if self.double_precision:
            n += "_double"
        return n


def _parse(name: str) -> Variant:
    """Parse a reference-style variant name. The backend prefix
    (scalar/packet/gpu/gpu_autodiff) is accepted and ignored: the device
    is chosen with ``set_device``."""
    parts = name.split("_")
    while parts and parts[0] in ("scalar", "packet", "gpu", "autodiff", "ad"):
        parts.pop(0)
    if not parts or parts[0] not in _COLOR_MODES:
        raise ValueError(f"cannot parse variant name {name!r}")
    color = parts.pop(0)
    polarized = "polarized" in parts
    double = "double" in parts
    leftover = [p for p in parts if p not in ("polarized", "double")]
    if leftover:
        raise ValueError(
            f"cannot parse variant name {name!r} (tokens {leftover})")
    return Variant(color, polarized, double)


class _State(threading.local):
    def __init__(self):
        self.variant = Variant("rgb")
        self.name = "scalar_rgb"
        self.device = torch.device("cuda")


_state = _State()


def set_variant(name: str) -> None:
    """Select the active variant for this thread."""
    _state.variant = _parse(name)
    _state.name = name


def variant() -> str:
    """Name of the currently active variant."""
    return _state.name


def current() -> Variant:
    """The active :class:`Variant` configuration object."""
    return _state.variant


def variant_config(name: str | None = None) -> Variant:
    """Resolve a name (or the active variant) to a :class:`Variant`."""
    return _state.variant if name is None else _parse(name)


def variants() -> list[str]:
    """All variant names the parser accepts."""
    out = []
    for backend in ("scalar", "packet", "gpu", "gpu_autodiff"):
        for color in _COLOR_MODES:
            for pol in ("", "_polarized"):
                for dbl in ("", "_double"):
                    out.append(f"{backend}_{color}{pol}{dbl}")
    return out


def set_device(dev) -> None:
    """Select the torch device scenes load their tables onto (for this
    thread; ``cuda`` until set). Nothing is detected: a scene loaded on
    ``cuda`` lives on the card or fails to load, and only a scene loaded
    after ``set_device("cpu")`` runs the plain PyTorch versions."""
    _state.device = torch.device(dev)


def device() -> torch.device:
    """The device scenes load onto in this thread."""
    return _state.device


def resolve_device(dev) -> torch.device:
    """``dev`` as the torch device a tensor placed there reports: ``cuda``
    without an index is the current CUDA device."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
