"""Core layer: plugin registry, properties, transforms, RNG.

Mirrors the role of the reference's libcore."""

from . import math, rng, transform

from .transform import Transform
