"""Render layer: scene, shapes, BSDFs, emitters, sensors, films,
samplers and the integrator drive (the reference's librender)."""
