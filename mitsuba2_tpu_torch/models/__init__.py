"""The plugin library. Importing this package registers every plugin."""

from . import (textures, spectra, rfilters, bsdfs, emitters, sensors, films,
               samplers, shapes, integrators, media, media_impl, phase,
               measured, rb)

ALL_PLUGIN_MODULES = [textures, spectra, rfilters, bsdfs, emitters, sensors,
                      films, samplers, shapes, integrators, media, media_impl,
                      phase, measured, rb]
