"""The plugin library. Importing this package registers every plugin."""

from . import (textures, rfilters, bsdfs, emitters, sensors, films,
               samplers, shapes, integrators)

ALL_PLUGIN_MODULES = [textures, rfilters, bsdfs, emitters, sensors, films,
                      samplers, shapes, integrators]
