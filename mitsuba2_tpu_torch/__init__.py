"""mitsuba2_tpu_torch — the PyTorch/CUDA port of mitsuba2_tpu.

Same surface as the JAX package: ``set_variant``, ``load_dict``,
``load_file`` and ``load_string`` (Mitsuba XML),
``scene.integrator.render(scene, seed=, spp=)``, ``traverse`` and
``python.autodiff`` (inverse rendering on torch.autograd), plus
``set_device``, which names the torch device every scene table and
buffer lives on: ``cuda`` unless the caller asks for another
(``set_device("cpu")``, as the tests do). Kernels are hand-written CUDA (``csrc/``), built with nvcc at first
use; each has a plain PyTorch version beside it, which is what runs for
tables on the CPU.
This package never imports ``jax`` or ``mitsuba2_tpu``.
"""

from .variants import (set_variant, variant, variants, variant_config,
                       Variant, set_device, device)
from .core.transform import Transform

__version__ = "0.1.0"

__all__ = ["set_variant", "variant", "variants", "variant_config", "Variant",
           "set_device", "device", "load_file", "load_string", "load_dict",
           "traverse", "Transform"]


def load_dict(d):
    """Instantiate a scene/plugin from a Python dict (parity:
    mitsuba.core.xml.load_dict, src/libcore/python/xml_v.cpp:56)."""
    from .core.dictio import load_dict as _ld
    return _ld(d)


def load_file(path, **kwargs):
    """Load a Mitsuba XML scene file (parity: xml.load_file, xml.h:33)."""
    from .core.xmlio import load_file as _lf
    return _lf(path, **kwargs)


def load_string(s, **kwargs):
    """Load a scene from an XML string (parity: xml.load_string,
    xml.h:39)."""
    from .core.xmlio import load_string as _ls
    return _ls(s, **kwargs)


def traverse(obj):
    """The differentiable parameters of a scene or plugin, as a
    ``python.util.ParameterMap`` (parity: mitsuba.python.util.traverse)."""
    from .python.util import traverse as _traverse
    return _traverse(obj)
