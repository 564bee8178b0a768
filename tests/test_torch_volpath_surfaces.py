"""The volpath slice's surface arms: the slab behind a glass pane above a
GGX aluminium floor (tests/test_volmegakernel.py:246-255), HG g = 0.3,
under ``volpath``. The plain version on the JAX kernel's tables, and the
port's ``load_dict`` + ``render``, against the JAX kernel in interpret mode
(``_dot3T`` exact), at the bar and size of test_torch_volpath.py, whose
docstring states both. Measured: every pixel within 1.3e-6 relative.
"""

import pytest

from mitsuba2_tpu_torch.ops import volpath_kernel as vk
from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_volpath import (check_against_reference,
                                      jax_reference, surfaces)

_on_cpu = cpu_device_fixture()


@pytest.fixture(scope="module")
def reference():
    return jax_reference(extra=surfaces)


def test_ggx_and_dielectric_match_jax_kernel(reference):
    check_against_reference(reference,
                            vk.HAS_HG | vk.HAS_GGX | vk.HAS_DIEL,
                            extra=surfaces)


def test_reference_tables_hold_both_surface_kinds(reference):
    _, tables, _ = reference
    kinds = set(tables.fattr[:, vk.C_KIND].tolist())
    assert kinds == {vk.KIND_DIFFUSE, vk.KIND_GGX, vk.KIND_DIEL}
    # the glass pane's relative IOR: bk7 in air
    diel = tables.fattr[:, vk.C_KIND] == vk.KIND_DIEL
    assert abs(float(tables.fattr[diel, vk.C_ETAD][0])
               - 1.5046 / 1.000277) < 1e-6
