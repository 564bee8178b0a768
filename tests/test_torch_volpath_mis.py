"""The volpath slice's MIS arm and isotropic phase: ``volpathmis`` on the
bench slab with g = 0 (the isotropic branch of the HG plugin). The plain
version on the JAX kernel's tables (``mis=True``), and the port's
``load_dict`` + ``render``, against the JAX kernel in interpret mode
(``_dot3T`` exact), at the bar and size of test_torch_volpath.py, whose
docstring states both. Measured: every pixel within 6.6e-7 relative,
image means 1.0e-7 apart.
"""

import pytest

from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_volpath import check_against_reference, jax_reference

_on_cpu = cpu_device_fixture()


@pytest.fixture(scope="module")
def reference():
    return jax_reference(g=0.0, mis=True)


def test_volpathmis_isotropic_matches_jax_kernel(reference):
    check_against_reference(reference, 0, mis=True, g=0.0)


def test_mis_changes_the_estimate_not_the_image(reference):
    """volpath and volpathmis are two estimators of one image: their means
    agree to Monte Carlo noise while their pixels differ."""
    from tests.test_torch_volpath import (MAX_DEPTH, RR_DEPTH, SEED, SPP, W,
                                          box_develop)
    from mitsuba2_tpu_torch.ops import volpath_kernel as vk
    ref, tables, cam = reference
    nee = box_develop(vk.volpath_radiance_reference(
        tables, cam, SEED, 0, SPP, W, W, MAX_DEPTH, RR_DEPTH), W, W,
        SPP).numpy()
    assert abs(nee.mean() - ref.mean()) < 0.05 * ref.mean()
    assert abs(nee - ref).max() > 1e-3
