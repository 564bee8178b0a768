"""The film splat's plain PyTorch version against the JAX path kernel's
``render_pass`` with a lanczos film (three lobes, a 7x7 stencil, signed
weights), in a file of its own so that each file renders the JAX kernel
once; the setting and the tolerance are tests/test_torch_splat.py's."""

from tests.test_torch_path_kernel import cpu_device_fixture
from tests.test_torch_splat import jax_splat_parity

_on_cpu = cpu_device_fixture()


def test_plain_splat_matches_jax_render_pass_lanczos():
    jax_splat_parity("lanczos")
