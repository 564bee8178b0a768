"""The port's general wavefront on the Cornell box against the
independent numpy path tracer (tests/reference_pt.py, which reads the JAX
scene's tables), at the bar and shape of tests/test_render.py:73-97: a
statistical check that does not lean on equal random numbers. A file of
its own, so that the test workers run it beside the parity files."""

import numpy as np

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.python.test.scenes import cornell_box_dict as cornell_t
from tests.test_torch_path_kernel import cpu_device_fixture

_on_cpu = cpu_device_fixture()


def test_cornell_wavefront_within_reference_tracer_bar():
    """About 35 s on one core, a third of it the numpy tracer."""
    import mitsuba2_tpu as mj
    from mitsuba2_tpu.python.test.scenes import cornell_box_dict as cornell_j
    from tests.reference_pt import render_reference
    w, spp = 32, 400
    mj.set_variant("scalar_rgb")
    mt.set_variant("scalar_rgb")
    dj = cornell_j(width=w, height=w, spp=spp, max_depth=4)
    st = mt.load_dict(cornell_t(width=w, height=w, spp=spp, max_depth=4))
    st.integrator._disable_kernel = True
    img = st.integrator.render(st, seed=0, spp=spp).numpy()
    assert st.integrator.last_engine == "wavefront"
    ref = render_reference(mj.load_dict(dj), w, w, spp=spp, max_depth=4,
                           fov_deg=39.3077, cam_to_world=dj["sensor"][
                               "to_world"], seed=7)
    rel = np.abs(img - ref).mean() / max(ref.mean(), 1e-6)
    assert rel < 0.045, f"relative error {rel:.4f}"
    ratio = img.mean() / ref.mean()
    assert abs(ratio - 1.0) < 0.02, f"bias: mean ratio {ratio:.4f}"
