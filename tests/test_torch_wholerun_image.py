"""Whole image-only runs of the port against the jitted JAX reference on
the same draws: GraphicEnd2 (GFTT/SIFT) over the 12-frame orbit of
tests/test_e2e.py at 320x240 (256 keypoints, 128 hypotheses), per frame
and streamed in chunks of 4. The run helpers, the draw replay and the
tolerances are those of tests/test_torch_wholerun.py: the log rows and
lost frames exact, each frame's T, norm and robot position within 2e-4,
keyframes and graph edges equal, final poses within 1e-3 m, ATE and RPE
within 1e-4 m.
"""

import pytest

from test_torch_wholerun import RUN, both, hold, summary, write_orbit

FRAMES = 12


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    from slam3d_gx_torch.testing import synthetic

    traj = synthetic.orbit_trajectory(FRAMES, radius=0.2, yaw_amp=0.1)
    return write_orbit(str(tmp_path_factory.mktemp("orbit")), traj), traj


@pytest.mark.parametrize("chunk", [None, 4], ids=["per_frame", "streamed"])
def test_image_only_run_matches_jax(orbit, tmp_path, capsys, chunk):
    root, traj = orbit
    port, ref, walls = both(root, dict(RUN, detector_name="GFTT"), FRAMES - 1, True, traj,
                            tmp_path, chunk)
    with capsys.disabled():
        print("\n" + summary(f"image-only, {'per frame' if chunk is None else f'chunks of {chunk}'}",
                             port, ref, walls))
    hold(port, ref)
