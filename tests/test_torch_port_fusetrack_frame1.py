"""Port parity, the whole slice, frame 1 of the FuseTrack clip (after frame 0,
the pyramid and the track state carried): vps_torch's video inference
against vps_tpu's ``predict`` (64x128, ResNet-18 trunk, TinyFlow, `exact`
preset, f32, the same weights; the clip and the bar in
``test_torch_port_fusetrack.py``).

The file's only test, one case of the parametrisation it had in
test_torch_port_fusetrack.py (pytest-xdist's loadfile scheduler queues a
one-test file after the files with several).
"""

import pytest

from test_torch_port_fusetrack import assert_frame_matches, run_clip
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("frame", [1])
def test_fusetrack_clip_matches_jax(frame):
    ours, port = run_clip(frame + 1)
    assert_frame_matches(ours[frame], {k: v[frame] for k, v in port.items()})
