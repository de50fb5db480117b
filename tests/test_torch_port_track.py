"""Port parity, PanopticTrack (tracking, no flow and no fuse neck):
vps_torch's video inference held against vps_tpu's ``predict`` on a 2-frame
clip (64x128, ResNet-18 trunk, `exact` preset, f32) with the same weights,
to ``assert_frame_matches``'s bar: identical detections, keep sets and
track ids, >= 0.999 semantic and panoptic agreement. The clip is
``clip_pair`` of test_torch_port_fuse.py.

It is the file's only test: pytest-xdist's loadfile scheduler queues files
by their number of tests, most first, so a one-test file starts after the
files with several.
"""

from test_torch_port_fuse import clip_pair
from test_torch_port_fusetrack import assert_frame_matches
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)


def test_track_clip_matches_jax():
    """Both frames to assert_frame_matches's bar; the second frame's track
    ids carry some of the first frame's objects."""
    ours, port, state = clip_pair("PanopticTrack", ("extra_neck",))
    for jframe, pframe in zip(ours, port):
        assert_frame_matches(jframe, pframe)
    ids = [set(p["panoptic_det_obj_ids"][:int(p["num_keep"])].tolist())
           for p in port]
    assert ids[0] & ids[1], ids
    assert int(state.count) >= len(ids[0])
