"""Port parity, the single-stage detectors: vps_torch's RepPointsDetector
held against vps_tpu's ``predict`` on tests/single_parity.py's tiny config
and image, seeded weights (``zoo_parity.fill``), the bar of
``zoo_parity.assert_dets_match``: identical detection sets, labels and
``det_valid``, boxes and scores within 1e-4; and the
``SingleStageDetector`` type, which builds the same class from the head's
type and predicts the same.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from single_parity import assert_dispatch_matches, pair
from zoo_parity import assert_dets_match

from vps_torch.models.detectors import RepPointsDetector


def test_single_reppoints_predict_matches_jax():
    want, got, port = pair("RepPointsDetector")
    assert type(port) is RepPointsDetector
    assert_dets_match(want, got)
    assert_dispatch_matches("RepPointsDetector", port, got)
