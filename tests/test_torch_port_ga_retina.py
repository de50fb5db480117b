"""Port parity, GARetinaHead's forward: vps_torch's against vps_tpu's on
tests/ga_parity.py's tiny widths (two convs a tower, two feature
adaptions a level) and seeded weights, unmasked and with the loc filter
on, under ``ga_parity.assert_forward_match``'s bar.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from ga_parity import assert_forward_match


def test_ga_retina_head_matches_jax():
    assert_forward_match("GARetinaHead")
