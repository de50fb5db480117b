"""Port parity, GARPNHead's forward: vps_torch's against vps_tpu's on
tests/ga_parity.py's tiny widths and seeded weights (the 3x3 stem, then
the guided-anchoring tail), unmasked and with the loc filter on, under
``ga_parity.assert_forward_match``'s bar.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from ga_parity import assert_forward_match


def test_ga_rpn_head_matches_jax():
    assert_forward_match("GARPNHead")
