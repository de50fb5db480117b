"""Port parity, GuidedAnchorHead's forward: vps_torch's against vps_tpu's
on tests/ga_parity.py's tiny widths and seeded weights, unmasked and with
the loc filter on (about half the positions filtered): outputs within atol
1e-5, rtol 1e-4, the filtered positions 0 on both sides
(``ga_parity.assert_forward_match``).

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from ga_parity import assert_forward_match


def test_ga_head_matches_jax():
    assert_forward_match("GuidedAnchorHead")
