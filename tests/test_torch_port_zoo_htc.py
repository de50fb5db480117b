"""Port parity, Hybrid Task Cascade: vps_torch's HybridTaskCascade held
against vps_tpu's ``predict`` with the fused semantic head (its features
pooled into the box and mask windows) and mask information flow, and
without the semantic head or the flow; built by the ``HTC`` alias too. On
tests/test_cascade.py's 2-stage HTC config and tests/test_two_stage.py's
image, seeded weights (``tests/zoo_parity.py``: its bar).

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from zoo_parity import assert_dets_match, htc_cfg, pair

from vps_torch.models.detectors import HybridTaskCascade
from vps_torch.registry import DETECTORS


def test_htc_with_and_without_semantic_head_and_alias():
    want, got, port = pair("HybridTaskCascade", htc_cfg())
    assert type(port) is HybridTaskCascade and port.semantic_head is not None
    # the flow feeds stage 1's head the features of stage 0's: only it has
    # conv_res
    assert port.mask_head[0].conv_res is None
    assert port.mask_head[1].conv_res is not None
    assert_dets_match(want, got)

    want, got, port = pair("HybridTaskCascade",
                           htc_cfg(semantic=False, mask_info_flow=False),
                           seed=1, port_kind="HTC")
    assert DETECTORS["HTC"] is HybridTaskCascade
    assert type(port) is HybridTaskCascade and port.semantic_head is None
    assert all(h.conv_res is None for h in port.mask_head)
    assert not any(k.startswith("semantic_head.") for k in port.state_dict())
    assert_dets_match(want, got)
