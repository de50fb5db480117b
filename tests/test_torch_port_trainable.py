"""Port parity, the trainable set: the tiny detector's ``requires_grad`` set
against vps_tpu's ``trainable_mask`` of the same weights.

It is the file's only test on purpose: pytest-xdist's loadfile scheduler
queues files by their number of tests, most first, so a one-test file starts
after the files with several, off the path of the suite's longest file.
"""

import numpy as np
import jax

from vps_tpu.train import optim as joptim
from vps_tpu.utils.convert import convert_detector

from test_full_graph_parity import build_sd
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch import zoo
from vps_torch.convert import _torch_key, state_dict_from_jax
from vps_torch.models.detectors import PanopticFuseTrack


def test_trainable_set_matches_jax_mask():
    """The tiny detector's requires_grad set equals vps_tpu's trainable_mask
    of the same weights, names mapped by state_dict_from_jax's rules."""
    params, stats, _ = convert_detector(build_sd(np.random.RandomState(0)),
                                        depth=18)
    params = dict(params)
    params["flownet2"] = {
        n: {"Conv_0": {"kernel": np.zeros((3, 3, i, o), np.float32),
                       "bias": np.zeros((o,), np.float32)}}
        for n, i, o in (("c1", 6, 16), ("c2", 16, 16), ("pred", 16, 2))}
    cfg = zoo.f32_compute_overrides(zoo.tiny_overrides(
        zoo.fusetrack_model_cfg()))
    cfg.pop("type")
    det = PanopticFuseTrack(train_cfg=zoo.tiny_train_cfg(),
                            test_cfg=zoo.fusetrack_test_cfg(), device="cpu",
                            **cfg)
    det.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    jmask = joptim.trainable_mask(params, frozen_stages=1)
    flat = jax.tree_util.tree_flatten_with_path(jmask)[0]
    jtrain = {_torch_key(tuple(k.key for k in path))[0]
              for path, v in flat if v}
    ours = {n for n, p in det.named_parameters() if p.requires_grad}
    assert ours == jtrain
    assert "backbone.layer1.0.conv1.weight" not in ours
    assert "backbone.layer2.0.conv1.weight" in ours
    assert not any(n.startswith("flownet2.") for n in ours)
