"""bf16-compute training, the path of ``vps_torch.tools.train
--bf16-compute`` and ``vps_torch.tools.profile_train`` (its default): the
tiny FuseTrack with the config's bf16 ``compute_dtype`` knobs gives
vps_tpu's ``PanopticFuseTrack.loss`` terms and the gradients of its
selection-free terms on the same weights, sample and sampler draws as
``test_torch_port_train.py``'s f32 ``parity`` fixture (one jitted
value_and_grad on the JAX side), within bf16 tolerances. The file's only
test (pytest-xdist's loadfile queues one-test files after the files with
several).

The weights are the f32 fixture's with TCEA's two embedding convs (tAtt_1,
tAtt_2) scaled by 1/32. With the fixture's own, the frame-center logits
``cor`` (a 256-channel dot product) have a median |cor| of 2034 and bf16
moves them by a median 26, up to 185, on both stacks: the sigmoid over them
is a step, and the one pixel that bf16 happens to bring within 1 of 0 gets
a slope of ~0.25 (f32's largest is 3.8e-4) and sets the gradients of
everything upstream of TCEA. That pixel is another one on each stack (JAX:
frame 0 at 0.23; the port: frame 1, the warped reference, at 0.61, so there
the gradient reaches the flow estimator through the warp): JAX's own bf16
gradients then depart from its f32 ones by up to 302x a tensor's norm, and
the two stacks' by up to 2.7x. Scaled, |cor| has a median of ~2 and the
sigmoid is smooth at bf16's rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vps_tpu.core.targets as jtargets
import vps_tpu.models.flow.liteflow as jliteflow
from vps_tpu import zoo as jzoo
from vps_tpu.core.sampler import _sample_by_priority as j_sample_by_priority
from vps_tpu.models.detectors import PanopticFuseTrack as JPanopticFuseTrack

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from test_torch_port_train import SELECTION_FREE, _prios, _sample, _weights

import vps_torch.core.sampler as tsampler
import vps_torch.models.flow.liteflow as tliteflow
from vps_torch import zoo
from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import PanopticFuseTrack

# bf16 keeps 8 bits of mantissa: one rounding is 2^-9 relative, and each
# tower rounds its activations layer after layer, in another order on each
# side (XLA's fused convolutions against PyTorch's); the sums of a loss over
# thousands of such values move by a few of those units
BF16_REL = 2e-2
# Gradients, per tensor, as |port - jax| / |jax| over the whole tensor: the
# activations move by ~1% (0.6-1.4% a layer, port bf16 against port f32),
# and that moves samples across the kinks of the selection-free terms
# (smooth-L1's beta, ReLU branches, max pools). On this sample JAX's own
# bf16 gradients depart from its f32 ones by a median 0.10 and up to 0.19;
# the port's from JAX's bf16 by a median 0.087 and up to 0.140 (rpn_reg's
# bias, whose gradient is smooth-L1's sign where one anchor crosses beta).
# A tensor that gets no gradient, or one of the wrong sign or scale, is 1.0
# or more.
BF16_GRAD_REL = 0.25
BF16_GRAD_REL_ALL = 0.12  # all tensors as one vector (measured 0.071)
# The cotangents the correlation's backward gives its two inputs in
# LiteFlowNetCorr, the same measure: the one that reaches its output
# already departs by 0.175 between the stacks (rounding upstream), and the
# inputs' by 0.189 and 0.198. The parameters' gradients cannot see this
# path: it carries ~1/1000 of the backbone's (measured: a correlation
# detached in bf16 passes the checks above).
BF16_CORR_GRAD_REL = 0.3


def _bf16_cfg(zoo_mod):
    cfg = zoo_mod.tiny_overrides(zoo_mod.fusetrack_model_cfg())
    cfg.pop("type")
    return cfg


def _bf16_weights():
    params, stats = _weights()
    neck = dict(params["extra_neck"])
    tcea = dict(neck["tcea_fusion"])
    for name in ("tAtt_1", "tAtt_2"):
        conv = tcea[name]["Conv_0"]
        tcea[name] = {"Conv_0": {k: v / 32 for k, v in conv.items()}}
    return dict(params, extra_neck=dict(neck, tcea_fusion=tcea)), stats


def test_bf16_loss_terms_and_gradients_match_jax():
    """The selection-free terms (``loss_segm``, ``loss_rpn_cls``,
    ``loss_rpn_bbox``) and loss_pano (gt boxes only) within BF16_REL, and
    every term finite; the gradients of the selection-free terms for every
    trainable parameter (backbone stages 2-4, FPN, the fuse neck through the
    warp and the correlation's backward, semantic head, RPN) within
    BF16_GRAD_REL each and BF16_GRAD_REL_ALL together, and at the
    correlation's inputs within BF16_CORR_GRAD_REL (zeros added to them on
    both stacks, whose gradients are those cotangents). The terms after the
    proposals' NMS and the samplers are not compared: bf16 scores that part
    between the stacks sample other RoIs (acc 0.111 against JAX's 0.197 on
    the fixture's weights), where the f32 fixture samples the same."""
    params, stats = _bf16_weights()
    assert _bf16_cfg(zoo)["backbone"]["compute_dtype"] == "bfloat16"
    s = _sample(np.random.RandomState(1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsampler, "uniform",
                   lambda gen, shape, device: torch.from_numpy(_prios(shape[1])))

        def j_random_sample(key, gi, num, pos_fraction):
            r = _prios(gi.shape[0])
            return j_sample_by_priority(jnp.asarray(r[0]), jnp.asarray(r[1]),
                                        gi > 0, gi == 0, num,
                                        int(num * pos_fraction))

        mp.setattr(jtargets, "random_sample", j_random_sample)
        taps = {"jax": [], "port": []}
        j_corr, t_corr = jliteflow.correlation, tliteflow.correlation

        def j_tapped(x1, x2, md, s2):
            zeros = taps["jax"].pop(0)
            if zeros is None:  # the shape pass
                taps["shapes"] = [jax.ShapeDtypeStruct(x.shape, x.dtype)
                                  for x in (x1, x2)]
                return j_corr(x1, x2, md, s2)
            return j_corr(x1 + zeros[0], x2 + zeros[1], md, s2)

        def t_tapped(x1, x2, md, s2):
            zeros = [torch.zeros_like(x, requires_grad=True) for x in (x1, x2)]
            taps["port"].append(zeros)
            return t_corr(x1 + zeros[0], x2 + zeros[1], md, s2)

        mp.setattr(jliteflow, "correlation", j_tapped)
        mp.setattr(tliteflow, "correlation", t_tapped)
        det = JPanopticFuseTrack(train_cfg=jzoo.tiny_train_cfg(),
                                 test_cfg=jzoo.tiny_test_cfg(),
                                 **_bf16_cfg(jzoo))

        def f(p, zeros, smp):
            taps["jax"] = [zeros]
            losses = det.apply({"params": p, "batch_stats": stats},
                               method=det.loss,
                               rngs={"sampler": jax.random.PRNGKey(0)}, **smp)
            return sum(losses[k] for k in SELECTION_FREE), losses

        smp = {k: jnp.asarray(v) for k, v in s.items()}
        jax.eval_shape(f, params, None, smp)
        zeros = [jnp.zeros(t.shape, t.dtype) for t in taps["shapes"]]
        (_, jl), (jg, jz) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(params, zeros, smp)
        port = PanopticFuseTrack(train_cfg=zoo.tiny_train_cfg(),
                                 test_cfg=zoo.fusetrack_test_cfg(),
                                 device="cpu", **_bf16_cfg(zoo))
        port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
        tl = port.loss(**{k: torch.from_numpy(v) for k, v in s.items()})
        sum(tl[k] for k in SELECTION_FREE).backward()
    jl = {k: float(v) for k, v in jl.items()}
    tl = {k: float(v.detach()) for k, v in tl.items()}
    assert set(tl) == set(jl)
    assert jl["loss_cls"] > 0 and jl["loss_mask"] > 0 and jl["loss_match"] > 0
    assert all(np.isfinite(v) for v in tl.values())
    for k in SELECTION_FREE + ("loss_pano",):
        assert tl[k] == pytest.approx(jl[k], rel=BF16_REL, abs=1e-5), k

    jg = state_dict_from_jax(jax.tree.map(np.asarray, jg))
    got, want = [], []
    for name, p in port.named_parameters():
        if not p.requires_grad:
            continue
        ref = jg[name].numpy()
        if p.grad is None:
            assert not ref.any(), name
            continue
        g = p.grad.numpy()
        err = np.linalg.norm(g - ref) / np.linalg.norm(ref)
        assert err <= BF16_GRAD_REL, (name, err)
        got.append(g.ravel())
        want.append(ref.ravel())
    assert len(got) > 100
    got, want = np.concatenate(got), np.concatenate(want)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_GRAD_REL_ALL
    assert port.extra_neck.liteflownet.flow_estimator.convs[0][0].weight.grad \
        is not None
    (tz,) = taps["port"]  # one LiteFlowNetCorr call (no next frame)
    for t, j in zip(tz, jz):
        assert t.grad is not None and t.grad.dtype == torch.bfloat16
        got, want = t.grad.float().numpy(), np.asarray(j, np.float32)
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_CORR_GRAD_REL, err
    assert port.bbox_head.fc_cls.weight.grad is None
