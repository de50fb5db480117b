"""Port parity, the training slice: the tiny FuseTrack (ResNet-18, TinyFlow,
64x128, f32 compute, ``tiny_train_cfg``) gives vps_tpu's
``PanopticFuseTrack.loss`` terms and, on the selection-free terms
(``loss_segm``, ``loss_rpn_cls``, ``loss_rpn_bbox``), its gradients, with the
same weights (the JAX tree through ``state_dict_from_jax``) and the same
sampler draws. The two comparisons of the ``parity`` fixture live in
one-test files of their own, ``test_torch_port_train_loss.py`` and
``test_torch_port_train_grads.py`` (pytest-xdist's loadfile scheduler queues
a one-test file after the files with several). Here: the port's Runner (2
steps, checkpoint, resume), its checkpoint loading into the JAX model, the
windowed head's weight cast under training, and a ``cuda``-marked check of
the correlation backward kernel.

Cost: the JAX weights come from ``convert_detector`` (no init at all) and
one jitted value_and_grad serves each parity comparison.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import vps_tpu.core.targets as jtargets
from vps_tpu import zoo as jzoo
from vps_tpu.core.sampler import _sample_by_priority as j_sample_by_priority
from vps_tpu.models.detectors import PanopticFuseTrack as JPanopticFuseTrack
from vps_tpu.utils.convert import convert_detector

from test_full_graph_parity import build_sd
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

import vps_torch.core.sampler as tsampler
from vps_torch import zoo
from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import PanopticFuseTrack
from vps_torch.train.optim import build_lr_schedule, build_optimizer
from vps_torch.train.runner import Runner
from vps_torch.train.step import IMAGE_KEYS
from vps_torch.utils.checkpoint import latest_checkpoint

H, W, G = 64, 128, 4
SELECTION_FREE = ("loss_segm", "loss_rpn_cls", "loss_rpn_bbox")


def _cfg(zoo_mod):
    cfg = zoo_mod.f32_compute_overrides(zoo_mod.tiny_overrides(
        zoo_mod.fusetrack_model_cfg()))
    cfg.pop("type")
    return cfg


@functools.lru_cache(maxsize=None)
def _weights(seed=0):
    """JAX params / batch_stats of the tiny detector: build_sd through
    convert_detector, TinyFlow's three convs seeded here. The DCN offsets
    are set near 0.5 and LiteFlowNet's residual flow near 0, so no bilinear
    sample whose position is trained sits within rounding of an integer,
    where its gradient jumps: there, f32 sums taken in another order move a
    sample across and change the gradients by ~1% (measured), which would
    hide what the test is after."""
    rng = np.random.RandomState(seed)
    params, stats, _ = convert_detector(build_sd(rng), depth=18)
    params = dict(params)
    params["flownet2"] = {
        n: {"Conv_0": {
            "kernel": (rng.randn(3, 3, i, o) / np.sqrt(9 * i)).astype(np.float32),
            "bias": np.zeros((o,), np.float32)}}
        for n, i, o in (("c1", 6, 16), ("c2", 16, 16), ("pred", 16, 2))}
    pan = dict(params["panopticFPN"])
    for name in [k for k in pan if k.startswith("dc")]:
        off = pan[name]["conv_offset"]["Conv_0"]
        pan[name] = dict(pan[name], conv_offset={"Conv_0": {
            "kernel": off["kernel"] * 0.05, "bias": np.full_like(off["bias"], 0.5)}})
    params["panopticFPN"] = pan
    neck = params["extra_neck"]
    est = neck["liteflownet"]["flow_estimator"]
    c3 = est["c3"]["Conv_0"]
    params["extra_neck"] = dict(neck, liteflownet=dict(
        neck["liteflownet"], flow_estimator=dict(
            est, c3={"Conv_0": dict(c3, kernel=c3["kernel"] * 0.01)})))
    return params, stats


def _sample(rng):
    """One training sample: 3 valid gts of 4, rectangle masks, a semantic
    map with ignored pixels, pids and shifted reference boxes."""
    boxes = np.array([[8, 8, 40, 40], [50, 10, 95, 60], [100, 20, 127, 63],
                      [0, 0, 0, 0]], np.float32)
    valid = np.array([1, 1, 1, 0], bool)
    masks = np.zeros((G, H, W), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(boxes[:3].astype(int)):
        masks[i, y1:y2 + 1, x1:x2 + 1] = 1
    seg = rng.randint(0, 19, (1, H, W)).astype(np.int32)
    seg[:, :8] = 255
    return dict(
        img=rng.randn(1, H, W, 3).astype(np.float32),
        ref_img=rng.randn(1, H, W, 3).astype(np.float32),
        gt_bboxes=boxes, gt_labels=np.array([1, 3, 8, 0], np.int32),
        gt_valid=valid, gt_masks=masks, gt_semantic_seg=seg,
        gt_semantic_seg_Nx=seg[:, ::4, ::4].copy(),
        gt_pids=np.array([1, 0, 2, 0], np.int32),
        ref_bboxes=(boxes + 2.0) * valid[:, None],
        ref_valid=np.array([1, 0, 1, 0], bool))


def _prios(n):
    return np.random.RandomState(n).rand(2, n).astype(np.float32)


def _port(params, stats):
    det = PanopticFuseTrack(train_cfg=zoo.tiny_train_cfg(),
                            test_cfg=zoo.fusetrack_test_cfg(), device="cpu",
                            **_cfg(zoo))
    det.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return det


@pytest.fixture(scope="module")
def parity():
    """Both stacks on one sample with the same draws: (JAX losses, JAX
    selection-free grads by torch name, port losses, port grads)."""
    params, stats = _weights()
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
        det = JPanopticFuseTrack(train_cfg=jzoo.tiny_train_cfg(),
                                 test_cfg=jzoo.tiny_test_cfg(), **_cfg(jzoo))

        def f(p, sample):
            losses = det.apply({"params": p, "batch_stats": stats},
                               method=det.loss,
                               rngs={"sampler": jax.random.PRNGKey(0)},
                               **sample)
            return sum(losses[k] for k in SELECTION_FREE), losses

        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in s.items()})

        port = _port(params, stats)
        losses = port.loss(**{k: torch.from_numpy(v) for k, v in s.items()})
        sum(losses[k] for k in SELECTION_FREE).backward()
    jg = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in port.named_parameters() if p.requires_grad}
    return ({k: float(v) for k, v in jlosses.items()}, jg,
            {k: float(v.detach()) for k, v in losses.items()}, grads)


class _Loader:
    """One fixed sample, ``n`` steps an epoch, batch 1."""

    def __init__(self, n=1):
        s = _sample(np.random.RandomState(2))
        self.batch = {k: v if k in IMAGE_KEYS else v[None]
                      for k, v in s.items()}
        self.n = n

    def steps_per_epoch(self):
        return self.n

    def epoch(self, e):
        for _ in range(self.n):
            yield self.batch


RUN_CFG = dict(optimizer=dict(lr=0.002), lr_config=dict(warmup_iters=2, step=[8]))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """2 epochs of 1 step from the shared weights, a checkpoint each."""
    work = tmp_path_factory.mktemp("train")
    det = _port(*_weights())
    before = {k: v.clone() for k, v in det.state_dict().items()}
    runner = Runner(det, _Loader(), RUN_CFG, str(work), total_epochs=2,
                    log_interval=1, ckpt_interval=1)
    state = runner.run()
    return work, det, before, runner, state


def test_runner_trains_then_resumes(trained):
    """2 steps: finite losses, no skip, trainable weights moved, frozen ones
    (FlowNet2, the stem, stage 1) and the BN statistics untouched. Resuming
    from the last checkpoint continues at epoch 3 with the optimizer's
    count and momentum restored."""
    work, det, before, runner, state = trained
    assert state.step == 2 and state.optimizer.count == 2
    assert [r["epoch"] for r in runner.log_history] == [1, 2]
    for rec in runner.log_history:
        assert np.isfinite(rec["loss"]) and rec["nonfinite_skips"] == 0
    after = det.state_dict()
    trainable = {n for n, p in det.named_parameters() if p.requires_grad}
    for k, v in after.items():
        moved = not torch.equal(v, before[k])
        assert moved == (k in trainable), k
    assert latest_checkpoint(str(work)).endswith("ckpt_2.pth")

    det2 = _port(*_weights())
    resumed = Runner(det2, _Loader(), RUN_CFG, str(work), total_epochs=3,
                     log_interval=1, ckpt_interval=1)
    opt = resumed.init_state().optimizer  # what resume restores into
    st = resumed.run(resume_from=latest_checkpoint(str(work)))
    assert st.step == 3 and st.optimizer.count == 3
    assert [r["epoch"] for r in resumed.log_history] == [3]
    assert opt.count == 0
    assert latest_checkpoint(str(work)).endswith("ckpt_3.pth")


def test_checkpoint_loads_into_jax(trained):
    """The saved state_dict converts into the JAX model's tree through
    vps_tpu's convert_detector: every key used, the same tree and shapes as
    the JAX weights, and the values back unchanged."""
    work = trained[0]
    sd = torch.load(str(work / "ckpt_2.pth"), weights_only=True)["state_dict"]
    sd = {k: v.numpy() for k, v in sd.items() if not k.startswith("flownet2.")}
    params, stats, used = convert_detector(sd, depth=18)
    assert used == set(sd)
    ref_params, ref_stats = _weights()
    ref_params = {k: v for k, v in ref_params.items() if k != "flownet2"}
    shape = lambda t: jax.tree.map(np.shape, t)  # noqa: E731
    assert shape(params) == shape(ref_params)
    assert shape(stats) == shape(ref_stats)
    back = state_dict_from_jax(params, stats)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_windowed_weight_cast_rebuilt_after_step():
    """The windowed head keeps its bf16 weight between inference calls; an
    optimizer step (in place) bumps the parameter's version, so the next
    inference call casts the updated weight instead of the stale one."""
    from vps_torch.models.panoptic_fpn import DeformConvWithOffset

    m = DeformConvWithOffset(8, 6, dcn_window=2)
    with torch.inference_mode():
        w1 = m._windowed_weight(torch.bfloat16)
    opt, _ = build_optimizer(m, build_lr_schedule(0.5, 1, 1, warmup_iters=1))
    x = torch.randn(1, 8, 6, 7)
    m([x])[0].square().sum().backward()
    assert opt.step()
    with torch.inference_mode():
        w2 = m._windowed_weight(torch.bfloat16)
    assert w2 is not w1 and not torch.equal(w2, w1)
    assert torch.equal(w2, m.conv.weight.detach().bfloat16())


@pytest.mark.cuda
def test_correlation_backward_kernel_matches_plain():
    """The backward kernel against autograd through the plain version, f32
    and bf16, both call sites' geometries and ragged ones (B = 3 with H < md,
    W not a multiple of the pixel block, C = 300, D = 41, H not a multiple
    of the block's rows); through ``correlation``'s autograd Function too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    from vps_torch.ops import (correlation, correlation_backward,
                               correlation_backward_reference,
                               correlation_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [((1, 50, 100, 256), 4, 1), ((1, 32, 64, 256), 20, 2),
             ((2, 13, 37, 100), 4, 1), ((1, 9, 50, 36), 7, 3),
             ((3, 3, 45, 64), 4, 1), ((1, 12, 70, 300), 4, 1),
             ((1, 12, 70, 40), 80, 4), ((2, 61, 130, 256), 4, 1)]
    for shape, md, s2 in cases:
        d2 = (2 * (md // s2) + 1) ** 2
        for dt, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
            f1 = torch.randn(shape, generator=gen, device="cuda").to(dt)
            f2 = torch.randn(shape, generator=gen, device="cuda").to(dt)
            g = torch.randn(shape[:3] + (d2,), generator=gen,
                            device="cuda").to(dt)
            ours = correlation_backward(g, f1, f2, md, s2)
            torch.cuda.synchronize()
            ref = correlation_backward_reference(g, f1, f2, md, s2)
            for a, b in zip(ours, ref):
                assert a.dtype == dt
                err = (a.float() - b.float()).abs().max().item()
                assert err <= rel * b.float().abs().max().item(), (shape, dt, err)
    a = torch.randn(1, 20, 30, 64, device="cuda", requires_grad=True)
    b = torch.randn(1, 20, 30, 64, device="cuda", requires_grad=True)
    n0 = correlation_backward.launches
    correlation(a, b, 4, 1).square().sum().backward()
    assert correlation_backward.launches == n0 + 1
    ga, gb = a.grad, b.grad
    a.grad = b.grad = None
    correlation_reference(a, b, 4, 1).square().sum().backward()
    torch.testing.assert_close(ga, a.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gb, b.grad, rtol=1e-5, atol=1e-6)
