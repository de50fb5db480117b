"""Shared pieces of the R-CNN zoo's parity tests
(``tests/test_torch_port_zoo_*.py``; for training ``train_pair``, the two
stacks' losses, sampled sets and gradients on the same draws, and its bar
``assert_train_match``): the tiny configs of
tests/test_two_stage.py and tests/test_cascade.py, seeded JAX variables
(``jax.eval_shape`` of ``init``, filled from numpy; no ``init`` is run),
one jitted JAX ``predict`` a detector, the port built through
``build_detector`` on the CPU and loaded through ``state_dict_from_jax``
with ``strict=True``, and the bar.

The bar, as tests/test_full_graph_parity.py sets it: identical detection
sets, labels and ``det_valid``, boxes and scores within 1e-4 (absolute,
pixels and probabilities on a 64x64 image; Grid R-CNN's voted boxes are
``det_bboxes``); mask logits and mask-IoU scores within ``LOGIT_TOL``. The
weights keep activations O(1), as a trained network's are (kernels
N(0, 1/fan_in), box regressors x0.1, classifiers x2, the last BN of each
residual branch x0.2): the two stacks then agree to <= 1.2e-5 on boxes and
<= 1.8e-6 on mask logits and scores of magnitude <= 1.35, summation order
through ~20 f32 layers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models import build_detector as _jax_registers  # noqa: F401
from vps_tpu.registry import DETECTORS as JDETECTORS

from test_cascade import stage_heads
from test_two_stage import IMG, TEST_CFG, tiny_cfg

from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import build_detector

BOX_TOL = 1e-4
# mask logits and mask-IoU scores: a few more conv / sigmoid layers on the
# pooled windows than the boxes; measured <= 1.8e-6 (values <= 1.35), held
# to the box bar
LOGIT_TOL = 1e-4

MASK = dict(
    mask_roi_extractor=dict(roi_layer=dict(out_size=14, sample_num=2),
                            featmap_strides=[4, 8, 16, 32]),
    mask_head=dict(num_convs=1, in_channels=32, conv_out_channels=32,
                   num_classes=5))


def fill(tree, rng, path=(), last_bn="bn2"):
    """Seeded values for an eval_shape tree, in sorted key order."""
    out = {}
    for k, v in sorted(tree.items()):
        p = path + (k,)
        if hasattr(v, "items"):
            if any(c.startswith("bn") for c in v):  # a residual block
                last_bn = "bn3" if "bn3" in v else "bn2"
            out[k] = fill(v, rng, p, last_bn)
            continue
        z = rng.standard_normal(tuple(v.shape), dtype=np.float32)
        name = "/".join(p)
        if k == "kernel":
            fan = int(np.prod(v.shape[:-1]))
            gain = (0.1 if "fc_reg" in name or "rpn_reg" in name
                    else 2.0 if "fc_cls" in name else 1.0)
            out[k] = z * np.float32(gain / np.sqrt(fan))
        elif k == "scale":
            last = (p[0].startswith(("backbone", "shared_head"))
                    and p[-2] == last_bn)
            out[k] = (1.0 + 0.1 * z) * (0.2 if last else 1.0)
        elif k == "var":
            out[k] = 1.0 + 0.1 * np.abs(z)
        elif k == "mean":
            out[k] = 0.1 * z
        else:  # bias
            out[k] = 0.02 * z
    return out


def mask_scoring_cfg(**over):
    return dict(mask_iou_head=dict(num_convs=2, num_fcs=1, roi_feat_size=14,
                                   in_channels=32, conv_out_channels=32,
                                   fc_out_channels=32, num_classes=5),
                **tiny_cfg(**MASK, **over))


def cascade_cfg(num_stages, mask=True):
    over = dict(MASK) if mask else {}
    return dict(num_stages=num_stages,
                **tiny_cfg(bbox_head=stage_heads()[:num_stages], **over))


def htc_cfg(semantic=True, mask_info_flow=True):
    cfg = dict(num_stages=2, interleaved=True, mask_info_flow=mask_info_flow,
               **tiny_cfg(bbox_head=stage_heads()[:2],
                          mask_roi_extractor=MASK["mask_roi_extractor"],
                          mask_head=dict(type="HTCMaskHead", num_convs=1,
                                         in_channels=32, conv_out_channels=32,
                                         num_classes=5)))
    if semantic:
        cfg.update(semantic_roi_extractor=dict(
            roi_layer=dict(out_size=14, sample_num=2), featmap_strides=[8]),
            semantic_head=dict(num_ins=5, fusion_level=1, num_convs=1,
                               in_channels=32, conv_out_channels=32,
                               num_classes=7))
    return cfg


def pair(kind, cfg, seed=0, test_cfg=TEST_CFG, img=IMG, proposals=None,
         port_kind=None, fill_fn=fill):
    """vps_tpu's ``kind`` and the port's (``port_kind``, default the same
    name) on the same seeded weights (``fill_fn``) and image. Returns (JAX
    outputs as numpy, the port's as numpy, the port detector)."""
    jdet = JDETECTORS.get(kind)(test_cfg=test_cfg, **cfg)
    extra = () if proposals is None else tuple(jnp.asarray(p) for p in proposals)
    shapes = jax.eval_shape(lambda: jdet.init(
        jax.random.PRNGKey(0), img, *extra, method=jdet.predict))
    rng = np.random.default_rng(seed)
    variables = {k: fill_fn(v, rng) for k, v in shapes.items()}
    want = jax.jit(lambda v, *a: jdet.apply(v, img, *a, method=jdet.predict))(
        variables, *extra)
    port = build_detector(dict(cfg, type=port_kind or kind), test_cfg=test_cfg,
                          device="cpu")
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables.get("batch_stats")),
                         strict=True)
    args = () if proposals is None else tuple(torch.from_numpy(np.array(p))
                                               for p in proposals)
    got = port.predict(torch.from_numpy(np.array(img)), *args)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()}, port)


def assert_dets_match(want, got, box_tol=BOX_TOL, min_valid=3):
    """Identical detection sets, labels and validity; boxes and scores
    within ``box_tol``; every other float output within LOGIT_TOL."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    nvalid = int(want["det_valid"].sum())
    assert nvalid >= min_valid, f"too few detections ({nvalid})"
    np.testing.assert_array_equal(got["det_valid"], want["det_valid"])
    np.testing.assert_array_equal(got["det_labels"], want["det_labels"])
    np.testing.assert_allclose(got["det_bboxes"], want["det_bboxes"], rtol=0,
                               atol=box_tol)
    for k in set(want) - {"det_valid", "det_labels", "det_bboxes"}:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=LOGIT_TOL,
                                   err_msg=k)


# -- training -----------------------------------------------------------------

# loss terms that no sampled selection reaches (the anchors' targets are
# drawn too, but both stacks get the same draws and the same anchors)
SELECTION_FREE = ("loss_rpn_cls", "loss_rpn_bbox", "loss_semantic_seg")


class Draws:
    """The samplers' priorities: each call (2, n) uniforms from its own
    seeded RandomState, in call order; one instance a stack, both from the
    same seed, feed the two the same draws."""

    def __init__(self, seed):
        self.seed, self.calls = seed, 0

    def __call__(self, n):
        r = np.random.RandomState(1000 * self.seed + self.calls).rand(2, n)
        self.calls += 1
        return r.astype(np.float32)


def gt_sample(masks=True, semantic=False):
    """tests/test_two_stage.py's gt (3 valid boxes of 4, box masks) as
    numpy, with the semantic labels HTC reads at stride 8 (seeded, 7
    classes, a border of 255) when asked."""
    from test_two_stage import gt

    gtb, gtl, gtv, gtm = (np.asarray(a) for a in gt())
    out = dict(gt_bboxes=gtb, gt_labels=gtl, gt_valid=gtv)
    if masks:
        out["gt_masks"] = gtm
    if semantic:
        sem = np.random.RandomState(5).randint(0, 7, (1, 8, 8)).astype(np.int32)
        sem[:, 0] = 255
        sem[:, :, -1] = 255
        out["gt_semantic_seg"] = sem
    return out


def train_pair(kind, cfg, train_cfg, sample, seed=0, jitter=None,
               port_kind=None, fill_fn=fill):
    """vps_tpu's ``kind`` and the port's ``loss`` on the same seeded weights,
    the image IMG and ``sample`` (numpy gt, and proposals for FastRCNN),
    the same sampler draws (``Draws``: JAX's ``random_sample`` and the
    port's ``uniform`` replaced) and, for Grid R-CNN, the same jitter
    (``jitter`` (n, 4): JAX's ``jax.random.uniform`` and the port's
    ``jitter_offsets`` replaced while each runs). JAX's side is one jitted
    value_and_grad of the total (the terms whose key holds "loss"); the
    port's is ``loss`` and one backward. Returns a dict: ``jl`` / ``tl``
    the terms, ``jg`` / ``tg`` the gradients by the port's parameter names
    (the port's None where a parameter got none), ``jsel`` / ``tsel`` each
    sampler call's (inds, valid), in order, and ``port``. ``fill_fn`` makes
    the weights (``fill``'s by default)."""
    import pytest

    import vps_tpu.core.targets as jtargets
    from vps_tpu.core.sampler import _sample_by_priority as j_by_priority

    import vps_torch.core.sampler as tsampler
    import vps_torch.core.targets as ttargets
    import vps_torch.models.detectors.two_stage as ttwo_stage

    jdet = JDETECTORS.get(kind)(train_cfg=train_cfg, test_cfg=TEST_CFG, **cfg)
    args = dict(sample, img=np.asarray(IMG))
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    shapes = jax.eval_shape(lambda: jdet.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        **jargs, method=jdet.loss))
    rng = np.random.default_rng(seed)
    variables = {k: fill_fn(v, rng) for k, v in shapes.items()}
    params, stats = variables["params"], variables.get("batch_stats")

    jdraws, tdraws = Draws(seed), Draws(seed)
    jsel, tsel = [], []

    def j_random_sample(key, gi, num, pos_fraction):
        r = jdraws(gi.shape[0])
        res = j_by_priority(jnp.asarray(r[0]), jnp.asarray(r[1]), gi > 0,
                            gi == 0, num, int(num * pos_fraction))
        slot = len(jsel)
        jsel.append(None)

        def record(inds, valid):
            jsel[slot] = (np.asarray(inds), np.asarray(valid))

        jax.debug.callback(record, res.inds, res.valid)
        return res

    t_random_sample = ttargets.random_sample

    def t_recording(generator, gi, num, pos_fraction):
        res = t_random_sample(generator, gi, num, pos_fraction)
        tsel.append((res.inds.numpy(), res.valid.numpy()))
        return res

    def j_uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        assert tuple(shape) == jitter.shape and minval == -0.15
        return jnp.asarray(jitter)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtargets, "random_sample", j_random_sample)
        if jitter is not None:
            mp.setattr(jax.random, "uniform", j_uniform)

        def f(p):
            v = {"params": p}
            if stats is not None:
                v["batch_stats"] = stats
            losses = jdet.apply(v, **jargs, method=jdet.loss,
                                rngs={"sampler": jax.random.PRNGKey(7)})
            return sum(x for k, x in losses.items() if "loss" in k), losses

        (_, jl), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        jl = {k: float(v) for k, v in jl.items()}

    port = build_detector(dict(cfg, type=port_kind or kind),
                          train_cfg=train_cfg, test_cfg=TEST_CFG, device="cpu")
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsampler, "uniform", lambda gen, shape, device:
                   torch.from_numpy(tdraws(shape[1])))
        mp.setattr(ttargets, "random_sample", t_recording)
        if jitter is not None:
            mp.setattr(ttwo_stage, "jitter_offsets",
                       lambda gen, shape, device, amp: torch.from_numpy(
                           np.asarray(jitter)))
        losses = port.loss(**{k: torch.from_numpy(np.asarray(v))
                              for k, v in args.items()})
        sum(v for k, v in losses.items() if "loss" in k).backward()
    return dict(jl=jl, tl={k: float(v.detach()) for k, v in losses.items()},
                jg={k: v.numpy() for k, v in state_dict_from_jax(
                    jax.tree.map(np.asarray, jg)).items()},
                tg={n: None if p.grad is None else p.grad.numpy()
                    for n, p in port.named_parameters()},
                jsel=jsel, tsel=tsel, port=port)


# the gradient bar: each parameter's gradient within GRAD_TOL of its
# tensor's largest JAX gradient, plus 1e-6 of the largest over all tensors
# (f32 sums in other orders; measured <= 1e-5 of the tensor's largest on
# every detector here)
GRAD_TOL = 1e-4


def assert_train_match(r, keys, min_sampled=2, rel=None):
    """The same loss keys (``keys``); every term finite and within rel 1e-4
    (SELECTION_FREE) or 1e-3 (after a sampled selection) of JAX's, or within
    ``rel`` when given; every sampler call with equal slots and validity, at
    least ``min_sampled`` calls; each parameter's gradient of the total
    within GRAD_TOL (a parameter the port gives none has none in JAX
    either)."""
    import pytest

    jl, tl = r["jl"], r["tl"]
    bar = rel
    assert set(tl) == set(jl) == set(keys), (sorted(tl), sorted(jl))
    for k, v in jl.items():
        rel = bar or (1e-4 if k in SELECTION_FREE else 1e-3)
        assert np.isfinite(tl[k]), k
        assert tl[k] == pytest.approx(v, rel=rel, abs=1e-6), (k, tl[k], v)
    assert len(r["jsel"]) == len(r["tsel"]) >= min_sampled
    for (ji, jv), (ti, tv) in zip(r["jsel"], r["tsel"]):
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti[tv], ji[jv])
    jg, tg = r["jg"], r["tg"]
    gmax = max(np.abs(v).max() for v in jg.values())
    reached = 0
    for name, g in tg.items():
        ref = jg[name]
        if g is None:
            assert not ref.any(), name
            continue
        err = np.abs(g - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max() + 1e-6 * gmax, (name, err)
        reached += 1
    assert reached > 0.9 * len(tg), (reached, len(tg))
