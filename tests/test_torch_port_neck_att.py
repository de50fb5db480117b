"""Port parity, the fuse neck's other forms, in f32 against vps_tpu on the
same weights: BFPTcea with ``refine_type='att'`` (a 3x3 conv then CBAM);
BFPTceaMulti's 3-frame call (previous and next frame warped onto the
current one, TCEA centred on it); and BFPTceaMulti as the detectors build
it (JAX's detector calls it without next frames, so flax sizes its TCEA for
2 frames: the port builds it for 2). Tolerance rtol 1e-4, atol 1e-5
(f32 sums in other orders).

JAX variables come from ``jax.eval_shape`` of the neck's init and a seeded
fill (the JAX converter has no names for CBAM), through
``state_dict_from_jax`` into the port.

It is the file's only test: pytest-xdist's loadfile scheduler queues files
by their number of tests, most first, so a one-test file starts after the
files with several.
"""

import numpy as np
import jax
import torch

from vps_tpu.models.bfp_tcea import BFPTcea as JBFPTcea
from vps_tpu.models.bfp_tcea import BFPTceaMulti as JBFPTceaMulti

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.convert import state_dict_from_jax
from vps_torch.models.bfp_tcea import BFPTcea, BFPTceaMulti

C = 32
SIZES = [(16, 32), (8, 16), (4, 8), (2, 4), (1, 2)]


def _fill(tree, rng):
    """Seeded values in flax's sorted key order: kernels N(0, 1/fan_in),
    biases N(0, 0.1^2)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if hasattr(v, "items"):
            out[k] = _fill(v, rng)
        elif k == "kernel":
            fan = int(np.prod(v.shape[:-1]))
            out[k] = (rng.randn(*v.shape) / np.sqrt(fan)).astype(np.float32)
        else:
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
    return out


def _case(rng, jneck, tneck, frames):
    """One call of both necks on seeded levels and flows of ``frames``
    frames (2: current and reference; 3: and the next one)."""
    levels = [[rng.randn(1, h, w, C).astype(np.float32) for h, w in SIZES]
              for _ in range(frames)]
    flows = [(2.0 * rng.randn(1, *SIZES[0], 2)).astype(np.float32)
             for _ in range(frames - 1)]
    args = (tuple(levels[0]), tuple(levels[1]), flows[0])
    if frames == 3:
        args += (tuple(levels[2]), flows[1])
    shapes = jax.eval_shape(lambda: jneck.init(jax.random.PRNGKey(0), *args))
    params = _fill(shapes["params"], rng)
    want = jneck.apply({"params": params}, *args)

    sd = state_dict_from_jax({"extra_neck": params})
    tneck.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                          strict=True)
    nchw = lambda lv: tuple(torch.from_numpy(x).permute(0, 3, 1, 2)  # noqa: E731
                            for x in lv)
    targs = (nchw(levels[0]), nchw(levels[1]), torch.from_numpy(flows[0]))
    if frames == 3:
        targs += (nchw(levels[2]), torch.from_numpy(flows[1]))
    with torch.no_grad():
        got = tneck(*targs)
    assert len(got) == len(want) == len(SIZES)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-5)


def test_neck_forms_match_jax():
    rng = np.random.RandomState(0)
    kw = dict(in_channels=C, compute_dtype=None)
    _case(rng, JBFPTcea(refine_type="att", **kw),
          BFPTcea(refine_type="att", device="cpu", **kw), 2)
    _case(rng, JBFPTceaMulti(**kw), BFPTceaMulti(device="cpu", **kw), 3)
    # the detectors' build: 2 frames, the config's centre
    _case(rng, JBFPTceaMulti(refine_type="att", **kw),
          BFPTceaMulti(nframes=2, refine_type="att", device="cpu", **kw), 2)
