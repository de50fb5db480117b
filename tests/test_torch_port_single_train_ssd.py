"""Port parity, the single-stage detectors' training: vps_torch's SSD
``loss`` held against vps_tpu's on SSD300 (tests/single_parity.py's seeded
300x300 image and gt, seeded weights), the bar of
``zoo_parity.assert_train_match``: every term within SINGLE_REL of JAX's,
the assignment and the kept hard negatives equal slot for slot, and each
parameter's gradient within zoo_parity.GRAD_TOL.

The gradients of VGG-16's convs through conv5_3 are held at that bar in a
float64 run of the port on the same weights: in f32 the two stacks round
differently, and in the ~10M ReLUs of the trunk at 300x300 a few
pre-activations within rounding of zero take the other sign (6 in the f32
run against float64, measured), which moves those convs' gradients by up to
~6e-3 of their largest. Every other parameter's f32 gradient is held at
the bar as it is.

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from single_parity import SINGLE_REL, TRAIN_CFGS, float64_grads, train_pair
from zoo_parity import assert_train_match

TRUNK = "backbone.features."


def test_single_train_ssd_loss_and_grads_match_jax():
    r = train_pair("SSD", TRAIN_CFGS["SSD"])
    keys = set(r["jl"])
    head = {n: g for n, g in r["tg"].items() if not n.startswith(TRUNK)}
    assert len(head) > 20
    assert_train_match(dict(r, tg=head), keys, min_sampled=2, rel=SINGLE_REL)
    assert_train_match(dict(r, tg=float64_grads(r, "SSD")), keys,
                       min_sampled=2, rel=SINGLE_REL)
