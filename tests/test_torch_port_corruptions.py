"""Port parity, image corruptions: each of vps_torch.data.corruptions'
17 corruptions at severities 1-5 on a seeded 24x40 frame against
vps_tpu.data.corruptions.corrupt with the same seed, exactly equal
(float32, the same numpy operations and random draws); unknown names and
severities outside 1-5 raise as in the JAX package (a severity: ValueError
where JAX asserts)."""

import numpy as np
import pytest

from vps_tpu.data import corruptions as j_corruptions

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.data import corruptions


def _frame():
    rng = np.random.RandomState(11)
    img = rng.uniform(0, 255, (24, 40, 3)).astype(np.float32)
    img[8:16, 10:30] = [200.0, 40.0, 90.0]  # a flat patch: blurs and jpeg
    return img


def test_the_sets_match():
    assert list(corruptions.CORRUPTIONS) == list(j_corruptions.CORRUPTIONS)
    assert len(corruptions.CORRUPTIONS) == 17
    assert corruptions.BENCHMARK_CORRUPTIONS == j_corruptions.BENCHMARK_CORRUPTIONS


@pytest.mark.parametrize("name", list(j_corruptions.CORRUPTIONS))
def test_corruption_matches_jax(name):
    img = _frame()
    for severity in range(1, 6):
        for seed in (0, 7):
            got = corruptions.corrupt(img, name, severity, seed=seed)
            want = j_corruptions.corrupt(img, name, severity, seed=seed)
            assert got.dtype == want.dtype == np.float32
            assert got.shape == img.shape
            np.testing.assert_array_equal(got, want)
            assert 0 <= got.min() and got.max() <= 255
    # the input is left as it was
    np.testing.assert_array_equal(img, _frame())


def test_bad_arguments_raise_as_in_jax():
    """An unknown name raises KeyError on both sides; a severity outside
    1-5 raises where JAX's asserts (ValueError: a check that ``python -O``
    keeps)."""
    img = _frame()
    for mod, bad_severity in ((corruptions, ValueError),
                              (j_corruptions, AssertionError)):
        with pytest.raises(KeyError):
            mod.corrupt(img, "no_such_corruption", 1, seed=0)
        for severity in (0, 6):
            with pytest.raises(bad_severity):
                mod.corrupt(img, "gaussian_noise", severity, seed=0)
