"""The benchmark's own tests: the harness's files load by name, its
arithmetic matches hand counts, the frozen reference equals the program at
a tiny size on the CPU, and a run with the program broken underneath comes
out not correct. Run from the repository's root:
``python -m pytest benchmark/tests -q``. Tests marked ``cuda`` need the
card and skip without one."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(min(4, old))
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
