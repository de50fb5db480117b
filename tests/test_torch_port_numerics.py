"""The port's numerics policy (``vps_torch.utils.numerics.f32_policy``):
the entry points that stop without a card (profile, kernel_ab, kernel_ablate,
chip_smoke) switch TF32 off first, and a static check that only the policy
sets a flag and nothing sets one at import. The three tools are checked in
``test_torch_port_cli.py``, which runs them.
"""

import ast
import importlib.util
from pathlib import Path

import pytest
import torch

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def tf32_on():
    """Both TF32 flags set True for the test; the old values after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _tf32_off():
    return not (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)


def _set_tf32():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def _module(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_points_without_a_card_set_the_f32_policy(tf32_on):
    """The profile, kernel_ab, kernel_ablate and chip_smoke entry points
    switch TF32 off before they look for a card (and, without one, stop)."""
    from vps_torch import kernel_ab, kernel_ablate, profile

    with pytest.raises(SystemExit):
        profile.main(["--frames", "1"])
    assert _tf32_off()
    _set_tf32()
    with pytest.raises(SystemExit):
        kernel_ab.main([])
    assert _tf32_off()
    _set_tf32()
    with pytest.raises(SystemExit):
        kernel_ablate.main([])
    assert _tf32_off()
    _set_tf32()
    assert _module(REPO / "chip_smoke.py").main() != 0
    assert _tf32_off()


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def test_only_the_policy_sets_flags():
    """Static check over vps_torch and chip_smoke.py: the only functions
    that assign a ``torch.backends`` flag are ``utils/numerics.py``'s
    policies, ``f32_policy``, ``inference_policy`` and ``train_policy``, and
    no module calls one (or any ``torch.set_*``) at import time, so
    importing the package changes no global flag."""
    files = sorted((REPO / "vps_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    setters = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for fn in [None] + [n for n in ast.walk(tree)
                            if isinstance(n, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))]:
            for node in ast.walk(fn or tree):
                if isinstance(node, ast.Assign) and any(
                        _dotted(t).startswith("torch.backends.")
                        for t in node.targets):
                    setters.append((path.relative_to(REPO).as_posix(),
                                    fn.name if fn else None))
        for stmt in tree.body:  # what runs at import
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    name = _dotted(node.func)
                    assert not name.endswith((
                        "f32_policy", "inference_policy", "train_policy",
                        "deterministic_cublas")) and not (
                        name.startswith("torch.set_")), (path, name)
    # each assignment is seen from the module and from its function
    assert set(setters) == {("vps_torch/utils/numerics.py", None),
                            ("vps_torch/utils/numerics.py", "f32_policy"),
                            ("vps_torch/utils/numerics.py", "inference_policy"),
                            ("vps_torch/utils/numerics.py", "train_policy")}
