"""The port's counterparts of the repo's smaller tools, on the CPU, against
the repo's ``tools/`` scripts (loaded by ``tests/repo_tools.py``):
``analyze_logs`` (the port's Runner's log and the JAX runner's line),
``upgrade_model_version``, ``publish_model``, ``get_flops``' correlation
count, ``profile_ops``' op list and ``profile_train``'s synthetic batch.
Each test is cheap (a fraction of a second to a few seconds)."""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repo_tools import TOOLS, tool
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.ops import correlation
from vps_torch.tools import (
    analyze_logs,
    get_flops,
    profile_ops,
    profile_train,
    publish_model,
    upgrade_model_version,
)
from vps_torch.train.runner import Runner
from vps_torch.utils.checkpoint import save_checkpoint
from vps_torch.utils.logging import close_root_logger, get_root_logger

JAX_LINES = [
    "2024-01-01 00:00:00,000 - INFO - Epoch [1][10] time: 0.512s, "
    "acc: 0.5000, loss: 3.2500, loss_cls: 1.2500, lr: 0.0050\n",
    "2024-01-01 00:00:05,000 - INFO - Epoch [1][20] time: 0.498s, "
    "acc: 0.6250, loss: 2.7500, loss_cls: 1.0000, lr: 0.0050\n",
]


class _Det(torch.nn.Module):
    """A detector of two scalars whose ``loss`` takes a batch's sample."""

    device = torch.device("cpu")

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Parameter(torch.tensor(1.5))
        self.b = torch.nn.Parameter(torch.tensor(-0.5))

    def loss(self, img, generator=None, **_):
        m = img.mean()
        return {"loss_a": (self.a * m) ** 2, "loss_b": (self.b - m).abs(),
                "acc": m.detach()}


class _Loader:
    def steps_per_epoch(self):
        return 4

    def epoch(self, e):
        rng = np.random.RandomState(e)
        for _ in range(4):
            batch = {"img": rng.rand(1, 1, 4, 4, 3).astype(np.float32) + 1}
            batch.update({k: np.zeros((1, 1), np.float32) for k in (
                "ref_img", "gt_semantic_seg", "gt_semantic_seg_Nx",
                "gt_bboxes", "gt_labels", "gt_valid", "gt_masks", "gt_pids",
                "ref_bboxes", "ref_valid")})
            yield batch


def test_analyze_logs_reads_the_runners_train_log(tmp_path):
    """parse_log on a train.log the port's Runner wrote (the line with the
    parenthesised rate, ``rank(s)`` inside it) gives the Runner's
    ``log_history``: every logged step, its time and every term to the
    log's 4 decimals; the repo tool's pattern finds none of its lines."""
    log = tmp_path / "train.log"
    get_root_logger(log_file=str(log))
    try:
        runner = Runner(_Det(), _Loader(), {}, str(tmp_path), total_epochs=2,
                        log_interval=2, ckpt_interval=2)
        runner.run()
    finally:
        close_root_logger()
    text = log.read_text()
    assert "images/s over 1 rank(s))" in text
    runs = analyze_logs.parse_log(str(log))
    hist = runner.log_history
    assert len(hist) == 4
    assert set(runs) == set(hist[0])
    for key in runs:
        want = [r[key] for r in hist]
        if key in ("epoch", "iter"):
            assert runs[key] == want
        else:
            np.testing.assert_allclose(runs[key], want, rtol=0, atol=5e-5 + 5e-4 * (key == "time"))
    assert dict(tool("analyze_logs").parse_log(str(log))) == {}


def test_analyze_logs_reads_the_jax_line(tmp_path, capsys):
    """On the JAX runner's lines the port's parse_log equals the repo
    tool's, and main prints the repo tool's lines (``--out`` says when
    matplotlib is missing)."""
    log = tmp_path / "jax.log"
    log.write_text("".join(JAX_LINES))
    want = tool("analyze_logs").parse_log(str(log))
    got = analyze_logs.parse_log(str(log))
    assert dict(got) == dict(want) and len(got["loss"]) == 2
    analyze_logs.main([str(log), "--keys", "loss", "loss_mask",
                       "--out", str(tmp_path / "c.png")])
    out = capsys.readouterr().out
    assert "2 logged iterations, avg iter time 0.505s" in out
    assert "loss: first 3.2500  last 2.7500  min 2.7500" in out
    assert "loss_mask: not logged" in out
    assert ("saved" in out) or ("matplotlib is not installed" in out)


def test_upgrade_model_version_matches_repo_tool(tmp_path):
    """upgrade_state_dict equals the repo tool's on tower and other keys,
    and convert rewrites a checkpoint file as the repo tool does."""
    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(3, generator=gen) for k in (
        "backbone.conv1.weight", "bbox_head.cls_convs.0.weight",
        "bbox_head.cls_convs.3.bias", "bbox_head.reg_convs.1.weight",
        "bbox_head.reg_convs.1.conv.weight", "bbox_head.retina_cls.bias",
        "rpn_head.rpn_conv.weight")}
    want = tool("upgrade_model_version").upgrade_state_dict(sd)
    got = upgrade_model_version.upgrade_state_dict(sd)
    assert list(got) == list(want)
    assert "bbox_head.cls_convs.0.conv.weight" in got
    for k in want:
        assert got[k] is want[k]
    src, a, b = (str(tmp_path / n) for n in ("in.pth", "a.pth", "b.pth"))
    torch.save({"state_dict": sd, "meta": {"epoch": 12}}, src)
    upgrade_model_version.main([src, a])
    tool("upgrade_model_version").convert(src, b)
    ca, cb = torch.load(a), torch.load(b)
    assert ca["meta"] == cb["meta"] and list(ca["state_dict"]) == list(cb["state_dict"])
    assert all(torch.equal(ca["state_dict"][k], cb["state_dict"][k])
               for k in cb["state_dict"])


def test_publish_model(tmp_path):
    """The published file reloads into the model with every tensor equal,
    holds no opt_state, is named after a digest of its tensors (the same
    twice), and latest.txt names it."""
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    ckpt = save_checkpoint(str(tmp_path / "work"), 7, model.state_dict(),
                           opt_state={"trace": {"0.weight": torch.ones(2)}})
    out = tmp_path / "pub"
    first = publish_model.main([ckpt, str(out)])
    second = publish_model.main([ckpt, str(out)])
    assert first == second
    name = os.path.basename(first)
    assert name == f"ckpt_0-{publish_model.digest(model.state_dict())}.pth"
    assert len(name) == len("ckpt_0-12345678.pth")
    assert (out / "latest.txt").read_text() == name
    payload = torch.load(first, weights_only=True)
    assert set(payload) == {"state_dict"}
    fresh = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    fresh.load_state_dict(payload["state_dict"], strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)
    meta = json.loads(Path(first + ".meta.json").read_text())
    assert meta == {"published": "True", "source": ckpt}
    with torch.no_grad():
        model[0].weight[0, 0, 0, 0] += 1
    assert publish_model.digest(model.state_dict()) not in name


def test_get_flops_counts_each_correlation():
    """The correlation's wrapper records every call while ``record_calls``
    is open, whoever calls it (LiteFlowNetCorr's md 4 and FlowNetC's md 20
    stride 2 alike), and get_flops counts each 2 * C * D^2 * H * W (times
    the batch)."""
    from vps_torch.models.flow import flownet2, liteflow
    from vps_torch.ops.correlation import record_calls

    f1 = torch.randn(2, 6, 10, 16)
    with record_calls() as calls:
        liteflow.correlation(f1, f1, 4, 1)
        flownet2.correlation(f1, f1, 20, 2)
    correlation(f1, f1, 4, 1)  # closed: not recorded
    assert calls == [((2, 6, 10, 16), 4, 1), ((2, 6, 10, 16), 20, 2)]
    calls = [get_flops.correlation_flops(*c) for c in calls]
    assert calls[0] == 2.0 * 16 * 9 ** 2 * 6 * 10 * 2
    assert calls[1] == 2.0 * 16 * 21 ** 2 * 6 * 10 * 2


def test_profile_ops_names_every_op_of_jax_list(capsys):
    """The op list names every op of the repo tool's list, in its order,
    and runs on the CPU at 1/16 of the spatial sizes; the correlations
    carry the kernel's wrapper, beside the plain version except on the f32
    correlation's Pallas row (the kernel alone; its XLA row, the plain
    version alone)."""
    jax_names = __import__("re").findall(
        r'bench\("([^"]+)"', (TOOLS / "profile_ops.py").read_text())
    ops = profile_ops.op_list(torch.device("cpu"), scale=16)
    assert [op.name for op in ops] == jax_names and len(ops) == 17
    assert [op.name for op in ops if op.kernel is not None] == [
        n for n in jax_names if "corr" in n and not n.startswith("corr xla")]
    assert [op.name for op in ops if op.plain is None] == [jax_names[0]]
    assert jax_names[0].startswith("corr pallas r=4")
    res = profile_ops.main(["--device", "cpu", "--scale", "16", "--reps", "1"])
    assert list(res) == jax_names
    assert all((p is None or p > 0) and (k is None or k > 0)
               and (p, k) != (None, None) for p, k in res.values())
    assert "deform_conv bf16 in" in capsys.readouterr().out


def _jax_recipe(h, w, mg):
    """The repo tool's batch, its own statements run with numpy: from
    ``r = np.random.RandomState(0)`` to the ``batch = dict(...)`` it
    builds."""
    src = (TOOLS / "profile_train.py").read_text()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = [ast.unparse(n) for n in main.body]
    start = next(i for i, s in enumerate(body)
                 if s.startswith("r = np.random.RandomState(0)"))
    end = next(i for i, s in enumerate(body) if s.startswith("batch = dict("))
    ns = {"np": np, "h": h, "w": w, "mg": mg}
    exec("\n".join(body[start:end + 1]), ns)
    return ns["batch"]


@pytest.mark.parametrize("h, w, mg", [(800, 1600, 16), (256, 320, 6)])
def test_profile_train_batch_is_jax_recipe(h, w, mg):
    """synthetic_batch equals the repo tool's batch element for element."""
    want = _jax_recipe(h, w, mg)
    got = profile_train.synthetic_batch(h, w, mg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
