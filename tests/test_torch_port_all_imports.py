"""The port's imports, all of them: vps_torch and chip_smoke.py import
nothing of jax, flax, optax or vps_tpu (a static check over every module's
import statements), and the modules every slice added are there.

The file's only test, moved out of test_torch_port_fusetrack.py. It is
cheap, and its name sorts first among the port's one-test files: pytest-
xdist's loadfile scheduler queues one-test files in name order after
``tests/test_cli_train_eval.py`` (one test, the suite's longest) and hands
the worker that runs it the next units of the queue, which then wait
behind it; this one costs a fraction of a second there.
"""

import ast
from pathlib import Path

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """vps_torch and chip_smoke.py import nothing of jax, flax, optax or
    vps_tpu (static check over every module's import statements), the
    training, data, eval, tools, utils and config modules included (the
    detection evaluation's, the single-stage detectors', the backbones',
    guided anchoring's, the data-parallel training's, the native host
    library's and the last tools' too)."""
    banned = ("jax", "jaxlib", "flax", "optax", "vps_tpu")
    files = sorted((REPO / "vps_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    names = {p.relative_to(REPO).as_posix() for p in files}
    required = {f"vps_torch/{m}.py" for m in (
        "core/assigner", "core/sampler", "core/targets", "ops/losses",
        "ops/mask", "train/optim", "train/step", "train/runner",
        "utils/checkpoint", "utils/numerics", "config", "data/coco",
        "data/transforms", "data/dataset", "data/loader", "data/synth",
        "eval/pq", "eval/vpq", "eval/unified", "train/eval_hook",
        "tools/train", "tools/test_vpq", "tools/eval_vpq",
        "configs/cityscapes/fusetrack", "configs/cityscapes/fusetrack_fast",
        "configs/cityscapes/fuse", "configs/cityscapes/track",
        "configs/viper/fusetrack", "eval/viper", "tools/eval_ipq",
        "utils/visualize", "utils/flow", "registry", "models/builder",
        "models/detectors/two_stage", "models/detectors/cascade",
        "models/mask_heads", "models/bbox_head", "ops/nms", "eval/mean_ap",
        "data/corruptions", "data/xml_style", "utils/metrics", "utils/timer",
        "tools/coco_eval", "tools/voc_eval", "tools/coco_error_analysis",
        "tools/robustness_eval", "tools/test_robustness",
        "tools/convert_datasets/pascal_voc", "models/anchor_heads",
        "models/reppoints", "models/ssd_vgg", "models/detectors/single_stage",
        "ops/anchors", "ops/deform_conv", "models/plugins", "models/hrnet",
        "ops/roi_pool", "models/ga_heads", "ops/masked_conv",
        "data/extra_aug", "train/dist", "utils/logging", "native/__init__",
        "tools/analyze_logs", "tools/upgrade_model_version",
        "tools/publish_model", "tools/get_flops", "tools/profile_train",
        "tools/profile_ops", "tools/profile_sections",
        "tools/preset_accuracy")}
    assert required <= names, required - names
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"
