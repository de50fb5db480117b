"""Nothing the harness loads is JAX, jaxlib, flax or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's), the reference loads nothing of the program, and no file of
the harness reads the JAX package's benchmark or its records."""

import os
import re
import subprocess
import sys

import run

FORBIDDEN = ("jax", "jaxlib", "flax", "vps_tpu")
HARNESS = ["run", "entries", "flops", "roofline", "trace", "traffic",
           "weights", "reference.drive", "reference.judge",
           "reference.control"]


def _loaded(modules, extra=""):
    code = (f"import sys; sys.path[:0] = [{run.ROOT!r}, {run.HERE!r}]\n"
            + "".join(f"import {m}\n" for m in modules) + extra
            + "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    tops = _loaded(HARNESS + ["vps_torch.models.detectors"], extra=(
        "import glob, os\n"
        "for p in glob.glob(os.path.join(" + repr(run.HERE) +
        ", 'metrics', '*.py')):\n"
        "    import run as r; r.reader(os.path.basename(p)[:-3])\n"))
    assert not tops & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded(["reference.drive", "reference.judge",
                    "reference.control"])
    assert "vps_torch" not in tops and not tops & set(FORBIDDEN)


def test_no_file_names_jax_or_the_tpu_records():
    records = ["bench" + ".py", "BENCH" + "_", "MULTICHIP" + "_",
               "BASELINE" + ".json"]
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|vps_tpu)\b"
                     + "|" + "|".join(re.escape(r) for r in records), re.M)
    prog = re.compile(r"^\s*(import|from)\s+vps_torch\b", re.M)
    for root, _, files in os.walk(run.HERE):
        if "_cache" in root:
            continue
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                text = f.read()
            assert not bad.search(text), path
            if os.sep + "reference" + os.sep in path + os.sep:
                assert not prog.search(text), path
