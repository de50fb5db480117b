"""The repo's ``tools/`` scripts as modules, for the port's tests to hold
the port's tools against: ``tool("coco_eval")`` loads ``tools/coco_eval.py``
(``tool("convert_datasets/pascal_voc")`` a converter) once, and
``run_tool(name, argv)`` calls its ``main()`` with ``sys.argv`` patched.
The scripts read their arguments from ``sys.argv`` and print their
numbers."""

import importlib.util
import sys
from pathlib import Path

TOOLS = Path(__file__).resolve().parents[1] / "tools"
_LOADED = {}


def tool(name):
    if name not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            "repo_tool_" + name.replace("/", "_"), TOOLS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[name] = mod
    return _LOADED[name]


def run_tool(name, argv):
    """``tools/<name>.py``'s main() with ``argv`` as its arguments; returns
    what main returns."""
    old = sys.argv
    sys.argv = [str(TOOLS / f"{name}.py")] + [str(a) for a in argv]
    try:
        return tool(name).main()
    finally:
        sys.argv = old
