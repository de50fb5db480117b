"""Checkpoints (port of vps_tpu/utils/checkpoint.py: ``save_checkpoint``,
``_gc``, ``latest_checkpoint``, ``load_checkpoint`` and
``_check_tree_compat``). ``load_from`` is a weights-only warm start,
``resume_from`` weights + optimizer + epoch, as in mmdet.

Format: ``ckpt_<step>.pth``, a ``torch.save`` of {"state_dict": the model's
state_dict under the mmdet names, "opt_state": the optimizer's state}, with
``ckpt_<step>.pth.meta.json`` beside it and ``latest.txt`` naming the newest.
The state_dict loads into the JAX package through its
``convert_detector``.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
from typing import Any, Dict, Optional

import torch


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_checkpoint(work_dir: str, step: int, state_dict, opt_state=None,
                    meta: Optional[Dict[str, Any]] = None, keep: int = 5) -> str:
    work_dir = osp.abspath(work_dir)
    os.makedirs(work_dir, exist_ok=True)
    path = osp.join(work_dir, f"ckpt_{step}.pth")
    payload = {"state_dict": _to_cpu(dict(state_dict))}
    if opt_state is not None:
        payload["opt_state"] = _to_cpu(opt_state)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump({k: str(v) for k, v in meta.items()}, f)
    with open(osp.join(work_dir, "latest.txt"), "w") as f:
        f.write(osp.basename(path))
    _gc(work_dir, keep)
    return path


def _gc(work_dir: str, keep: int) -> None:
    """Keep the ``keep`` newest checkpoints (and their meta files)."""
    ckpts = sorted((d for d in os.listdir(work_dir)
                    if d.startswith("ckpt_") and d.endswith(".pth")),
                   key=lambda d: int(d[len("ckpt_"):-len(".pth")]))
    for d in ckpts[:-keep]:
        for f in (d, d + ".meta.json"):
            if osp.exists(osp.join(work_dir, f)):
                os.remove(osp.join(work_dir, f))


def latest_checkpoint(work_dir: str) -> Optional[str]:
    latest = osp.join(osp.abspath(work_dir), "latest.txt")
    if not osp.exists(latest):
        return None
    with open(latest) as f:
        return osp.join(osp.abspath(work_dir), f.read().strip())


def load_checkpoint(path: str, target: Optional[Dict[str, Any]] = None):
    """Restore a checkpoint (on the CPU). ``target``: a dict of like-shaped
    templates ("state_dict", "opt_state"); None returns it as saved.

    Lenient at the top level: a key absent from the checkpoint keeps the
    template's value (a weights-only checkpoint restores into a training
    template), as mmdet's load_checkpoint(strict=False). Within a key, a
    checkpoint of another model raises (``_check_tree_compat``)."""
    raw = torch.load(osp.abspath(path), map_location="cpu", weights_only=True)
    if target is None:
        return raw
    out = dict(target)
    fallback = []
    for k in target:
        if raw.get(k) is not None:
            _check_tree_compat(k, raw[k], target[k])
            out[k] = raw[k]
        else:
            fallback.append(k)
    if fallback:
        logging.getLogger("vps_torch").warning(
            "load_checkpoint(%s): keys %s absent from the checkpoint; keeping "
            "the template's values", path, fallback)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _check_tree_compat(key: str, restored, template) -> None:
    """A checkpoint of another model must not load silently: the restored
    entries must have the template's names and shapes (an empty template
    accepts anything)."""
    t = dict(_flat(template))
    if not t:
        return
    r = dict(_flat(restored))
    if set(r) != set(t):
        missing, extra = sorted(set(t) - set(r)), sorted(set(r) - set(t))
        raise ValueError(f"load_checkpoint: '{key}' does not match the target "
                         f"model: missing {missing[:5]}, unexpected {extra[:5]}")
    for name, tv in t.items():
        rs = tuple(r[name].shape) if torch.is_tensor(r[name]) else ()
        ts = tuple(tv.shape) if torch.is_tensor(tv) else ()
        if rs != ts:
            raise ValueError(f"load_checkpoint: shape mismatch in '{key}' at "
                             f"{name}: restored {rs} vs target {ts}")
