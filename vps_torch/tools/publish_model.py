"""Strip the optimizer state from a checkpoint and append a content hash
(the port's counterpart of the repo's ``tools/publish_model.py``).

    python -m vps_torch.tools.publish_model IN_CKPT OUT_DIR

Loads a port checkpoint (``vps_torch.utils.checkpoint``), saves its
``state_dict`` alone, without ``opt_state``, with the meta ``published=True``
and the source path, then renames it after the first 8 hex digits of a
sha256 over the saved tensors' bytes, in key order, and writes
``OUT_DIR/latest.txt`` naming it. The digest goes before the suffix,
``ckpt_0-1a2b3c4d.pth``, as the reference mmdet names a published model
(the JAX tool appends it after the name of its checkpoint directory). The
same weights always give the same name.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import os.path as osp

import torch

from vps_torch.utils.checkpoint import load_checkpoint


def digest(state_dict) -> str:
    """The first 8 hex digits of a sha256 over the tensors' bytes, in key
    order."""
    h = hashlib.sha256()
    for key in state_dict:
        t = state_dict[key]
        if torch.is_tensor(t):
            # bytes of any dtype (bfloat16 has no numpy counterpart)
            h.update(t.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
    return h.hexdigest()[:8]


def publish(in_ckpt: str, out_dir: str) -> str:
    """Returns the published file's path. Written beside ``save_checkpoint``'s
    files, not through it: its clean-up reads ``ckpt_<step>.pth`` names
    only."""
    state_dict = load_checkpoint(in_ckpt)["state_dict"]
    out_dir = osp.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    final = osp.join(out_dir, f"ckpt_0-{digest(state_dict)}.pth")
    torch.save({"state_dict": state_dict}, final + ".tmp")
    os.replace(final + ".tmp", final)
    with open(final + ".meta.json", "w") as f:
        json.dump({"published": "True", "source": in_ckpt}, f)
    with open(osp.join(out_dir, "latest.txt"), "w") as f:
        f.write(osp.basename(final))
    print(f"published {final}")
    return final


def main(argv=None):
    p = argparse.ArgumentParser(description="Publish a checkpoint")
    p.add_argument("in_ckpt")
    p.add_argument("out_dir")
    args = p.parse_args(argv)
    return publish(args.in_ckpt, args.out_dir)


if __name__ == "__main__":
    main()
