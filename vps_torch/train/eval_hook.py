"""Train-time validation hook (port of vps_tpu/train/eval_hook.py, one
process): after an epoch, the validation videos run frame by frame through
the detector's per-frame carry (``make_frame_step``), in order, and an
``evaluate`` callable turns the per-frame outputs into metrics. The rank
sharding and the file exchange between hosts wait for the distributed port.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from vps_torch.models.detectors import make_frame_step


def make_video_eval_hook(
    detector,
    dataset,
    track_cap: int = 256,
    evaluate: Optional[Callable] = None,
    keep_keys=("panoptic_outputs", "fcn_outputs", "num_keep"),
):
    """Returns eval_fn(state, epoch) -> metrics dict for Runner(eval_fn=...).

    ``evaluate(results, epoch)`` receives {frame_id: {key: np.ndarray}} and
    returns a metrics dict. Default: the fraction of frames with any
    detection, a smoke-level metric; pass a VPQ-backed callable for real
    validation.
    """

    def eval_fn(state, epoch: int) -> Dict[str, float]:
        step = make_frame_step(detector, track_cap=track_cap)
        results: Dict[object, Dict[str, np.ndarray]] = {}
        for idx in range(len(dataset)):
            img, ref_img, meta = dataset.prepare_test(idx)
            outputs = step(img, ref_img, meta["is_first"])
            results[meta["iid"]] = {k: outputs[k].cpu().numpy()
                                    for k in keep_keys if k in outputs}
        if evaluate is not None:
            return evaluate(results, epoch)
        if not results:
            return {"eval_frames": 0.0}
        det_frac = float(np.mean([
            float(r.get("num_keep", 0)) > 0 for r in results.values()
        ]))
        return {"eval_frames": float(len(results)),
                "eval_det_frac": det_frac}

    return eval_fn
