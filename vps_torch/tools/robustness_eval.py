"""The corruption benchmark's summary of a ``robustness.json`` written by
``vps_torch.tools.test_robustness`` (the port's counterpart of the repo's
``tools/robustness_eval.py``):

- P   -- the performance on clean data;
- mPC -- the mean performance under corruption (over corruptions, each the
         mean over its severities);
- rPC -- the relative performance under corruption, mPC / P.

    python -m vps_torch.tools.robustness_eval OUT/robustness.json
        [--metric bbox_mAP] [--prints P mPC rPC]
"""

from __future__ import annotations

import argparse
import json
import re
from collections import defaultdict


def aggregate(report: dict, metric: str = "bbox_mAP"):
    """dict(P, mPC, rPC, per_corruption) of a report keyed "clean" and
    "<corruption>_s<severity>"."""
    clean = report.get("clean")
    if clean is None or metric not in clean:
        raise KeyError(f"report has no clean run with metric {metric!r}; "
                       f"keys: {sorted(report)}")
    p = float(clean[metric])
    by_corruption = defaultdict(list)
    for key, stats in report.items():
        m = re.match(r"(.+)_s(\d+)$", key)
        if not m or metric not in stats:
            continue
        by_corruption[m.group(1)].append(float(stats[metric]))
    if not by_corruption:
        raise ValueError("no corruption runs in report")
    per_corruption = {c: sum(v) / len(v) for c, v in sorted(by_corruption.items())}
    mpc = sum(per_corruption.values()) / len(per_corruption)
    rpc = mpc / p if p > 0 else 0.0
    return dict(P=p, mPC=mpc, rPC=rpc, per_corruption=per_corruption)


def main(argv=None):
    """Prints the summary and its JSON; returns ``aggregate``'s dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("report", help="robustness.json from test_robustness")
    ap.add_argument("--metric", default="bbox_mAP")
    ap.add_argument("--prints", nargs="+", default=["P", "mPC", "rPC"],
                    choices=["P", "mPC", "rPC"])
    args = ap.parse_args(argv)
    with open(args.report) as f:
        out = aggregate(json.load(f), args.metric)
    if "P" in args.prints:
        print(f"Performance on Clean Data [P] ({args.metric})")
        print(f"  {args.metric:10} = {out['P']:.3f}")
    if "mPC" in args.prints:
        print(f"Mean Performance under Corruption [mPC] ({args.metric})")
        for c, v in out["per_corruption"].items():
            print(f"  {c:20} = {v:.3f}")
        print(f"  {args.metric:10} = {out['mPC']:.3f}")
    if "rPC" in args.prints:
        print(f"Relative Performance under Corruption [rPC] ({args.metric})")
        print(f"  {args.metric:10} => {out['rPC'] * 100:.1f} %")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
