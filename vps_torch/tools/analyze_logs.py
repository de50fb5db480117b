"""Training-log analysis (the port's counterpart of the repo's
``tools/analyze_logs.py``): parses a ``train.log``, prints per-key stats and
optionally plots the curves.

    python -m vps_torch.tools.analyze_logs LOG [--keys loss loss_mask]
        [--out curves.png]

Reads both forms of the iteration line: the port's Runner writes
``Epoch [e][i] time: 0.500s (2.00 images/s over 1 rank(s)), loss: ...``,
the JAX package's runner ``Epoch [e][i] time: 0.500s, loss: ...``. The
parenthesised rate holds a parenthesis of its own (``rank(s)``), so the
pattern takes it whole, up to the ``), `` that ends it. ``--out`` plots
only where matplotlib imports, and says so otherwise.
"""

from __future__ import annotations

import argparse
import re
from collections import defaultdict

LINE_RE = re.compile(
    r"Epoch \[(\d+)\]\[(\d+)\] time: ([\d.]+)s(?: \(.*?\))?, (.*)")


def parse_log(path):
    """{key: [values]} over the log's iteration lines, in order: ``epoch``,
    ``iter``, ``time`` and every logged key, as the repo tool returns."""
    runs = defaultdict(list)
    with open(path) as f:
        for line in f:
            m = LINE_RE.search(line)
            if not m:
                continue
            epoch, it, t = int(m.group(1)), int(m.group(2)), float(m.group(3))
            runs["epoch"].append(epoch)
            runs["iter"].append(it)
            runs["time"].append(t)
            for kv in m.group(4).split(", "):
                k, v = kv.split(": ")
                runs[k].append(float(v))
    return runs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Analyze a train.log")
    p.add_argument("log")
    p.add_argument("--keys", nargs="+", default=["loss"])
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def main(argv=None):
    """Prints the repo tool's lines; returns ``parse_log``'s dict."""
    args = parse_args(argv)
    runs = parse_log(args.log)
    if not runs:
        print("no train iterations found")
        return runs
    n = len(runs["time"])
    print(f"{n} logged iterations, avg iter time {sum(runs['time']) / n:.3f}s")
    for k in args.keys:
        if k not in runs:
            print(f"{k}: not logged")
            continue
        v = runs[k]
        print(f"{k}: first {v[0]:.4f}  last {v[-1]:.4f}  min {min(v):.4f}")
    if args.out:
        try:
            import matplotlib
        except ImportError:
            print(f"matplotlib is not installed: {args.out} not written")
            return runs
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for k in args.keys:
            if k in runs:
                plt.plot(runs[k], label=k)
        plt.legend()
        plt.xlabel("logged step")
        plt.savefig(args.out)
        print(f"saved {args.out}")
    return runs


if __name__ == "__main__":
    main()
