"""Plot training/testing curves from a trainer log (reference:
python/paddle/utils/plotcurve.py — same CLI shape: keys of scores to
plot, stdin→png).  Understands both this repo's trainer lines
("Pass 0, Batch 12, Cost 0.531", "Eval: classification_error=0.21",
"Test done ... cost 0.4") and reference-style "Pass=0 ... AvgCost=..."
lines.

usage: python -m paddle_tpu_torch.utils.plotcurve [-i LOG] [-o OUT.png] [key ...]
"""

import argparse
import re
import sys

_REPO_BATCH = re.compile(r"Pass (\d+), Batch (\d+), Cost ([0-9eE+\-.]+)")
_REPO_EVAL = re.compile(r"Eval: ([\w.]+)=([0-9eE+\-.]+)")
_REPO_TEST = re.compile(r"Test .*cost ([0-9eE+\-.]+)")
_REF_PASS = re.compile(r"Pass=(\d+)")


def parse_log(lines, keys=None):
    """→ {series_name: [values...]} in log order."""
    keys = list(keys or [])
    series: dict = {}

    def add(name, val):
        series.setdefault(name, []).append(float(val))

    for line in lines:
        m = _REPO_BATCH.search(line)
        if m:
            add("Cost", m.group(3))
        for name, val in _REPO_EVAL.findall(line):
            add(name, val)
        m = _REPO_TEST.search(line)
        if m:
            add("TestCost", m.group(1))
        m = _REF_PASS.search(line)
        if m:
            for k in keys or ("AvgCost",):
                km = re.search(r"%s=([0-9eE+\-.]+)" % re.escape(k), line)
                if km:
                    add(k, km.group(1))
    if keys:
        series = {k: v for k, v in series.items() if k in keys or
                  k in ("Cost", "TestCost")}
    return series


def plotcurve(lines, output=None, keys=None):
    series = parse_log(lines, keys)
    if output:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 5))
        for name, vals in series.items():
            ax.plot(range(len(vals)), vals, label=name)
        ax.set_xlabel("record")
        ax.set_ylabel("value")
        ax.legend()
        fig.savefig(output)
        plt.close(fig)
    return series


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Plot training and testing curves from a trainer "
                    "log file.")
    p.add_argument("-i", "--input", default=None,
                   help="log file (default: stdin)")
    p.add_argument("-o", "--output", default=None,
                   help="output figure (.png); omit for a text summary")
    p.add_argument("key", nargs="*", help="score keys to plot")
    a = p.parse_args(argv)
    lines = (open(a.input).readlines() if a.input
             else sys.stdin.readlines())
    series = plotcurve(lines, a.output, a.key)
    if not a.output:
        for name, vals in series.items():
            print(f"{name}: n={len(vals)} first={vals[0]:.6g} "
                  f"last={vals[-1]:.6g} min={min(vals):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
