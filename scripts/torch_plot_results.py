#!/usr/bin/env python3
"""Results plotting for the port: the reference tests/clipFigures.py equivalent.

The counterpart of ``scripts/plot_results.py``, the port's own copy. The
reference hardcodes measured checkpoint numbers and regenerates the README
comparison figures (clipFigures.py:1-75: ImageNet top-1/top-5 bars and the
STS-per-dataset chart for Mixer vs Transformer). This script renders the
same two figures from a results JSON so any pair of runs can be compared:

  python scripts/torch_plot_results.py --results results.json --out figures/

``--metrics outputs/<run>/runs/metrics.jsonl`` additionally renders the
training curves of a port run (every scalar that ``train/metrics.py``'s
``MetricsWriter`` wrote as ``{"step", "name", "value"}``: Loss, Gradient
norm, Throughput, validator scalars; one subplot each).

results.json format (numbers are percentages / SRCC):
{
  "models": ["Mixer", "Transformer"],
  "imagenet": {"top1": [11.76, 2.38], "top5": [24.89, 7.59]},
  "sts": {"sick": [0.60, 0.62], "sts12": [0.44, 0.46], ...}
}

The reference's step-16k numbers above (clipFigures.py:40-43) are the default
when --results is omitted, reproducing the README figures. It runs on the
host only (matplotlib, Agg) and touches no card.
"""

import argparse
import json
import os

REFERENCE_RESULTS = {
    "models": ["Mixer", "Transformer"],
    # tests/clipFigures.py:40-41 (step 16k)
    "imagenet": {"top1": [11.76, 2.38], "top5": [24.89, 7.59]},
    # tests/clipFigures.py:42-43 (per-set SRCC cosine, step 16k averages to
    # 0.5040 / 0.5224)
    "sts": {
        "sick": [0.5539, 0.5795],
        "sts12": [0.4413, 0.4631],
        "sts13": [0.4691, 0.4866],
        "sts14": [0.4783, 0.4962],
        "sts15": [0.5519, 0.5700],
        "sts16": [0.5297, 0.5389],
    },
}


def plot_metrics_jsonl(path: str, out_dir: str, plt, np) -> str:
    """Training curves from the run's metrics.jsonl (train/metrics.py sink):
    one subplot per scalar name, step on x."""
    series = {}
    with open(path) as f:
        for line in f:
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                # a run killed mid-append (preemption/OOM — the very case
                # this post-mortem mode serves) leaves a truncated tail line
                if line.strip():
                    print(f"note: skipping malformed metrics line: {line[:60]!r}")
                continue
            series.setdefault(row["name"], []).append((row["step"], row["value"]))
    if not series:
        raise SystemExit(f"{path}: no scalars")
    names = sorted(series)
    fig, axes = plt.subplots(len(names), 1, figsize=(7, 2.2 * len(names)), sharex=True)
    axes = np.atleast_1d(axes)
    for ax, name in zip(axes, names):
        pts = sorted(series[name])
        ax.plot([s for s, _ in pts], [v for _, v in pts], lw=1.2)
        ax.set_ylabel(name, fontsize=8)
        ax.grid(True, alpha=0.3)
    axes[-1].set_xlabel("step")
    fig.tight_layout()
    out = os.path.join(out_dir, "training_curves.png")
    fig.savefig(out, dpi=150)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--results", default=None, help="results JSON (default: reference step-16k numbers)")
    p.add_argument("--metrics", default=None, help="a run's metrics.jsonl -> training_curves.png")
    p.add_argument("--out", default="figures")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    if args.metrics:
        os.makedirs(args.out, exist_ok=True)
        print(f"wrote {plot_metrics_jsonl(args.metrics, args.out, plt, np)}")
        if args.results is None:
            return

    results = REFERENCE_RESULTS if args.results is None else json.load(open(args.results))
    os.makedirs(args.out, exist_ok=True)
    models = results["models"]

    # Figure 1: ImageNet zero-shot accuracy (clipImagenet.png equivalent).
    fig, ax = plt.subplots(figsize=(6, 4))
    x = np.arange(2)
    width = 0.35
    for i, m in enumerate(models):
        vals = [results["imagenet"]["top1"][i], results["imagenet"]["top5"][i]]
        ax.bar(x + (i - 0.5) * width, vals, width, label=m)
    ax.set_xticks(x, ["Top-1", "Top-5"])
    ax.set_ylabel("ImageNetV2 zero-shot accuracy (%)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(args.out, "imagenet.png"), dpi=150)

    # Figure 2: STS SRCC per dataset (clipSTSCosine.png equivalent).
    fig, ax = plt.subplots(figsize=(7, 4))
    sets = list(results["sts"].keys())
    x = np.arange(len(sets))
    for i, m in enumerate(models):
        ax.bar(x + (i - 0.5) * width, [results["sts"][s][i] for s in sets], width, label=m)
    ax.set_xticks(x, sets, rotation=30)
    ax.set_ylabel("STS Spearman (cosine)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(args.out, "sts.png"), dpi=150)
    print(f"wrote {args.out}/imagenet.png and {args.out}/sts.png")


if __name__ == "__main__":
    main()
