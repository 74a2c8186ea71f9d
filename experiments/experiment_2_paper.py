"""Experiment 2 (paper variant): publication-format charts for the
end-to-end learning benchmark.

Counterpart of the reference's ``experiments/experiment_2_paper.py``,
which re-runs experiment 2 and renders its two paper figures as PDFs
(``images_paper/exp_2_dz_*.pdf`` cumulative-time bars and
``exp_2_conv_dz_*.pdf`` loss-convergence bands,
/root/reference/experiments/experiment_2_paper.py:103-126).  Here the
benchmark itself lives in ``experiment_2.py`` and writes
``exp2_results.json``; this script renders the paper figures from that
artifact (re-running the training loop just to change chart formatting
would double the capture cost for identical numbers).  Run
``experiment_2.py`` first — or pass ``--run`` to do both.

Run:  python experiments/experiment_2_paper.py [--run]
"""

import argparse
import json
import subprocess
import sys

sys.path.insert(0, ".")


def render(results_path="exp2_results.json"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    with open(results_path) as f:
        res = json.load(f)
    n_x = res["config"]["n_x"]
    losses = np.asarray(res["losses"], float)
    epochs = np.arange(len(losses))

    # Figure 1: cumulative training time (reference exp_2_dz_*.pdf) —
    # per-dispatch loop vs the fused one-dispatch horizon, with the
    # reference's published CPU number for context.
    fig, ax = plt.subplots(figsize=(4.2, 3.2))
    bars = {
        "ADMM (per-step)": res["total_time_s"],
        "ADMM (fused scan)": res["fused_total_s"],
        "reference CPU (ADMM)": 27.0,     # images/exp_2_n_500.png
        "reference CPU (OptNet)": 365.0,  # images/exp_2_n_500.png
    }
    ax.bar(range(len(bars)), list(bars.values()),
           color=["C0", "C0", "C7", "C7"])
    ax.set_yscale("log")
    ax.set_xticks(range(len(bars)))
    ax.set_xticklabels(list(bars.keys()), rotation=20, ha="right",
                       fontsize=7)
    ax.set_ylabel(f"training time, {len(losses)} epochs (s)")
    ax.set_title(f"Experiment 2, dz={n_x}")
    fig.tight_layout()
    fig.savefig(f"exp2_paper_time_dz_{n_x}.pdf")
    fig.savefig(f"exp2_paper_time_dz_{n_x}.png", dpi=120)

    # Figure 2: loss convergence (reference exp_2_conv_dz_*.pdf).  The
    # reference plots mean +/- 2 SE across sims; this run is a single
    # deterministic trajectory (fused == per-step is asserted by
    # experiment_2), so the band is the fused-vs-loop deviation bound.
    fig, ax = plt.subplots(figsize=(4.2, 3.2))
    ax.plot(epochs, losses, "C0", label="ADMM layer (JAX)")
    dev = float(res.get("fused_vs_loop_loss_dev", 0.0))
    ax.fill_between(epochs, losses - 2 * dev, losses + 2 * dev,
                    color="C0", alpha=0.25,
                    label="fused-dispatch agreement band")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(f"Experiment 2 convergence, dz={n_x}")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(f"exp2_paper_conv_dz_{n_x}.pdf")
    fig.savefig(f"exp2_paper_conv_dz_{n_x}.png", dpi=120)
    print(f"wrote exp2_paper_time_dz_{n_x}.(pdf|png), "
          f"exp2_paper_conv_dz_{n_x}.(pdf|png)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", action="store_true",
                    help="run experiment_2.py first")
    ap.add_argument("--results", default="exp2_results.json")
    args = ap.parse_args()
    if args.run:
        subprocess.run([sys.executable, "experiments/experiment_2.py"],
                       check=True)
    render(args.results)


if __name__ == "__main__":
    main()
