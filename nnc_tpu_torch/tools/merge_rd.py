"""Merge RD-sweep outputs into the repo's rd_results.json artifact.

Counterpart of ``tools/merge_rd.py``, record for record.
``nnc_tpu_torch.tools.rd_sweep`` (like ``tools/rd_sweep.py``) writes one
rd_results.json per output dir; rounds accumulate points at different
tuning budgets. This merges any number of sweep outputs into the tracked
artifact deterministically: records are keyed by (qp, lsa, lsa_iters,
epochs, mode, scene), later inputs win, output is sorted. Records missing
the budget fields (early sweeps) are normalized to the old defaults (500
iters x 1 epoch). run_dir records each point's provenance.

Usage:
    python -m nnc_tpu_torch.tools.merge_rd rd_runs/rd_results.json ... \
        [--into rd_results.json]
"""
import argparse
import json
import os


def normalize(rec):
    rec = dict(rec)
    rec.setdefault("lsa_iters", 500)
    rec.setdefault("epochs", 1)
    rec.setdefault("mode", "flat")  # pre-r4b records: flat global QP
    rec.setdefault("scene", "synthetic")  # pre-r5 sweeps: one scene only
    return rec


def key_of(rec):
    return (int(rec["qp"]), bool(rec["lsa"]), int(rec["lsa_iters"]),
            int(rec["epochs"]), str(rec["mode"]), str(rec["scene"]))


def merge(base, inputs):
    merged = {key_of(r): r for r in map(normalize, base)}
    for recs in inputs:
        for r in map(normalize, recs):
            merged[key_of(r)] = r
    return sorted(merged.values(),
                  key=lambda r: (r["lsa_iters"] * r["epochs"], r["mode"],
                                 r["qp"], r["lsa"]))


def load(path):
    # accept either the json file or a sweep output dir containing it
    if os.path.isdir(path):
        path = os.path.join(path, "rd_results.json")
    with open(path) as f:
        recs = json.load(f)
    if not isinstance(recs, list):
        raise ValueError(f"{path}: expected a list of RD records")
    return recs


def plot(results, out_path):
    """One RD curve per (mode, lsa, budget) series; budgets get line
    styles so the 500-iter regression points and production points read
    apart, and the IOQ per-tensor-QP series gets its own color."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    budgets = sorted({(r["lsa_iters"], r["epochs"]) for r in results})
    styles = ["--", "-", "-.", ":"]
    fig, ax = plt.subplots(figsize=(7, 5))
    for bi, (it, ep) in enumerate(budgets):
        for mode, lsa, color in (("flat", False, "C0"),
                                 ("flat", True, "C1"),
                                 ("ioq", False, "C2"),
                                 ("ioq", True, "C3")):
            pts = sorted((r["bytes"] / 1024, r["psnr"]) for r in results
                         if r["lsa"] == lsa and r["mode"] == mode
                         and (r["lsa_iters"], r["epochs"]) == (it, ep))
            if pts:
                label = f"LSA {'on' if lsa else 'off'}, {it}x{ep} iters"
                if mode == "ioq":
                    label = "IOQ, " + label
                ax.plot(*zip(*pts), marker="o",
                        linestyle=styles[bi % len(styles)],
                        color=color, label=label)
    ax.set_xlabel("bitstream size (KiB)")
    ax.set_ylabel("test PSNR (dB)")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    print(f"saved {out_path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs", nargs="+",
                    help="rd_results.json files or sweep output dirs")
    ap.add_argument("--into", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "rd_results.json"))
    ap.add_argument("--plot", default=None, metavar="PNG",
                    help="also render the merged RD curves to this file")
    args = ap.parse_args(argv)

    base = load(args.into) if os.path.exists(args.into) else []
    out = merge(base, [load(p) for p in args.inputs])
    with open(args.into, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"{args.into}: {len(out)} records "
          f"({len(base)} existing + {len(out) - len(base)} new)")
    if args.plot:
        plot(out, args.plot)


if __name__ == "__main__":
    main()
