"""Plot score-vs-latency curves from sparsity_sweep JSON files.

Counterpart of `wavelet_monodepth_tpu/tools/plot_sparsity_curve.py`,
with its panels, palette and styles; it reads the JSONs of both
packages' `tools/sparsity_sweep.py` (the JAX package's slope-measured
rows and the port's CUDA-event rows) into one figure. matplotlib is
imported when the plot is drawn, with the Agg backend.

Two panels, one x-axis each (never dual-axis):
  left  — the tradeoff itself: device ms/image vs score (abs_rel vs the
          sweep's GT when present, else abs_rel vs the dense decode),
          one line per (weights, mask family); points labeled with
          coefficient density
  right — the paper's axis: counted GFLOPs vs density

Color identifies the weight source (fixed assignment, never cycled);
line style identifies the mask family (solid = the decoder's own
thresholded coefficients, dashed = maskgen edge masks).

Usage:
  python -m wavelet_monodepth_tpu_torch.tools.plot_sparsity_curve \
      sparsity_curve.json [more.json ...] --out curve.png
"""

from __future__ import annotations

import argparse
import json

# fixed categorical assignment by weight source (validated palette)
_COLORS = {"random": "#2a78d6", "synthetic": "#eb6834",
           "torch": "#1baf7a"}
_FALLBACK = "#eda100"
_STYLE = {"threshold": "-", "edge": "--"}

_TEXT = "#0b0b0b"
_MUTED = "#52514e"
_GRID = "#e4e3df"


def _score_key(rows):
    return ("abs_rel_vs_gt" if any("abs_rel_vs_gt" in r for r in rows)
            else "abs_rel_vs_dense")


def _series(rows):
    """Group rows into ((weights, family) -> sorted rows)."""
    out = {}
    for r in rows:
        if r["mask_family"] == "dense":
            continue
        out.setdefault((r["weights"], r["mask_family"]), []).append(r)
    for v in out.values():
        v.sort(key=lambda r: r["density"])
    return out


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="plot sparsity sweep curves")
    p.add_argument("jsons", nargs="+")
    p.add_argument("--out", type=str, default="sparsity_curve.png")
    args = p.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows, meta = [], None
    for path in args.jsons:
        with open(path) as f:
            data = json.load(f)
        rows += data["rows"]
        meta = meta or data.get("meta", {})

    # rows whose timing could not be trusted carry latency_unreliable
    # (the JAX sweep's slope retries gave up, or the port's windows kept
    # spreading): never plot a missing, negative or NaN latency
    bad = [r for r in rows
           if r.get("latency_unreliable") or r.get("ms_per_image") is None
           or not r["ms_per_image"] > 0]
    if bad:
        print(f"dropping {len(bad)} row(s) with unreliable latency "
              "(latency_unreliable / non-positive slope)")
        rows = [r for r in rows if r not in bad]

    skey = _score_key(rows)
    dense = {r["weights"]: r for r in rows if r["mask_family"] == "dense"}

    fig, (ax1, ax2) = plt.subplots(
        1, 2, figsize=(11, 4.4), facecolor="#fcfcfb")
    for ax in (ax1, ax2):
        ax.set_facecolor("#fcfcfb")
        ax.grid(True, color=_GRID, linewidth=0.8)
        ax.set_axisbelow(True)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
        for s in ("left", "bottom"):
            ax.spines[s].set_color(_MUTED)
        ax.tick_params(colors=_MUTED, labelsize=9)

    for (src, fam), srows in sorted(_series(rows).items()):
        c = _COLORS.get(src, _FALLBACK)
        xs = [r["ms_per_image"] for r in srows]
        ys = [r.get(skey, float("nan")) for r in srows]
        ax1.plot(xs, ys, _STYLE.get(fam, "-"), color=c, linewidth=2,
                 marker="o", markersize=5,
                 label=f"{src} / {fam} masks")
        for r in srows:
            ax1.annotate(f"{r['density']:.2f}",
                         (r["ms_per_image"], r.get(skey, float("nan"))),
                         textcoords="offset points", xytext=(4, 4),
                         fontsize=7.5, color=_MUTED)
        ax2.plot([r["density"] for r in srows],
                 [r["gflops"] for r in srows],
                 _STYLE.get(fam, "-"), color=c, linewidth=2,
                 marker="o", markersize=5)

    for src, r in dense.items():
        c = _COLORS.get(src, _FALLBACK)
        ax1.axvline(r["ms_per_image"], color=c, linewidth=1, alpha=0.45)
        if skey in r:
            ax1.plot([r["ms_per_image"]], [r[skey]], "s", color=c,
                     markersize=6)
        ax2.plot([1.0], [r["gflops"]], "s", color=c, markersize=6)

    ax1.set_xlabel("device ms / image (" + (meta or {}).get(
        "measurement", "slope-measured").split(":")[0].split(" (")[0]
        + ")", color=_TEXT)
    ax1.set_ylabel({"abs_rel_vs_gt": "abs_rel vs GT disparity",
                    "abs_rel_vs_dense": "abs_rel vs dense decode"}[skey],
                   color=_TEXT)
    ax1.set_title("score vs latency (labels: coefficient density; "
                  "squares: dense)", fontsize=10, color=_TEXT)
    ax1.legend(fontsize=8.5, frameon=False, labelcolor=_TEXT)
    ax2.set_xlabel("aggregate coefficient density", color=_TEXT)
    ax2.set_ylabel("counted GFLOPs / image", color=_TEXT)
    ax2.set_title("the paper's axis: compute vs density",
                  fontsize=10, color=_TEXT)

    if meta:
        fig.suptitle(
            f"{meta.get('model', '')}  {tuple(meta.get('shape', ()))}  "
            f"{meta.get('dtype', '')}  —  {meta.get('device', '')}",
            fontsize=9, color=_MUTED)
    fig.tight_layout(rect=(0, 0, 1, 0.94))
    fig.savefig(args.out, dpi=160)
    plt.close(fig)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
