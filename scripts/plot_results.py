"""Render the docs/plots/ figures from benchmarks/results/ JSONL.

The reference repo ships thesis plots generated by small Python helpers
(SURVEY.md §1.1); this is that component here — regenerate with
`python scripts/plot_results.py` after refreshing the results files.

Two figures:
  quality_gain.png   — denoising quality before/after the round-3
                       bandwidth calibration (PSNR vs the clean image)
  motion_guide.png   — temporal basis reuse vs motion (motion_guide.jsonl)

Colors/typography follow a validated palette (fixed categorical order,
single-hue magnitude, neutral grid); values are labeled directly where a
reader would otherwise have to interpolate.
"""

import json
import pathlib
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "docs" / "plots"
RESULTS = ROOT / "benchmarks" / "results"

# palette roles (light mode)
SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT2 = "#52514e"
GRID = "#e4e3df"
S1, S2, S3 = "#2a78d6", "#eb6834", "#1baf7a"   # fixed categorical order


def _style(ax, title):
    ax.set_facecolor(SURFACE)
    ax.figure.set_facecolor(SURFACE)
    ax.set_title(title, color=TEXT, fontsize=11, loc="left", pad=12)
    ax.tick_params(colors=TEXT2, labelsize=8.5)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(GRID)
    ax.grid(True, axis="x", color=GRID, linewidth=0.6)
    ax.set_axisbelow(True)


def quality_gain():
    rows = [  # (config, noisy input, round-2 defaults, round-3 tuned)
        ("cfg1 128² bilateral", 20.25, 20.34, 25.36),
        ("cfg2 512² NLM", 20.23, 22.77, 26.72),
    ]
    fig, ax = plt.subplots(figsize=(7.2, 2.9), dpi=160)
    for i, (name, noisy, r2, r3) in enumerate(rows):
        y = len(rows) - 1 - i
        ax.plot([noisy, r3], [y, y], color=GRID, linewidth=2, zorder=2)
        ax.scatter([noisy], [y], s=46, color=TEXT2, zorder=3)
        ax.scatter([r2], [y], s=46, color=S2, zorder=3)
        ax.scatter([r3], [y], s=46, color=S1, zorder=3)
        ax.text(r3 + 0.25, y, f"{r3:.1f} dB", va="center", color=TEXT,
                fontsize=8.5)
    ax.set_yticks(range(len(rows)), [r[0] for r in rows[::-1]])
    ax.set_xlabel("PSNR vs clean image, dB (σ=0.1)", color=TEXT2, fontsize=9)
    ax.set_xlim(19.2, 28.5)
    # legend: 3 series → legend box, muted text
    for col, lab in ((TEXT2, "noisy input"), (S2, "round-2 defaults"),
                     (S1, "tuned (h=2σ bilateral / 1.5σ NLM)")):
        ax.scatter([], [], s=40, color=col, label=lab)
    ax.legend(loc="upper center", bbox_to_anchor=(0.5, -0.32),
              frameon=False, fontsize=8, labelcolor=TEXT2, ncols=3,
              handletextpad=0.2)
    _style(ax, "Denoising quality: measured bandwidth calibration")
    fig.tight_layout()
    fig.savefig(OUT / "quality_gain.png", facecolor=SURFACE)
    plt.close(fig)


def motion_guide():
    path = RESULTS / "motion_guide.jsonl"
    if not path.exists():
        return
    rows = [json.loads(l) for l in path.open()]
    rows = [r for r in rows if r.get("kind") == "motion_guide"]
    if not rows:
        return
    fig, ax = plt.subplots(figsize=(7.2, 3.6), dpi=160)
    ks = sorted({int(k.rstrip("r")) for r in rows for k in r["by_k"]})
    colors = {1: TEXT2, 2: S1, 4: S2, 8: S3}
    for k in ks:
        if k == 1:
            continue
        for reg in (False, True):
            key = f"{k}r" if reg else str(k)
            vs = sorted((r["v_px_per_frame"],
                         r["by_k"][key] - r["by_k"]["1"]) for r in rows
                        if key in r["by_k"])
            if not vs:
                continue
            ax.plot([v for v, _ in vs], [d for _, d in vs], marker="o",
                    markersize=4, linewidth=1.6, color=colors.get(k, S1),
                    linestyle=(0, (4, 2)) if reg else "-",
                    label=f"k={k}" + (" registered" if reg else ""),
                    zorder=3)
    ax.axhline(0.0, color=TEXT2, linewidth=1, linestyle=(0, (4, 3)))
    ax.text(2.6, 0.12, "per-frame bases (k=1)", color=TEXT2, fontsize=8)
    ax.set_xlabel("motion, px/frame (64², 8 frames, σ=0.1)",
                  color=TEXT2, fontsize=9)
    ax.set_ylabel("PSNR vs per-frame bases, dB", color=TEXT2, fontsize=9)
    ax.grid(True, axis="y", color=GRID, linewidth=0.6)
    ax.legend(loc="lower left", frameon=False, fontsize=7.5,
              labelcolor=TEXT2, ncols=2)
    _style(ax, "Temporal basis reuse vs motion: registration extends\n"
               "the ~0.5–1 px boundary ~8× (content change then limits)")
    fig.tight_layout()
    fig.savefig(OUT / "motion_guide.png", facecolor=SURFACE)
    plt.close(fig)


if __name__ == "__main__":
    OUT.mkdir(parents=True, exist_ok=True)
    quality_gain()
    motion_guide()
    print("wrote", *(p.name for p in sorted(OUT.glob("*.png"))),
          file=sys.stderr)
