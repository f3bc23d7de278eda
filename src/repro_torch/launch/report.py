"""Render the dry run's JSON (``launch.dryrun --out``) into its two tables:
every cell's counts, then the three roofline terms a cell.

The JAX package's ``launch/report.py`` over the port's records: the counts
are one rank's on the ``meta`` device (FLOPs of the matmuls, op-level
bytes, collective bytes on the wire, the rank's exact state bytes), and the
roofline terms are priced at an H100's rates.

Usage:
  python -m repro_torch.launch.report dryrun.json > tables.md
"""

from __future__ import annotations

import json
import sys

from repro_torch.launch.dryrun import HBM_BW, LINK_BW, PEAK_FLOPS

__all__ = ["render", "main"]


def _f(x: float) -> str:
    if x == 0:
        return "0"
    if x >= 1e4 or x < 1e-3:
        return f"{x:.2e}"
    return f"{x:.3f}"


def render(path: str) -> str:
    with open(path) as f:
        data = json.load(f)
    recs = data["records"]
    fails = data.get("failures", [])
    out = ["### Dry run: one rank's step on the meta device, every (arch × shape × mesh)\n",
           f"**{len(recs)} cells run, {len(fails)} failures.** Single-pod mesh 16×16 (256 "
           "devices), multi-pod 2×16×16 (512). Counts are one rank's, the larger of "
           "positions 0 and tp − 1: FLOPs of the matmuls (FlopCounterMode; masked-dense, "
           "so DAS does not discount them), op-level bytes (each aten op's inputs and "
           "outputs: an upper bound on HBM traffic, not a measurement), collective bytes "
           "on the wire (an all-reduce 2× its operand), and the rank's exact state "
           "(params + ZeRO-1 moment slices + step for train; packed serving weights + "
           "caches for serving). Every layer is counted (no scan). `build s` / `run s` "
           "are host seconds of the meta build and run.\n",
           "| arch | shape | mesh | flops/dev | op bytes/dev | coll B/dev | "
           "state GiB/dev | build s | run s |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {_f(r['flops_per_dev'])} | "
            f"{_f(r['bytes_per_dev'])} | {_f(r['collective_bytes_per_dev'])} | "
            f"{r['state_bytes_per_dev'] / 2**30:.2f} | {r['lower_s']} | {r['compile_s']} |")
    if fails:
        out.append(f"\n**Failures ({len(fails)}):**\n")
        for a, s, mp, e in fails:
            out.append(f"- {a} × {s} multi_pod={mp}: `{e[:160]}`")

    out.append(f"""
### Roofline: three terms a cell (single pod, one training or serving step)

Rates: {PEAK_FLOPS / 1e12:.0f} TFLOP/s dense bf16 and {HBM_BW / 1e12:.2f} TB/s HBM3 a GPU
(an H100 SXM5's data sheet, core/perfmodel.py `H100_SXM`), {LINK_BW / 1e9:.0f} GB/s a GPU
between nodes (InfiniBand NDR, 400 Gb/s: a 16-way "model" axis spans two 8-GPU
nodes). The terms are **workload-intrinsic** (launch/analytic.py), because op-level
bytes count every op's operands, fused or not; the counted columns above
cross-check magnitudes. `roofline%` = t_compute / max(terms). `MODEL_FLOPS` = 6·N·D
(train) / 2·N_active·D (serve); `useful/counted` = MODEL_FLOPS / (counted FLOPs ×
devices): how much of the counted compute is model math (remat's recompute and
the work every "model" rank repeats show here).
""")
    out.append("| arch | shape | t_compute | t_memory | t_collective | dominant | roofline% | "
               "MODEL_FLOPS | useful/counted |")
    out.append("|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r["mesh"] != "16x16" or "a_t_compute" not in r:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {_f(r['a_t_compute'])} | {_f(r['a_t_memory'])} | "
            f"{_f(r['a_t_collective'])} | **{r['a_dominant']}** | {r['roofline_frac']:.1%} | "
            f"{_f(r['model_flops'])} | {r['useful_flops_frac']:.1%} |")
    return "\n".join(out)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python -m repro_torch.launch.report DRYRUN.json", file=sys.stderr)
        return 2
    print(render(args[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
