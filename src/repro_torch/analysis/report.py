"""The dry-run and roofline tables from the recorded dry-run JSONs.

Port of ``repro.analysis.report``:

    PYTHONPATH=src python -m repro_torch.analysis.report experiments/dryrun

Memory is per rank against the card's 80 GB; the roofline terms are
reckoned at the H100's published peaks (``analysis/roofline.py``), not
measured.
"""

from __future__ import annotations

import json
import os
import sys


def load(out_dir: str):
    recs = []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                recs.append(json.load(f))
    return recs


def dryrun_table(recs) -> str:
    lines = ["| mesh | arch | shape | status | GB/card | fits 80 GB | "
             "trace s |",
             "|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] == "OK":
            m = r["memory"]
            lines.append(
                f"| {r['mesh']} | {r['arch']} | {r['shape']} | OK | "
                f"{m['total_per_chip_gb']:.2f} | "
                f"{'yes' if m['fits'] else '**no**'} | {r['trace_s']} |")
        elif r["status"] == "SKIP":
            lines.append(f"| {r['mesh']} | {r['arch']} | {r['shape']} | "
                         f"SKIP | — | — | — |")
        else:
            lines.append(f"| {r['mesh']} | {r['arch']} | {r['shape']} | "
                         f"**FAIL** | — | — | — |")
    return "\n".join(lines)


def roofline_table(recs, mesh="pod16x16") -> str:
    lines = ["| arch | shape | compute s | memory s | coll s | dominant | "
             "useful/traced | peak frac | GB/card | mult |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] != "OK" or r["mesh"] != mesh:
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.2f} | "
            f"{rf['memory_s']:.2f} | {rf['collective_s']:.3f} | "
            f"**{rf['dominant']}** | {rf['useful_flops_ratio']:.2f} | "
            f"{rf['peak_fraction']:.2%} | "
            f"{r['memory']['total_per_chip_gb']:.2f} | "
            f"{rf['scan_multiplier']:.0f} |")
    return "\n".join(lines)


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun"
    recs = load(out_dir)
    ok = sum(r["status"] == "OK" for r in recs)
    skip = sum(r["status"] == "SKIP" for r in recs)
    fail = sum(r["status"] == "FAIL" for r in recs)
    print(f"## cells: {ok} OK, {skip} SKIP, {fail} FAIL\n")
    print("### Dry-run (per rank; H100 80 GB)\n")
    print(dryrun_table(recs))
    print("\n### Roofline (single pod, 16x16; reckoned at published "
          "H100 peaks)\n")
    print(roofline_table(recs, "pod16x16"))
    print("\n### Roofline (multi-pod, 2x16x16; reckoned at published "
          "H100 peaks)\n")
    print(roofline_table(recs, "pod2x16x16"))


if __name__ == "__main__":
    main()
