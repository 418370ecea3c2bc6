"""Render dryrun_report.json into markdown tables: the dry run's cells
and collectives, and each mesh's roofline.

The port of the reference's ``launch.report``; its headings name the
H100 meshes (32 hosts of 8 cards, and two such pods).  The tables are
predictions from the fake-card dry run, not measurements.

    PYTHONPATH=src python -m repro_torch.launch.report dryrun_report.json
"""
from __future__ import annotations

import json
import sys
from typing import List

SINGLE = "single pod (32×8 = 256 H100s, 32 hosts of 8)"
MULTI = "two pods (2×32×8 = 512 H100s)"


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def roofline_table(records: List[dict], mesh: str = "single") -> str:
    rows = ["| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | "
            "bound | 6ND/analytic | roofline frac | peak mem/chip |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "SKIP":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"SKIP | — | — | — |")
            continue
        if r["status"] != "OK":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"**FAIL** | — | — | — |")
            continue
        f = r["roofline"]
        mem = r.get("memory_analysis", {})
        peak = (mem.get("argument_size_in_bytes", 0)
                + mem.get("temp_size_in_bytes", 0))
        tc = f.get("t_compute_analytic_s", f["t_compute_s"])
        rows.append(
            f"| {r['arch']} | {r['shape']} | {tc:.3f} | "
            f"{f['t_memory_s']:.3f} | {f['t_collective_s']:.3f} | "
            f"{f.get('bottleneck_analytic', f['bottleneck'])} | "
            f"{r.get('useful_flops_ratio_analytic', 0):.2f} | "
            f"{f.get('roofline_fraction', 0):.2f} | "
            f"{fmt_bytes(peak)} |")
    return "\n".join(rows)


def dryrun_table(records: List[dict]) -> str:
    ok_s = sum(r["status"] == "OK" and r["mesh"] == "single"
               for r in records)
    ok_m = sum(r["status"] == "OK" and r["mesh"] == "multi"
               for r in records)
    sk = sum(r["status"] == "SKIP" for r in records) // 2
    fails = [r for r in records if r["status"] == "FAIL"]
    lines = [f"{SINGLE}: {ok_s} OK; {MULTI}: "
             f"{ok_m} OK; {sk} documented skips per mesh."]
    if fails:
        lines.append("FAILURES:")
        for r in fails:
            lines.append(f"  {r['arch']}×{r['shape']}×{r['mesh']}: "
                         f"{r['error'][:160]}")
    # collective inventory for the most collective-bound cells
    lines.append("")
    lines.append("| arch | shape | mesh | collectives (count) | "
                 "ring-bytes/chip | compile (s) |")
    lines.append("|---|---|---|---|---|---|")
    for r in records:
        if r["status"] != "OK":
            continue
        f = r["roofline"]
        cc = ", ".join(f"{k}:{v}" for k, v in
                       sorted(f["coll_counts"].items()))
        lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {cc} | "
                     f"{fmt_bytes(f['coll_bytes_per_chip'])} | "
                     f"{r['compile_s']} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "dryrun_report.json"
    with open(path) as f:
        records = json.load(f)
    print("## §Dry-run\n")
    print(dryrun_table(records))
    print(f"\n## §Roofline ({SINGLE})\n")
    print(roofline_table(records, "single"))
    print(f"\n## §Roofline ({MULTI})\n")
    print(roofline_table(records, "multi"))


if __name__ == "__main__":
    main()
