"""Post-process dryrun_report.json: add analytic compute terms.

The port of the reference's ``launch.enrich``, over the port's
``flopcount.cell_flops`` and the H100's ``roofline.PEAK_FLOPS``.

    PYTHONPATH=src python -m repro_torch.launch.enrich dryrun_report.json
"""
from __future__ import annotations

import json
import sys

from repro_torch.configs.base import get_config
from repro_torch.flopcount import cell_flops
from repro_torch.roofline import PEAK_FLOPS


def enrich(records):
    for r in records:
        if r["status"] != "OK":
            continue
        cfg = get_config(r["arch"])
        n_dev = r["n_devices"]
        fl = cell_flops(cfg, r["shape"])
        r["analytic_flops_global"] = fl
        r["roofline"]["t_compute_analytic_s"] = fl / n_dev / PEAK_FLOPS
        r["useful_flops_ratio_analytic"] = r["model_flops_global"] / fl
        # bottleneck using the analytic compute term
        f = r["roofline"]
        terms = {"compute": f["t_compute_analytic_s"],
                 "memory": f["t_memory_s"],
                 "collective": f["t_collective_s"]}
        f["bottleneck_analytic"] = max(terms, key=terms.get)
        f["roofline_fraction"] = (f["t_compute_analytic_s"]
                                  / max(sum(terms.values()), 1e-12))
    return records


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "dryrun_report.json"
    with open(path) as f:
        records = json.load(f)
    with open(path, "w") as f:
        json.dump(enrich(records), f, indent=1)
    print(f"enriched {sum(r['status'] == 'OK' for r in records)} OK records")


if __name__ == "__main__":
    main()
