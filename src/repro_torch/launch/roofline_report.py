"""Roofline table of the dry-run's cells (port of
``benchmarks/roofline_report.py``).

Per (arch x shape x mesh [x impl]): the three terms (compute / memory /
collective, seconds a step against the H100 data-sheet peaks that
``launch.dryrun`` names), the dominant one, the model-FLOPs ratio and the
roofline fraction, one CSV line each (``name,us_per_call,derived``).
These are predictions from the meta pass, not measurements.  A cell
without a cost (``lower_cell(skip_full=True)``) prints its error
instead.  Run the sweep first:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.roofline_report
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR


def load_all(results=RESULTS_DIR):
    out = []
    for p in sorted(glob.glob(os.path.join(results, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def rows(cells):
    """The table's rows ({"name", "us_per_call", "derived"})."""
    out = []
    ok = [c for c in cells if c.get("status") == "ok"]
    n_refused = 0
    for c in sorted(ok, key=lambda c: (c["arch"], c["shape"],
                                       c.get("impl", "baseline"))):
        mesh = "multi" if "pod" in c["mesh"]["axes"] else "single"
        impl = c.get("impl", "baseline")
        suffix = "" if impl == "baseline" else f"/{impl}"
        name = f"roofline/{c['arch']}/{c['shape']}/{mesh}{suffix}"
        t = c["roofline"]
        if "error" in t:
            n_refused += 1
            out.append({"name": name, "us_per_call": "",
                        "derived": "refused=" + t["error"].split(":")[0]
                        + ";" + t["error"].split(": ", 1)[-1][:90]})
            continue
        out.append({
            "name": name,
            "us_per_call": f"{t['bound_s']*1e6:.0f}",
            "derived": (
                f"compute_s={t['compute_s']:.3e};"
                f"memory_s={t['memory_s']:.3e};"
                f"collective_s={t['collective_s']:.3e};"
                f"dominant={t['dominant']};"
                f"useful_flops_ratio={c.get('useful_flops_ratio') or 0:.3f};"
                f"roofline_frac={c.get('roofline_fraction') or 0:.4f}"),
        })
    out.append({"name": "roofline/summary",
                "derived": f"cells_ok={len(ok)};cells_err="
                f"{len(cells) - len(ok)};cost_refused={n_refused}"})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS_DIR,
                    help="the dry-run's output directory")
    args = ap.parse_args(argv)
    table = rows(load_all(args.dir))
    for r in table:
        print(f"{r['name']},{r.get('us_per_call', '')},{r.get('derived', '')}")
    return table


if __name__ == "__main__":
    main()
