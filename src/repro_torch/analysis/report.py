"""Render the roofline table (markdown) from dry-run JSON results.

Port of `repro.analysis.report`: the same markdown for the same JSON."""
from __future__ import annotations

import json


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.1f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def roofline_markdown(path: str) -> str:
    with open(path) as f:
        results = json.load(f)
    lines = [
        "| arch | shape | compute | memory | collective | bound | "
        "MODEL_FLOPS/HLO | note |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        tag = f"| {r['arch']} | {r['shape']} |"
        if r["status"] == "skipped":
            lines.append(f"{tag} — | — | — | skip | — | {r['note'][:48]} |")
            continue
        if r["status"] != "ok":
            lines.append(f"{tag} — | — | — | ERROR | — | "
                         f"{r.get('error','')[:48]} |")
            continue
        rf = r["roofline"]
        ratio = rf.get("useful_flops_ratio")
        lines.append(
            f"{tag} {_fmt_s(rf['compute_s'])} | {_fmt_s(rf['memory_s'])} | "
            f"{_fmt_s(rf['collective_s'])} | **{rf['dominant']}** | "
            f"{ratio:.2f} | {r.get('note','')[:40]} |"
            if ratio is not None else
            f"{tag} {_fmt_s(rf['compute_s'])} | {_fmt_s(rf['memory_s'])} | "
            f"{_fmt_s(rf['collective_s'])} | **{rf['dominant']}** | n/a | |")
    return "\n".join(lines)


def memory_markdown(path: str) -> str:
    with open(path) as f:
        results = json.load(f)
    lines = ["| arch | shape | args/device | temps/device | compile |",
             "|---|---|---|---|---|"]
    for r in results:
        if r["status"] != "ok":
            continue
        m = r.get("memory", {})
        a = m.get("argument_size_in_bytes")
        t = m.get("temp_size_in_bytes")
        gb = lambda v: f"{v/2**30:.2f}GiB" if v is not None else "n/a"
        lines.append(f"| {r['arch']} | {r['shape']} | {gb(a)} | {gb(t)} | "
                     f"{r['compile_s']}s |")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    print(roofline_markdown(sys.argv[1] if len(sys.argv) > 1
                            else "results/dryrun_baseline.json"))
