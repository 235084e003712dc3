"""Per-layer probes of the dry run's counts: a check, not a correction.

Port of `repro.analysis.calibration`. XLA's HloCostAnalysis counts a
while-loop body ONCE, so the reference corrects a scanned L-layer count
by compiling the step with 1 and 2 unrolled layers per segment:

    body_seg   = metrics(2 layers) - metrics(1 layer)
    corrected  = scanned_full + sum_seg (L_seg - 1) * body_seg

The port runs every layer eagerly and the dry run counts every op it
dispatches (`launch.dryrun.CostMode`), so its full count has no loop
undercount: adding the reference's correction would count each layer
twice. Here the probes check the count instead (`probe_identity`): the
full count must equal the 1-layer probe plus sum_seg (L_seg - 1) x
body_seg — FLOPs exactly, bytes and collective bytes within 1e-6
relative. `Metrics` and `probe_configs` are the reference's.
"""
from __future__ import annotations

import dataclasses

# Relative tolerance of the probe identity for bytes and collective bytes.
PROBE_RTOL = 1e-6


@dataclasses.dataclass
class Metrics:
    flops: float
    bytes: float
    coll: dict[str, float]

    def __sub__(self, o: "Metrics") -> "Metrics":
        keys = set(self.coll) | set(o.coll)
        return Metrics(
            self.flops - o.flops, self.bytes - o.bytes,
            {k: self.coll.get(k, 0.0) - o.coll.get(k, 0.0) for k in keys})

    def scaled(self, f: float) -> "Metrics":
        return Metrics(self.flops * f, self.bytes * f,
                       {k: v * f for k, v in self.coll.items()})

    def __add__(self, o: "Metrics") -> "Metrics":
        keys = set(self.coll) | set(o.coll)
        return Metrics(
            self.flops + o.flops, self.bytes + o.bytes,
            {k: self.coll.get(k, 0.0) + o.coll.get(k, 0.0) for k in keys})


def probe_configs(cfg):
    """(cfg_1layer, cfg_2layer) unrolled probes per segment structure.

    Returns list of (seg_index, cfg1, cfg2, n_layers) — one entry per
    segment (plus one for the encoder stack if present, marked -1)."""
    probes = []
    segs = cfg.resolved_segments
    for i, seg in enumerate(segs):
        if seg.n_layers <= 1:
            continue

        def with_n(n, i=i, seg=seg):
            new_segs = tuple(
                dataclasses.replace(s, n_layers=n) if j == i
                else dataclasses.replace(s, n_layers=min(s.n_layers, 1))
                for j, s in enumerate(segs))
            enc = cfg.encoder
            if enc is not None:
                enc = dataclasses.replace(enc, n_layers=1)
            return dataclasses.replace(
                cfg, segments=new_segs, scan_unroll=True, encoder=enc,
                n_layers=sum(s.n_layers for s in new_segs))

        probes.append((i, with_n(1), with_n(2), seg.n_layers))
    if cfg.encoder is not None and cfg.encoder.n_layers > 1:
        def with_enc(n):
            new_segs = tuple(dataclasses.replace(s, n_layers=min(s.n_layers, 1))
                             for s in segs)
            return dataclasses.replace(
                cfg, segments=new_segs, scan_unroll=True,
                encoder=dataclasses.replace(cfg.encoder, n_layers=n),
                n_layers=sum(s.n_layers for s in new_segs))
        probes.append((-1, with_enc(1), with_enc(2), cfg.encoder.n_layers))
    return probes


def probe_prediction(probes) -> Metrics:
    """The count the probes predict for the full model: the 1-layer probe
    (the same config for every segment) plus sum (L - 1) x (m2 - m1).
    `probes`: a list of (m1, m2, n_layers), one per `probe_configs`
    entry."""
    m1 = probes[0][0]
    out = m1
    for p1, p2, n_layers in probes:
        out = out + (p2 - p1).scaled(n_layers - 1)
    return out


def probe_identity(full: Metrics, probes) -> dict:
    """How far the full count lies from the probes' prediction: each
    term's relative gap, and whether the identity holds (FLOPs exactly,
    bytes and each collective kind within PROBE_RTOL)."""
    want = probe_prediction(probes)

    def rel(a: float, b: float) -> float:
        return abs(a - b) / max(abs(a), abs(b), 1.0)

    gaps = {"flops": rel(full.flops, want.flops),
            "bytes": rel(full.bytes, want.bytes)}
    for k in set(full.coll) | set(want.coll):
        gaps[f"coll/{k}"] = rel(full.coll.get(k, 0.0), want.coll.get(k, 0.0))
    ok = full.flops == want.flops and all(
        v <= PROBE_RTOL for k, v in gaps.items() if k != "flops")
    return {"ok": ok, "gaps": gaps}
