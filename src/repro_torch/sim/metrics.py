"""Round-level records and sweep summaries (the paper's three metrics)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RoundRecord:
    idx: int
    t_start: float
    t_end: float
    participants: list[int]
    epochs: list[int]
    idle_s: list[float]          # per participant, within this round span
    compute_s: list[float]
    comm_s: list[float]
    relays: list[int]
    staleness: list[int]
    accuracy: float | None = None
    # Comms accounting (repro.comms): ISL legs paid per participant's
    # return (0 = direct upload or the seed's free relay), and total bytes
    # on the wire per participant (model download + every return leg).
    relay_hops: list[int] = dataclasses.field(default_factory=list)
    comms_bytes: list[float] = dataclasses.field(default_factory=list)
    # Wire bytes the uplink codec saved this round vs full-precision
    # returns over the same legs (0.0 for the identity codec — exactly).
    wire_bytes_saved: float = 0.0
    # How the round's client updates executed: "host" (vmapped reference
    # path) or "mesh" (cluster-as-collective shard_map + masked psum).
    execution: str = "host"

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def total_relay_hops(self) -> int:
        return sum(self.relay_hops)

    @property
    def total_comms_bytes(self) -> float:
        return float(sum(self.comms_bytes))

    @property
    def mean_idle_frac(self) -> float:
        d = max(self.duration_s, 1e-9)
        return float(sum(self.idle_s) / (len(self.idle_s) * d)) if self.idle_s else 0.0


@dataclasses.dataclass
class SimResult:
    algorithm: str
    n_sats: int
    n_stations: int
    rounds: list[RoundRecord]
    accuracy_curve: list[tuple[int, float, float]]  # (round, sim time s, acc)
    # Execution-mode provenance + parity hooks: the global-model snapshots
    # are host pytrees (device_get), populated only when the run trains
    # (`params_history` additionally needs SimConfig.record_params).
    execution: str = "host"
    params_history: list = dataclasses.field(default_factory=list)
    final_params: object | None = None

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    @property
    def max_accuracy(self) -> float:
        return max((a for _, _, a in self.accuracy_curve), default=0.0)

    @property
    def final_accuracy(self) -> float:
        return self.accuracy_curve[-1][2] if self.accuracy_curve else 0.0

    @property
    def total_time_s(self) -> float:
        return self.rounds[-1].t_end if self.rounds else 0.0

    @property
    def mean_round_duration_s(self) -> float:
        if not self.rounds:
            return 0.0
        return sum(r.duration_s for r in self.rounds) / len(self.rounds)

    @property
    def mean_idle_per_round_s(self) -> float:
        vals = [sum(r.idle_s) / max(len(r.idle_s), 1) for r in self.rounds]
        return sum(vals) / len(vals) if vals else 0.0

    @property
    def total_relay_hops(self) -> int:
        return sum(r.total_relay_hops for r in self.rounds)

    @property
    def total_comms_bytes(self) -> float:
        return float(sum(r.total_comms_bytes for r in self.rounds))

    @property
    def total_wire_bytes_saved(self) -> float:
        return float(sum(r.wire_bytes_saved for r in self.rounds))

    def time_to_accuracy(self, target: float) -> float | None:
        """Simulation seconds until `target` eval accuracy (None if never)."""
        for _, t, a in self.accuracy_curve:
            if a >= target:
                return t
        return None

    def summary(self) -> dict:
        return {
            "algorithm": self.algorithm,
            "execution": self.execution,
            "n_sats": self.n_sats,
            "n_stations": self.n_stations,
            "rounds": self.n_rounds,
            "max_accuracy": round(self.max_accuracy, 4),
            "final_accuracy": round(self.final_accuracy, 4),
            "mean_round_duration_h": round(self.mean_round_duration_s / 3600, 3),
            "mean_idle_per_round_h": round(self.mean_idle_per_round_s / 3600, 3),
            "total_days": round(self.total_time_s / 86400, 2),
            "relay_hops": self.total_relay_hops,
            "comms_mb": round(self.total_comms_bytes / 1e6, 3),
            "wire_saved_mb": round(self.total_wire_bytes_saved / 1e6, 3),
        }
