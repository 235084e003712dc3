"""The one generator of token traffic, read from a mix's file.

A mix file (`bench/traffic/<mix>.json`) gives `rows` sequences of `seq`
tokens a batch, drawn ("tokens": "markov") from the satellite's own
pseudo-language, as the program's launchers train on: a first-order
Markov chain in which each token has `successors` likely next tokens
(one drawn uniformly) and with probability `jump` the chain jumps to a
uniform id; the first token of a row is uniform. The successor table is
drawn once a run, from the seed. (Uniform ids give a random model almost
nothing to learn: its true gradient is then below the bf16 program's
rounding.)

Batch i of a run is drawn by a generator of its own, seeded from the
run's seed and i, so the same seed gives the same batches, every batch
differs from every other, and any set of them can be drawn again (the
reference's copy) in one pass. Batches are drawn ahead of use, a pool
at a time, on the device: a Markov row takes one step a token, and the
steps of every batch in a pool are taken together.
"""
from __future__ import annotations

import torch

from bench import harness


class TokenFeed:
    def __init__(self, traffic: dict, vocab_size: int, seed: int, device):
        if traffic["tokens"] != "markov":
            raise ValueError(f"unknown token draw {traffic['tokens']!r}")
        self.jump = float(traffic["jump"])
        self.rows, self.seq = int(traffic["rows"]), int(traffic["seq"])
        self.vocab = int(vocab_size)
        self.seed = seed
        self.device = torch.device(device)
        self.drawn = 0
        self.pool: list[torch.Tensor] = []
        self.succ = torch.randint(
            0, self.vocab, (self.vocab, int(traffic["successors"])),
            generator=self._gen("chain"), device=self.device)

    def _gen(self, tag: str) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            harness.derive_seed(self.seed, tag))

    def fill(self, n: int) -> None:
        """Draw the next `n` batches into the pool."""
        idx = range(self.drawn, self.drawn + n)
        self.drawn += n
        shape = (self.rows, self.seq)
        picks, jumps, targets = [], [], []
        for i in idx:
            g = self._gen(f"batch{i}")
            picks.append(torch.randint(0, self.succ.shape[1], shape,
                                       generator=g, device=self.device))
            jumps.append(torch.rand(shape, generator=g, device=self.device)
                         < self.jump)
            targets.append(torch.randint(0, self.vocab, shape, generator=g,
                                         device=self.device))
        pick, jump, target = (torch.cat(x) for x in (picks, jumps, targets))
        toks = torch.empty_like(target)
        toks[:, 0] = target[:, 0]
        for t in range(1, self.seq):
            nxt = self.succ[toks[:, t - 1], pick[:, t]]
            toks[:, t] = torch.where(jump[:, t], target[:, t], nxt)
        self.pool += list(toks.split(self.rows))

    def next(self) -> torch.Tensor:
        """The next batch: (rows, seq) int64 token ids on the device."""
        if not self.pool:
            self.fill(1)
        return self.pool.pop(0)
