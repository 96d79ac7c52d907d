"""The one traffic driver: what a mix's file asks for, drawn from the seed.

A mix (``traffic/<name>.json``) gives:

* ``kind`` — ``"solve"``: a closed loop of one client; each solve starts
  from x0 = 0 and runs until every column meets its tolerance or
  ``max_sweeps`` sweeps have run.  ``"sweep"``: back-to-back sweeps that
  carry x from one to the next, from x0 = 0, each with tolerance 0;
* ``block`` (rows a pick updates; 1 is coordinate GS), ``k`` (right-hand
  sides), ``rhs`` (``"gaussian"``: a fresh standard normal block a solve;
  ``"config"``: the configuration's own b), ``rtol`` (a column's tolerance
  is ``rtol * ||b_c||``), ``max_sweeps``, ``trace_units`` (units the
  traced run traces, null: all).

Every mix runs Gauss-Seidel, coordinate or block, and records once a
sweep: a sweep is n / block picks, then one record.  Every unit (solve or sweep) draws its right-
hand sides and picks from a generator of its own, seeded by the run's
seed and its index, so a unit is drawn again alike after the window.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def unit_seed(seed: int, index: int) -> int:
    """The seed of unit ``index`` (-1: the warm-up) of a run."""
    words = np.random.SeedSequence([seed % 2 ** 64, index + 1]).generate_state(2)
    return (int(words[0]) << 32 | int(words[1])) & (2 ** 63 - 1)


@dataclass
class Done:
    """One unit of the window as the harness saw it."""

    index: int
    due: float          # host clock: when it was due
    done: float         # host clock: when its result was on the host
    records: int        # one a sweep
    converged: int      # columns that met their tolerance
    failed: bool
    traced: bool


class Driver:
    def __init__(self, traffic: dict, n: int, b_config, seed: int, device):
        self.kind = traffic["kind"]
        if self.kind not in ("solve", "sweep"):
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        self.block = int(traffic.get("block", 1))
        self.k = int(traffic["k"])
        self.rhs = traffic["rhs"]
        self.rtol = float(traffic.get("rtol", 0.0))
        self.n, self.seed, self.device = n, seed, torch.device(device)
        if n % self.block:
            raise ValueError("a sweep must hold whole blocks")
        self.directions = n // self.block
        self.per_record = self.directions         # a record a sweep
        sweeps = int(traffic.get("max_sweeps", 1)) if self.kind == "solve" else 1
        self.num_iters = sweeps * self.directions
        self.cap_records = sweeps
        self.trace_units = traffic.get("trace_units")
        if self.rhs == "config":
            if b_config is None or b_config.shape[1] != self.k:
                raise ValueError("the configuration gives no b of k columns")
            self.b_config = b_config
        elif self.rhs != "gaussian":
            raise ValueError(f"unknown rhs {self.rhs!r}")

    def draw(self, index: int):
        """(b, tol, picks) of unit ``index``."""
        g = torch.Generator(device=self.device)
        g.manual_seed(unit_seed(self.seed, index))
        if self.rhs == "gaussian":
            b = torch.randn((self.n, self.k), generator=g, device=self.device)
        else:
            b = self.b_config
        picks = torch.randint(0, self.directions, (self.num_iters,), generator=g,
                              device=self.device, dtype=torch.int32)
        if self.kind == "solve":
            tol = self.rtol * torch.linalg.vector_norm(b, dim=0)
        else:
            tol = torch.zeros(self.k, device=self.device)
        return b, tol, picks

    def start(self):
        """x0 of a unit: zeros where sweeps carry x, else None (the
        program's own zeros)."""
        if self.kind == "sweep":
            return torch.zeros((self.n, self.k), device=self.device)
        return None
