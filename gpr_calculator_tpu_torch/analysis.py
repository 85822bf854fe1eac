"""Convergence analysis of on-the-fly runs from the dispatch log protocol
(a copy of the JAX package's ``analysis.py``).

The hybrid calculator emits one line per evaluation (dispatch.py, parse-
compatible with the reference):

    From Base model E: {E_std}/{E_surrogate}/{E_base}, F: {F_std}/{Fmax_s}/{Fmax_b}
    From Surrogate  E: {E_std}/{e_tol}/{E}, F: {F_std}/{f_tol}/{Fmax}

plus ``Loss: {nll} {theta...}`` lines from hyperparameter optimisation and
``Update GP model => {queue}/{maxiter}`` refit markers.  This module turns
a log (or captured stdout) into structured records and convergence plots
-- the library-grade equivalent of the reference's ad-hoc scraper
(examples/Pd4/analysis.py:1-92).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class EvalRecord:
    index: int            # running evaluation counter
    kind: str             # "base" | "surrogate"
    energy: float         # energy actually served (base E for base calls)
    e_std: float          # predicted energy std (total)
    f_std: float          # max predicted force std
    f_max: float          # max |F| served


@dataclass
class RunSummary:
    records: List[EvalRecord]
    losses: List[float]           # NLL trace across refits
    refits: int

    @property
    def n_base(self) -> int:
        return sum(r.kind == "base" for r in self.records)

    @property
    def n_surrogate(self) -> int:
        return sum(r.kind == "surrogate" for r in self.records)

    @property
    def base_fraction(self) -> float:
        n = len(self.records)
        return self.n_base / n if n else 0.0

    def base_fraction_series(self, window: int = 20) -> np.ndarray:
        """Rolling fraction of base calls -- the convergence signal: it
        should decay toward 0 as the surrogate takes over."""
        flags = np.asarray([r.kind == "base" for r in self.records], float)
        if len(flags) == 0:
            return flags
        kernel = np.ones(min(window, len(flags)))
        return np.convolve(flags, kernel / kernel.size, mode="valid")


def parse_log(path_or_lines) -> RunSummary:
    """Parse a dispatch log file (or an iterable of lines)."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as fh:
            lines = fh.readlines()
    else:
        lines = list(path_or_lines)

    records: List[EvalRecord] = []
    losses: List[float] = []
    refits = 0
    for line in lines:
        line = line.strip()
        # logging prefixes (timestamps etc.) may precede the markers
        for marker in ("From Base model", "From Surrogate", "Loss:",
                       "Update GP model"):
            pos = line.find(marker)
            if pos >= 0:
                line = line[pos:]
                break
        if line.startswith("From "):
            is_base = line.startswith("From Base model")
            try:
                e_part, f_part = line.split("E:")[1].split(", F:")
                e_fields = [float(v.rstrip(",")) for v in
                            e_part.strip().split("/")]
                f_fields = [float(v.rstrip(",")) for v in
                            f_part.strip().split("/")]
            except (IndexError, ValueError):
                continue
            records.append(EvalRecord(
                index=len(records),
                kind="base" if is_base else "surrogate",
                energy=e_fields[2], e_std=e_fields[0],
                f_std=f_fields[0], f_max=f_fields[2]))
        elif line.startswith("Loss:"):
            try:
                losses.append(float(line.split()[1]))
            except (IndexError, ValueError):
                continue
        elif line.startswith("Update GP model"):
            refits += 1
    return RunSummary(records=records, losses=losses, refits=refits)


def plot_energy_scatter(summary: RunSummary, n_images: Optional[int] = None,
                        output_file: str = "energy_scatter.png",
                        reference_energy: Optional[float] = None):
    """Energy of every evaluation over the run, base calls highlighted
    (figure parity with examples/Pd4/analysis.py:55-92)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    e = np.asarray([r.energy for r in summary.records])
    if reference_energy is None and len(e):
        reference_energy = e[0]
    e = e - (reference_energy or 0.0)
    x = np.arange(len(e), dtype=float)
    if n_images:
        x /= n_images

    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(x, e, "-", color="grey", alpha=0.6, lw=0.8)
    base = np.asarray([r.kind == "base" for r in summary.records])
    if base.any():
        ax.scatter(x[base], e[base], s=8, color="tab:blue", zorder=3,
                   label="Base (DFT)")
    ax.set_xlabel("NEB iteration" if n_images else "Evaluation",
                  fontsize=14)
    ax.set_ylabel("Energy (eV, relative)", fontsize=14)
    ax.legend(fontsize=12, frameon=False)
    fig.tight_layout()
    fig.savefig(output_file, dpi=300)
    plt.close(fig)
    return output_file


def plot_convergence(summary: RunSummary, window: int = 20,
                     output_file: str = "convergence.png"):
    """Rolling base-call fraction + NLL trace: did the surrogate take
    over, and did the hyperparameter optimisation settle?"""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    frac = summary.base_fraction_series(window)
    axes[0].plot(frac, color="tab:blue")
    axes[0].set_ylim(-0.02, 1.02)
    axes[0].set_xlabel("Evaluation", fontsize=12)
    axes[0].set_ylabel(f"Base fraction (window={window})", fontsize=12)
    if summary.losses:
        axes[1].plot(summary.losses, color="tab:orange")
    axes[1].set_xlabel("Optimiser step", fontsize=12)
    axes[1].set_ylabel("Negative log marginal likelihood", fontsize=12)
    fig.tight_layout()
    fig.savefig(output_file, dpi=300)
    plt.close(fig)
    return output_file
