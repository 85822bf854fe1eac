"""Carry a GP's state between the JAX package and the port as NumPy.

``state_of`` reads a fitted GP of either package through its attributes
and NumPy alone (this module never imports JAX): the ``save_dict``
metadata (kernel, descriptor, noise), the training lists and, when
present, the weights and the Cholesky factor restricted to the real rows
(the port's after incremental appends in their insertion order,
``L_groups``).
``gp_from_state`` builds the port's GP from such a state on any device,
so both packages can be held to the same computation.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.gp import GP, _factor_perm
from .models.kernels import kernel_from_dict
from .ops.so3 import SO3


def _numpy(a) -> np.ndarray:
    """A float64 NumPy copy of a torch tensor (any device) or array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.array(a, dtype=float)


def _real_rows(m_e: int, n_e: int, n_f: int) -> np.ndarray:
    return np.r_[np.arange(n_e), m_e + np.arange(3 * n_f)]


def state_of(gp) -> dict:
    """NumPy state of a GP (JAX package or port)."""
    state = {
        "save_dict": gp.save_dict(None),
        "energy_pts": [(np.array(x, float), np.array(ele, int))
                       for x, ele in gp._energy_pts],
        "energy_y": [float(y) for y in gp._energy_y],
        "force_pts": [(np.array(x, float), np.array(dx, float),
                       np.array(ele, int))
                      for x, dx, ele in gp._force_pts],
        "force_y": [np.array(y, float) for y in gp._force_y],
        "N_energy": int(gp.N_energy),
        "N_forces": int(gp.N_forces),
    }
    snap = getattr(gp, "_fit_snapshot", None)
    if snap is not None and gp.alpha_ is not None:
        e, _, n_e, n_f = snap
        rows = _real_rows(int(e.x.shape[0]), n_e, n_f)
        state["alpha"] = _numpy(gp.alpha_)[rows]
        state["n_fit"] = (n_e, n_f)
        if isinstance(gp, GP):
            # the port: the factor over the real rows in the insertion
            # order of its groups [(kE, kF), ...] (canonical for one)
            if gp._inc is not None:
                state["L"] = _numpy(gp.L_)
                state["L_groups"] = [tuple(g) for g in gp._inc["groups"]]
            return state
        L = _canonical_factor(gp, rows)
        if L is not None:
            state["L"] = L
    return state


def _canonical_factor(gp, rows):
    """The JAX GP's lower factor over the real rows in canonical order
    [E..., F...], or None when it holds it in another order.  It keeps it
    in a capacity buffer after a full factorisation (one group, no ghost
    rows: canonical order); after incremental appends the rows are
    permuted, and that factor is not carried."""
    if getattr(gp, "L_", None) is not None:
        return _numpy(gp.L_)[np.ix_(rows, rows)]
    inc = getattr(gp, "_inc", None)
    if inc is not None and len(inc["groups"]) == 1 \
            and inc["groups"][0][2] == 0 and inc["n"] == len(rows):
        return _numpy(inc["L_buf"])[:len(rows), :len(rows)]
    return None


def gp_from_state(state: dict, device=None, dtype=None,
                  log_file: str = "gpr.log") -> GP:
    """The port's GP holding ``state``; fitted (alpha_, L_) when the state
    carries the weights and factor (in the order of ``L_groups``, default
    canonical), else ready for ``fit(opt=False)``."""
    sd = state["save_dict"]
    gp = GP(kernel=kernel_from_dict(sd["kernel"]),
            descriptor=SO3.from_dict(sd["descriptor"]),
            noise_e=sd["noise"]["energy"], noise_f=sd["noise"]["force"],
            f_coef=sd["noise"]["f_coef"], log_file=log_file,
            device=device, dtype=dtype)
    gp.set_train_pts({
        "energy": [(x, y, ele) for (x, ele), y
                   in zip(state["energy_pts"], state["energy_y"])],
        "force": [(x, dx, y, ele) for (x, dx, ele), y
                  in zip(state["force_pts"], state["force_y"])],
    }, mode="w")
    if "alpha" in state and "L" in state:
        n_e, n_f = state["n_fit"]
        e, f = gp._pack(n_e, n_f)
        groups = state.get("L_groups", [(n_e, n_f)])
        perm = _factor_perm(groups, n_e)
        # float64 whatever the working dtype, as ``_factorize`` keeps them
        kw = dict(dtype=torch.float64, device=gp.device)
        gp._adopt_factor(e, f, n_e, n_f, torch.as_tensor(state["L"], **kw),
                         torch.as_tensor(np.asarray(state["alpha"])[perm],
                                         **kw), groups)
    return gp
