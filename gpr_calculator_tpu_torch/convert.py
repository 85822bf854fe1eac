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

from .models.gp import GP
from .models.kernels import kernel_from_dict
from .models.posterior import Posterior, _factor_perm, _packed_rows
from .ops.so3 import SO3


def _numpy(a) -> np.ndarray:
    """A float64 NumPy copy of a torch tensor (any device) or array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.array(a, dtype=float)


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
        rows = _packed_rows(n_e, n_f, int(e.x.shape[0]))
        state["alpha"] = _numpy(gp.alpha_)[rows]
        state["n_fit"] = (n_e, n_f)
        if isinstance(gp, GP):
            # the port: the factor over the real rows in the insertion
            # order of its groups [(kE, kF), ...] (canonical for one),
            # while it is the factor of the training lists
            if gp.posterior.appendable:
                state["L"] = _numpy(gp.L_)
                state["L_groups"] = [tuple(g) for g in gp.posterior.groups]
            return state
        L = _canonical_factor(gp, rows)
        if L is not None:
            state["L"] = L
    return state


def _canonical_factor(gp, rows):
    """The JAX GP's lower factor over the real rows in canonical order
    [E..., F...] (``_serve_factor``'s, where its columns are the real rows
    in order, as a full factorisation leaves them), else None."""
    try:
        L, index = gp._serve_factor()
    except RuntimeError:         # no factor kept
        return None
    cols, pos = (rows, rows) if index is None else index
    if not np.array_equal(np.asarray(cols), rows):
        return None
    return _numpy(L)[np.ix_(np.asarray(pos), np.asarray(pos))]


def gp_from_state(state: dict, device=None, dtype=None,
                  log_file: str = "gpr.log") -> GP:
    """The port's GP holding ``state``; fitted (its ``Posterior``) when
    the state carries the weights and factor (in the order of
    ``L_groups``, default canonical), else ready for
    ``fit(opt=False)``."""
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
        gp.posterior = Posterior(
            e, f, torch.as_tensor(state["L"], **kw),
            torch.as_tensor(np.asarray(state["alpha"])[perm], **kw), groups,
            gp._params_signature(), gp.logging.info)
    return gp
