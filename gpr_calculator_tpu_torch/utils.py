"""Data plumbing, metrics and plotting utilities (a port of the JAX
package's ``utils.py``: parity with gpr_calc/utilities.py minus the MPI
machinery).  Descriptors come from the port's ``SO3`` on its working
device."""
from __future__ import annotations

import os

import numpy as np

from .atoms.atoms import ATOMIC_NUMBERS
from .models.gp import metric_values, new_pt  # noqa: F401  (re-export)


# thin delegations: ONE canonical implementation of the scoring math
# (models/gp.metric_values) so conventions cannot diverge

def rmse(true, predicted):
    return metric_values(true, predicted)[2]


def mae(true, predicted):
    return metric_values(true, predicted)[1]


def r2(true, predicted):
    return metric_values(true, predicted)[0]


def metric_single(y_train, y_train_pred, header, show_max=False):
    """One-line scoreboard for a single split (utilities.py:87-95)."""
    r2_v, mae_v, rmse_v = metric_values(y_train, y_train_pred)
    s = (f"{header} [{len(y_train):4d}]: R2 {r2_v:8.4f} "
         f"MAE {mae_v:6.3f} RMSE {rmse_v:6.3f}")
    if show_max:
        diff = np.abs(np.asarray(y_train_pred, float)
                      - np.asarray(y_train, float))
        s += f"  Max {float(diff.max()):6.4f}"
    print(s)
    return s


def metrics(y_train, y_test, y_train_pred, y_test_pred, header):
    r2_1, mae_1, rmse_1 = metric_values(y_train, y_train_pred)
    r2_2, mae_2, rmse_2 = metric_values(y_test, y_test_pred)
    s1 = (f"{header} Train[{len(y_train):4d}]: R2 {r2_1:6.4f} "
          f"MAE {mae_1:6.3f} RMSE {rmse_1:6.3f}")
    s2 = (f"{header} Test [{len(y_test):4d}]: R2 {r2_2:6.4f} "
          f"MAE {mae_2:6.3f} RMSE {rmse_2:6.3f}")
    print(s1)
    print(s2)
    return (s1, s2)


# -- db ingest helpers (utilities.py:132-241) --------------------------------

def get_train_data(db_file, include_stress=False):
    from .io.ase_db import read_db
    strucs, energies, forces, stresses = [], [], [], []
    for row in read_db(db_file):
        strucs.append(row["atoms"])
        energies.append(row["data"]["energy"])
        forces.append(np.asarray(row["data"]["force"]))
        if include_stress:
            sv = row["data"].get("stress")
            # keep None (energy/forces-only rows) instead of wrapping it
            # into a dtype=object scalar array
            stresses.append(None if sv is None else np.asarray(sv))
    if include_stress:
        return strucs, energies, forces, stresses
    return strucs, energies, forces


def get_strucs(db_file, N_max=None):
    """(structures, [(E, F, S or None), ...]) from an ASE-format sqlite db
    (utilities.py:225-242)."""
    from .io.ase_db import read_db
    structures, values = [], []
    for row in read_db(db_file):
        structures.append(row["atoms"])
        data = row["data"]
        S = data.get("stress")
        values.append((data["energy"], np.asarray(data["force"]),
                       None if S is None else np.asarray(S)))
        if N_max is not None and len(values) == N_max:
            break
    return structures, values


def fea(des, struc):
    """One structure's descriptor dict (utilities.py:244-246; the
    reference's multiprocessing map target -- here `convert_struc` maps
    serially since the descriptor itself runs on the device)."""
    return des.calculate(struc)


def convert_struc(db_file, des, ids=None, N=None, stress=False, ncpu=1):
    from .io.ase_db import read_db
    structures, train_Y = [], {"energy": [], "forces": [], "stress": []}
    for k, row in enumerate(read_db(db_file)):
        if ids is not None and k not in ids:
            continue
        structures.append(row["atoms"])
        train_Y["energy"].append(row["data"]["energy"])
        train_Y["forces"].append(np.asarray(row["data"]["force"]))
        if stress:
            sv = row["data"].get("stress")
            # keep None for energy/forces-only rows (same guard as
            # get_train_data -- np.asarray(None) is a dtype=object
            # scalar that poisons downstream stacking)
            train_Y["stress"].append(None if sv is None
                                     else np.asarray(sv))
        if N is not None and len(structures) == N:
            break
    xs = [des.calculate(s) for s in structures]
    return xs, train_Y, structures


def get_data(db_name, des, N_force=100000, lists=None, select=False,
             no_energy=False, ncpu=1):
    X, Y, structures = convert_struc(db_name, des, lists, ncpu=ncpu)
    energy_data, force_data, db_data = [], [], []
    for idx in range(len(X)):
        ele = np.asarray([ATOMIC_NUMBERS[e] for e in X[idx]["elements"]])
        energy_data.append(
            (X[idx]["x"], Y["energy"][idx] / len(X[idx]["x"]), ele))
        atom_ids = [0] if select else range(len(X[idx]["x"]))
        f_ids = []
        for i in atom_ids:
            if len(force_data) < N_force:
                ids = np.flatnonzero(X[idx]["seq"][:, 1] == i)
                _i = X[idx]["seq"][ids, 0]
                force_data.append((X[idx]["x"][_i], X[idx]["dxdr"][ids],
                                   Y["forces"][idx][i], ele[_i]))
                f_ids.append(i)
        db_data.append((structures[idx], Y["energy"][idx],
                        Y["forces"][idx], True, f_ids))
    return {"energy": [] if no_energy else energy_data,
            "force": force_data, "db": db_data}


# -- point-list <-> packed-tuple converters (utilities.py:340-405) -----------

def list_to_tuple(data, stress=False, include_value=False, mode="force"):
    """Concatenate a list of per-point tuples into one stacked tuple.

    ``mode='force'`` points are ``(x, dxdr[, f], ele)`` with x (Ni, d),
    dxdr (Ni, d, 3|9); ``mode='energy'`` points are ``(x[, e], ele)``.
    Returns ``(X, [dXdR,] ELE, indices[, values])`` — the layout the
    reference's MPI train-data broadcast used (utilities.py:340-390); here
    it is a plain serialization/IPC convenience (packing for the device
    builds is ops/packing.py's job).
    """
    rows = sum(p[0].shape[0] for p in data)
    d = data[0][0].shape[1]
    X = np.zeros((rows, d))
    ELE, indices, values = [], [], []
    if mode == "force":
        dXdR = np.zeros((rows, d, 9 if stress else 3))
    count = 0
    for p in data:
        x = np.asarray(p[0], float)
        n = x.shape[0]
        X[count:count + n] = x
        if mode == "force":
            dXdR[count:count + n] = np.asarray(p[1], float)
        if include_value:
            values.append(p[-2])
        ELE.extend(np.asarray(p[-1]).tolist())
        indices.append(n)
        count += n
    ELE = np.ravel(ELE)
    out = (X, dXdR, ELE, indices) if mode == "force" else (X, ELE, indices)
    return out + (values,) if include_value else out


def tuple_to_list(data, mode="force"):
    """Inverse of :func:`list_to_tuple` (utilities.py:393-405)."""
    out, c = [], 0
    if mode == "force":
        X, dXdR, ELE, indices = data
        for n in indices:
            out.append((X[c:c + n], dXdR[c:c + n], ELE[c:c + n]))
            c += n
    else:
        X, ELE, indices = data
        for n in indices:
            out.append((X[c:c + n], ELE[c:c + n]))
            c += n
    return out


# -- plotting (utilities.py:277-338) ------------------------------------------

def plot(Xs, Ys, labels, figname="results.png", draw_line=True,
         type="Energy"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    x_mins, x_maxs = [], []
    for x, y, label in zip(Xs, Ys, labels):
        plt.scatter(x, y, alpha=0.8, label=label, s=5)
        x_mins.append(np.min(x))
        x_maxs.append(np.max(x))
    xs = np.linspace(min(x_mins) - 0.1, max(x_maxs) + 0.1, 100)
    if draw_line:
        plt.plot(xs, xs, "g--", alpha=0.5)
        plt.xlim(min(x_mins) - 0.1, max(x_maxs) + 0.1)
        plt.ylim(min(x_mins) - 0.1, max(x_maxs) + 0.1)
    unit = {"Energy": "(eV/atom)", "Force": "(eV/A)",
            "Stress": "GPa"}.get(type, "")
    plt.xlabel("True" + unit)
    plt.ylabel("Prediction" + unit)
    plt.legend(loc=2)
    plt.tight_layout()
    plt.savefig(figname)
    plt.close()
    print("save the figure to ", figname)


def plot_two_body(model, figname, rs=(1.0, 5.0)):
    from .atoms import Atoms
    from .calculator import GPR
    rs = np.linspace(rs[0], rs[1], 50)
    cell = 10 * np.eye(3)
    engs = []
    calc = GPR(ff=model, return_std=False)
    for r in rs:
        dimer = Atoms(["Si", "Si"],
                      positions=[[0, 0, 0], [r, 0, 0]], cell=cell)
        dimer.calc = calc
        calc._calculate(dimer)
        engs.append(calc.results["energy"])
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.plot(rs, engs, "-d", label="2-body")
    plt.legend()
    plt.xlabel("R (Angstrom)")
    plt.ylabel("Energy (eV)")
    plt.tight_layout()
    plt.savefig(figname)
    plt.close()


def write_db_from_dict(data, db_filename="viz.db", permission="w"):
    from .io.ase_db import write_db as _write
    rows = []
    N = len(data["atoms"])
    for i in range(N):
        kvp = {k: data[k][i] for k in data if k != "atoms"}
        rows.append({"atoms": data["atoms"][i], "key_value_pairs": kvp})
    _write(db_filename, rows, permission=permission)


def write_db(data, db_filename="viz.db", permission="w"):
    from .io.ase_db import write_db as _write
    (structures, y_qm, y_ml) = data
    rows = [{"atoms": x,
             "key_value_pairs": {"QM_energy": y_qm[i], "ML_energy": y_ml[i],
                                 "diff_energy": abs(y_qm[i] - y_ml[i])}}
            for i, x in enumerate(structures)]
    _write(db_filename, rows, permission=permission)


def PyXtal(sgs, species, numIons, conventional=True):
    """Random symmetric structure generation (utilities.py:14-30).
    Requires the optional pyxtal package."""
    try:
        from pyxtal import pyxtal
    except ImportError as exc:  # pragma: no cover
        raise ImportError("PyXtal generation requires pyxtal "
                          "(pip install pyxtal)") from exc
    from random import choice
    while True:
        struc = pyxtal()
        struc.from_random(3, choice(sgs), species, numIons,
                          conventional=conventional, force_pass=True)
        if struc.valid:
            return struc.to_ase()


def reserve_host_cores(n_reserved: int, rankfile: str = "rankfile.txt"):
    """Equivalent of utilities.set_mpi (utilities.py:445-465): write a
    rankfile so a base-calculator child MPI job binds to the host cores the
    GPR driver is not using.  The GPR side occupies the accelerator, so
    all host cores minus ``n_reserved`` are handed to the child job."""
    import socket
    cpu_count = os.cpu_count() or 1
    ncpu = max(1, cpu_count - n_reserved)
    hostname = socket.gethostname()
    with open(rankfile, "w") as f:
        for i in range(ncpu):
            f.write(f"rank {i}={hostname} slot={i + n_reserved}\n")
    return ncpu
