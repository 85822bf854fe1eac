#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (gpr_calculator_tpu_torch).

Usage (one CUDA card, no arguments):  python3 chip_smoke.py

Builds the CUDA kernels from csrc/ and drives the port's main path once:
the on-the-fly GP surrogate for Au on Al(100) (13 atoms, SO3 nmax=3
lmax=4 rcut=5.0, RBF zeta=2) is trained on three NEB images, then served
through the GPR calculator, which answers from the surrogate or calls EMT
and refits.  Around that run it checks every kernel against its plain
PyTorch version at the path's shapes and at the 10k-covariance bench
shape, factorises that covariance, re-serves the frozen model against a
float64 CPU model of the same training set, and times kernel and plain
versions.  Any failure raises (non-zero exit).  The second-to-last line
is the card's name and power limit, the last a JSON status object.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# (sigma, l) fitted by the JAX package, GP.set_GPR(images, EMT(),
# noise_e=0.05/13, noise_f=0.05) on the five images of
# au_on_al100_images(), CPU float64.
SIGMA, L_SCALE = 0.9000824419630231, 1.291296129835527
NOISE_E, NOISE_F = 0.05 / 13, 0.05
KERNEL_RTOL = 2e-5     # f32 kernel vs plain: |diff| <= 2e-5 max|plain|

REPLACES = {   # launch-counter name -> the Pallas kernel it replaces
    "kff_tri": "gpr_calculator_tpu/ops/kff_pallas.py:282",   # K1
    "kef_rect": "gpr_calculator_tpu/ops/kff_pallas.py:748",  # K2
    "kff_rect": "gpr_calculator_tpu/ops/kff_pallas.py:269",  # K3
}
SOURCE = "gpr_calculator_tpu_torch/csrc/kff.cu"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def perturbed(image, rng, scale=0.05):
    a = image.copy()
    free = np.setdiff1d(np.arange(len(a)), a.fixed_indices())
    a.positions[free] += rng.normal(0.0, scale, (len(free), 3))
    return a


def run_slice(T, device, dtype, log):
    """The main path: train on images 0, 4, 2, refit, then serve the five
    images and three perturbed copies through the gated dispatcher, and
    two more perturbed copies with the base call forced (none of the
    gated requests needs EMT at these geometries, so these exercise the
    dispatcher's grow-and-refit branch)."""
    images = T.au_on_al100_images()
    rng = np.random.RandomState(0)
    gated = images + [perturbed(images[k], rng) for k in (1, 2, 3)]
    forced = [perturbed(images[k], rng) for k in (1, 3)]
    gp = T.GP(kernel=T.RBF(para=[SIGMA, L_SCALE], zeta=2),
              descriptor=T.SO3(nmax=3, lmax=4, rcut=5.0),
              noise_e=NOISE_E, noise_f=NOISE_F, log_file=None,
              device=device, dtype=dtype)
    for k in (0, 4, 2):
        a = images[k].copy()
        a.calc = T.EMT()
        e, f = a.get_potential_energy(), a.get_forces(apply_constraint=False)
        a.calc = None
        gp.add_structure((a, e, f))
    gp.fit(opt=False, show=False)
    out = []
    for k, atoms in enumerate(gated + forced):
        a = atoms.copy()
        a.calc = T.GPR(base=T.EMT(), ff=gp, save=False, opt_freq=10 ** 6)
        a.calc.verbose = False
        a.calc.force_base = k >= len(gated)
        base_before = gp.use_base
        E = a.get_potential_energy()
        F = a.get_forces()
        r = a.calc.results
        out.append(dict(E=E, F=F, var_e=r["var_e"], var_f=r["var_f"],
                        source="base" if gp.use_base > base_before
                        else "surrogate"))
        log(f"(d) request {k}: {out[-1]['source']:9s} E={E:.6f} eV "
            f"max|F|={np.abs(F).max():.4f} eV/A "
            f"max sigma_F={np.max(r['var_f']):.4f} eV/A")
    return gp, images, out


def bench_data(torch, device, m_e=1000, m_f=3000, envs=32, d=30):
    """bench.py's synthetic workload (1000 energy points, 3000 force
    points, 32 envs each, d=30: a 10k x 10k covariance), float32."""
    from gpr_calculator_tpu_torch.ops.packing import EnergyData, ForceData
    rng = np.random.RandomState(0)
    f32 = torch.float32
    e = EnergyData(
        x=torch.as_tensor(rng.uniform(0.2, 1.0, (m_e, envs, d)), dtype=f32,
                          device=device),
        ele=torch.as_tensor(rng.choice([13, 79], (m_e, envs)),
                            dtype=torch.int32, device=device),
        counts=torch.full((m_e,), float(envs), dtype=f32, device=device),
        nreal=m_e)
    f = ForceData(
        x=torch.as_tensor(rng.uniform(0.2, 1.0, (m_f, envs, d)), dtype=f32,
                          device=device),
        dxdr=torch.as_tensor(rng.uniform(-1, 1, (m_f, envs, d, 3)),
                             dtype=f32, device=device),
        ele=torch.as_tensor(rng.choice([13, 79], (m_f, envs)),
                            dtype=torch.int32, device=device),
        nreal=m_f)
    return e, f


def kernel_cases(kff, e1, f1, e2, f2, params):
    """(name, kernel call, plain call) for every kernel at the shapes of
    one serving request (e1, f1) against a training set (e2, f2)."""
    U1, w1 = kff.energy_operand(e1)
    X1, re1 = kff.force_operand(f1)
    U2, w2 = kff.energy_operand(e2)
    X2, re2 = kff.force_operand(f2)
    A1, B1, A2, B2 = e1.x.shape[1], f1.x.shape[1], e2.x.shape[1], \
        f2.x.shape[1]
    return [
        ("kff_tri",
         lambda: kff.kff_from_ops(X2, re2, B2, X2, re2, B2, params, 2,
                                  symmetric=True),
         lambda: kff.kff_plain(X2, re2, B2, X2, re2, B2, params, 2,
                               symmetric=True)),
        ("kef_rect",
         lambda: kff.kef_from_ops(U2, w2, A2, X2, re2, B2, params, 2),
         lambda: kff.kef_plain(U2, w2, A2, X2, re2, B2, params, 2)),
        ("kef_rect",
         lambda: kff.kef_from_ops(U1, w1, A1, X2, re2, B2, params, 2),
         lambda: kff.kef_plain(U1, w1, A1, X2, re2, B2, params, 2)),
        ("kef_rect",
         lambda: kff.kef_from_ops(U2, w2, A2, X1, re1, B1, params, 2),
         lambda: kff.kef_plain(U2, w2, A2, X1, re1, B1, params, 2)),
        ("kff_rect",
         lambda: kff.kff_from_ops(X1, re1, B1, X2, re2, B2, params, 2),
         lambda: kff.kff_plain(X1, re1, B1, X2, re2, B2, params, 2)),
    ]


def compare(torch, cases, tag, errs, log):
    for name, kern, plain in cases:
        K = kern()
        P = plain()
        torch.cuda.synchronize()
        err = float((K - P).abs().max())
        scale = float(P.abs().max())
        log(f"(b) {tag} {name} {tuple(K.shape)}: max|kernel-plain| = "
            f"{err:.3e}, max|plain| = {scale:.3e}")
        if not err <= KERNEL_RTOL * scale:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {tag}: {err:.3e} > {KERNEL_RTOL} * "
                                 f"{scale:.3e}")
        errs[name] = max(errs.get(name, 0.0), err)


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    import gpr_calculator_tpu_torch as T
    from gpr_calculator_tpu_torch import convert
    from gpr_calculator_tpu_torch.ops import kff
    from gpr_calculator_tpu_torch.ops import kernels as K_ops

    def log(msg):
        print(msg, flush=True)

    dev, f32 = torch.device("cuda"), torch.float32
    log(f"(a) card: {card_line()}")
    t0 = time.time()
    _, compiler_log = kff.build()
    log(f"(a) kernel build: {time.time() - t0:.1f} s")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"(a) ptxas: {line.strip()}")

    # (d) the main path, counted
    kff.reset_launches()
    t0 = time.time()
    gp, images, served = run_slice(T, dev, f32, log)
    torch.cuda.synchronize()
    main_launches = dict(kff.launches)
    log(f"(d) slice: {len(served)} requests in {time.time() - t0:.2f} s; "
        f"use_base={gp.use_base} use_surrogate={gp.use_surrogate} "
        f"fits={gp.fits} N_energy={gp.N_energy} N_forces={gp.N_forces}")
    for r in served:
        vals = np.concatenate([[r["E"], r["var_e"]], np.ravel(r["F"]),
                               np.ravel(r["var_f"])])
        if not np.all(np.isfinite(vals)):
            raise AssertionError("non-finite E/F/sigma in a slice request")
    if gp.error is None:
        raise AssertionError("the dispatcher never refit the model")
    log(f"(d) gp.error: {json.dumps(gp.error)}")
    if gp.error["energy_mae"] > 0.1 or gp.error["forces_mae"] > 0.3:
        raise AssertionError("training error above the dispatcher's gate")
    log("(d) gp.error under the gate (energy_mae <= 0.1, forces_mae <= 0.3)")

    # (f) every kernel ran on the main path
    log(f"(f) launches on the main path: {json.dumps(main_launches)}")
    for name, n in main_launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never ran on the main path")

    # (b) kernels vs plain, at the slice's shapes and at the bench shape
    params = gp.kernel.params()
    te, tf, _, _ = gp._train_view()
    from gpr_calculator_tpu_torch.atoms.atoms import ATOMIC_NUMBERS
    from gpr_calculator_tpu_torch.models.gp import _pack_from_device_descs
    dd = gp.descriptor.calculate_device(images[2], device=dev, dtype=f32)
    ele = np.asarray([ATOMIC_NUMBERS[s] for s in dd["elements"]])
    pe, pf = _pack_from_device_descs(
        [dd], [ele], [[i for i in range(len(ele))
                       if i not in set(images[2].fixed_indices())]])
    errs = {}
    slice_cases = kernel_cases(kff, pe, pf, te, tf, params)
    compare(torch, slice_cases, "slice", errs, log)
    be, bf = bench_data(torch, dev)
    bparams = {"sigma": 2.0, "l": 1.0}
    compare(torch, kernel_cases(kff, be, bf, be, bf, bparams), "bench",
            errs, log)

    # (c) PSD: the bench covariance plus noise factorises
    from gpr_calculator_tpu_torch.models.gp import _noise_diag
    Kb = K_ops.k_self(be, bf, bparams, 2)
    Kb.diagonal().add_(_noise_diag(be, bf, 0.01, 0.1))
    Lb, info = torch.linalg.cholesky_ex(Kb)
    if int(info) != 0:
        raise AssertionError(f"bench covariance not PD (info={int(info)})")
    log(f"(c) cholesky_ex of the {tuple(Kb.shape)} bench covariance: "
        f"info=0, min diag(L)={float(Lb.diagonal().min()):.4e}")
    del Kb, Lb

    # (e) frozen re-serve: card f32 kernels vs a CPU f64 plain model
    state = convert.state_of(gp)
    for key in ("alpha", "L", "n_fit"):
        state.pop(key, None)
    ref = convert.gp_from_state(state, device="cpu", dtype=torch.float64,
                                log_file=None)
    ref.fit(opt=False, show=False)
    for k, img in enumerate(images):
        E1, F1, _, _, _ = gp.predict_structure(img, return_std=True)
        E2, F2, _, _, _ = ref.predict_structure(img, return_std=True)
        dE, dF = abs(E1 - E2), float(np.abs(F1 - F2).max())
        log(f"(e) image {k}: |dE| = {dE:.3e} eV "
            f"(limit {0.1 * NOISE_E * len(img):.3e}), max|dF| = {dF:.3e} "
            f"eV/A (limit {0.1 * NOISE_F:.3e})")
        if dE > 0.1 * NOISE_E * len(img) or dF > 0.1 * NOISE_F:
            raise AssertionError("card model and CPU f64 model disagree")

    # (g) times at the slice's shapes and at a mid shape
    times = {}
    for name, kern, plain in slice_cases:
        if name not in times:
            times[name] = (cuda_ms(torch, kern, 50), cuda_ms(torch, plain, 10))
    for name, (ms, pms) in times.items():
        log(f"(g) slice {name}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    for tag, (m_e, m_f) in (("mid (250 E + 750 F)", (250, 750)),
                            ("bench (1000 E + 3000 F)", (1000, 3000))):
        me, mf = bench_data(torch, dev, m_e=m_e, m_f=m_f)
        seen = set()
        for name, kern, plain in kernel_cases(kff, me, mf, me, mf, bparams):
            if name in seen:
                continue
            seen.add(name)
            log(f"(g) {tag}, 32 envs, {name}: kernel "
                f"{cuda_ms(torch, kern, 3):.3f} ms, plain "
                f"{cuda_ms(torch, plain, 1):.3f} ms")

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name],
                "launches": main_launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]} for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
