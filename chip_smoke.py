#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (gpr_calculator_tpu_torch).

Usage (one CUDA card, no arguments):  python3 chip_smoke.py

To compare two revisions on one card in one process tree, instead of the
run below:  python3 chip_smoke.py --alt-source OTHER  times the highest
kernels and the mode K1-K3 kernels of the package's csrc/ and of another
revision's sources with the same entry points (OTHER: a directory of
.cu/.cuh files, or one .cu file such as an older csrc/kff.cu) in turns;
--alt-root OTHER_CHECKOUT  times one slice request's _predict_packed and
one bench NLL+gradient of each kernel family of this checkout and of
another in turns.

Builds the CUDA kernels from csrc/ and drives the port's main paths,
each with the launch counts reset just before and read just after, for
Au on Al(100) (13 atoms, SO3 nmax=3 lmax=4 rcut=5.0, zeta=2):
  (d) the serving slice: an RBF GP trained at fixed hyperparameters on
      three NEB images, served through the GPR calculator, which answers
      from the surrogate or calls EMT and refits;
  (h) training: GP.set_GPR on the five images, L-BFGS-B over the
      analytic RBF NLL (the dual kernels), its NLL and gradient held
      against a float64 CPU model of the same training set;
  (i) the on-the-fly NEB from that model, every refit re-optimising the
      hyperparameters, its barrier held against the JAX package's;
  (j) the same with the Dot kernel: GP.set_GPR(kernel="Dot") over the
      analytic Dot NLL, its NLL and gradient against float64, the NEB
      and a re-serve of its final model against float64 -- through the
      Dot kernels alone;
  (k1) the matmul precision modes: with config.set_kff_precision(
      "bf16x4"), set_GPR and the NEB (RBF, then Dot) through the
      tensor-core kernels of that mode alone, with the NLL and a
      re-serve against float64 recorded, then the RBF path once in
      "bf16" (its outcome recorded: it may end on another band, or at
      the dispatcher's training-error gate);
  (m) the batched paths: (m1) the 3 interior images of the slice band
      and the 7 of a 9-image band served by GP.predict_structures (one
      batched descriptor call, one served block) against the same images
      served one at a time, from the same descriptors and end to end, and
      against a CPU float64 model, with the host times of each form and
      of the descriptor step alone; (m2) the batched on-the-fly NEB
      (neb_calc(batched=True)), RBF then Dot, from set_GPR as in (i) /
      (j), its barrier held against the JAX package's batched run and set
      beside the serial NEB of this run; (m3) 100 perturbed 65-atom Al(100)
      slabs with an Au adatom, labelled by EMT, saved by a model built one
      structure at a time and read back by GP.load on the card (one
      batched float64 ingest, SO3.calculate_many), its descriptors against
      calculate in one group and in several, extract_db against the
      per-structure loop, the measured bytes per pair, the loaded
      model's served band against the saving model's and, end to end,
      against a float64 model of its training set on the card (the plain
      versions throughout), and where its float32 sigma_E moves between
      two identical calls (bands of 5 slabs from three seeds);
  (l) the mesh-sharded builds on a mesh of four shards over the cards
      present (shard i on card i % count, so on one card four virtual
      shards): (l1) the tile-range form of every K1 kernel in every mode
      against kff_plain(tiles=) and, summed over the shards, against the
      single launch bit for bit, and the K2/K3 stripes against the single
      launch; (l2) at the bench shape, in "highest" and "bf16x4",
      k_self_dual, both NLLs, _factorize with the replicated and the
      sharded Cholesky, cholesky_sharded and a served block, each against
      the unsharded one; (l3) GP(mesh=...) through set_GPR and the
      on-the-fly NEB with the sharded route forced, through range-form
      launches alone, then parallel.dryrun.dryrun_multichip(4); and the
      times of the sharded builds beside the single launches (on one
      card: overhead, not speed-up).
  (n) the incremental refit of fit(opt=False): (n1) at the 10k bench
      shape, in "highest" and "bf16x4", 25 and 100 rows appended to a
      factorised model, the blocks it builds against a full k_self, its
      served mean and sigma against a full refit, its launches (K2, K3 and
      one K1 over the new rows alone) and its time against a full
      _factorize; (n2) the on-the-fly Langevin MD/EOS example
      (examples/md_onthefly.py) at its full width, its final model held
      to a full refit on the card and to a CPU float64 model, and where
      the float32 model's distance from float64 comes from; (n3) the
      serial RBF NEB with opt_freq=3, its barrier against (i)'s.
  (o) the last modules of the JAX package: (o1) stress serving, an RBF
      model with SO3(stress=True) on LJ-labelled periodic Cu cells served
      by predict_structure(stress=True) and a GPR stress request against
      a CPU float64 model, K2 and K3 one launch a column group of three
      (3 each for the 9 columns, and the energy row's K2), the latency of
      a stress request beside a plain one; (o2) the Hutchinson trace of
      the NLL gradient at the 10k bench shape, RBF and Dot, highest and
      bf16x4, against the exact trace (value bit for bit, the gradient
      within the gate at 64 and 1024 probes), the ms and peak memory of
      each, and fit(trace="auto") taking the trace its gate decides;
      (o3) sparsify on the slice model beside a CPU float64 copy's, the
      refit against float64, and predict(return_cov=True) against
      predict's std.
  (p) float64 on the card, the JAX package's default x64 mode
      (GP(..., dtype=torch.float64)) on the _f64 kernels of
      csrc/kff_f64.cu: (p1) each of the twelve against its float64 plain
      version within 1e-12 max|plain| at the slice, mid and bench shapes,
      sorted and as packed, with its ptxas registers and spills, its
      time, plain time and bound, and its K1 tile ranges over four
      virtual shards summed bit for bit (the K2/K3 stripes too); (p2)
      set_GPR and the serial on-the-fly NEB, RBF then Dot, then the
      batched RBF NEB, the NLL and gradient at theta0 and theta* within
      1e-10 of the plain float64 build on the card and within 1e-9 of a
      CPU float64 model, and every NEB the JAX package's run (steps,
      counts, barrier within 1e-6 eV); (p3) the 10 000-row bench: the RBF
      and Dot NLL+gradient against the plain float64 build within 1e-10
      (the Dot gradient 1e-8), _factorize, a served 13-atom request and a
      25-row append, each against a float64 model built from the plain
      versions, with ms and peak memory; (p4) the MD example at full
      width (100 steps a volume), its final model against a CPU float64
      refit within 1e-8 eV and eV/A.  Every path counted: only _f64
      kernels, and no call of kff_plain or kef_plain.  After each path
      its _f64 kernels are held to their plain versions (1e-12
      max|plain|) at the shapes it gave them: each NEB's request against
      its final training set (the batched one: its band), the bench
      request against the factorised and the appended training set, the
      appended rows against the bench side and themselves, and the MD
      model's training set against the last volume's request.
(a)-(j), (m), (n) and (o) run in the default precision, "highest" ((n1)
and (o2) also in "bf16x4"); (m) runs after (j), (n) after (m), (o) after
(n), (p) after (l).  Around those runs it
checks every kernel (every mode, and the deriv and K3-dual kernels no
path reaches) against its plain PyTorch version at the paths' shapes --
the batched ones too: the bands of 3 and 7 structures as the query side
against the slice model's and the batched NEBs' training sets, and the
ingest's training set (K1 at its 6100 rows, K2 with 65 envs an energy
point) against its band of 5 slabs; the final MD model's training set
against the last volume's 8-atom request; each column group of the (o1)
stress requests against their training sets; the (n1) appended rows, sorted
as the refit sorts them, against the bench training side and against
themselves -- and at the 10k-covariance bench shape, and the card's bf16
split of the operand rows against the CPU's ((b), (k2)); factorises
that covariance in each mode and holds alpha from bf16x4 to float32
((c), (k3));
re-serves the frozen slice model against a float64 CPU model; times
kernel and plain versions at the slice, a mid and the bench shape, with
each one's bound on the card, and one NLL+gradient evaluation, and
compares that evaluation with float64 on the card (g).  For every kernel
(K1 kff_tri*, K2 kef_rect*, K3 kff_rect*, in highest and in the modes)
(b)/(k2) also run operands sorted by element and left as packed, and (g)
prints the wrapper call's time, the device time of one raw launch, the
launch floor (an empty kernel), the share of the bound reached at the mid
and bench shapes, what a launch skips (K1 in every mode: on sorted and
packed operands at the slice, mid and bench shapes), the host cost of a
mode kernel's tensor map
encoded anew, what sorting a side by element costs and saves at growing
sizes, one request's _predict_packed with the training side's operands
kept or rebuilt, and checks that a model serving twice builds
them once and that a request against the 10k bench set served from
_factorize's weights and factor (mean and sigma) equals a float64 solve
of the same covariance within a tenth of the noise.  Any
failure raises (non-zero exit); nothing falls back.  The third-to-last
line is a JSON list of the kernels, the second-to-last the card's name and
power limit, the last a JSON status object.
"""
import argparse
import contextlib
import json
import math
import os
import re
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
# card f32 vs CPU f64 NLL on one training set: |dNLL| <= 2e-4 |NLL_f64|,
# |dg| <= 2e-3 |g_f64| (about 5x the plain f32 readings on a CPU)
NLL_RTOL, GRAD_RTOL = 2e-4, 2e-3
THETA0 = (1.0, 0.1)    # set_GPR's starting (sigma, l)
# the JAX package's on-the-fly NEB (CPU float64): set_GPR + neb_calc(
# images, GPR(base=EMT(), ff=gp, save=False), fmax=0.05, steps=150)
JAX_NEB = dict(converged=True, nsteps=19, barrier=0.3555160, use_base=8,
               use_surrogate=51, fits=4, N_energy=13, N_forces=40)
# the same with GP.set_GPR(..., kernel="Dot") (zeta=2): its (sigma,
# sigma0), set_GPR's starting point, and the NEB
DOT_THETA = (0.5980691048753912, 1.6996223564233595)
DOT_THETA0 = (2.0, 2.0)
JAX_DOT_NEB = dict(converged=True, nsteps=24, barrier=0.3560402,
                   use_base=10, use_surrogate=64, fits=5, N_energy=15,
                   N_forces=40)
BARRIER_TOL = 0.01     # eV
# the JAX package's batched on-the-fly NEB (CPU float64): the same
# set_GPR, then neb_calc(..., batched=True)
JAX_BATCHED_NEB = dict(converged=True, nsteps=18, barrier=0.3569161,
                       use_base=9, use_surrogate=45, fits=4, N_energy=14,
                       N_forces=38)
JAX_BATCHED_DOT_NEB = dict(converged=True, nsteps=24, barrier=0.3539455,
                           use_base=9, use_surrogate=63, fits=5,
                           N_energy=14, N_forces=36)
# a batched band against the same images served one at a time, and a
# loaded model against the saving one, from the same descriptors and end
# to end: |dE|, |dsigma_E| <= BAND_TOL noise_e natoms,
# max|dF|, max|dsigma_F| <= BAND_TOL noise_f, a hundredth of the
# card-vs-float64 limits
BAND_TOL = 1e-3
# the batched ingest: N_INGEST perturbed 65-atom slabs, each with its
# energy and the forces of INGEST_FORCES atoms
N_INGEST, INGEST_FORCES = 100, 20
# (n1) rows appended to the 10 000-row bench set, (energy points, force
# points): one 8-atom structure's worth (1 E + 8 F = 25 rows) and 100 rows
APPENDS = ((1, 8), (10, 30))
# (n2) the on-the-fly MD example at its full width: one sweep of its seven
# volumes, 400 steps each; its noise (noise_e, noise_f)
MD_STEPS, MD_VOLUMES = 400, 7
MD_NOISE_E, MD_NOISE_F = 2e-3, 0.1
# (n3) the serial RBF NEB re-optimises at every opt_freq-th refit only
NEB_OPT_FREQ = 3
# (o1) the stress model: LJ labels of periodic Cu cells, its (sigma, l)
# (tests/test_stress.py's starting point, factorised there without the
# optimisation that runs sigma to its bound) and noise
STRESS_LJ = {"rc": 3.2, "sigma": 2.2, "epsilon": 0.4}
STRESS_THETA = (1.0, 0.8)
STRESS_NOISE = (0.002, 0.05)
# one NVIDIA H100 SXM (data sheet, dense): fp32 outside the tensor cores,
# bf16 on the tensor cores, and HBM3 bandwidth; fp64 on the CUDA cores and
# on the tensor cores (DMMA)
PEAK_FP32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
PEAK_FP64, PEAK_FP64_TC = 34e12, 67e12
MODES = ("bf16x4", "bf16")
# (p) float64 on the card: the _f64 kernels (csrc/kff_f64.cu) against
# their float64 plain versions, |diff| <= F64_RTOL max|plain|; the NLL
# and gradient against the plain float64 build on the card, relative; NEB
# barriers against the JAX package's, eV (the steps and counts equal);
# the MD model against a CPU float64 refit, eV, eV/A
F64 = "f64"
F64_RTOL, F64_NLL_RTOL, F64_BARRIER_TOL, F64_MD_TOL = 1e-12, 1e-10, 1e-6, \
    1e-8
# (p2) the NLL and gradient against a CPU float64 model, relative: the
# card's and the CPU's float64 linear algebra alone (the plain build on
# the card against the CPU model) read up to 1.9e-10 at set_GPR's start
# (cond(K) ~1e8)
F64_CPU_RTOL = 1e-9
# (p3) the bench gradient against the plain float64 build, relative, by
# kernel: the Dot one reads 5.4e-10 (dNLL/dsigma0 ~ 1 is a difference of
# traces ~1e4), 2.4e-8 between two plain builds that sum in other orders
F64_BENCH_GRAD_RTOL = {"RBF": 1e-10, "Dot": 1e-8}
# (p4) the MD example in float64 at full width, 100 steps a volume: at
# (n2)'s 400 the float64 sweep took the whole script past 450 s
F64_MD_STEPS = 100
PREC = {"highest": 0, "bf16x4": 1, "bf16": 2}   # template PREC
# kernel base name -> (template parameters <LC, MODE, SEL, KIND> -- MODE
# 1: the triangular K1, 0: the rectangular K2/K3 --, the Pallas kernel it
# replaces); each base runs in every precision mode
BASES = {
    "kff_tri": ("4,1,0,0", 282), "kff_tri_dual": ("4,1,1,0", 282),
    "kff_tri_deriv": ("4,1,2,0", 282), "kff_tri_dot": ("4,1,0,1", 282),
    "kef_rect": ("1,0,0,0", 748), "kef_rect_dual": ("1,0,1,0", 748),
    "kef_rect_deriv": ("1,0,2,0", 748), "kef_rect_dot": ("1,0,0,1", 748),
    "kff_rect": ("4,0,0,0", 269), "kff_rect_dual": ("4,0,1,0", 269),
    "kff_rect_deriv": ("4,0,2,0", 269), "kff_rect_dot": ("4,0,0,1", 269)}
# the kernels each family's main path runs (the deriv kernels and K3-dual
# are on no path of the JAX package or of the port)
RBF = ("kff_tri", "kff_tri_dual", "kef_rect", "kef_rect_dual", "kff_rect")
DOT = ("kff_tri_dot", "kef_rect_dot", "kff_rect_dot")
CSRC = "gpr_calculator_tpu_torch/csrc/"
# the tile-range form of the K1 kernels (the mesh-sharded training build)
K1_BASES = [b for b in BASES if b.startswith("kff_tri")]
RANGE_REPLACES = ("gpr_calculator_tpu/parallel/sharded_kernels.py:200, "
                  "gpr_calculator_tpu/ops/kff_pallas.py:703")
N_SHARDS = 4
# the twelve highest entry points: the eight rectangular ones run
# rect_kernel<LC, SEL, KIND>, the four K1 ones tri_kernel<SEL, KIND>
# (template parameters, here without the precision)
HIGHEST = list(BASES)
RECT = {b: v[0].replace(",0,", ",", 1) for b, v in BASES.items()
        if "_rect" in b}
TRI = {b: v[0][len("4,1,"):] for b, v in BASES.items()
       if b.startswith("kff_tri")}
# the sixteen mode K2/K3 entry points: rect_mma_kernel<LC, SEL, KIND,
# PREC>; the eight mode K1 ones: tri_mma_kernel<SEL, KIND, PREC>
MMA = {f"{b}_{m}": f"{params},{PREC[m]}" for m in MODES
       for b, params in RECT.items()}
TRI_MMA = {f"{b}_{m}": f"{params},{PREC[m]}" for m in MODES
           for b, params in TRI.items()}


def source_of(name):
    """The source file of kernel (or range launch) ``name``."""
    base, mode = split_name(name)
    if mode == F64:
        return CSRC + "kff_f64.cu"
    if base.startswith("kff_tri"):
        return CSRC + ("kff_tri.cu" if mode == "highest"
                       else "kff_tri_mma.cu")
    return CSRC + ("kff_rect.cu" if mode == "highest"
                   else "kff_rect_mma.cu")


def kname(base, mode):
    return base if mode == "highest" else f"{base}_{mode}"


def split_name(name):
    """kernel name -> (base, mode); mode F64 for the float64 kernels."""
    for mode in MODES + (F64,):
        if name.endswith("_" + mode):
            return name[:-len(mode) - 1], mode
    return name, "highest"


NAMES = [kname(b, m) for m in PREC for b in BASES]
RANGE_NAMES = [kname(b + "_range", m) for m in PREC for b in K1_BASES]
# the twelve float64 entry points: rect_f64_kernel<LC, SEL, KIND> (K2,
# K3) and tri_f64_kernel<SEL, KIND> (K1), and their range launches
F64_NAMES = [kname(b, F64) for b in BASES]
F64_RANGE_NAMES = [kname(b + "_range", F64) for b in K1_BASES]
RECT_F64 = {kname(b, F64): v for b, v in RECT.items()}
TRI_F64 = {kname(b, F64): v for b, v in TRI.items()}


def replaces(name):
    line = BASES[split_name(name)[0]][1]
    return f"gpr_calculator_tpu/ops/kff_pallas.py:{line}"


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


def slice_request(gp, image, device, dtype):
    """One structure packed as a served request: (EnergyData, ForceData)
    of its free atoms, from the descriptor on the card."""
    from gpr_calculator_tpu_torch.atoms.atoms import ATOMIC_NUMBERS
    from gpr_calculator_tpu_torch.models.gp import _pack_from_device_descs
    dd = gp.descriptor.calculate_device(image, device=device, dtype=dtype)
    ele = np.asarray([ATOMIC_NUMBERS[s] for s in dd["elements"]])
    fixed = set(image.fixed_indices())
    return _pack_from_device_descs(
        [dd], [ele], [[i for i in range(len(ele)) if i not in fixed]])


def run_training(T, device, dtype, kernel="RBF", mesh=None):
    """GP.set_GPR on the five images: EMT labels, add_structure, then
    fit(opt=True) -- L-BFGS-B from set_GPR's starting point over the
    analytic NLL of the kernel."""
    images = T.au_on_al100_images()
    gp = T.GP.set_GPR(images, T.EMT(), kernel=kernel, noise_e=NOISE_E,
                      noise_f=NOISE_F, log_file=None, device=device,
                      dtype=dtype, mesh=mesh)
    return gp, images


def run_neb(T, gp, images, batched=False):
    """The on-the-fly NEB through a GPR calculator at its defaults
    (opt_freq=1: every refit re-optimises the hyperparameters); batched:
    every interior image served by one batched prediction a step."""
    band = T.neb_calc(images, T.GPR(base=T.EMT(), ff=gp, save=False),
                      fmax=0.05, steps=150, batched=batched)
    E = np.asarray(band.energies, float)
    return dict(converged=bool(band.converged), nsteps=band.nsteps,
                barrier=float(E.max() - E[0]), use_base=gp.use_base,
                use_surrogate=gp.use_surrogate, fits=gp.fits,
                N_energy=gp.N_energy, N_forces=gp.N_forces), E


def ptxas_lines(compiler_log):
    """(kernel name, body, ptxas resource line) for each instantiation of
    tri_f64_kernel<SEL, KIND> and rect_f64_kernel<LC, SEL, KIND> (K1 and
    K2, K3 in float64), of
    tri_mma_kernel<SEL, KIND, PREC> (K1 in the bf16 modes), of
    rect_mma_kernel<LC, SEL, KIND, PREC> (K2, K3 in the bf16 modes), of
    rect_kernel<LC, SEL, KIND> (K2, K3 in highest) and of tri_kernel<SEL,
    KIND> (K1 in highest)."""
    bodies = {
        "tri_f64": (r"tri_f64_kernelILi(\d)ELi(\d)E",
                    {params: name for name, params in TRI_F64.items()}),
        "rect_f64": (r"rect_f64_kernelILi(\d)ELi(\d)ELi(\d)E",
                     {params: name for name, params in RECT_F64.items()}),
        "tri_mma": (r"tri_mma_kernelILi(\d)ELi(\d)ELi(\d)E",
                    {params: name for name, params in TRI_MMA.items()}),
        "rect_mma": (r"rect_mma_kernelILi(\d)ELi(\d)ELi(\d)ELi(\d)E",
                     {params: name for name, params in MMA.items()}),
        "rect": (r"rect_kernelILi(\d)ELi(\d)ELi(\d)E",
                 {params: b for b, params in RECT.items()}),
        "tri": (r"tri_kernelILi(\d)ELi(\d)E",
                {params: b for b, params in TRI.items()})}
    name = None
    for line in compiler_log.splitlines():
        found = [(body, re.search(pattern, line), names)
                 for body, (pattern, names) in bodies.items()]
        found = [(body, m, names) for body, m, names in found if m]
        if found:
            body, m, names = found[0]
            name = names.get(",".join(m.groups()), "?")
        elif "Compiling entry function" in line:
            name = None
        elif name and ("registers" in line or "spill" in line):
            yield name, body, line.strip()


def bench_data(torch, device, m_e=1000, m_f=3000, envs=32, d=30, seed=0):
    """bench.py's synthetic workload (1000 energy points, 3000 force
    points, 32 envs each, d=30: a 10k x 10k covariance), float32."""
    from gpr_calculator_tpu_torch.ops.packing import EnergyData, ForceData
    rng = np.random.RandomState(seed)
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


def bench_points(torch, device, m_e, m_f, seed):
    """bench_data(seed)'s rows as a GP's training points, with labels
    drawn from N(0, 0.1) (per-atom energies, force vectors)."""
    e, f = bench_data(torch, device, m_e, m_f, seed=seed)
    rng = np.random.RandomState(seed + 100)
    ex, ee = e.x.double().cpu().numpy(), e.ele.cpu().numpy()
    fx, fd, fe = (f.x.double().cpu().numpy(), f.dxdr.double().cpu().numpy(),
                  f.ele.cpu().numpy())
    return {"energy": [(ex[i], float(rng.normal(0.0, 0.1)), ee[i])
                       for i in range(m_e)],
            "force": [(fx[i], fd[i], rng.normal(0.0, 0.1, 3), fe[i])
                      for i in range(m_f)]}


def bench_gp(T, device, dtype, *point_sets):
    """An RBF GP at the bench's (sigma, l) = (2, 1) and noise (0.01, 0.1)
    holding the given training points, not fitted."""
    gp = T.GP(kernel=T.RBF(para=[2.0, 1.0], zeta=2), noise_e=0.01,
              noise_f=0.1, log_file=None, device=device, dtype=dtype)
    for pts in point_sets:
        gp.set_train_pts(pts, mode="a+")
    return gp


def served_off(a, b, m_e, natoms, noise):
    """|dE|, max|dF|, |dsigma_E|, max|dsigma_F| between two served
    (mean, std) of one structure (energy rows [:m_e], per atom), each
    over its limit, a tenth of the noise (E, sigma_E: of the structure's
    total)."""
    (ma, sa), (mb, sb) = a, b
    lim_e, lim_f = 0.1 * noise[0] * natoms, 0.1 * noise[1]
    return ((abs(ma[0] - mb[0]) * natoms, lim_e),
            (float(np.abs(ma[m_e:] - mb[m_e:]).max()), lim_f),
            (abs(sa[0] - sb[0]) * natoms, lim_e),
            (float(np.abs(sa[m_e:] - sb[m_e:]).max()), lim_f))


def run_incremental(T, torch, kff, dev, dtype, query, log, card,
                    m_e=1000, m_f=3000, reps=5):
    """(n1) The incremental refit at the bench shape, in highest and
    bf16x4: a GP holding bench_data's rows (m_e E + m_f F), factorised
    from scratch, takes the rows of APPENDS (drawn from the same
    generator) through fit(opt=False).  Gates: the cross block K(old,
    new) and the new self block the refit builds against the matching
    blocks of a full k_self within KERNEL_RTOL of their max; the extended
    model's served mean and sigma at the query points (``query``: the (g)
    request) against a full factorisation of the same rows on the card
    within a tenth of the noise; one incremental refit; and (in main)
    the launches.  Times: the append (blocks, chol_append, the host read
    of L_c's diagonal, chol_solve) against a full _factorize of the same
    rows, host clock to a synchronise, median of ``reps``; chol_append's
    new factor against the same append in place into a capacity
    buffer.
    Returns the launch counts of each incremental fit by (mode, k)."""
    from gpr_calculator_tpu_torch.models.gp import (_factorize,
                                                    _factor_perm,
                                                    _noise_diag)
    from gpr_calculator_tpu_torch.ops import kernels as K_ops
    from gpr_calculator_tpu_torch.ops import linalg
    pe, pf, natoms = query
    base = bench_points(torch, dev, m_e, m_f, seed=0)
    out = {}
    for mode in ("highest", "bf16x4"):
        T.config.set_kff_precision(mode)
        for kE, kF in APPENDS:
            tag = f"{mode}, {m_e} E + {m_f} F + {kE} E + {kF} F"
            new = bench_points(torch, dev, kE, kF, seed=1 + kE)
            gp = bench_gp(T, dev, dtype, base)
            gp.fit(opt=False, show=False)
            gp.set_train_pts(new, mode="a+")
            ref = bench_gp(T, dev, dtype, base, new)
            ref.fit(opt=False, show=False)
            # the blocks the refit builds against those of a full k_self
            B, C = gp._append_blocks(m_e, m_f)
            e_all, f_all, _, _ = ref._train_view()
            K = K_ops.k_self(e_all, f_all, ref.kernel.params(), 2,
                             dtype=torch.float64)
            K.diagonal().add_(_noise_diag(e_all, f_all, 0.01, 0.1))
            # packed rows of the old and the appended points in ref's K
            m = e_all.m
            old = torch.as_tensor(np.r_[:m_e, m:m + 3 * m_f], device=dev)
            add = torch.as_tensor(np.r_[m_e:m_e + kE,
                                        m + 3 * m_f:m + 3 * (m_f + kF)],
                                  device=dev)
            for what, got, want in (
                    ("cross block K(old, new)", B,
                     K[old[:, None], add[None, :]]),
                    ("new self block", C, K[add[:, None], add[None, :]])):
                want = want.double()
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                parts = {"EE": (slice(None, m_e), slice(None, kE)),
                         "EF": (slice(None, m_e), slice(kE, None)),
                         "FE": (slice(m_e, None), slice(None, kE)),
                         "FF": (slice(m_e, None), slice(kE, None))} \
                    if what.startswith("cross") else {}
                log(f"(n1) {tag}: {what} {tuple(got.shape)} against the "
                    f"full k_self's: max|diff| = {err:.3e}, max = "
                    f"{scale:.3e} (limit {KERNEL_RTOL} of max); by part "
                    + json.dumps({k: float((got[v] - want[v]).abs().max())
                                  for k, v in parts.items()}))
                if not err <= KERNEL_RTOL * scale:
                    raise AssertionError(f"(n1) {tag}: the {what} is not "
                                         "the full covariance's")
            del K
            # the append's time; chol_append (a new factor) against the
            # same append written in place into a float64 capacity buffer
            # of 256-row steps
            L0, k = gp.L_, C.shape[0]
            perm = _factor_perm([(m_e, m_f), (kE, kF)], m_e + kE)
            ylab = gp._y_factor_order(perm)

            def append():
                L, d = linalg.chol_append(L0, *gp._append_blocks(m_e, m_f))
                d.cpu()
                return linalg.chol_solve(L, ylab)
            n0 = L0.shape[0]
            cap = (n0 + k + 255) // 256 * 256
            buf = L0.new_zeros((cap, cap))
            buf[:n0, :n0] = L0

            def in_place():
                S = torch.linalg.solve_triangular(buf[:n0, :n0], B,
                                                  upper=False)
                buf[n0:n0 + k, :n0] = S.T
                buf[n0:n0 + k, n0:n0 + k] = torch.linalg.cholesky_ex(
                    C - S.T @ S)[0]
                return buf[:n0 + k, :n0 + k]
            y_all = ref._y_vector(e_all, f_all, ref.N_energy, ref.N_forces)
            t_app = host_ms(torch, append, reps)
            t_full = host_ms(torch, lambda: _factorize(
                e_all, f_all, y_all, ref.kernel.params(), 0.01, 0.1, 2,
                "rbf"), reps)
            t_cat = host_ms(torch, lambda: linalg.chol_append(L0, B, C),
                            reps)
            t_buf = host_ms(torch, in_place, reps)
            del buf
            kff.reset_launches()
            gp.fit(opt=False, show=False)
            torch.cuda.synchronize()
            out[(mode, kE + 3 * kF)] = dict(kff.launches)
            rs, rf = gp.refit_stats, ref.refit_stats
            log(f"(n1) [{card}] {tag}: the append (blocks, chol_append, "
                f"L_c's diagonal read, chol_solve) {t_app[1]:.3f} ms against "
                f"a full _factorize {t_full[1]:.3f} ms (median of {reps}, "
                f"min/max {t_app[0]:.3f}/{t_app[2]:.3f} and "
                f"{t_full[0]:.3f}/{t_full[2]:.3f}); chol_append (a new factor)"
                f" {t_cat[1]:.3f} ms, in place into a capacity buffer "
                f"{t_buf[1]:.3f} ms; refit_stats: this fit "
                f"{rs['incremental_ms']:.3f} ms incremental, the model's "
                f"first {rs['full_ms']:.3f} ms full, the reference's "
                f"{rf['full_ms']:.3f} ms full; launches "
                f"{json.dumps(nonzero(kff.launches))}")
            if rs["incremental"] != 1 or rs["full"] != 1:
                raise AssertionError(f"(n1) {tag}: refit_stats {rs}")
            te, tf, _, _ = gp._train_view()
            re_, rf_, _, _ = ref._train_view()
            offs = served_off(gp._serve(pe, pf, te, tf, True),
                              ref._serve(pe, pf, re_, rf_, True), pe.m,
                              natoms, (0.01, 0.1))
            log(f"(n1) {tag}: served against the full refit: |dE| "
                f"{offs[0][0]:.3e} eV, max|dF| {offs[1][0]:.3e} eV/A, "
                f"|dsigma_E| {offs[2][0]:.3e} eV, max|dsigma_F| "
                f"{offs[3][0]:.3e} eV/A (limits {offs[0][1]:.3e}, "
                f"{offs[1][1]:.3e})")
            if not all(np.isfinite(v) and v <= lim for v, lim in offs):
                raise AssertionError(f"(n1) {tag}: the extended model is "
                                     "not the full refit's")
            del gp, ref, B, C
    T.config.set_kff_precision("highest")
    return out


def run_md(T, torch, kff, K_ops, dev, dtype, log, card, steps=MD_STEPS,
           volumes=MD_VOLUMES, phase="(n2)", tol=None):
    """(n2) The on-the-fly MD/EOS example (examples/md_onthefly.run) at
    its full width on the card, counted: its record, the ms a step and
    the K1/K2/K3 launches a step, the training-side operand builds and
    what one costs at the final size.  Gates: at least one incremental
    refit; the final model's (the rows added after its last refit taken
    in first, by fit(opt=False), and logged) served E, F, sigma_E and
    sigma_F on the last volume's structure and four perturbed copies
    within a tenth of the noise of a full factorisation of the same
    training set on the card and of a CPU float64 model of it.  The full
    refit is held to the float64 model at the same limits, and where its
    distance from float64 comes from is recorded (``f64_split``).  tol
    (a float64 model): E and F held within ``tol`` (eV, eV/A) instead,
    sigma at the noise limits, and no ``f64_split``.
    Returns the launch counts (and plain-version calls), the final model
    and the last volume's structure."""
    from gpr_calculator_tpu_torch import convert
    from gpr_calculator_tpu_torch.examples import md_onthefly as ex
    kept = []

    class Kept(ex.Langevin):
        def run(self, n):
            kept.append(self.atoms)
            return super().run(n)

    orig, ex.Langevin = ex.Langevin, Kept
    kff.reset_launches()
    K_ops.reset_operand_builds()
    try:
        rec, gp = ex.run(steps_per_volume=steps, max_volumes=volumes,
                         device=dev, dtype=dtype)
    finally:
        ex.Langevin = orig
    torch.cuda.synchronize()
    launches = counted(kff)
    builds = dict(K_ops.operand_builds)
    log(f"{phase} [{card}] MD record: {json.dumps(rec)}")
    log(f"{phase} [{card}] {1e3 * rec['wall_s'] / rec['md_steps']:.3f} ms a "
        f"step (wall over {rec['md_steps']} steps); launches a step "
        f"{per_k(launches, rec['md_steps'])}; launches "
        f"{json.dumps(nonzero(launches))}; operand builds "
        f"{json.dumps(builds)}; refit_stats {json.dumps(gp.refit_stats)}")
    te, tf, _, _ = gp._train_view()
    t_ops = host_ms(torch, lambda: K_ops.side_operands(
        te, tf, T.config.kff_precision(), "train"), 5)
    log(f"{phase} [{card}] the training side's operands at the final "
        f"{te.m} E + {tf.m} F points ({tf.m * tf.x.shape[1]} force envs): "
        f"{t_ops[1]:.3f} ms a build (median of 5; rebuilt once after "
        f"each refit, {builds['train']} builds in the run)")
    if rec["refit_incremental"] < 1:
        raise AssertionError(f"{phase} the MD run made no incremental refit")
    queued = (gp.N_energy - te.nreal, gp.N_forces - tf.nreal)
    if any(queued):
        # rows added after the last refit: the model takes them (one more
        # incremental refit) so that it and the references hold one set
        gp.fit(opt=False, show=False)
    log(f"{phase} rows added after the MD model's last refit: {queued[0]} E + "
        f"{queued[1]} F" + (f", taken in by one more fit(opt=False): "
                            f"refit_stats {json.dumps(gp.refit_stats)}"
                            if any(queued) else ""))
    state = convert.state_of(gp)
    for key in ("alpha", "L", "n_fit"):
        state.pop(key, None)
    full = convert.gp_from_state(state, device=dev, dtype=dtype,
                                 log_file=None)
    full.fit(opt=False, show=False)
    cpu = cpu_f64_copy(T, gp, fit=True)
    if full.refit_stats["full"] != 1 or cpu.refit_stats["full"] != 1:
        raise AssertionError(f"{phase} the references were not refit in full")
    rng = np.random.RandomState(3)
    last = kept[-1]
    strucs = [last] + [perturbed(last, rng, 0.03) for _ in range(4)]
    models = {"MD model": gp, "card full refit": full, "CPU float64": cpu}
    bad = []

    def dist(a, b, n):
        """|dE|, max|dF|, |dsigma_E| (of the total), max|dsigma_F|."""
        return np.array([abs(a[0] - b[0]), float(np.abs(a[1] - b[1]).max()),
                         abs(a[3] - b[3]) * n,
                         float(np.abs(a[4] - b[4]).max())])
    for k, a in enumerate(strucs):
        out = {w: m.predict_structure(a, return_std=True)
               for w, m in models.items()}
        n = len(a)
        lim = 0.1 * np.array([MD_NOISE_E * n, MD_NOISE_F, MD_NOISE_E * n,
                              MD_NOISE_F])
        if tol is not None:
            lim[:2] = tol
        for one, other in (("MD model", "card full refit"),
                           ("MD model", "CPU float64"),
                           ("card full refit", "CPU float64")):
            d = dist(out[one], out[other], n)
            log(f"{phase} structure {k}, the {one} against the {other}: |dE| "
                f"{d[0]:.3e} eV, max|dF| {d[1]:.3e} eV/A, |dsigma_E| "
                f"{d[2]:.3e} eV, max|dsigma_F| {d[3]:.3e} eV/A (limits "
                f"{lim[0]:.3e}, {lim[1]:.3e}, {lim[2]:.3e}, {lim[3]:.3e})")
            if not (np.all(np.isfinite(d)) and np.all(d <= lim)):
                bad.append((k, one, other))
    if tol is None:
        f64_split(T, torch, kff, K_ops, full, strucs,
                  (MD_NOISE_E, MD_NOISE_F), log, phase)
    if bad:
        raise AssertionError(f"{phase} models outside a tenth of the noise "
                             f"(structure, model, reference): {bad}")
    return launches, gp, last


def run_neb_opt_freq(T, torch, kff, dev, dtype, log, barrier):
    """(n3) The serial RBF NEB from set_GPR, as in (i), with the
    hyperparameters re-optimised at every NEB_OPT_FREQ-th refit only (the
    rest incremental).  Gates: converged within 150 steps, at least one
    incremental refit, the barrier within BARRIER_TOL of (i)'s
    ``barrier``.  Returns the launch counts."""
    gp, images = run_training(T, dev, dtype)
    kff.reset_launches()
    t0 = time.time()
    calc = T.GPR(base=T.EMT(), ff=gp, save=False, opt_freq=NEB_OPT_FREQ)
    band = T.neb_calc(images, calc, fmax=0.05, steps=150)
    torch.cuda.synchronize()
    launches = dict(kff.launches)
    E = np.asarray(band.energies, float)
    bar = float(E.max() - E[0])
    log(f"(n3) NEB with opt_freq={NEB_OPT_FREQ}: {time.time() - t0:.2f} s, "
        f"converged {band.converged} in {band.nsteps} steps, barrier "
        f"{bar:.7f} eV ((i): {barrier:.7f}), base/surrogate/fits "
        f"{gp.use_base}/{gp.use_surrogate}/{gp.fits}, N_energy="
        f"{gp.N_energy} N_forces={gp.N_forces}; refit_stats "
        f"{json.dumps(gp.refit_stats)}; launches a step "
        f"{per_k(launches, band.nsteps)}")
    if not band.converged or band.nsteps > 150 or \
            gp.refit_stats["incremental"] < 1 or \
            abs(bar - barrier) > BARRIER_TOL:
        raise AssertionError("(n3) the opt_freq NEB did not converge with "
                             "an incremental refit to (i)'s barrier within "
                             f"{BARRIER_TOL} eV")
    return launches


MODEL_STEP = "K_EE and the energy prior in float64 (the model)"


def f64_split(T, torch, kff, K_ops, gp, strucs, noise, log, phase):
    """Which float32 ingredient of a float32 model carries its distance
    from float64.  ``gp`` (fitted in full) is rebuilt step by step, each
    factor and solve in float64 as ``_factorize`` and ``_predict_packed``
    do them, from the port's earlier all-float32 form -- the descriptors
    and labels rounded to float32, the whole training K (its noise added
    in float32) and the served block (K_EE rounded once) from the
    kernels, the energy prior from operands normalised in float64 -- to
    a float64 model of the same data (the plain versions, as
    ``card_f64_copy``), one ingredient more in float64 at each step:
    K_EE and the energy prior as the model now builds them (MODEL_STEP:
    the training and the served K_EE and the prior in float64 from the
    float32 operands), the training K_EF and K_FE, K_FF, then every block
    and the prior from operands built in float64 from the float32
    descriptors, the labels, the descriptors.  Every step serves
    ``strucs``; its distance from the float64 end is logged (|dE|,
    max|dF|, |dsigma_E|, max|dsigma_F|, the energies of the structure's
    total, each the max over the structures), MODEL_STEP's also from
    ``gp`` itself.  Recorded, not gated.  Returns {step: those four}."""
    from gpr_calculator_tpu_torch import convert
    from gpr_calculator_tpu_torch.models.gp import _noise_diag
    f64 = torch.float64
    params, zeta, kind = gp.kernel.params(), gp.kernel.zeta, gp.kernel.kind
    state = convert.state_of(gp)
    for key in ("alpha", "L", "n_fit"):
        state.pop(key, None)
    g64 = convert.gp_from_state(state, device=gp.device, dtype=f64,
                                log_file=None)
    nE, nF = gp.N_energy, gp.N_forces
    e64, f64s = g64._pack(nE, nF)
    e32, f32s = gp._pack(nE, nF)
    er, fr = to_f64(torch, e32, f32s)
    m = e32.m

    def noisy(K, e, f):
        K.diagonal().add_(_noise_diag(e, f, gp.noise_e, gp.noise_f))
        return K.to(f64)
    K32 = noisy(K_ops.k_self(e32, f32s, params, zeta, kind), e32, f32s)
    Km = noisy(K_ops.k_self(e32, f32s, params, zeta, kind, dtype=f64), e32,
               f32s)
    Kr = noisy(K_ops.k_self(er, fr, params, zeta, kind, plain=True), er, fr)
    K64 = noisy(K_ops.k_self(e64, f64s, params, zeta, kind, plain=True),
                e64, f64s)
    y32 = gp._y_vector(e32, f32s, nE, nF).to(f64)
    y64 = g64._y_vector(e64, f64s, nE, nF)
    parts = {"K_EF, K_FE": [(slice(None, m), slice(m, None)),
                            (slice(m, None), slice(None, m))],
             "K_FF": [(slice(m, None), slice(m, None))]}

    def hybrid(names):
        K = Km.clone()
        for name in names:
            for p in parts[name]:
                K[p] = Kr[p]
        return K
    # (step, K, y, served block and prior: "float32", "model" or "plain",
    # descriptors)
    steps = [("all float32 (K_EE too)", K32, y32, "float32", "rounded"),
             (MODEL_STEP, Km, y32, "model", "rounded"),
             ("+ K_EF, K_FE", hybrid(["K_EF, K_FE"]), y32, "model",
              "rounded"),
             ("+ K_FF", hybrid(["K_EF, K_FE", "K_FF"]), y32, "model",
              "rounded"),
             ("+ every block from float64 operands", Kr, y32, "plain",
              "rounded"),
             ("+ labels", Kr, y64, "plain", "rounded"),
             ("+ descriptors (the float64 model)", K64, y64, "plain",
              "float64")]
    queries = []
    for a in strucs:
        q64 = slice_request(g64, a, gp.device, f64)
        q32 = to_f64(torch, *q64, dtype=gp.dtype)
        queries.append((len(a), q64, q32))

    def serve(K, y, block, descs):
        L = torch.linalg.cholesky(K)
        alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
        te, tf = (e64, f64s) if descs == "float64" else (er, fr)
        out = []
        for n, q64, q32 in queries:
            pe, pf = q32
            if block == "float32":
                Kt = K_ops.k_block(pe, pf, e32, f32s, params, zeta,
                                   kind).to(f64)
                ee = K_ops.diag_energy(to_f64(torch, pe, pf)[0], params,
                                       zeta, kind)
            elif block == "model":
                Kt = K_ops.k_block(pe, pf, e32, f32s, params, zeta, kind,
                                   dtype=f64)
                ee = K_ops.diag_energy(pe, params, zeta, kind, dtype=f64)
            else:
                pe, pf = q64 if descs == "float64" else to_f64(torch, pe,
                                                                pf)
                Kt = plain_block(torch, kff, pe, pf, te, tf, params, zeta,
                                 kind)
                ee = K_ops.diag_energy(pe, params, zeta, kind)
            diag = torch.cat([ee, K_ops.diag_force(pf, params, zeta, kind)
                              .reshape(-1).to(f64)])
            V = torch.linalg.solve_triangular(L, Kt.T, upper=False)
            std = torch.clamp(diag - (V * V).sum(0), min=0.0).sqrt()
            out.append((n, pe.m, (Kt @ alpha).cpu().numpy(),
                        std.cpu().numpy()))
        return out
    served = {name: serve(K, y, block, descs)
              for name, K, y, block, descs in steps}
    end = served[steps[-1][0]]

    def dist(a, b):
        return np.max([[v for v, _ in served_off((ma, sa), (mb, sb), me, n,
                                                 noise)]
                       for (n, me, ma, sa), (_, _, mb, sb) in zip(a, b)], 0)
    own = [(n, me, *gp._serve(*q32, *gp._train_view()[:2], True))
           for (n, _, q32), (_, me, _, _) in zip(queries, end)]
    d_own = dist(served[MODEL_STEP], own)
    log(f"{phase} float64 split: '{MODEL_STEP}' against the model itself: "
        f"|dE| {d_own[0]:.3e} eV, max|dF| {d_own[1]:.3e} "
        f"eV/A, |dsigma_E| {d_own[2]:.3e} eV, max|dsigma_F| "
        f"{d_own[3]:.3e} eV/A")
    out = {}
    for name, *_ in steps:
        d = out[name] = dist(served[name], end)
        log(f"{phase} float64 split: {name} against float64: |dE| "
            f"{d[0]:.3e} eV, max|dF| {d[1]:.3e} eV/A, |dsigma_E| "
            f"{d[2]:.3e} eV, max|dsigma_F| {d[3]:.3e} eV/A (recorded)")
    return out


def to_f64(torch, e, f, dtype=None):
    """The (EnergyData, ForceData) pair with float64 descriptors (or
    ``dtype``'s)."""
    dt = torch.float64 if dtype is None else dtype
    return (e._replace(x=e.x.to(dt), counts=e.counts.to(dt)),
            f._replace(x=f.x.to(dt), dxdr=f.dxdr.to(dt)))


def pair_count(re1, B1, re2, B2, symmetric):
    """Valid same-element env pairs a block needs: the pairs whose
    coefficients are not zero, over the upper triangle of point pairs
    for a symmetric block (diagonal point blocks whole)."""
    v1, v2 = re1[0] != 0, re2[0] != 0
    total = diag = 0
    for el in re1[1][v1].unique().tolist():
        a, b = (re1[1] == el) & v1, (re2[1] == el) & v2
        total += int(a.sum()) * int(b.sum())
        if symmetric:
            per = a.reshape(-1, B1).sum(1).double()
            diag += int((per * per).sum())
    return (total + diag) // 2 if symmetric else total


def bound(mma_ops, fp32_ops, nbytes):
    """(least ms on the card, what binds it): the bf16 tensor-core
    operations at their peak plus the fp32 operations at the fp32 peak
    outside the tensor cores, or the bytes over the memory rate."""
    t_ops = mma_ops / PEAK_BF16 + fp32_ops / PEAK_FP32
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def bound_f64(dot_ops, asm_ops, nbytes):
    """(least ms on the card, what binds it) of a float64 kernel: the dot
    products at the FP64 tensor-core peak plus the assembly at the FP64
    CUDA-core peak, or the bytes over the memory rate."""
    t_ops = dot_ops / PEAK_FP64_TC + asm_ops / PEAK_FP64
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def range_pair_count(torch, kff, re, B, tiles):
    """pair_count of a tile-range launch of K1: the valid same-element
    env pairs of the point pairs p <= q inside upper-triangle tiles
    [k0, k0 + nk) (diagonal point blocks whole)."""
    m = re.shape[1] // B
    valid = re[0] != 0
    pairs = torch.zeros((m, m), dtype=torch.float64, device=re.device)
    for el in re[1][valid].unique().tolist():
        per = ((re[1] == el) & valid).reshape(m, B).sum(1).double()
        pairs += per[:, None] * per[None, :]
    own = kff.tile_mask(m, tiles, re.device)[::3, ::3]
    return int((pairs * torch.triu(own)).sum())


def work(name, d, lhs, rhs, out_numel, pairs=None):
    """(bf16 tensor-core operations, fp32 operations, bytes) one call of
    kernel ``name`` needs (``pairs``: the env pairs of a tile-range
    launch, whose bytes are the whole zeroed output and the operands):
    per valid same-element env pair, the 16 (K_FF)
    or 4 (K_EF) length-d dot products at 2 d operations each -- in fp32
    for highest, as four bf16 products (bf16x4) or one (bf16) on the
    tensor cores -- plus the coefficients and the assembly in fp32 (K_FF
    40 per plane set, 46 for the dK/dgamma one; K_EF 12 and 10); each
    operand read once, each output written once.  A float64 kernel
    (mode F64): the dot products in the first slot (``bound_f64`` puts
    them at the FP64 tensor-core peak), the assembly in the second, 8
    bytes an output element."""
    (X1, re1, B1), (X2, re2, B2) = lhs, rhs
    base, mode = split_name(name)
    base = base.removesuffix("_range")
    if pairs is None:
        pairs = pair_count(re1, B1, re2, B2, base.startswith("kff_tri"))
    kff_block = base.startswith("kff")
    dots = (16 if kff_block else 4) * 2 * d
    planes = (40, 46) if kff_block else (12, 10)
    asm = {"_dual": planes[0] + planes[1],
           "_deriv": planes[1]}.get(base[base.rfind("_"):], planes[0])
    mma = {"highest": 0, "bf16x4": 4 * dots, "bf16": dots, F64: dots}[mode]
    fp32 = asm + (dots if mode == "highest" else 0)
    tensors = {t.data_ptr(): t for t in (X1, re1, X2, re2)}.values()
    nbytes = sum(t.numel() * t.element_size() for t in tensors) \
        + (8 if mode == F64 else 4) * out_numel
    return pairs * mma, pairs * fp32, nbytes


def kernel_cases(kff, e1, f1, e2, f2, params, kind="rbf", mode="highest",
                 sort=None, query_only=False):
    """(name, kernel call, plain call, (mma ops, fp32 ops, bytes)) for
    every kernel of the family in ``mode`` at the shapes of one serving
    request (e1, f1) against a training set (e2, f2), zeta = 2; the
    operands are built in the mode (sort: their envs sorted by element,
    or not, or by the operand functions' default), and the plain version
    reads the same rounded values.  query_only: only the cases that read
    the request side (K2 both ways, K3).  mode F64: the float64 kernels,
    on float64 data (named ``<base>_f64``)."""
    prec = "highest" if mode == F64 else mode
    U1, w1 = kff.energy_operand(e1, prec, sort)
    X1, re1 = kff.force_operand(f1, prec, sort)
    U2, w2 = kff.energy_operand(e2, prec, sort)
    X2, re2 = kff.force_operand(f2, prec, sort)
    A1, B1, A2, B2 = e1.x.shape[1], f1.x.shape[1], e2.x.shape[1], \
        f2.x.shape[1]
    d = e2.x.shape[2]
    E1, F1, E2, F2 = (U1, w1, A1), (X1, re1, B1), (U2, w2, A2), (X2, re2, B2)

    def flags(base):
        return dict(dual=base.endswith("_dual"),
                    deriv=base.endswith("_deriv"), kind=kind)

    def kff_case(base, lhs, rhs, symmetric=False):
        fl = flags(base)

        def call(fn, **kw):
            return lambda: fn(*lhs, *rhs, params, 2, symmetric=symmetric,
                              **fl, **kw)
        out = 3 * (lhs[0].shape[-2] // lhs[2]) * 3 * (rhs[0].shape[-2]
                                                      // rhs[2])
        name = kname(base, mode)
        return (name, call(kff.kff_from_ops, mm_precision=prec),
                call(kff.kff_plain),
                work(name, d, lhs, rhs, out * (1 + fl["dual"])))

    def kef_case(base, lhs, rhs):
        fl = flags(base)

        def call(fn, **kw):
            return lambda: fn(*lhs, *rhs, params, 2, **fl, **kw)
        out = (lhs[0].shape[-2] // lhs[2]) * 3 * (rhs[0].shape[-2]
                                                  // rhs[2])
        name = kname(base, mode)
        return (name, call(kff.kef_from_ops, mm_precision=prec),
                call(kff.kef_plain),
                work(name, d, lhs, rhs, out * (1 + fl["dual"])))

    if kind == "dot":
        own = [lambda: kff_case("kff_tri_dot", F2, F2, symmetric=True),
               lambda: kef_case("kef_rect_dot", E2, F2)]
        cross = [lambda: kef_case("kef_rect_dot", E1, F2),
                 lambda: kef_case("kef_rect_dot", E2, F1),
                 lambda: kff_case("kff_rect_dot", F1, F2)]
    else:
        own = [lambda: kff_case("kff_tri", F2, F2, symmetric=True),
               lambda: kff_case("kff_tri_dual", F2, F2, symmetric=True),
               lambda: kff_case("kff_tri_deriv", F2, F2, symmetric=True),
               lambda: kef_case("kef_rect_dual", E2, F2),
               lambda: kef_case("kef_rect_deriv", E2, F2),
               lambda: kef_case("kef_rect", E2, F2)]
        cross = [lambda: kef_case("kef_rect", E1, F2),
                 lambda: kef_case("kef_rect", E2, F1),
                 lambda: kff_case("kff_rect", F1, F2),
                 lambda: kff_case("kff_rect_dual", F1, F2),
                 lambda: kff_case("kff_rect_deriv", F1, F2)]
    return [case() for case in (cross if query_only else own + cross)]


def all_cases(kff, e1, f1, e2, f2, params, dparams, modes=tuple(PREC),
              sort=None, query_only=False):
    """kernel_cases of both families in each of ``modes``."""
    kw = dict(sort=sort, query_only=query_only)
    return [c for m in modes
            for c in (kernel_cases(kff, e1, f1, e2, f2, params, mode=m, **kw)
                      + kernel_cases(kff, e1, f1, e2, f2, dparams, "dot",
                                     m, **kw))]


def compare(torch, cases, tag, errs, log, plain_ms=None, rtol=KERNEL_RTOL,
            phase=None):
    """Every plane of each kernel within ``rtol`` max|plain| of the same
    plane of its plain version (dual kernels: K and dK/dgamma); K1
    exactly symmetric.  plain_ms, when given, receives the time of each
    kernel's first plain call (CUDA events, one call)."""
    if phase is None:
        phase = "(b)" if all(split_name(c[0])[1] == "highest"
                             for c in cases) else "(k2)"
    for name, kern, plain, _ in cases:
        Ks = kern()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        Ps = plain()
        end.record()
        torch.cuda.synchronize()
        if plain_ms is not None:
            plain_ms.setdefault(name, start.elapsed_time(end))
        if not isinstance(Ks, tuple):
            Ks, Ps = (Ks,), (Ps,)
        for plane, (K, P) in zip(("K", "dK/dgamma"), zip(Ks, Ps)):
            err = float((K - P).abs().max())
            scale = float(P.abs().max())
            what = f"{name} {plane}" if len(Ks) > 1 else name
            log(f"{phase} {tag} {what} {tuple(K.shape)}: max|kernel-plain| "
                f"= {err:.3e}, max|plain| = {scale:.3e}")
            if not err <= rtol * scale:
                raise AssertionError(
                    f"{what} disagrees with its plain version at {tag}: "
                    f"{err:.3e} > {rtol} * {scale:.3e}")
            if name.startswith("kff_tri") and not torch.equal(K, K.T):
                raise AssertionError(f"{what} is not exactly symmetric")
            errs[name] = max(errs.get(name, 0.0), err)


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def counted(kff):
    """The launch counts and the plain versions' calls since the last
    ``kff.reset_launches()``."""
    return {**kff.launches, **kff.plain_calls}


def check_launches(counts, names, path, absent=()):
    """Every kernel of ``names`` ran on the path, none of ``absent``."""
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never ran on the {path} "
                                 "path")
    for name in absent:
        if counts[name] != 0:
            raise AssertionError(f"kernel {name} ran on the {path} path")


def nll_vs_f64(gp, ref, theta, tag, log, phase="(h)", gate=True):
    """Card f32 NLL and gradient against the CPU f64 model's at theta
    (held to the limits when ``gate``, else recorded)."""
    lml, g = gp.log_marginal_likelihood(list(theta), eval_gradient=True)
    lml64, g64 = ref.log_marginal_likelihood(list(theta), eval_gradient=True)
    dn, dg = abs(lml - lml64), float(np.linalg.norm(g - g64))
    gn = float(np.linalg.norm(g64))
    log(f"{phase} NLL at {tag} = ({theta[0]:.6g}, {theta[1]:.6g}): card "
        f"f32 {-lml:.8g}, CPU f64 {-lml64:.8g}, |dNLL| = {dn:.3e} "
        f"({dn / abs(lml64):.3e} relative, limit {NLL_RTOL}); grad card "
        f"{np.array2string(-g, precision=6)}, f64 "
        f"{np.array2string(-g64, precision=6)}, |dg| = {dg:.3e} "
        f"({dg / gn:.3e} relative, limit {GRAD_RTOL})"
        + ("" if gate else " (recorded, not a gate)"))
    if not np.isfinite(lml) or gate and not (dn <= NLL_RTOL * abs(lml64)
                                             and dg <= GRAD_RTOL * gn):
        raise AssertionError(f"card NLL/gradient at {tag} outside the "
                             "limits against float64")
    return -lml64, -g64


def cpu_f64_copy(T, gp, fit):
    """A CPU float64 model holding ``gp``'s training set (refit at its
    hyperparameters when ``fit``)."""
    import torch
    from gpr_calculator_tpu_torch import convert
    state = convert.state_of(gp)
    for key in ("alpha", "L", "n_fit"):
        state.pop(key, None)
    ref = convert.gp_from_state(state, device="cpu", dtype=torch.float64,
                                log_file=None)
    if fit:
        ref.fit(opt=False, show=False)
    return ref


def reserve_vs_f64(T, gp, images, log, phase, gate=True):
    """The card model and a CPU f64 model of its training set serve the
    images: |dE| <= 0.1 noise_e natoms, max|dF| <= 0.1 noise_f (held
    when ``gate``, else recorded)."""
    ref = cpu_f64_copy(T, gp, fit=True)
    for k, img in enumerate(images):
        E1, F1, _, _, _ = gp.predict_structure(img, return_std=True)
        E2, F2, _, _, _ = ref.predict_structure(img, return_std=True)
        dE, dF = abs(E1 - E2), float(np.abs(F1 - F2).max())
        log(f"{phase} image {k}: |dE| = {dE:.3e} eV "
            f"(limit {0.1 * NOISE_E * len(img):.3e}), max|dF| = {dF:.3e} "
            f"eV/A (limit {0.1 * NOISE_F:.3e})"
            + ("" if gate else " (recorded, not a gate)"))
        if not np.isfinite(E1) or gate and (
                dE > 0.1 * NOISE_E * len(img) or dF > 0.1 * NOISE_F):
            raise AssertionError("card model and CPU f64 model disagree")


def dot_nll_f32_ee(torch, gp, theta):
    """The card model's Dot NLL and dNLL/dsigma at theta with K_EE in
    float32 too (the port builds K_EE in float64 for the NLL): the
    reading that choice rests on."""
    from gpr_calculator_tpu_torch.models import gp as gp_mod
    from gpr_calculator_tpu_torch.ops import kernels as K_ops
    e, f = gp._pack(gp.N_energy, gp.N_forces)
    y = gp._y_vector(e, f, gp.N_energy, gp.N_forces)
    params = {"sigma": theta[0], "sigma0": theta[1]}
    nll, g = gp_mod._analytic_nll(
        K_ops.k_self(e, f, params, gp.kernel.zeta, "dot"), e, f, y,
        theta[0], gp.noise_e, gp.noise_f, gp.f_coef, False,
        lambda traces, alpha: torch.zeros((), dtype=torch.float64,
                                          device=alpha.device))
    return float(nll), float(g[0])


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

def device_us(torch, kff, base, lhs, rhs, params, reps=200, fns=None,
              outs=None):
    """Device time of one launch of entry point ``base`` (a highest or a
    mode kernel; its operands in that mode): CUDA events around ``reps``
    back-to-back launches through the bound ctypes entry point on
    preallocated outputs, no Python wrapper between them (uncounted: a
    measurement, not a path).  fns: the entry points of another library
    (``kff.load``); the package's own by default.  A K1 kernel (lhs is
    rhs) runs its whole tile range; where the library takes the k-major
    copy for it (``kff_tri_rows``), that copy is built once, before the
    launches.  outs: a list that receives the output planes."""
    (X1, r1, B1), (X2, r2, B2) = lhs, rhs
    m1, m2 = X1.shape[-2] // B1, X2.shape[-2] // B2
    rows = m1 if base.startswith("kef") else 3 * m1
    out = torch.empty((rows, 3 * m2), dtype=torch.float32, device=X1.device)
    outd = torch.empty_like(out)
    second = params.get("l")
    gamma = 0.0 if second is None else 1.0 / (2.0 * float(second) ** 2)
    lib = kff._lib() if fns is None else fns
    fn = lib[base]
    nk = kff.n_tri_tiles(m1) if base.startswith("kff_tri") else 0
    if nk and "kff_tri_rows" in lib and X2.dtype == torch.float32:
        X2 = kff.tri_operand(X2, r2, B2).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    args = (X1.data_ptr(), r1.data_ptr(), m1, B1, X2.data_ptr(),
            r2.data_ptr(), m2, B2, out.data_ptr(), outd.data_ptr(),
            float(params["sigma"]) ** 2, gamma, 2, 0, nk, 3 * m2, 0, stream)

    def call():
        if fn(*args) != 0:
            raise RuntimeError(f"{base} launch failed")
    us = 1e3 * cuda_ms(torch, call, reps)
    if outs is not None:
        outs.extend((out, outd))
    return us


def map_host_us(torch, kff, name, lhs, rhs, params, n=200):
    """Host time of one raw launch of the mode kernel ``name``, which in
    bf16x4 reads its sides through tensor maps: (us a launch with the lhs
    map found in the library's cache, us with it encoded anew).  The lhs
    sits at one address, or at 40 in turn -- more than the 32 maps a source
    keeps -- as a served request's new query side does; time.perf_counter
    around each of n asynchronous launches (uncounted; fewer than the
    launch queue holds, so none waits for the card), summed."""
    (X1, r1, B1), (X2, r2, B2) = lhs, rhs
    m1, m2 = X1.shape[-2] // B1, X2.shape[-2] // B2
    rows = m1 if name.startswith("kef") else 3 * m1
    out = torch.empty((rows, 3 * m2), dtype=torch.float32, device=X1.device)
    copies = [X1.clone() for _ in range(40)]
    fn = kff._lib()[name]
    stream = torch.cuda.current_stream().cuda_stream
    gamma = 1.0 / (2.0 * float(params["l"]) ** 2)

    def run(ptrs):
        torch.cuda.synchronize()
        total = 0.0
        for i in range(n):
            t0 = time.perf_counter()
            rc = fn(ptrs[i % len(ptrs)], r1.data_ptr(), m1, B1,
                    X2.data_ptr(), r2.data_ptr(), m2, B2, out.data_ptr(),
                    out.data_ptr(), float(params["sigma"]) ** 2, gamma, 2, 0,
                    0, 3 * m2, 0, stream)
            total += time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"{name} launch failed")
        torch.cuda.synchronize()
        return 1e6 * total / n
    run([X1.data_ptr()])
    return (run([X1.data_ptr()]), run([c.data_ptr() for c in copies]))


def host_ms(torch, fn, reps):
    """Host clock to a synchronise: (min, median, max) ms of ``reps``
    calls of ``fn``, each followed by torch.cuda.synchronize()."""
    ts = []
    for i in range(reps + 3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= 3:
            ts.append(1e3 * (time.perf_counter() - t0))
    return min(ts), float(np.median(ts)), max(ts)


def sort_readings(torch, kff, dev, log, card):
    """What sorting a side's envs by element costs and saves, at growing
    side sizes (force points x 32 envs, two elements at random, both sides
    of K3 alike): force_operand as packed and sorted (host clock to a
    synchronise, median of 10), and the device time of one kff_rect launch
    on either.  ops/kff.SORT_MIN_ENVS is set from these readings: below it
    the kernel saves less than the two sorts cost."""
    params = {"sigma": 2.0, "l": 1.0}
    for m, reps in ((13, 200), (32, 200), (64, 100), (128, 50), (256, 20),
                    (750, 5)):
        _, f = bench_data(torch, dev, m_e=8, m_f=m)
        build_ms, kernel_us = {}, {}
        for sort in (False, True):
            build_ms[sort] = host_ms(
                torch, lambda: kff.force_operand(f, "highest", sort), 10)[1]
            side = kff.force_operand(f, "highest", sort) + (32,)
            kernel_us[sort] = device_us(torch, kff, "kff_rect", side, side,
                                        params, reps)
        log(f"(g) [{card}] sorting a side of {m} points x 32 envs = "
            f"{32 * m} envs: force_operand as packed "
            f"{build_ms[False]:.3f} ms, sorted {build_ms[True]:.3f} ms "
            f"(+{1e3 * (build_ms[True] - build_ms[False]):.0f} us a side); "
            f"kff_rect {m} x {m} points on the card, as packed "
            f"{kernel_us[False]:.1f} us, sorted {kernel_us[True]:.1f} us "
            f"(-{kernel_us[False] - kernel_us[True]:.1f} us a launch); "
            f"the default {'sorts' if kff._sorts(None, m, 32) else 'keeps'}"
            " this side")


def sigma_vs_f64(torch, K_ops, pe, pf, be, bf, params, K, Kt, L, alpha,
                 natoms, log):
    """(g) the served sigma at n = 10 000: the 13-atom request through
    _predict_packed with _factorize's factor L, against sigma from a
    float64 factor and solve of the same K (noise on its diagonal) --
    sigma_E and every sigma_F within a tenth of the noise, the limits of
    the mean (bench noise 0.01 / 0.1).  Some force components of this
    symmetric request have no prior variance, so the variance is also
    read against the request's largest one.  Beside it, recorded: the
    same solve against the float64 factor rounded to float32.  Fails
    when _factorize's sigma is outside the limits."""
    from gpr_calculator_tpu_torch.models.gp import _predict_packed
    f64 = torch.float64
    diag = torch.cat([K_ops.diag_energy(pe, params, 2),
                      K_ops.diag_force(pf, params, 2).reshape(-1)]).to(f64)
    L64 = torch.linalg.cholesky(K.to(f64))

    def std_from(L_):
        V = torch.linalg.solve_triangular(L_, Kt.T.to(L_.dtype), upper=False)
        return torch.clamp(diag - (V.to(f64) ** 2).sum(0), min=0.0).sqrt()
    ref = std_from(L64)
    lim_e, lim_f = 0.1 * 0.01 * natoms, 0.1 * 0.1
    readings = {}
    for what, std in (("_factorize's factor", _predict_packed(
            pe, pf, be, bf, params, alpha, L, 2, True)[1].to(f64)),
            ("the float64 factor rounded to float32",
             std_from(L64.float()))):
        d = (std - ref).abs()
        dE, dF = float(d[0]) * natoms, float(d[pe.m:].max())
        dvar = float((std ** 2 - ref ** 2).abs().max() / (ref ** 2).max())
        readings[what] = (dE, dF)
        log(f"(g) bench sigma of the 13-atom request from {what} "
            f"({L.dtype if what.startswith('_f') else torch.float32}) "
            f"against a float64 factor and solve of the same K: "
            f"|dsigma_E| = {dE:.3e} eV (limit {lim_e:.3e}), max|dsigma_F| "
            f"= {dF:.3e} eV/A (limit {lim_f:.3e}); max|dsigma^2| = {dvar:.3e} "
            f"of the largest variance; sigma_E {float(ref[0]) * natoms:.3e}, "
            f"max sigma_F {float(ref[pe.m:].max()):.3e}")
    dE, dF = readings["_factorize's factor"]
    if not (dE <= lim_e and dF <= lim_f):
        raise AssertionError("the bench request's sigma from _factorize's "
                             "factor is outside the limits against a "
                             "float64 factor and solve of the same K")
    return readings


def k1_readings(torch, kff, shapes, log, card):
    """(g) the twelve K1 kernels (four in each mode) on operands sorted by
    element and left as packed: the device time of one raw launch, its
    share of the bound, and what a launch stages and multiplies (highest:
    ``staged_pairs`` in its triangle form, (lhs point, chunk pair)
    products; the modes: ``mma_pairs`` in its triangle form, warp
    products).  Returns {(shape, kernel name, sorted): device us}."""
    out = {}
    for tag, f, prm, dprm, reps in shapes:
        B, d = f.x.shape[1], f.x.shape[2]
        for sort in (True, False):
            for mode in PREC:
                X, re_ = kff.force_operand(f, mode, sort)
                side = (X, re_, B)
                if mode == "highest":
                    some, every = kff.staged_pairs(re_, B, re_, B,
                                                   triangle=True)
                    mine, prods = kff.staged_pairs(
                        re_, B, re_, B, triangle=True, per_lhs_point=True)
                    what = "(lhs point, chunk pair) products"
                else:
                    some, every, mine, prods = kff.mma_pairs(
                        re_, B, re_, B, triangle=True)
                    what = "warp products (16 x 8 env sub-tiles)"
                for base in K1_BASES:
                    name = kname(base, mode)
                    p_ = dprm if base.endswith("_dot") else prm
                    us = device_us(torch, kff, name, side, side, p_, reps)
                    out[(tag, name, sort)] = us
                    numel = (3 * f.m) ** 2 * (1 + base.endswith("_dual"))
                    bms, by = bound(*work(name, d, side, side, numel))
                    log(f"(g) [{card}] {tag} {name} ({f.m} points, envs "
                        f"{'sorted by element' if sort else 'as packed'}): "
                        f"device {us:.2f} us a launch, bound "
                        f"{1e3 * bms:.2f} us ({by}), {1e3 * bms / us:.3f} "
                        f"of the bound; staged {some / every:.3f} of the "
                        f"chunk pairs, multiplied {mine / prods:.3f} of the "
                        f"{what}")
    return out


def compare_sources(torch, T, kff, alt_source, log):
    """--alt-source: the device time of one launch of the twelve highest
    kernels but the three rectangular Dot ones (K1, K1-dual, K1-deriv,
    K1-dot, K2 and K3 with their dual and deriv forms), of the sixteen
    mode K2/K3 kernels and of the eight mode K1 kernels, from the
    package's csrc/ and from ``alt_source`` --
    another revision's sources with the same entry points, a directory or
    one .cu file -- in turns (other, own, own, other) inside this one
    process, at the slice, mid and bench shapes, on the same operands; and
    whether the two libraries' outputs are equal bit for bit."""
    dev, f32 = torch.device("cuda"), torch.float32
    card = card_line()
    t0 = time.time()
    libs = {"other": kff.load(kff.build(alt_source)[0]), "own": kff._lib()}
    # the other library's ring kernels need their shared-memory limit too
    if "kff_rect_init" in libs["other"] and libs["other"]["kff_rect_init"]():
        raise RuntimeError(f"kff_rect_init of {alt_source} failed")
    log(f"[{card}] both libraries built in {time.time() - t0:.1f} s; other: "
        f"{alt_source}")
    gp, images, _ = run_slice(T, dev, f32, lambda msg: None)
    pe, pf = slice_request(gp, images[2], dev, f32)
    te, tf, _, _ = gp._train_view()
    me, mf = bench_data(torch, dev, m_e=250, m_f=750)
    be, bf = bench_data(torch, dev)
    bparams = {"sigma": 2.0, "l": 1.0}
    names = [b for b in HIGHEST if b.startswith("kff_tri")
             or not b.endswith("_dot")] + list(MMA) + list(TRI_MMA)
    for tag, e1, f1, f2, prm, reps in (
            ("slice", pe, pf, tf, gp.kernel.params(), 200),
            ("mid", me, mf, mf, bparams, 5), ("bench", be, bf, bf, bparams, 3)):
        for mode in PREC:
            E1 = kff.energy_operand(e1, mode) + (e1.x.shape[1],)
            F1, F2 = (kff.force_operand(f, mode) + (f.x.shape[1],)
                      for f in (f1, f2))
            for name in [n for n in names if split_name(n)[1] == mode]:
                base = split_name(name)[0]
                lhs = E1 if base.startswith("kef") else \
                    F2 if base.startswith("kff_tri") else F1
                us = {"other": [], "own": []}
                outs = {"other": [], "own": []}
                prm_b = {"sigma": prm["sigma"], "sigma0": 2.0} \
                    if base.endswith("_dot") else prm
                for which in ("other", "own", "own", "other"):
                    us[which].append(device_us(
                        torch, kff, name, lhs, F2, prm_b, reps, libs[which],
                        outs[which] if not outs[which] else None))
                planes = list(zip(outs["other"], outs["own"]))[
                    :2 if base.endswith("_dual") else 1]
                same = all(torch.equal(a, b) for a, b in planes)
                diff = "" if same else " (max|own - other| = " + ", ".join(
                    f"{rel_to(b, a):.3e}" for a, b in planes) + " of max|other|)"
                log(f"[{card}] {tag} {name} ({lhs[0].shape[-2] // lhs[2]} x "
                    f"{F2[0].shape[-2] // F2[2]} points), device us a launch: "
                    f"other {us['other'][0]:.2f}, own {us['own'][0]:.2f}, own "
                    f"{us['own'][1]:.2f}, other {us['other'][1]:.2f}; outputs "
                    f"equal bit for bit: {same}{diff}")
                del outs


def predict_packed_of(torch, T, log):
    """--predict-packed: one slice request's _predict_packed (with std;
    host clock to a synchronise, min / median / max of 30) and one bench
    NLL+gradient of each kernel family (CUDA events, mean of 3) of the
    package this process imported, printed as one JSON line.  A model
    that keeps its training-side operands serves from them."""
    from gpr_calculator_tpu_torch.models.gp import (_nll_dot_analytic,
                                                    _nll_rbf_analytic,
                                                    _predict_packed)
    dev, f32 = torch.device("cuda"), torch.float32
    gp, images, _ = run_slice(T, dev, f32, lambda msg: None)
    pe, pf = slice_request(gp, images[2], dev, f32)
    te, tf, _, _ = gp._train_view()
    kept = getattr(gp, "_train_operands", None)
    kw = {} if kept is None else {"train_ops": kept()}
    ms = host_ms(torch, lambda: _predict_packed(
        pe, pf, te, tf, gp.kernel.params(), gp.alpha_, gp.L_, 2, True, "rbf",
        **kw), 30)
    be, bf = bench_data(torch, dev)
    y = torch.as_tensor(np.random.RandomState(1).normal(
        0.0, 0.1, be.m + 3 * bf.m), dtype=f32, device=dev)
    rest = (be, bf, y, (0.01, 0.1), 10.0, 2, False)
    nll_ms = {"rbf": cuda_ms(torch, lambda: _nll_rbf_analytic(
                  (2.0, 1.0), *rest), 3),
              "dot": cuda_ms(torch, lambda: _nll_dot_analytic(
                  (2.0, 2.0), *rest), 3)}
    log(json.dumps({"package": os.path.dirname(os.path.dirname(T.__file__)),
                    "card": card_line(), "predict_packed_ms":
                    dict(zip(("min", "median", "max"), ms)),
                    "bench_nll_ms": nll_ms}))


def compare_roots(alt_root, log):
    """--alt-root: _predict_packed and the bench NLLs of this checkout's
    package and of the one under ``alt_root`` (another revision's
    checkout), each in a process of its own (``--predict-packed``), in
    turns (other, own, own, other)."""
    for root in (alt_root, ROOT, ROOT, alt_root):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--predict-packed",
             "--package-root", root], capture_output=True, text=True,
            timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"--predict-packed failed for {root}:\n"
                               f"{res.stderr}")
        log(res.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# (m) the batched band, the batched NEB and the batched ingest
# ---------------------------------------------------------------------------

def band_diffs(a, b, natoms):
    """Between two lists of (E, F, E_std, F_std): the largest |dE| and
    max|dF|, and |dsigma_E| (of the structure's energy) and max|dsigma_F|
    as variances, each d sigma^2 over twice the largest sigma of ``b``
    (the sigma difference at the largest sigma that would move the
    variance as much).  Components with zero prior variance (this
    fixture's symmetry) keep a float32 variance at the rounding floor,
    whose square root is not reproducible from one call to the next."""
    def top(f):
        return max(f(x, y) for x, y in zip(a, b))
    se = max(float(y[2]) for y in b)
    sf = max(float(y[3].max()) for y in b)
    return (top(lambda x, y: abs(x[0] - y[0])),
            top(lambda x, y: abs(x[2] ** 2 - y[2] ** 2)) / (2 * se) * natoms,
            top(lambda x, y: float(np.abs(x[1] - y[1]).max())),
            top(lambda x, y: float(np.abs(x[3] ** 2 - y[3] ** 2).max()))
            / (2 * sf))


def from_descs(so3, band, descs, fn):
    """``fn()`` with ``so3``'s descriptor calls answered from ``descs``,
    one calculate_device dict a structure of ``band``."""
    by_id = {id(a): d for a, d in zip(band, descs)}
    so3.calculate_device = lambda atoms, atom_ids=None, device=None, \
        dtype=None: by_id[id(atoms)]
    so3.calculate_many_device = lambda atoms_list, dtype=None, \
        pair_budget=None, device=None: [by_id[id(a)] for a in atoms_list]
    try:
        return fn()
    finally:
        del so3.calculate_device, so3.calculate_many_device


def band_gate(d, natoms, tol, what, log, tag):
    """Hold band_diffs ``d`` to |dE|, |dsigma_E| <= tol noise_e natoms and
    max|dF|, max|dsigma_F| <= tol noise_f."""
    lim_e = tol * NOISE_E * natoms
    lim_f = tol * NOISE_F
    log(f"{tag}, {what}: |dE| {d[0]:.3e}, |dsigma_E| {d[1]:.3e} eV (limit "
        f"{lim_e:.3e}), max|dF| {d[2]:.3e}, max|dsigma_F| {d[3]:.3e} eV/A "
        f"(limit {lim_f:.3e})")
    if not (d[0] <= lim_e and d[1] <= lim_e and d[2] <= lim_f
            and d[3] <= lim_f):
        raise AssertionError(f"{tag}: {what} outside the limits")


def band_vs_serial(torch, T, kff, K_ops, gp, band, tag, log, card):
    """One band served by ``predict_structures`` against the same images
    served one at a time by ``predict_structure``: from the same
    descriptors and end to end, each call computing its own descriptors
    (both gated at BAND_TOL of the noise; each form against a repeat of
    itself recorded; each gated against a CPU float64 model of the same
    training set at a tenth of the noise).  The end-to-end forms also
    include the band served batched from one ``calculate_device`` an
    image.  Then the host times, the launches and operand builds.
    Returns the batched call's launches (the counts set to 0 just before
    it)."""
    natoms = len(band[0])
    so3 = gp.descriptor
    kff.reset_launches()
    batch = gp.predict_structures(band, return_std=True)
    torch.cuda.synchronize()
    launches = dict(kff.launches)

    def batched():
        return gp.predict_structures(band, return_std=True)

    def batched_per_image():
        so3.calculate_many_device = lambda atoms_list, dtype=None, \
            pair_budget=None, device=None: [
                so3.calculate_device(a, device=device, dtype=dtype)
                for a in atoms_list]
        try:
            return gp.predict_structures(band, return_std=True)
        finally:
            del so3.calculate_many_device

    def serial():
        return [(E, F, sE, sF) for E, F, _, sE, sF in
                (gp.predict_structure(a, return_std=True) for a in band)]
    descs = so3.calculate_many_device(band, device=gp.device,
                                      dtype=gp.dtype, pair_budget=math.inf)
    band_gate(band_diffs(from_descs(so3, band, descs, batched),
                         from_descs(so3, band, descs, serial), natoms),
              natoms, BAND_TOL, "batched vs one at a time, same "
              "descriptors", log, f"(m1) {tag}")
    forms = {"batched": batched,
             "batched, one calculate_device an image": batched_per_image,
             "one at a time": serial}
    one = serial()
    band_gate(band_diffs(batch, one, natoms), natoms, BAND_TOL,
              "batched vs one at a time, end to end", log, f"(m1) {tag}")
    f64 = cpu_f64_copy(T, gp, fit=True).predict_structures(band, True)
    for form, fn in forms.items():
        first = batch if form == "batched" else fn()
        for what, other in (("one at a time", one), ("itself", fn())):
            d = band_diffs(first, other, natoms)
            log(f"(m1) {tag}, {form} vs {what}, end to end: |dE| "
                f"{d[0]:.3e}, |dsigma_E| {d[1]:.3e} eV, max|dF| {d[2]:.3e}, "
                f"max|dsigma_F| {d[3]:.3e} eV/A (recorded)")
        band_gate(band_diffs(first, f64, natoms), natoms, 0.1,
                  f"{form} vs CPU float64, end to end", log, f"(m1) {tag}")
    for form, fn in forms.items():
        kff.reset_launches()
        K_ops.reset_operand_builds()
        fn()
        torch.cuda.synchronize()
        builds = dict(K_ops.operand_builds)
        log(f"(m1) {tag} {form}: launches {json.dumps(nonzero(kff.launches))}"
            f", operand builds {json.dumps(builds)}")
        if form == "batched" and builds != {"query": 1, "train": 0}:
            raise AssertionError("a batched band must build one query side "
                                 "and reuse the kept training operands")
    dev, dt = gp.device, torch.float64
    times = {form: host_ms(torch, fn, 20) for form, fn in forms.items()}
    times["descriptor, calculate_many_device"] = host_ms(
        torch, lambda: so3.calculate_many_device(band, device=dev, dtype=dt,
                                                 pair_budget=math.inf), 20)
    times["descriptor, calculate_device an image"] = host_ms(
        torch, lambda: [so3.calculate_device(a, device=dev, dtype=dt)
                        for a in band], 20)
    for form, (lo, med, hi) in times.items():
        log(f"(m1) [{card}] {tag} {form}: {med:.3f} ms median of 20 "
            f"(min {lo:.3f}, max {hi:.3f}), host clock to a synchronise")
    return launches


def band_request(gp, band):
    """A band packed as ``predict_structures`` serves it: (EnergyData,
    ForceData) of every structure's energy and free atoms, from one
    descriptor call on the card."""
    from gpr_calculator_tpu_torch.models.gp import _pack_structures
    descs = gp.descriptor.calculate_many_device(
        band, device=gp.device, dtype=gp.dtype, pair_budget=math.inf)
    return _pack_structures(band, descs)[:2]


def plain_block(torch, kff, pe, pf, te, tf, params, zeta, kind):
    """The served block [[K_EE, K_EF], [K_FE, K_FF]] of (pe, pf) against
    (te, tf) from the plain versions, in the data's dtype."""
    (U1, w1), (X1, re1) = (kff.energy_operand(pe, "highest"),
                           kff.force_operand(pf, "highest"))
    (U2, w2), (X2, re2) = (kff.energy_operand(te, "highest"),
                           kff.force_operand(tf, "highest"))
    A1, B1, A2, B2 = (pe.x.shape[1], pf.x.shape[1], te.x.shape[1],
                      tf.x.shape[1])
    return torch.cat([
        torch.cat([kff.kee_from_ops(U1, w1, A1, U2, w2, A2, params, zeta,
                                    kind=kind),
                   kff.kef_plain(U1, w1, A1, X2, re2, B2, params, zeta,
                                 kind=kind)], 1),
        torch.cat([kff.kef_plain(U2, w2, A2, X1, re1, B1, params, zeta,
                                 kind=kind).T,
                   kff.kff_plain(X1, re1, B1, X2, re2, B2, params, zeta,
                                 kind=kind)], 1)])


def card_f64_copy(T, torch, kff, K_ops, gp):
    """A float64 model of ``gp``'s training set on the card, fitted at its
    hyperparameters, through the plain versions (``plain_serve``: the
    reference a model on the kernels is held to).  The CPU float64 copy
    of (m1) would take minutes at the ingest's 6100 rows."""
    from gpr_calculator_tpu_torch import convert
    state = convert.state_of(gp)
    for key in ("alpha", "L", "n_fit"):
        state.pop(key, None)
    ref = convert.gp_from_state(state, device=gp.device,
                                dtype=torch.float64, log_file=None)
    serve, (e, f) = plain_serve(torch, kff, K_ops, ref)
    ref._fit_snapshot = (e, f, ref.N_energy, ref.N_forces)
    ref._serve = serve
    return ref


def plain_serve(torch, kff, K_ops, ref):
    """(serve, (e, f)) of the float64 GP ``ref``'s training set fitted at
    its hyperparameters through the plain versions on its device: the
    plain K, a float64 Cholesky factor and weights; serve(pe, pf, te, tf,
    return_std) takes the served block of float64 descriptors from the
    plain versions against (te, tf) = (e, f), with _predict_packed's mean
    and variance."""
    from gpr_calculator_tpu_torch.models.gp import _noise_diag
    e, f = ref._pack(ref.N_energy, ref.N_forces)
    y = ref._y_vector(e, f, ref.N_energy, ref.N_forces)
    params, zeta, kind = (ref.kernel.params(), ref.kernel.zeta,
                          ref.kernel.kind)
    K = K_ops.k_self(e, f, params, zeta, kind, plain=True)
    K.diagonal().add_(_noise_diag(e, f, ref.noise_e, ref.noise_f))
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]

    def serve(pe, pf, te, tf, return_std):
        Kt = plain_block(torch, kff, pe, pf, te, tf, params, zeta, kind)
        mean = (Kt @ alpha).cpu().numpy()
        if not return_std:
            return mean, None
        diag = torch.cat([K_ops.diag_energy(pe, params, zeta, kind),
                          K_ops.diag_force(pf, params, zeta,
                                           kind).reshape(-1)])
        V = torch.linalg.solve_triangular(L, Kt.T, upper=False)
        return mean, torch.clamp(diag - (V * V).sum(0), min=0.0) \
            .sqrt().cpu().numpy()
    return serve, (e, f)


def sigma_jitter(torch, K_ops, gp, ref, bands, log, card):
    """(m3) sigma_E of ``gp`` from two identical calls on each band, by
    the port (float64 descriptors rounded once, the energy diagonal, the
    solve against _factorize's float64 factor and the subtraction in
    float64) and by the float32 algebra it replaced (float32 descriptors,
    whose segment sums add in no fixed order on the card, a float32 solve
    against the factor rounded to float32 and a float32 subtraction).
    Recorded per band, sigma_E in eV of the structure: each one's move
    between the two calls and distance from ``ref`` (float64
    throughout), the prior over the posterior variance, and one float32
    step of the prior variance as a sigma_E difference."""
    from gpr_calculator_tpu_torch.models.gp import _pack_structures
    te, tf, _, _ = gp._train_view()
    params, zeta, kind = gp.kernel.params(), gp.kernel.zeta, gp.kernel.kind
    L32 = gp.L_.float()
    ops = gp._train_operands()
    for tag, band in bands.items():
        n, natoms = len(band), len(band[0])
        old, port, xs, prior = [], [], [], None
        for _ in range(2):
            descs = gp.descriptor.calculate_many_device(
                band, device=gp.device, dtype=torch.float32,
                pair_budget=math.inf)
            xs.append(torch.cat([d["x"] for d in descs]))
            pe, pf, _ = _pack_structures(band, descs)
            Kt = K_ops.k_block(pe, pf, te, tf, params, zeta, kind,
                               train_ops=ops)
            diag = K_ops.diag_energy(pe, params, zeta, kind)
            V = torch.linalg.solve_triangular(L32, Kt.T[:, :n], upper=False)
            var = (diag - (V * V).sum(0)).clamp(min=0)
            old.append(var.sqrt().double().cpu().numpy() * natoms)
            port.append(np.asarray([r[2] for r in gp.predict_structures(
                band, True)]) * natoms)
            prior = diag.double().cpu().numpy()
        truth = np.asarray([r[2] for r in ref.predict_structures(
            band, True)]) * natoms
        dx = float((xs[0] - xs[1]).abs().max() / xs[0].abs().max())
        ratio = prior / (truth / natoms) ** 2
        step = np.spacing(prior.astype(np.float32)).astype(float) \
            / (2 * truth / natoms) * natoms
        log(f"(m3) [{card}] sigma_E, {tag}: float32 descriptors of two "
            f"identical calls differ by {dx:.3e} of max|x|; sigma_E (float64"
            f" model) {truth.min():.4e}-{truth.max():.4e} eV, prior / "
            f"posterior variance {ratio.min():.3e}-{ratio.max():.3e}; one "
            f"float32 step of the prior variance moves sigma_E by "
            f"{step.min():.3e}-{step.max():.3e} eV")
        for what, (a, b) in (("float32 algebra (before)", old),
                             ("the port", port)):
            log(f"(m3) [{card}] sigma_E, {tag}, {what}: max move between "
                f"the two calls {np.abs(a - b).max():.3e} eV, max |d| from "
                f"the float64 model {np.abs(a - truth).max():.3e}, "
                f"{np.abs(b - truth).max():.3e} eV (recorded)")


def per_k(launches, nsteps):
    """K1 / K2 / K3 launches per NEB step."""
    fam = {"K1": "kff_tri", "K2": "kef_rect", "K3": "kff_rect"}
    return {k: round(sum(v for n, v in launches.items()
                         if n.startswith(p)) / nsteps, 3)
            for k, p in fam.items()}


def ingest_set(T, rng):
    """N_INGEST perturbed copies of a 4x4x4 Al(100) slab with an Au
    adatom in a four-fold hollow (65 atoms; bottom two layers fixed), and
    INGEST_FORCES free atoms of each."""
    from gpr_calculator_tpu_torch.atoms.build import fcc100_positions
    a = 4.05
    pos, cell, layer = fcc100_positions(a, (4, 4, 4), vacuum=4.0)
    s = a / np.sqrt(2.0)
    pos = np.vstack([pos, [[s, s, pos[:, 2].max() + 1.7]]])
    fixed = np.flatnonzero(layer < 2)
    free = np.setdiff1d(np.arange(len(pos)), fixed)
    strucs, f_ids = [], []
    for _ in range(N_INGEST):
        p = pos.copy()
        p[free] += rng.normal(0.0, 0.08, (len(free), 3))
        strucs.append(T.Atoms(symbols=["Al"] * (len(pos) - 1) + ["Au"],
                              positions=p, cell=cell,
                              pbc=[True, True, False],
                              constraints=[T.FixAtoms(indices=fixed)]))
        f_ids.append(sorted(int(i) for i in rng.choice(
            free, INGEST_FORCES, replace=False)))
    return strucs, f_ids


def per_structure_pts(gp, rows):
    """The training points of (atoms, energy, forces, force ids) rows as
    ``extract_db`` makes them, from one ``SO3.calculate`` a structure."""
    import torch
    from gpr_calculator_tpu_torch.atoms.atoms import ATOMIC_NUMBERS
    from gpr_calculator_tpu_torch.models.gp import _group_force_points
    pts = {"energy": [], "force": [], "db": []}
    for atoms, energy, force, fids in rows:
        d = gp.descriptor.calculate(atoms, device=gp.device,
                                    dtype=torch.float64)
        ele = np.asarray([ATOMIC_NUMBERS[e] for e in d["elements"]])
        pts["energy"].append((d["x"], energy / len(atoms), ele))
        for fid, (x, dx, el) in zip(fids, _group_force_points(d, ele,
                                                               fids)):
            pts["force"].append((x, dx, force[fid], el))
        pts["db"].append((atoms, energy, force, True, fids))
    return pts


def many_vs_one(torch, so3, strucs, one, dev, pair_budget, log):
    """calculate_many against one calculate a structure, float64: x and
    dxdr within 1e-12 of their largest magnitude."""
    many = so3.calculate_many(strucs, device=dev, dtype=torch.float64,
                              pair_budget=pair_budget)
    for key in ("x", "dxdr"):
        err = max(float(np.abs(m[key] - o[key]).max())
                  for m, o in zip(many, one))
        scale = max(float(np.abs(o[key]).max()) for o in one)
        log(f"(m3) calculate_many (pair budget {pair_budget}) vs calculate, "
            f"{key}: max|diff| {err:.3e} = {err / scale:.3e} of "
            f"max|{key}| (limit 1e-12)")
        if err > 1e-12 * scale:
            raise AssertionError(f"calculate_many's {key} is not "
                                 "calculate's")


def run_ingest(T, torch, kff, K_ops, dev, log, card):
    """(m3): N_INGEST labelled slabs saved by a model built one structure
    at a time, GP.load on the card (one batched float64 ingest), the
    descriptors against calculate, extract_db in both forms, the loaded
    model's served band against the saving model's, and end to end
    against a float64 model of its training set on the card, on bands of
    5 slabs from three seeds, with where its sigma_E moves.  Returns the
    launches of GP.load and its fit, the loaded model and its first
    band."""
    import tempfile
    from gpr_calculator_tpu_torch.atoms.neighborlist import neighbor_pairs
    from gpr_calculator_tpu_torch.ops import so3 as so3_mod
    f32, f64 = torch.float32, torch.float64
    rng = np.random.RandomState(10)
    strucs, f_ids = ingest_set(T, rng)
    rows = []
    for atoms, fids in zip(strucs, f_ids):
        a = atoms.copy()
        a.calc = T.EMT()
        e, f = a.get_potential_energy(), a.get_forces(apply_constraint=False)
        rows.append((atoms, float(e), np.asarray(f, float), fids))
    pairs = [len(neighbor_pairs(a, 5.0)[0]) for a in strucs]
    so3 = T.SO3(nmax=3, lmax=4, rcut=5.0)
    budget = so3.default_pair_budget(dev)
    log(f"(m3) [{card}] {N_INGEST} slabs of {len(strucs[0])} atoms, "
        f"{sum(pairs)} pairs ({min(pairs)}-{max(pairs)} a structure); "
        f"_so3_core float64 with derivatives: {so3.bytes_per_pair(dev):.0f} "
        f"bytes a pair (peak above the allocation, probe of "
        f"{so3_mod.PROBE_PAIRS} pairs); default pair budget {budget} "
        f"({so3_mod.MEMORY_SHARE} of the free memory)")
    one = [so3.calculate(a, device=dev, dtype=f64) for a in strucs]
    small = sum(pairs) // 5
    groups, cur = 1, 0
    for p in pairs:
        if cur and cur + p > small:
            groups, cur = groups + 1, 0
        cur += p
    for pb in (None, small):
        many_vs_one(torch, so3, strucs, one, dev, pb, log)
    log(f"(m3) groups: 1 at the default budget, {groups} at {small} pairs")
    if budget < sum(pairs) or groups < 4:
        raise AssertionError("the ingest is not one group at the default "
                             "budget and at least 4 at the small one")

    def model():
        return T.GP(kernel=T.RBF(para=[SIGMA, L_SCALE], zeta=2),
                    descriptor=T.SO3(nmax=3, lmax=4, rcut=5.0),
                    noise_e=NOISE_E, noise_f=NOISE_F, log_file=None,
                    device=dev, dtype=f32)
    sgp = model()
    sgp.set_train_pts(per_structure_pts(sgp, rows), "w")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        jf, db = os.path.join(tmp, "ingest.json"), os.path.join(tmp,
                                                              "ingest.db")
        sgp.save(jf, db, verbose=False)
        kff.reset_launches()
        t0 = time.time()
        lgp = T.GP.load(jf, device=dev, dtype=f32, log_file=None)
        lgp.fit(opt=False, show=False)
        torch.cuda.synchronize()
        launches = dict(kff.launches)
        log(f"(m3) GP.load + fit(opt=False): {time.time() - t0:.2f} s, "
            f"N_energy={lgp.N_energy} N_forces={lgp.N_forces}; launches "
            f"{json.dumps(nonzero(launches))}")
        if (lgp.N_energy, lgp.N_forces) != (N_INGEST,
                                            N_INGEST * INGEST_FORCES):
            raise AssertionError("GP.load did not load the training set")
        with open(jf) as fp:
            loop = T.GP.load_from_dict(json.load(fp), device=dev,
                                       dtype=f32, log_file=None)
        d = loop.descriptor
        d.calculate_many = lambda atoms_list, dtype=None, pair_budget=None, \
            device=None: [d.calculate(a, device=device, dtype=dtype)
                          for a in atoms_list]
        ms = {"per-structure loop": [], "calculate_many": []}
        for form in ("per-structure loop", "calculate_many",
                     "calculate_many", "per-structure loop"):
            g = loop if form == "per-structure loop" else lgp
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            g.extract_db(db)
            torch.cuda.synchronize()
            ms[form].append(1e3 * (time.perf_counter() - t0))
            peak = torch.cuda.max_memory_allocated(dev) - before
            log(f"(m3) [{card}] extract_db, {form}: {ms[form][-1]:.1f} ms, "
                f"peak {peak / 1e9:.3f} GB above the allocation")
        loop_ms, many_ms = (min(ms["per-structure loop"]),
                            min(ms["calculate_many"]))
        log(f"(m3) [{card}] extract_db of {N_INGEST} structures: "
            f"per-structure loop {loop_ms:.1f} ms, calculate_many "
            f"{many_ms:.1f} ms (min of two turns): {loop_ms / many_ms:.2f}x")
    sgp.fit(opt=False, show=False)
    bands = {f"band of 5 slabs, seed {seed}": ingest_set(
        T, np.random.RandomState(seed))[0][:5] for seed in (11, 12, 13)}
    band = bands["band of 5 slabs, seed 11"]
    natoms = len(band[0])
    descs = lgp.descriptor.calculate_many_device(band, device=dev, dtype=f32)
    band_gate(band_diffs(
        from_descs(lgp.descriptor, band, descs,
                   lambda: lgp.predict_structures(band, True)),
        from_descs(sgp.descriptor, band, descs,
                   lambda: sgp.predict_structures(band, True)), natoms),
        natoms, BAND_TOL, "loaded vs saving model, same descriptors", log,
        "(m3) served band of 5 slabs")
    band_gate(band_diffs(lgp.predict_structures(band, True),
                         sgp.predict_structures(band, True), natoms),
              natoms, BAND_TOL, "loaded vs saving model, end to end", log,
              "(m3) served band of 5 slabs")
    d = band_diffs(lgp.predict_structures(band, True),
                   lgp.predict_structures(band, True), natoms)
    log(f"(m3) served band of 5 slabs, loaded model vs itself, end to end: "
        f"|dE| {d[0]:.3e}, |dsigma_E| {d[1]:.3e} eV, max|dF| {d[2]:.3e}, "
        f"max|dsigma_F| {d[3]:.3e} eV/A (recorded)")
    t0 = time.time()
    ref = card_f64_copy(T, torch, kff, K_ops, lgp)
    log(f"(m3) float64 model of the loaded training set on the card, "
        f"plain versions: {time.time() - t0:.2f} s")
    for tag, b in bands.items():
        band_gate(band_diffs(lgp.predict_structures(b, True),
                             ref.predict_structures(b, True), natoms),
                  natoms, 0.1, "loaded model vs float64, end to end", log,
                  f"(m3) served {tag}")
    sigma_jitter(torch, K_ops, lgp, ref, bands, log, card)
    return launches, lgp, band


# ---------------------------------------------------------------------------
# (l) the mesh-sharded builds
# ---------------------------------------------------------------------------

def planes_of(x):
    return x if isinstance(x, tuple) else (x,)


def k1_flags(base, kind):
    return dict(dual=base.endswith("_dual"), deriv=base.endswith("_deriv"),
                kind=kind)


def sharded_k1(torch, kff, par, mesh, f, params, kind, mode, tag, errs, log,
               with_plain, rtol=KERNEL_RTOL, phase="(l1)"):
    """(l1) every K1 variant of the family in ``mode`` over the mesh's
    tile ranges: each shard's output within ``rtol`` max|plain| of
    kff_plain(tiles=) (``with_plain``), and the sum of the shards' outputs
    on the root equal to the single launch bit for bit, every plane
    exactly symmetric.  Float64 data: the float64 kernels (the ``_f64``
    range names)."""
    X, re = kff.force_operand(f, mode)
    B = f.x.shape[1]
    kmode = F64 if X.dtype == torch.float64 else mode
    ranges = par.partition_tri_tiles(kff.n_tri_tiles(f.m), mesh.size)
    shards = par.shard_train_data(mesh, X, re)
    bases = ("kff_tri_dot",) if kind == "dot" else (
        "kff_tri", "kff_tri_dual", "kff_tri_deriv")
    for base in bases:
        fl = k1_flags(base, kind)
        name = kname(base + "_range", kmode)
        single = planes_of(kff.kff_from_ops(
            X, re, B, X, re, B, params, 2, symmetric=True, mm_precision=mode,
            **fl))
        total = None
        for (Xs, res), tiles in zip(shards, ranges):
            if not tiles[1]:
                continue
            part = planes_of(kff.kff_from_ops(
                Xs, res, B, Xs, res, B, params, 2, symmetric=True,
                mm_precision=mode, tiles=tiles, **fl))
            if with_plain:
                plain = planes_of(kff.kff_plain(
                    Xs, res, B, Xs, res, B, params, 2, symmetric=True,
                    tiles=tiles, **fl))
                for K, P in zip(part, plain):
                    err, scale = float((K - P).abs().max()), \
                        float(P.abs().max())
                    if not err <= rtol * scale:
                        raise AssertionError(
                            f"{name} tiles {tiles} disagrees with "
                            f"kff_plain(tiles=) at {tag}: {err:.3e} > "
                            f"{rtol} * {scale:.3e}")
                    errs[name] = max(errs.get(name, 0.0), err)
            moved = [p.to(mesh.root) for p in part]
            if total is None:
                total = moved
            else:
                for acc, p in zip(total, moved):
                    acc.add_(p)
        for K, S in zip(total, single):
            if not (torch.equal(K, S) and torch.equal(K, K.T)):
                raise AssertionError(
                    f"the sum of {name} over {ranges} is not the single "
                    f"launch bit for bit at {tag} (max diff "
                    f"{float((K - S).abs().max()):.3e})")
        log(f"{phase} {tag} {name} {tuple(single[0].shape)}: tile ranges "
            f"{ranges}, sum over shards == single launch bit for bit"
            + (f", max|range - plain(tiles)| = {errs[name]:.3e}"
               if with_plain else ""))


def sharded_stripes(torch, kff, par, mesh, e, f, params, kind, mode, tag,
                    log, phase="(l1)"):
    """(l1) the K3 row stripes (kff_sharded) and the K2 energy-row stripes
    (kef_sharded), concatenated, equal the single launch bit for bit."""
    U, w = kff.energy_operand(e, mode)
    X, re = kff.force_operand(f, mode)
    A, B = e.x.shape[1], f.x.shape[1]
    kw = dict(kind=kind, mm_precision=mode)
    for what, single, parts in (
            ("K3", kff.kff_from_ops(X, re, B, X, re, B, params, 2, **kw),
             par.kff_sharded(f, params, mesh, 2, **kw)),
            ("K2", kff.kef_from_ops(U, w, A, X, re, B, params, 2, **kw),
             par.kef_sharded(e, f, params, mesh, 2, **kw))):
        striped = torch.cat([t.to(mesh.root) for t in parts])
        if not torch.equal(striped, single):
            raise AssertionError(f"{what} {kind} {mode} stripes differ from "
                                 f"the single launch at {tag}")
        log(f"{phase} {tag} {what} {kind} {mode} {single.dtype} "
            f"{tuple(single.shape)}: stripes "
            f"{[t.shape[0] for t in parts]} rows on "
            f"{[str(t.device) for t in parts]}, concatenated == single "
            "launch bit for bit")
        del striped, single, parts


def rel_to(a, b):
    """max|a - b| / max|b|."""
    return float((a - b).abs().max() / b.abs().max())


def sharded_bench(T, torch, K_ops, par, mesh, be, bf, pe, pf, params, y,
                  mode, log):
    """(l2) the slice at full width in ``mode``: every sharded build at
    the bench shape against the unsharded one."""
    from gpr_calculator_tpu_torch.models.gp import (
        _factorize, _nll_dot_analytic, _nll_rbf_analytic, _noise_diag,
        _predict_packed, _resolve_chol_mode)
    T.config.set_kff_precision(mode)
    m, n = be.m, be.m + 3 * bf.m
    tag = f"(l2) bench {mode}"
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    Ks = K_ops.k_self_dual(be, bf, params, mesh=mesh)
    peak = torch.cuda.max_memory_allocated() - base_mem
    Ku = K_ops.k_self_dual(be, bf, params)
    for plane, a, b in zip(("K", "dK/dgamma"), Ks, Ku):
        same = (torch.equal(a[m:, m:], b[m:, m:])
                and torch.equal(a[:m, m:], b[:m, m:])
                and torch.equal(a[m:, :m], b[m:, :m]))
        ee = rel_to(a[:m, :m], b[:m, :m])
        log(f"{tag} k_self_dual(mesh=) {plane}: K_FF, K_EF, K_FE equal the "
            f"unsharded ones bit for bit: {same}; K_EE max diff {ee:.3e} of "
            f"max|K_EE| (limit {KERNEL_RTOL})")
        if not same or not ee <= KERNEL_RTOL:
            raise AssertionError(f"sharded k_self_dual {plane} differs from "
                                 f"the unsharded one in {mode}")
    log(f"{tag} k_self_dual(mesh=): peak device memory above the data "
        f"{peak / 1e9:.3f} GB on {mesh}")
    del Ks, Ku, a, b
    chol = _resolve_chol_mode(mesh, n)
    log(f"{tag}: _resolve_chol_mode({mesh.size} shards, n={n}) = {chol}")
    for label, fn, theta in (("RBF", _nll_rbf_analytic, (2.0, 1.0)),
                             ("Dot", _nll_dot_analytic, (2.0, 2.0))):
        args = (theta, be, bf, y, (0.01, 0.1), 10.0, 2, False)
        nll_u, g_u = fn(*args)
        for cm in ("replicated", "sharded"):
            nll_s, g_s = fn(*args, mesh=mesh, chol_mode=cm)
            dn = abs(float(nll_s) - float(nll_u)) / abs(float(nll_u))
            dg = float((g_s - g_u).norm() / g_u.norm())
            log(f"{tag} {label} NLL(mesh=, chol_mode={cm}) {float(nll_s):.10g}"
                f" vs unsharded {float(nll_u):.10g}: {dn:.3e} relative, "
                f"gradient {dg:.3e} relative (limit 1e-6)")
            if not (dn <= 1e-6 and dg <= 1e-6):
                raise AssertionError(f"sharded {label} NLL differs from the "
                                     f"unsharded one in {mode}")
    # the covariance the factorisations see (float32 force blocks, K_EE
    # and the noise in float64) and its float64 weights: _factorize
    # solves in float64 whoever factors, so both sharded routes are held
    # to the unsharded weights
    K = K_ops.k_self(be, bf, params, 2, mesh=mesh, dtype=torch.float64)
    K.diagonal().add_(_noise_diag(be, bf, 0.01, 0.1))
    L64 = torch.linalg.cholesky(K)
    a64 = torch.cholesky_solve(y.double()[:, None], L64)[:, 0]
    L_u, a_u = _factorize(be, bf, y, params, 0.01, 0.1, 2, "rbf")
    e_u = rel_to(a_u.double(), a64)
    for cm in ("replicated", "sharded"):
        L_s, a_s = _factorize(be, bf, y, params, 0.01, 0.1, 2, "rbf",
                              mesh=mesh, chol_mode=cm)
        da, e_s = rel_to(a_s, a_u), rel_to(a_s.double(), a64)
        log(f"{tag} _factorize(mesh=, chol_mode={cm}): max|alpha - "
            f"alpha_unsharded| = {da:.3e} of max|alpha| (limit 1e-5); "
            f"against the float64 alpha of the same K {e_s:.3e} (the "
            f"unsharded alpha: {e_u:.3e})")
        if not da <= 1e-5:
            raise AssertionError(f"sharded _factorize alpha ({cm}) outside "
                                 f"its limit in {mode}")
    del L_s
    K = K.float()
    e_sh = rel_to(par.cholesky_sharded(K, mesh).double(), L64)
    e_lib = rel_to(torch.linalg.cholesky(K).double(), L64)
    log(f"{tag} cholesky_sharded of the {tuple(K.shape)} float32 covariance "
        f"against a float64 factor: {e_sh:.3e} of max|L| (the library's "
        f"float32 factor: {e_lib:.3e}; limit: twice that, or 5e-5)")
    if not e_sh <= max(2 * e_lib, 5e-5):
        raise AssertionError("cholesky_sharded is farther from the float64 "
                             "factor than twice the library's float32 one")
    del K, L64
    Kt_s = K_ops.k_block(pe, pf, be, bf, params, 2, mesh=mesh)
    Kt_u = K_ops.k_block(pe, pf, be, bf, params, 2)
    mean_s, std_s = _predict_packed(pe, pf, be, bf, params, a_u, L_u, 2,
                                    True, "rbf", mesh=mesh)
    mean_u, std_u = _predict_packed(pe, pf, be, bf, params, a_u, L_u, 2,
                                    True, "rbf")
    same = torch.equal(Kt_s, Kt_u)
    dm, ds = rel_to(mean_s, mean_u), rel_to(std_s, std_u)
    log(f"{tag} one 13-atom request against the bench training set: "
        f"k_block(mesh=) {tuple(Kt_s.shape)} equals the unsharded block bit "
        f"for bit: {same}; mean {dm:.3e}, std {ds:.3e} relative (limit "
        "1e-6)")
    if not (same and dm <= 1e-6 and ds <= 1e-6
            and bool(torch.isfinite(mean_s).all())):
        raise AssertionError(f"sharded serving differs from the unsharded "
                             f"one in {mode}")
    T.config.set_kff_precision("highest")


def sharded_times(torch, kff, K_ops, par, mesh, be, bf, pe, pf, bparams, y,
                  log):
    """The sharded builds at the bench shape beside the single launches
    (CUDA events).  Shards that share a card run one after the other, so
    these show the overhead of sharding, not a speed-up.  Returns
    (per-shard K1-dual range ms, single ms, reduction ms)."""
    from gpr_calculator_tpu_torch.models.gp import _nll_rbf_analytic
    card = card_line()
    X, re = kff.force_operand(bf, "highest")
    U, w = kff.energy_operand(be, "highest")
    A, B = be.x.shape[1], bf.x.shape[1]
    ranges = par.partition_tri_tiles(kff.n_tri_tiles(bf.m), mesh.size)
    shards = par.shard_train_data(mesh, X, re)
    kw = dict(symmetric=True, dual=True)
    single = cuda_ms(torch, lambda: kff.kff_from_ops(
        X, re, B, X, re, B, bparams, 2, **kw), 3)
    per = [cuda_ms(torch, lambda: kff.kff_from_ops(
        Xs, res, B, Xs, res, B, bparams, 2, tiles=t, **kw), 3)
        for (Xs, res), t in zip(shards, ranges)]
    parts = [kff.kff_from_ops(Xs, res, B, Xs, res, B, bparams, 2, tiles=t,
                              **kw) for (Xs, res), t in zip(shards, ranges)]

    def reduce():
        for plane in zip(*parts):
            acc = plane[0].to(mesh.root)
            for p in plane[1:]:
                acc.add_(p.to(mesh.root))
    red = cuda_ms(torch, reduce, 3)
    red_bytes = 2 * (mesh.size - 1) * 3 * parts[0][0].numel() * 4
    del parts
    log(f"(l) times [{card}] bench K1-dual, {mesh.size} tile ranges "
        f"{ranges}: per shard {[round(t, 3) for t in per]} ms (each with the "
        f"zero-fill of its two {(3 * bf.m, 3 * bf.m)} planes), sum "
        f"{sum(per):.3f} ms, "
        f"single launch {single:.3f} ms: sum over shards / single launch = "
        f"{sum(per) / single:.4f} (work proportionality; 1 is ideal); "
        f"largest shard / single = {max(per) / single:.4f} (the build's "
        "time on distinct cards, before the reduction)")
    log(f"(l) times [{card}] the reduction on the root ({mesh.size - 1} "
        f"adds of 2 planes, {red_bytes / 1e9:.3f} GB read and written): "
        f"{red:.3f} ms, bound {1e3 * red_bytes / PEAK_BYTES:.3f} ms (bytes)")
    ef_single = cuda_ms(torch, lambda: kff.kef_from_ops(
        U, w, A, X, re, B, bparams, 2, dual=True), 3)
    ef_stripes = cuda_ms(torch, lambda: [
        kff.kef_from_ops(U[p0 * A:p1 * A], w[:, p0 * A:p1 * A].contiguous(),
                         A, X, re, B, bparams, 2, dual=True)
        for p0, p1 in par.sharded_kernels.partition_points(be.m, mesh.size)],
        3)
    log(f"(l) times [{card}] bench K2-dual: {mesh.size} energy-row stripes "
        f"{ef_stripes:.3f} ms in all, single launch {ef_single:.3f} ms")
    # in turns, five times each: one reading of either is noise
    kb = {"sharded": [], "unsharded": []}
    for _ in range(5):
        kb["sharded"].append(cuda_ms(torch, lambda: K_ops.k_block(
            pe, pf, be, bf, bparams, 2, mesh=mesh), 10))
        kb["unsharded"].append(cuda_ms(torch, lambda: K_ops.k_block(
            pe, pf, be, bf, bparams, 2), 10))
    log(f"(l) times [{card}] one 13-atom request against the bench training "
        f"set, k_block, 5 turns of 10 calls: column stripes over "
        f"{mesh.size} shards " + " / ".join(f"{t:.3f}" for t in
                                            sorted(kb["sharded"]))
        + " ms, unsharded " + " / ".join(f"{t:.3f}" for t in
                                         sorted(kb["unsharded"])) + " ms")
    ks_single = cuda_ms(torch, lambda: K_ops.k_self_dual(be, bf, bparams), 3)
    ks_mesh = cuda_ms(torch, lambda: K_ops.k_self_dual(be, bf, bparams,
                                                       mesh=mesh), 3)
    args = ((2.0, 1.0), be, bf, y, (0.01, 0.1), 10.0, 2, False)
    nll_single = cuda_ms(torch, lambda: _nll_rbf_analytic(*args), 3)
    nll_mesh = cuda_ms(torch, lambda: _nll_rbf_analytic(*args, mesh=mesh), 3)
    nll_chol = cuda_ms(torch, lambda: _nll_rbf_analytic(
        *args, mesh=mesh, chol_mode="sharded"), 3)
    log(f"(l) times [{card}] bench k_self_dual: sharded {ks_mesh:.3f} ms, "
        f"unsharded {ks_single:.3f} ms; one RBF NLL + gradient: sharded "
        f"build {nll_mesh:.3f} ms, sharded build and sharded float64 "
        f"Cholesky {nll_chol:.3f} ms, unsharded {nll_single:.3f} ms (shards "
        "on one card run in turn: overhead, not speed-up)")
    return per, single, red


def range_times(torch, kff, par, mesh, f, params, dparams, reps, plain_reps):
    """{range kernel name: (ms, plain ms, bound ms, bound by, per-shard
    ms, single-launch ms)} at one shape: shard 0's tile range of every K1
    variant in every mode, timed beside kff_plain(tiles=) (``plain_reps``
    calls; 0: not timed) and its bound, then every shard's range and the
    single launch."""
    out = {}
    B = f.x.shape[1]
    ranges = par.partition_tri_tiles(kff.n_tri_tiles(f.m), mesh.size)
    for mode in PREC:
        X, re = kff.force_operand(f, mode)
        shards = par.shard_train_data(mesh, X, re)
        for base in K1_BASES:
            kind = "dot" if base.endswith("_dot") else "rbf"
            fl = k1_flags(base, kind)
            prm = dparams if kind == "dot" else params
            name = kname(base + "_range", mode)

            def call(s, fn=kff.kff_from_ops, **kw):
                Xs, res = shards[s]
                return lambda: fn(Xs, res, B, Xs, res, B, prm, 2,
                                  symmetric=True, tiles=ranges[s], **fl, **kw)
            per = [cuda_ms(torch, call(s, mm_precision=mode), reps)
                   for s in range(mesh.size) if ranges[s][1]]
            single = cuda_ms(torch, lambda: kff.kff_from_ops(
                X, re, B, X, re, B, prm, 2, symmetric=True,
                mm_precision=mode, **fl), reps)
            pms = cuda_ms(torch, call(0, fn=kff.kff_plain), plain_reps) \
                if plain_reps else None
            out_numel = (3 * f.m) ** 2 * (1 + fl["dual"])
            bms, by = bound(*work(
                name, f.x.shape[2], (X, re, B), (X, re, B), out_numel,
                pairs=range_pair_count(torch, kff, re, B, ranges[0])))
            out[name] = (per[0], pms, bms, by, per, single)
    return out


# ---------------------------------------------------------------------------
# (o) stress serving, the Hutchinson trace, sparsify and the covariance
# ---------------------------------------------------------------------------

def periodic_cu(T, seed, natoms=4, a=3.8):
    """tests/test_stress.py's make_periodic: a distorted fcc-like periodic
    Cu cell with a triclinic tilt (the off-diagonal strain rows live)."""
    rng = np.random.RandomState(seed)
    frac = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                     [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])[:natoms]
    cell = np.eye(3) * a
    cell[0, 1] = 0.13 * a
    pos = frac @ cell + 0.05 * a * rng.randn(natoms, 3)
    return T.Atoms(numbers=[29] * natoms, positions=pos, cell=cell, pbc=True)


def stress_model(T, dev, dtype):
    """An RBF GP with SO3(nmax=2, lmax=2, rcut=3.2, stress=True) trained on
    five periodic Cu cells labelled by LJ (tests/test_stress.py's lj_gp),
    at (sigma, l) = STRESS_THETA, factorised once (fit(opt=False))."""
    from gpr_calculator_tpu_torch.calculators.lj import LJ
    lj = LJ(STRESS_LJ)
    gp = T.GP(kernel=T.RBF(para=list(STRESS_THETA), zeta=2),
              descriptor=T.SO3(nmax=2, lmax=2, rcut=STRESS_LJ["rc"],
                               stress=True),
              noise_e=STRESS_NOISE[0], noise_f=STRESS_NOISE[1],
              log_file=None, device=dev, dtype=dtype)
    for k in range(5):
        s = periodic_cu(T, 10 + k)
        e, f, _ = lj.calculate(s)
        gp.add_structure((s, e, f))
    gp.fit(opt=False, show=False)
    return gp


def stress_request(gp, atoms):
    """One structure packed as a served stress request on the model's
    device: (EnergyData, ForceData with 9 columns) of every atom."""
    from gpr_calculator_tpu_torch.atoms.atoms import ATOMIC_NUMBERS
    from gpr_calculator_tpu_torch.models.gp import _pack_from_device_descs
    dd = gp.descriptor.calculate_device(atoms, device=gp.device,
                                        dtype=gp.dtype)
    ele = np.asarray([ATOMIC_NUMBERS[s] for s in dd["elements"]])
    return _pack_from_device_descs([dd], [ele], [list(range(len(ele)))],
                                   stress=True)


def column_groups(f):
    """The 3-column ForceData of each group of three cartesian columns of
    a 9-column side: each gives the operand ``force_operands`` builds for
    that group, so the kernel cases read what a stress request reads."""
    return [f._replace(dxdr=f.dxdr[..., c:c + 3].contiguous())
            for c in range(0, f.ncart, 3)]


def run_stress(T, torch, kff, dev, log, card, slice_gp, slice_image):
    """(o1) stress serving on the card: the LJ periodic-Cu model served
    through predict_structure(stress=True) and a GPR stress request,
    counted, against a CPU float64 model of the same training set: E
    within 0.1 noise_e natoms, F and sigma_F within 0.1 noise_f, each
    atom's 6 stress rows within 0.1 noise_f rcut / V (the force limit
    carried through the strain rows' r / V), their sum within natoms
    times that; K3 3 and K2 4 (3 K_FE + the energy row's K_EF) launches a
    request, nothing else.  Then the latency of a stress request beside a
    plain one, on this model and on a stress-enabled copy of the slice
    model.  Returns (launches, the column-group shapes for (b)/(k2))."""
    from gpr_calculator_tpu_torch import convert
    from gpr_calculator_tpu_torch.calculators.lj import LennardJones
    f32 = torch.float32
    gp = stress_model(T, dev, f32)
    ref = cpu_f64_copy(T, gp, fit=True)
    probes = [periodic_cu(T, s) for s in (30, 31, 32)]
    calcs = []
    for model in (gp, ref):
        calc = T.GPR(base=LennardJones(STRESS_LJ), ff=model, save=False,
                     stress=True)
        calc.verbose = False
        calc.freeze()
        calcs.append(calc)
    kff.reset_launches()
    served = [gp.predict_structure(a, stress=True, return_std=True)
              for a in probes]
    calcs[0].calculate(probes[0].copy(), ["energy", "forces", "stress"])
    torch.cuda.synchronize()
    launches = dict(kff.launches)
    n_req = len(probes) + 1
    log(f"(o1) launches in {n_req} stress requests: "
        f"{json.dumps(nonzero(launches))}")
    check_launches(launches, ("kef_rect", "kff_rect"), "stress",
                   absent=[n for n in NAMES
                           if n not in ("kef_rect", "kff_rect")])
    if launches["kff_rect"] != 3 * n_req or \
            launches["kef_rect"] != 4 * n_req:
        raise AssertionError("a stress request takes 3 K3 and 4 K2 "
                             "launches (a launch per column group)")
    noise_e, noise_f = STRESS_NOISE
    for a, (E, F, S, sE, sF) in zip(probes, served):
        rE, rF, rS, rsE, rsF = ref.predict_structure(a, stress=True,
                                                     return_std=True)
        n, V = len(a), a.get_volume()
        lim_s = 0.1 * noise_f * STRESS_LJ["rc"] / V
        offs = (("E", abs(E - rE), 0.1 * noise_e * n),
                ("sigma_E", abs(sE - rsE), 0.1 * noise_e * n),
                ("F", float(np.abs(F - rF).max()), 0.1 * noise_f),
                ("sigma_F", float(np.abs(sF - rsF).max()), 0.1 * noise_f),
                ("S rows", float(np.abs(S - rS).max()), lim_s),
                ("S sum", float(np.abs(S.sum(0) - rS.sum(0)).max()),
                 n * lim_s))
        log(f"(o1) [{card}] stress request ({n} atoms, V = {V:.3f} A^3) "
            "against CPU f64: " + ", ".join(
                f"|d{k}| {v:.3e} (limit {lim:.3e})" for k, v, lim in offs)
            + f"; max|S| {np.abs(rS).max():.4f} eV/A^3")
        if not all(np.isfinite(v) and v <= lim for _, v, lim in offs):
            raise AssertionError("the card's stress request is outside the "
                                 "limits against float64")
    calcs[1].calculate(probes[0].copy(), ["energy", "forces", "stress"])
    dS = float(np.abs(calcs[0].results["stress"]
                      - calcs[1].results["stress"]).max())
    lim = len(probes[0]) * 0.1 * noise_f * STRESS_LJ["rc"] / \
        probes[0].get_volume()
    stress = np.array2string(calcs[0].results["stress"], precision=5)
    log(f"(o1) GPR(stress=True) results['stress'] {stress} against CPU "
        f"f64: max|dS| {dS:.3e} (limit {lim:.3e})")
    if not dS <= lim:
        raise AssertionError("the GPR stress result is off float64")
    # the latency of a stress request beside a plain one: on this model,
    # and on a stress-enabled copy of the slice model (13 atoms)
    sgp = convert.gp_from_state(convert.state_of(slice_gp), device=dev,
                                dtype=f32, log_file=None)
    sgp.descriptor = T.SO3(nmax=3, lmax=4, rcut=5.0, stress=True)
    plain = convert.gp_from_state(convert.state_of(gp), device=dev,
                                  dtype=f32, log_file=None)
    plain.descriptor = T.SO3(nmax=2, lmax=2, rcut=STRESS_LJ["rc"])
    for tag, model, atoms in (("LJ Cu cell", (gp, plain), probes[0]),
                              ("slice", (sgp, slice_gp), slice_image)):
        ms_s = host_ms(torch, lambda: model[0].predict_structure(
            atoms, stress=True, return_std=True), 20)
        ms_p = host_ms(torch, lambda: model[1].predict_structure(
            atoms, return_std=True), 20)
        log(f"(o1) [{card}] {tag} request ({len(atoms)} atoms), host clock "
            f"to a synchronise, min / median / max of 20: with stress "
            f"{ms_s[0]:.3f} / {ms_s[1]:.3f} / {ms_s[2]:.3f} ms, plain "
            f"(a descriptor without strain rows) {ms_p[0]:.3f} / "
            f"{ms_p[1]:.3f} / {ms_p[2]:.3f} ms")
    te, tf, _, _ = gp._train_view()
    ste, stf, _, _ = sgp._train_view()
    shapes = [("LJ Cu stress request", stress_request(gp, probes[0]), te, tf,
               gp.kernel.params()),
              ("slice stress request", stress_request(sgp, slice_image), ste,
               stf, sgp.kernel.params())]
    return launches, shapes


def run_hutch(T, torch, kff, dev, log, card):
    """(o2) the NLL and its gradient at the 10k bench shape with the exact
    trace and the Hutchinson estimate, RBF and Dot, highest and bf16x4:
    the ms and peak memory of each at 64 probes (the default); the
    estimate's value must equal the exact one bit for bit and its
    gradient lie within the gate, 5 % of the exact norm + 1e-3 (at 1024
    probes too, where the distance is recorded beside it); then one
    fit(trace="auto") of a 10k model, which must run the gate and take
    the trace it decides.  Returns the launches of the hutch evaluations
    and the fit."""
    from gpr_calculator_tpu_torch.models.gp import (_nll_dot_analytic,
                                                    _nll_rbf_analytic,
                                                    _probe_block)
    f32 = torch.float32
    be, bf = bench_data(torch, dev)
    n = be.m + 3 * bf.m
    y = torch.as_tensor(np.random.RandomState(1).normal(0.0, 0.1, n),
                        dtype=f32, device=dev)
    probes = {p: _probe_block(n, p, dev) for p in (64, 1024)}
    cases = (("RBF", _nll_rbf_analytic, (2.0, 1.0)),
             ("Dot", _nll_dot_analytic, (2.0, 2.0)))
    launches = {k: 0 for k in kff.launches}
    for mode in ("highest", "bf16x4"):
        T.config.set_kff_precision(mode)
        for label, fn, th in cases:
            args = (th, be, bf, y, (0.01, 0.1), 10.0, 2, False)
            kw = {"exact": {}, "hutch": dict(trace="hutch", probes=probes[64])}
            out, ms, peak = {}, {}, {}
            for trace in ("exact", "hutch"):
                kff.reset_launches()
                out[trace] = fn(*args, **kw[trace])
                torch.cuda.synchronize()
                if trace == "hutch":
                    for k, v in kff.launches.items():
                        launches[k] += v
                ms[trace] = cuda_ms(torch, lambda: fn(*args, **kw[trace]), 3)
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                fn(*args, **kw[trace])
                torch.cuda.synchronize()
                peak[trace] = torch.cuda.max_memory_allocated(dev) - before
            out["hutch 1024"] = fn(*args, trace="hutch", probes=probes[1024])
            v_e, g_e = out["exact"][0], out["exact"][1].cpu().numpy()
            lim = 0.05 * float(np.linalg.norm(g_e)) + 1e-3
            dist = {}
            for key in ("hutch", "hutch 1024"):
                g_h = out[key][1].cpu().numpy()
                dist[key] = (float(np.linalg.norm(g_h - g_e)), g_h)
            log(f"(o2) [{card}] bench (1000 E + 3000 F), {label} NLL + "
                f"gradient in {mode}: exact {ms['exact']:.3f} ms, peak "
                f"{peak['exact'] / 1e9:.3f} GB above the data; hutch (64 "
                f"probes) {ms['hutch']:.3f} ms, peak "
                f"{peak['hutch'] / 1e9:.3f} GB; value exact {float(v_e)!r}"
                f", hutch {float(out['hutch'][0])!r}; grad exact "
                f"{np.array2string(g_e, precision=8)}, hutch 64 "
                f"{np.array2string(dist['hutch'][1], precision=8)} "
                f"(|dg| {dist['hutch'][0]:.3e}, "
                f"{dist['hutch'][0] / np.linalg.norm(g_e):.3e} of |g|), "
                f"hutch 1024 |dg| {dist['hutch 1024'][0]:.3e} "
                f"({dist['hutch 1024'][0] / np.linalg.norm(g_e):.3e}); the "
                f"gate's limit {lim:.3e}")
            for key in ("hutch", "hutch 1024"):
                if float(out[key][0]) != float(v_e):
                    raise AssertionError(f"the {key} {label} NLL value is "
                                         "not the exact one")
                if not dist[key][0] <= lim:
                    raise AssertionError(f"the {key} {label} gradient is "
                                         "outside the gate")
    T.config.set_kff_precision("highest")
    gp = bench_gp(T, dev, f32, bench_points(torch, dev, 1000, 3000, 0))
    gp.trace = "auto"
    kff.reset_launches()
    t0 = time.perf_counter()
    gp.fit(opt=True, show=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, v in kff.launches.items():
        launches[k] += v
    verdict = gp._trace_gate[1] if gp._trace_gate else None
    log(f"(o2) [{card}] fit(trace='auto') at n = {n}: the gate at theta0 "
        f"-> {verdict}, trace used {gp._nll_trace_used}, theta "
        f"({gp.kernel.parameters()[0]:.6f}, "
        f"{gp.kernel.parameters()[1]:.6f}), {wall:.2f} s")
    if verdict is None or gp._nll_trace_used not in (verdict, "exact"):
        raise AssertionError("fit(trace='auto') at 10k rows ran no gate or "
                             "took a trace the gate did not allow")
    return launches


def run_sparsify_cov(T, torch, kff, dev, log, card, slice_gp, images):
    """(o3) sparsify and the predictive covariance on the card, from a
    copy of the slice model (images 0 and 4 are one structure up to a
    lattice translation): the ids its sparsify removes beside a CPU
    float64 copy's (recorded: float32 blocks floor the eigenvalues far
    above l_tol), its refit held to a CPU float64 model after the same
    removal at 0.1 of the noise, and _predict_cov's diagonal against
    predict's std.  Returns the launches of sparsify and of the
    covariance."""
    from gpr_calculator_tpu_torch import convert
    from gpr_calculator_tpu_torch.atoms.atoms import ATOMIC_NUMBERS
    from gpr_calculator_tpu_torch.models.gp import _group_force_points
    state = convert.state_of(slice_gp)
    for key in ("alpha", "L", "n_fit"):
        state.pop(key, None)
    models, removed = {}, {}
    for tag, kw in (("card", dict(device=dev, dtype=torch.float32)),
                    ("CPU f64", dict(device="cpu", dtype=torch.float64))):
        gp = convert.gp_from_state(state, log_file=None, **kw)
        gp.fit(opt=False, show=False)

        def record(e_ids, f_ids, gp=gp, tag=tag):
            removed[tag] = (sorted(int(i) for i in e_ids),
                            sorted(int(i) for i in f_ids))
            type(gp).remove_train_pts(gp, e_ids, f_ids)
        gp.remove_train_pts = record
        removed[tag] = ([], [])
        models[tag] = gp
    kff.reset_launches()
    models["card"].sparsify()
    torch.cuda.synchronize()
    sp_launches = dict(kff.launches)
    models["CPU f64"].sparsify()
    log(f"(o3) sparsify of the slice model ({state['N_energy']} E + "
        f"{state['N_forces']} F): removed (energy, force) ids card "
        f"{removed['card']}, CPU f64 {removed['CPU f64']} ("
        f"{'the same' if removed['card'] == removed['CPU f64'] else 'other'}"
        " ids; recorded, not a gate); launches "
        f"{json.dumps(nonzero(sp_launches))}")
    gp = models["card"]
    reserve_vs_f64(T, gp, images, log, "(o3) the sparsified card model "
                   "against a CPU f64 model after the same removal")
    image = images[2]
    d = gp.descriptor.calculate(image, device=dev, dtype=torch.float64)
    ele = np.asarray([ATOMIC_NUMBERS[s] for s in d["elements"]])
    free = [i for i in range(len(image)) if i not in
            set(image.fixed_indices())]
    X = {"energy": [(d["x"], ele)],
         "force": _group_force_points(d, ele, free)}
    kff.reset_launches()
    mean, cov = gp.predict(X, return_cov=True)
    torch.cuda.synchronize()
    cov_launches = dict(kff.launches)
    _, std = gp.predict(X, return_std=True)
    sq = np.sqrt(np.clip(np.diag(cov), 0.0, None))
    err = float(np.abs(sq - std).max())
    log(f"(o3) [{card}] predict(return_cov=True), one request of "
        f"{len(free)} free atoms: cov {cov.shape}, max|sqrt(diag cov) - "
        f"std| = {err:.3e}, {err / std.max():.3e} of max std (limit 1e-6); "
        f"launches {json.dumps(nonzero(cov_launches))}")
    if not (np.all(np.isfinite(cov)) and err <= 1e-6 * std.max()):
        raise AssertionError("_predict_cov's diagonal is not predict's "
                             "variance")
    check_launches(cov_launches, ("kff_tri", "kef_rect", "kff_rect"), "cov",
                   absent=[n for n in NAMES
                           if n not in ("kff_tri", "kef_rect", "kff_rect")])
    return sp_launches, cov_launches


# ---------------------------------------------------------------------------
# (p) float64 on the card: the JAX package's default x64 mode
# ---------------------------------------------------------------------------

RBF_F64 = [kname(b, F64) for b in RBF]
DOT_F64 = [kname(b, F64) for b in DOT]


def check_f64_path(counts, names, path, family):
    """Every kernel of ``names`` ran on the float64 path, no kernel outside
    the float64 ``family`` (no float32, mode or range kernel), and no
    plain version."""
    check_launches(counts, names, path,
                   absent=[n for n in NAMES + RANGE_NAMES + F64_NAMES
                           + F64_RANGE_NAMES if n not in family])
    if counts["kff_plain"] or counts["kef_plain"]:
        raise AssertionError(f"the plain versions ran on the {path} path: "
                             f"kff_plain {counts['kff_plain']}, kef_plain "
                             f"{counts['kef_plain']}")


def f64_kernel_checks(torch, kff, par, dev, log, card, slice_sides,
                      compiler_log):
    """(p1) Every _f64 kernel against its float64 plain version on the
    card, within F64_RTOL max|plain|, on operands sorted by element and
    as packed: at the slice's shapes (``slice_sides``: the request and
    the slice model's training set, in float64) and the mid shape every
    case of both families, at the bench shape each kernel against the
    plane of one shared plain pass (RBF: the dual pass, K_FF symmetric
    and K_EF; Dot: K_FF and K_EF), computed once on sorted operands; the
    K1 tile ranges over four virtual shards against kff_plain(tiles=)
    and, summed, against the single launch bit for bit, and the K2/K3
    stripes, at each shape.  Times (CUDA events) with the bound of each
    (``bound_f64``).  Returns (max|kernel - plain| by kernel, slice
    times, {"mid": ..., "bench": ...})."""
    f64 = torch.float64
    for name, body, line in ptxas_lines(compiler_log):
        if body in ("tri_f64", "rect_f64"):
            log(f"(p1) ptxas {name} ({body}_kernel): {line}")
    params, dparams = {"sigma": SIGMA, "l": L_SCALE}, {"sigma": 0.6,
                                                       "sigma0": 1.7}
    bparams, bdparams = {"sigma": 2.0, "l": 1.0}, {"sigma": 2.0,
                                                   "sigma0": 2.0}
    pe, pf, te, tf = slice_sides
    me, mf = to_f64(torch, *bench_data(torch, dev, m_e=250, m_f=750))
    be, bf = to_f64(torch, *bench_data(torch, dev))
    errs, times, at = {}, {}, {"mid": {}, "bench": {}}

    def cases(e1, f1, e2, f2, p, dp, sort):
        return (kernel_cases(kff, e1, f1, e2, f2, p, "rbf", F64, sort)
                + kernel_cases(kff, e1, f1, e2, f2, dp, "dot", F64, sort))

    for tag, sides, p, dp in (("slice", (pe, pf, te, tf), params, dparams),
                              ("mid", (me, mf, me, mf), bparams, bdparams)):
        for sort in (True, False):
            compare(torch, cases(*sides, p, dp, sort), f"{tag}, envs "
                    f"{'sorted by element' if sort else 'as packed'}", errs,
                    log, rtol=F64_RTOL, phase="(p1)")
        # times on the operands as the model builds them (sort=None)
        for name, kern, plain, wk in cases(*sides, p, dp, None):
            if name in (times if tag == "slice" else at[tag]):
                continue
            reps = (50, 10) if tag == "slice" else (5, 1)
            cell = (cuda_ms(torch, kern, reps[0]),
                    cuda_ms(torch, plain, reps[1]), *bound_f64(*wk))
            if tag == "slice":
                times[name] = cell
            else:
                at[tag][name] = dict(ms=cell[0], plain_ms=cell[1],
                                     bound_ms=cell[2], bound_by=cell[3])
    # the bench shape: one shared plain pass per block family
    A = B = be.x.shape[1]
    ops = {sort: (kff.energy_operand(be, "highest", sort),
                  kff.force_operand(bf, "highest", sort))
           for sort in (True, False)}
    (U, w), (X, re_) = ops[True]
    refs = {}
    for key, fn in (
            ("rbf_ff", lambda: kff.kff_plain(X, re_, B, X, re_, B, bparams,
                                             2, symmetric=True, dual=True)),
            ("rbf_ef", lambda: kff.kef_plain(U, w, A, X, re_, B, bparams,
                                             2, dual=True)),
            ("dot_ff", lambda: (kff.kff_plain(X, re_, B, X, re_, B,
                                              bdparams, 2, symmetric=True,
                                              kind="dot"),)),
            ("dot_ef", lambda: (kff.kef_plain(U, w, A, X, re_, B, bdparams,
                                              2, kind="dot"),))):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        planes = fn()
        end.record()
        torch.cuda.synchronize()
        refs[key] = (planes, start.elapsed_time(end))
    which = {"": (0,), "_dual": (0, 1), "_deriv": (1,), "_dot": (0,)}
    for base in BASES:
        name = kname(base, F64)
        dot = base.endswith("_dot")
        key = ("dot" if dot else "rbf") + ("_ef" if base.startswith("kef")
                                           else "_ff")
        suffix = base[base.rfind("_"):] if base.count("_") > 1 else ""
        ref_planes = [refs[key][0][i] for i in which[suffix]]
        fl = k1_flags(base, "dot" if dot else "rbf")
        p = bdparams if dot else bparams

        def call(sort):
            (U_, w_), (X_, r_) = ops[sort]
            if base.startswith("kef"):
                return lambda: kff.kef_from_ops(U_, w_, A, X_, r_, B, p, 2,
                                                **fl)
            return lambda: kff.kff_from_ops(
                X_, r_, B, X_, r_, B, p, 2,
                symmetric=base.startswith("kff_tri"), **fl)
        for sort in (True, False):
            got = planes_of(call(sort)())
            torch.cuda.synchronize()
            for K, P in zip(got, ref_planes):
                err, scale = float((K - P).abs().max()), float(P.abs().max())
                log(f"(p1) bench, envs {'sorted' if sort else 'as packed'} "
                    f"{name} {tuple(K.shape)}: max|kernel-plain| = "
                    f"{err:.3e}, max|plain| = {scale:.3e}")
                if not err <= F64_RTOL * scale:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version at bench: {err:.3e} > "
                                         f"{F64_RTOL} * {scale:.3e}")
                if base.startswith("kff_tri") and not torch.equal(K, K.T):
                    raise AssertionError(f"{name} is not exactly symmetric")
                errs[name] = max(errs.get(name, 0.0), err)
            del got
        lhs = (U, w, A) if base.startswith("kef") else (X, re_, B)
        out = (be.m if base.startswith("kef") else 3 * bf.m) * 3 * bf.m
        bms, by = bound_f64(*work(name, be.x.shape[2], lhs, (X, re_, B),
                                  out * (1 + fl["dual"])))
        at["bench"][name] = dict(ms=cuda_ms(torch, call(True), 2),
                                 plain_ms=refs[key][1], bound_ms=bms,
                                 bound_by=by)
    del refs, ops
    for tag in ("slice", "mid", "bench"):
        for name in F64_NAMES:
            if tag == "slice":
                ms, pms, bms, by = times[name]
            else:
                c = at[tag][name]
                ms, pms, bms, by = (c["ms"], c["plain_ms"], c["bound_ms"],
                                    c["bound_by"])
            log(f"(p1) [{card}] {tag} {name}: kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms" + (" (the shared plain pass)"
                                   if tag == "bench" else "")
                + f", bound {bms:.4g} ms ({by}); {bms / ms:.3f} of the "
                "bound")
    # the K1 tile ranges and the K2/K3 stripes over four virtual shards
    mesh = par.make_mesh(N_SHARDS, [f"cuda:{i % torch.cuda.device_count()}"
                                    for i in range(N_SHARDS)])
    for tag, (e_, f_), p, dp in (("slice", (te, tf), params, dparams),
                                 ("mid", (me, mf), bparams, bdparams),
                                 ("bench", (be, bf), bparams, bdparams)):
        for kind, prm in (("rbf", p), ("dot", dp)):
            sharded_k1(torch, kff, par, mesh, f_, prm, kind, "highest", tag,
                       errs, log, tag != "bench", rtol=F64_RTOL,
                       phase="(p1)")
            sharded_stripes(torch, kff, par, mesh, e_, f_, prm, kind,
                            "highest", tag, log, phase="(p1)")
    return errs, times, at


@contextlib.contextmanager
def recorded_decisions(out):
    """Each decision of the dispatcher (``DispatchPolicy.needs_base``)
    appended to ``out`` as (needs base, the policy, its inputs)."""
    from gpr_calculator_tpu_torch.dispatch import DispatchPolicy
    orig = DispatchPolicy.needs_base

    def needs_base(self, natoms, F, E_std_total, F_std):
        res = orig(self, natoms, F, E_std_total, F_std)
        out.append((bool(res), self, (natoms, np.array(F),
                                      float(E_std_total), np.array(F_std))))
        return res
    DispatchPolicy.needs_base = needs_base
    try:
        yield
    finally:
        DispatchPolicy.needs_base = orig


def decision_margins(decision):
    """(needs base, force margin = the policy's force reference less the
    largest sigma_F, energy margin = its energy tolerance less sigma_E)
    of a recorded decision."""
    res, policy, (natoms, F, E_std_total, F_std) = decision
    return (res, policy.force_reference(natoms, F) - float(np.max(F_std)),
            policy.tolerances(natoms)[0] - E_std_total)


def f64_neb(T, torch, kff, gp, images, kernel, jref, fam, log, card,
            batched=False):
    """(p2) One on-the-fly NEB of a float64 model on the card, counted:
    only the family's _f64 kernels and no plain version; converged in
    the JAX package's steps with its base/surrogate/fit counts and rows,
    and its barrier within F64_BARRIER_TOL.  On a mismatch the CPU
    float64 run of the port (the JAX package's run, tests/test_torch_neb.py)
    is repeated and the first dispatcher decision that differs is
    printed with both margins.  Returns the counts."""
    what = f"{'batched ' if batched else ''}{kernel} NEB"
    decisions = []
    kff.reset_launches()
    t0 = time.time()
    with recorded_decisions(decisions):
        neb, E = run_neb(T, gp, images, batched=batched)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = counted(kff)
    log(f"(p2) [{card}] float64 {what}: {wall:.2f} s, band energies "
        f"{np.array2string(E, precision=7)} eV, {len(decisions)} "
        "dispatcher decisions")
    for key, ref_val in jref.items():
        log(f"(p2) float64 {what} {key}: card {neb[key]}, JAX CPU f64 "
            f"{ref_val}")
    log(f"(p2) float64 {what}: launches a step "
        f"{per_k(counts, neb['nsteps'])}; launches "
        f"{json.dumps(nonzero(counts))}")
    check_f64_path(counts, [kname(b, F64) for b in fam], f"float64 {what}",
                   [kname(b, F64) for b in fam])
    same = all(neb[k] == v for k, v in jref.items() if k != "barrier") \
        and abs(neb["barrier"] - jref["barrier"]) <= F64_BARRIER_TOL
    if not same:
        cpu = []
        cgp, cimages = run_training(T, "cpu", torch.float64, kernel=kernel)
        with recorded_decisions(cpu):
            run_neb(T, cgp, cimages, batched=batched)
        first = next((i for i, (a, b) in enumerate(zip(decisions, cpu))
                      if a[0] != b[0]), None)
        log(f"(p2) float64 {what}: the first dispatcher decision that "
            f"differs from the CPU float64 run: "
            + ("none in the common length" if first is None else
               f"#{first}: card {decision_margins(decisions[first])}, CPU "
               f"{decision_margins(cpu[first])} (needs base, force margin, "
               "energy margin)"))
        raise AssertionError(f"the float64 {what} on the card is not the "
                             "JAX package's run")
    return counts


def f64_nll_check(gp, ref, theta, tag, log):
    """(p2) A float64 card model's NLL and gradient at theta on the _f64
    kernels against the same evaluation from the plain float64 build on
    the card, within F64_NLL_RTOL relative (the kernels' own share), and
    against the CPU float64 model ``ref`` within F64_CPU_RTOL.  The plain
    build on the card against the CPU model (the two devices' float64
    linear algebra) is recorded beside them."""
    from gpr_calculator_tpu_torch.models import gp as gp_mod
    e, f = gp._pack(gp.N_energy, gp.N_forces)
    y = gp._y_vector(e, f, gp.N_energy, gp.N_forces)
    nll = {"rbf": gp_mod._nll_rbf_analytic,
           "dot": gp_mod._nll_dot_analytic}[gp.kernel.kind]
    _, _, noise_opt = gp._theta()
    v, g = nll(list(theta), e, f, y, (gp.noise_e, gp.noise_f),
               float(gp.f_coef), gp.kernel.zeta, noise_opt, plain=True)
    evals = {"kernels": gp.log_marginal_likelihood(list(theta),
                                                   eval_gradient=True),
             "plain": (-float(v), -g.detach().cpu().numpy()),
             "CPU": ref.log_marginal_likelihood(list(theta),
                                                eval_gradient=True)}

    def rel(a, b):
        (la, ga), (lb, gb) = evals[a], evals[b]
        return (abs(la - lb) / abs(lb),
                float(np.linalg.norm(ga - gb) / np.linalg.norm(gb)))
    kp, kc, floor = rel("kernels", "plain"), rel("kernels", "CPU"), \
        rel("plain", "CPU")
    log(f"(p2) NLL at {tag} = ({theta[0]:.6g}, {theta[1]:.6g}): card f64 "
        f"{-evals['kernels'][0]:.12g}, grad "
        f"{np.array2string(-evals['kernels'][1], precision=10)}; against "
        f"the plain float64 build on the card {kp[0]:.3e} / {kp[1]:.3e} "
        f"relative (limit {F64_NLL_RTOL}); against the CPU float64 model "
        f"{kc[0]:.3e} / {kc[1]:.3e} (limit {F64_CPU_RTOL}); the plain "
        f"build on the card against the CPU model {floor[0]:.3e} / "
        f"{floor[1]:.3e} (recorded)")
    if not (max(kp) <= F64_NLL_RTOL and max(kc) <= F64_CPU_RTOL):
        raise AssertionError(f"(p2) the float64 NLL/gradient at {tag} is "
                             "outside the limits")


def f64_path_shapes(torch, kff, gp, query, tag, errs, log, kinds=None,
                    query_only=False):
    """(p1) at a float64 path's shapes: every _f64 kernel of ``kinds``
    (default: the model's family) on ``query`` (EnergyData, ForceData)
    against ``gp``'s training set, as the path builds the operands,
    within F64_RTOL max|plain| of its plain version."""
    te, tf, _, _ = gp._train_view()
    dparams = {"sigma": 0.6, "sigma0": 1.7}
    cases = []
    for kind in kinds or (gp.kernel.kind,):
        params = gp.kernel.params() if kind == gp.kernel.kind else dparams
        cases += kernel_cases(kff, *query, te, tf, params, kind, F64,
                              query_only=query_only)
    compare(torch, cases, tag, errs, log, rtol=F64_RTOL, phase="(p1)")


def run_f64_paths(T, torch, kff, dev, log, card, errs):
    """(p2) set_GPR and the serial on-the-fly NEB of a float64 model on
    the card (``GP.set_GPR(..., dtype=torch.float64)``), RBF then Dot,
    then the batched RBF NEB, each counted: the NLL and gradient at
    set_GPR's start and at the JAX theta* held to the plain float64
    build and to a CPU float64 model (``f64_nll_check``), and each NEB
    held to the JAX package's run (``f64_neb``); after each NEB its
    kernels against their plain versions at its shapes (into ``errs``).
    Returns the launch counts by path."""
    f64 = torch.float64
    paths = {}
    for kernel, theta0, jtheta, jneb, fam, train in (
            ("RBF", THETA0, (SIGMA, L_SCALE), JAX_NEB, RBF,
             ("kff_tri_dual", "kef_rect_dual")),
            ("Dot", DOT_THETA0, DOT_THETA, JAX_DOT_NEB, DOT,
             ("kff_tri_dot", "kef_rect_dot"))):
        tag = "f64_" if kernel == "RBF" else "f64_dot_"
        kff.reset_launches()
        t0 = time.time()
        gp, images = run_training(T, dev, f64, kernel=kernel)
        torch.cuda.synchronize()
        paths[tag + "training"] = counted(kff)
        theta = gp.kernel.parameters()
        log(f"(p2) [{card}] float64 set_GPR(kernel={kernel!r}): "
            f"{time.time() - t0:.2f} s, theta = ({theta[0]:.10f}, "
            f"{theta[1]:.10f}), JAX CPU f64 ({jtheta[0]:.10f}, "
            f"{jtheta[1]:.10f}), relative diff ({theta[0] / jtheta[0] - 1:.2e}"
            f", {theta[1] / jtheta[1] - 1:.2e}); launches "
            f"{json.dumps(nonzero(paths[tag + 'training']))}")
        check_f64_path(paths[tag + "training"], [kname(b, F64) for b in train],
                       f"float64 {kernel} training",
                       [kname(b, F64) for b in fam])
        ref = cpu_f64_copy(T, gp, fit=False)
        for ttag, th in (("theta0", theta0), ("JAX theta*", jtheta)):
            f64_nll_check(gp, ref, th, ttag, log)
        paths[tag + "neb"] = f64_neb(T, torch, kff, gp, images, kernel, jneb,
                                     fam, log, card)
        f64_path_shapes(torch, kff, gp, slice_request(gp, images[2], dev,
                                                      f64),
                        f"float64 {kernel} NEB training set, image 2", errs,
                        log)
    gp, images = run_training(T, dev, f64)
    paths["f64_batched_neb"] = f64_neb(T, torch, kff, gp, images, "RBF",
                                       JAX_BATCHED_NEB, RBF, log, card,
                                       batched=True)
    f64_path_shapes(torch, kff, gp, band_request(gp, images[1:-1]),
                    "float64 batched RBF NEB training set, its final band",
                    errs, log)
    return paths


def cuda_peak(torch, fn):
    """(fn(), the device memory it allocated above what was held before,
    GiB, at its peak)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - before) / 2 ** 30


def run_f64_bench(T, torch, kff, K_ops, dev, log, card, query, errs):
    """(p3) The 10 000-row bench in float64 on the card: the RBF and Dot
    NLL+gradient (exact trace) against the plain float64 build on the
    card, relative, the value within F64_NLL_RTOL and the gradient within
    F64_BENCH_GRAD_RTOL (the float64 floor, the plain build on operands
    left as packed against it, recorded beside), beside the float32
    evaluation; a GP holding the bench rows factorised
    (``fit(opt=False)``: _factorize), one 13-atom request (``query``)
    served from it, then 1 E + 8 F rows appended (the incremental
    refit), each model's request against a float64 model of its
    training set built from the plain versions on the card
    (``plain_serve``) within a millionth of the noise.  Each counted
    (only _f64 kernels, no plain version), with its ms and peak device
    memory; then the kernels against their plain versions (into
    ``errs``) at its shapes: the request against each training set, the
    appended rows (sorted as the refit sorts them) against the bench side
    and against themselves.  Returns the launch counts by path."""
    from gpr_calculator_tpu_torch.models.gp import (_factorize,
                                                    _nll_dot_analytic,
                                                    _nll_rbf_analytic)
    f64 = torch.float64
    pe, pf, natoms = query
    be32, bf32 = bench_data(torch, dev)
    be, bf = to_f64(torch, be32, bf32)
    n = be.m + 3 * bf.m
    y = torch.as_tensor(np.random.RandomState(1).normal(0.0, 0.1, n),
                        dtype=f64, device=dev)
    paths = {}
    for label, fn, theta, train in (
            ("RBF", _nll_rbf_analytic, (2.0, 1.0),
             ("kff_tri_dual", "kef_rect_dual")),
            ("Dot", _nll_dot_analytic, (2.0, 2.0),
             ("kff_tri_dot", "kef_rect_dot"))):
        tail = ((0.01, 0.1), 10.0, 2, False)
        kff.reset_launches()
        (nll, g), gib = cuda_peak(torch, lambda: fn(theta, be, bf, y, *tail))
        paths[f"f64_bench_{label.lower()}_nll"] = counts = counted(kff)
        check_f64_path(counts, [kname(b, F64) for b in train],
                       f"float64 bench {label} NLL",
                       [kname(b, F64) for b in train])
        ms = cuda_ms(torch, lambda: fn(theta, be, bf, y, *tail), 2)
        (nllp, gpl), gibp = cuda_peak(
            torch, lambda: fn(theta, be, bf, y, *tail, plain=True))
        (nll32, g32), gib32 = cuda_peak(
            torch, lambda: fn(theta, be32, bf32, y.float(), *tail))
        ms32 = cuda_ms(torch, lambda: fn(theta, be32, bf32, y.float(),
                                         *tail), 2)
        # the float64 floor: the plain build on operands left as packed
        # (each point's env sums in another order) against the plain build
        sort_min, kff.SORT_MIN_ENVS = kff.SORT_MIN_ENVS, 1 << 62
        try:
            nllq, gq = fn(theta, be, bf, y, *tail, plain=True)
        finally:
            kff.SORT_MIN_ENVS = sort_min
        nll, nllp, nll32, nllq = (float(v) for v in (nll, nllp, nll32, nllq))
        g, gpl, g32, gq = (t.cpu().double().numpy()
                           for t in (g, gpl, g32, gq))
        gn = float(np.linalg.norm(gpl))
        dn = abs(nll - nllp) / abs(nllp)
        dg = float(np.linalg.norm(g - gpl)) / gn
        fn_, fg = abs(nllq - nllp) / abs(nllp), \
            float(np.linalg.norm(gq - gpl)) / gn
        glim = F64_BENCH_GRAD_RTOL[label]
        log(f"(p3) [{card}] bench {label} NLL + gradient in float64: "
            f"{ms:.3f} ms, peak {gib:.3f} GiB (float32 on the kernels "
            f"{ms32:.3f} ms, peak {gib32:.3f} GiB; the plain float64 build "
            f"peak {gibp:.3f} GiB); NLL {nll:.12g} against the plain "
            f"{nllp:.12g}: {dn:.3e} relative (limit {F64_NLL_RTOL}), "
            f"gradient {np.array2string(g, precision=12)} against "
            f"{np.array2string(gpl, precision=12)}: {dg:.3e} relative "
            f"(limit {glim}); the float64 floor, the plain build on packed "
            f"operands: NLL {fn_:.3e}, gradient {fg:.3e} relative "
            "(recorded); "
            f"float32 {nll32:.12g}, {abs(nll32 - nllp) / abs(nllp):.3e} "
            f"and {np.linalg.norm(g32 - gpl) / gn:.3e} off (recorded)")
        if not (dn <= F64_NLL_RTOL and dg <= glim):
            raise AssertionError(f"(p3) the float64 bench {label} NLL is not "
                                 "the plain float64 build's")
    noise = (0.01 * 1e-5, 0.1 * 1e-5)   # served_off takes a tenth of it
    gp = bench_gp(T, dev, f64, bench_points(torch, dev, be.m, bf.m, seed=0))
    kff.reset_launches()
    _, gib = cuda_peak(torch, lambda: gp.fit(opt=False, show=False))
    paths["f64_bench_factorize"] = counts = counted(kff)
    check_f64_path(counts, [kname(b, F64) for b in ("kff_tri", "kef_rect")],
                   "float64 bench _factorize", RBF_F64)
    e, f, _, _ = gp._train_view()
    yv = gp._y_vector(e, f, gp.N_energy, gp.N_forces)
    ms = cuda_ms(torch, lambda: _factorize(e, f, yv, gp.kernel.params(),
                                           0.01, 0.1, 2, "rbf"), 2)
    log(f"(p3) [{card}] bench _factorize in float64 ({e.m} E + {f.m} F "
        f"points): {ms:.3f} ms, the fit's peak {gib:.3f} GiB")
    for step in ("factorised", "appended"):
        te, tf, _, _ = gp._train_view()
        kff.reset_launches()
        served, gib = cuda_peak(torch, lambda: gp._serve(pe, pf, te, tf,
                                                         True))
        counts = counted(kff)
        check_f64_path(counts, [kname(b, F64) for b in ("kef_rect",
                                                        "kff_rect")],
                       f"float64 bench request ({step})", RBF_F64)
        t = host_ms(torch, lambda: gp._serve(pe, pf, te, tf, True), 5)
        serve, ref = plain_serve(torch, kff, K_ops, gp)
        offs = served_off(served, serve(pe, pf, *ref, True), pe.m, natoms,
                          noise)
        log(f"(p3) [{card}] bench request ({step}, {te.m} E + {tf.m} F): "
            f"{t[1]:.3f} ms (median of 5, host clock), peak {gib:.3f} GiB; "
            f"against the plain float64 build: |dE| {offs[0][0]:.3e} eV, "
            f"max|dF| {offs[1][0]:.3e} eV/A, |dsigma_E| {offs[2][0]:.3e} "
            f"eV, max|dsigma_F| {offs[3][0]:.3e} eV/A (limits "
            f"{offs[0][1]:.3e}, {offs[1][1]:.3e})")
        if not all(np.isfinite(v) and v <= lim for v, lim in offs):
            raise AssertionError(f"(p3) the {step} float64 bench model does "
                                 "not serve as the plain float64 build")
        del serve, ref
        f64_path_shapes(torch, kff, gp, (pe, pf), f"float64 bench request, "
                        f"{step} training set", errs, log, query_only=True)
        if step == "appended":
            break
        gp.set_train_pts(bench_points(torch, dev, *APPENDS[0], seed=2),
                         mode="a+")
        kff.reset_launches()
        _, gib = cuda_peak(torch, lambda: gp.fit(opt=False, show=False))
        paths["f64_incremental"] = counts = counted(kff)
        names = [kname(b, F64) for b in ("kef_rect", "kff_rect", "kff_tri")]
        check_f64_path(counts, names, "float64 incremental refit", RBF_F64)
        rs = gp.refit_stats
        log(f"(p3) [{card}] bench append of {APPENDS[0][0]} E + "
            f"{APPENDS[0][1]} F in float64: {rs['incremental_ms']:.3f} ms "
            f"incremental (the first fit {rs['full_ms']:.3f} ms full), peak "
            f"{gib:.3f} GiB; launches {json.dumps(nonzero(counts))}")
        if rs["incremental"] != 1 or counts[kname("kff_tri", F64)] != 1:
            raise AssertionError(f"(p3) the float64 append was not one "
                                 f"incremental refit with one K1: {rs}")
        # the append's shapes: its rows (bench_points' rows of seed 2)
        # against the bench side (K2 both ways, K3) and themselves (K1)
        ne, nf = to_f64(torch, *bench_data(torch, dev, *APPENDS[0], seed=2))
        tag = f"float64 {APPENDS[0][0]} E + {APPENDS[0][1]} F appended"
        bparams = gp.kernel.params()
        compare(torch, kernel_cases(kff, ne, nf, be, bf, bparams, "rbf", F64,
                                    sort=True, query_only=True),
                f"{tag}, against the bench training side", errs, log,
                rtol=F64_RTOL, phase="(p1)")
        compare(torch, kernel_cases(kff, ne, nf, ne, nf, bparams, "rbf", F64,
                                    sort=True),
                f"{tag}, against themselves", errs, log, rtol=F64_RTOL,
                phase="(p1)")
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--alt-source", help="another revision's kernel "
                    "sources, a directory like csrc/ or one .cu file (same "
                    "entry points): time its kernels beside the package's, "
                    "in turns, and stop")
    ap.add_argument("--alt-root", help="another revision's checkout: time "
                    "its _predict_packed and bench NLLs beside this one's, "
                    "in turns, and stop")
    ap.add_argument("--predict-packed", action="store_true",
                    help="time one slice request's _predict_packed and the "
                    "bench NLLs, and stop")
    ap.add_argument("--package-root", help="import the package from here")
    args = ap.parse_args(argv)
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    import gpr_calculator_tpu_torch as T
    from gpr_calculator_tpu_torch.ops import kff
    from gpr_calculator_tpu_torch.ops import kernels as K_ops

    def log(msg):
        print(msg, flush=True)

    if args.predict_packed:
        predict_packed_of(torch, T, log)
        return 0
    if args.alt_source or args.alt_root:
        if args.alt_source:
            compare_sources(torch, T, kff, args.alt_source, log)
        if args.alt_root:
            compare_roots(args.alt_root, log)
        return 0

    t_run = time.time()
    dev, f32 = torch.device("cuda"), torch.float32
    log(f"(a) card: {card_line()}")
    t0 = time.time()
    _, compiler_log = kff.build()
    log(f"(a) kernel build: {time.time() - t0:.1f} s")
    if not compiler_log:
        log("(a) the library was built before this run: no ptxas lines")
    bodies = {}
    for name, body, line in ptxas_lines(compiler_log):
        log(f"(a) ptxas {name} ({body}_kernel): {line}")
        bodies.setdefault(body, set()).add(name)
    if compiler_log:
        log(f"(a) instantiations: rect_kernel "
            f"{len(bodies.get('rect', ()))}, tri_kernel "
            f"{len(bodies.get('tri', ()))}, rect_mma_kernel "
            f"{len(bodies.get('rect_mma', ()))}, tri_mma_kernel "
            f"{len(bodies.get('tri_mma', ()))}, rect_f64_kernel "
            f"{len(bodies.get('rect_f64', ()))}, tri_f64_kernel "
            f"{len(bodies.get('tri_f64', ()))}")
        if set(bodies) != {"rect", "tri", "rect_mma", "tri_mma", "rect_f64",
                           "tri_f64"} or \
                bodies["rect"] != set(RECT) or \
                bodies["tri"] != set(TRI) or \
                bodies["rect_mma"] != set(MMA) or \
                bodies["tri_mma"] != set(TRI_MMA) or \
                bodies["rect_f64"] != set(RECT_F64) or \
                bodies["tri_f64"] != set(TRI_F64) or \
                "cov_kernel" in compiler_log:
            raise AssertionError("the library does not hold 8 rect_kernel, "
                                 "4 tri_kernel, 16 rect_mma_kernel, 8 "
                                 "tri_mma_kernel, 8 rect_f64_kernel and 4 "
                                 "tri_f64_kernel instantiations and no "
                                 "cov_kernel")
        for body in ("rect_mma", "tri_mma", "rect_f64", "tri_f64"):
            spills = {name: int(m.group(1)) for name, b, line in
                      ptxas_lines(compiler_log) if b == body
                      for m in [re.search(r"(\d+) bytes spill stores",
                                          line)] if m}
            log(f"(a) {body}_kernel spill stores (bytes): "
                f"{json.dumps(spills)}")

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

    # (f) every kernel of the serving slice ran on it
    log(f"(f) launches on the slice: {json.dumps(nonzero(main_launches))}")
    check_launches(main_launches, ("kff_tri", "kef_rect", "kff_rect"),
                   "slice", absent=DOT)

    # (h) training on the card, counted
    kff.reset_launches()
    t0 = time.time()
    tgp, timages = run_training(T, dev, f32)
    torch.cuda.synchronize()
    train_launches = dict(kff.launches)
    theta = tgp.kernel.parameters()
    log(f"(h) set_GPR: {time.time() - t0:.2f} s, N_energy={tgp.N_energy} "
        f"N_forces={tgp.N_forces}; theta = ({theta[0]:.8f}, "
        f"{theta[1]:.8f}), JAX CPU f64 ({SIGMA:.8f}, {L_SCALE:.8f}), "
        f"relative diff ({theta[0] / SIGMA - 1:.2e}, "
        f"{theta[1] / L_SCALE - 1:.2e})")
    log(f"(h) launches in set_GPR: {json.dumps(nonzero(train_launches))}")
    check_launches(train_launches, ("kff_tri_dual", "kef_rect_dual"),
                   "training", absent=DOT)
    tref = cpu_f64_copy(T, tgp, fit=False)
    for tag, th in (("theta0", THETA0), ("JAX theta*", (SIGMA, L_SCALE))):
        nll_vs_f64(tgp, tref, th, tag, log)

    # (i) the on-the-fly NEB on the card from the card-trained model
    kff.reset_launches()
    t0 = time.time()
    neb, E = run_neb(T, tgp, timages)
    torch.cuda.synchronize()
    neb_launches = dict(kff.launches)
    neb["wall_s"] = time.time() - t0
    log(f"(i) NEB: {time.time() - t0:.2f} s, band energies "
        f"{np.array2string(E, precision=6)} eV")
    for key, ref_val in JAX_NEB.items():
        log(f"(i) {key}: card {neb[key]}, JAX CPU f64 {ref_val}")
    log(f"(i) launches in the NEB: {json.dumps(nonzero(neb_launches))}")
    check_launches(neb_launches, RBF, "NEB", absent=DOT)
    if not neb["converged"] or \
            abs(neb["barrier"] - JAX_NEB["barrier"]) > BARRIER_TOL:
        raise AssertionError(f"the card NEB did not converge to the JAX "
                             f"barrier within {BARRIER_TOL} eV")

    # (j) the Dot kernel: training, NLL against float64, the NEB and a
    # re-serve of its final model, each counted
    kff.reset_launches()
    t0 = time.time()
    dgp, dimages = run_training(T, dev, f32, kernel="Dot")
    torch.cuda.synchronize()
    dot_train_launches = dict(kff.launches)
    theta = dgp.kernel.parameters()
    log(f"(j) set_GPR(kernel='Dot'): {time.time() - t0:.2f} s, "
        f"N_energy={dgp.N_energy} N_forces={dgp.N_forces}; (sigma, sigma0)"
        f" = ({theta[0]:.8f}, {theta[1]:.8f}), JAX CPU f64 "
        f"({DOT_THETA[0]:.8f}, {DOT_THETA[1]:.8f}), relative diff "
        f"({theta[0] / DOT_THETA[0] - 1:.2e}, "
        f"{theta[1] / DOT_THETA[1] - 1:.2e})")
    log(f"(j) launches in set_GPR(kernel='Dot'): "
        f"{json.dumps(nonzero(dot_train_launches))}")
    check_launches(dot_train_launches, ("kff_tri_dot", "kef_rect_dot"),
                   "Dot training", absent=RBF)
    dref = cpu_f64_copy(T, dgp, fit=False)
    for tag, th in (("theta0", DOT_THETA0), ("JAX theta*", DOT_THETA)):
        nll64, g64 = nll_vs_f64(dgp, dref, th, tag, log, phase="(j)")
        nll_ee, gs_ee = dot_nll_f32_ee(torch, dgp, th)
        log(f"(j) NLL at {tag} with K_EE in float32 too: {nll_ee:.8g}, "
            f"|dNLL| = {abs(nll_ee - nll64):.3e} "
            f"({abs(nll_ee - nll64) / abs(nll64):.3e} relative); "
            f"dNLL/dsigma {gs_ee:.6g} vs f64 {g64[0]:.6g} "
            f"({abs(gs_ee - g64[0]) / np.linalg.norm(g64):.3e} of |g|) "
            "(recorded, not a gate)")
    kff.reset_launches()
    t0 = time.time()
    dneb, E = run_neb(T, dgp, dimages)
    torch.cuda.synchronize()
    dot_neb_launches = dict(kff.launches)
    dneb["wall_s"] = time.time() - t0
    log(f"(j) Dot NEB: {time.time() - t0:.2f} s, band energies "
        f"{np.array2string(E, precision=6)} eV")
    for key, ref_val in JAX_DOT_NEB.items():
        log(f"(j) {key}: card {dneb[key]}, JAX CPU f64 {ref_val}")
    log("(j) launches in the Dot NEB: "
        f"{json.dumps(nonzero(dot_neb_launches))}")
    check_launches(dot_neb_launches, DOT, "Dot NEB", absent=RBF)
    if not dneb["converged"] or \
            abs(dneb["barrier"] - JAX_DOT_NEB["barrier"]) > BARRIER_TOL:
        raise AssertionError(f"the card Dot NEB did not converge to the JAX "
                             f"barrier within {BARRIER_TOL} eV")
    reserve_vs_f64(T, dgp, dimages, log, "(j) re-serve")
    path_launches = {"slice": main_launches, "training": train_launches,
                     "neb": neb_launches, "dot_training": dot_train_launches,
                     "dot_neb": dot_neb_launches}

    # (m1) batched bands against the images served one at a time, from
    # the slice model: the 3 interior images of the slice band and the 7
    # of a 9-image band; the batched calls counted
    card = card_line()
    band_launches = {}
    bands = {"band of 3": images[1:4],
             "band of 7": T.au_on_al100_images(9)[1:8]}
    for tag, band in bands.items():
        for name, v in band_vs_serial(torch, T, kff, K_ops, gp, band, tag,
                                      log, card).items():
            band_launches[name] = band_launches.get(name, 0) + v
    path_launches["batched_band"] = band_launches
    # (m2) the batched on-the-fly NEB, RBF then Dot, from set_GPR as in
    # (i) / (j), beside the serial NEB of this run
    batched_models = {}
    for kernel, jref, serial, fam in (
            ("RBF", JAX_BATCHED_NEB, (neb, neb_launches), RBF),
            ("Dot", JAX_BATCHED_DOT_NEB, (dneb, dot_neb_launches), DOT)):
        bgp, bimages = run_training(T, dev, f32, kernel=kernel)
        kff.reset_launches()
        t0 = time.time()
        bneb, E = run_neb(T, bgp, bimages, batched=True)
        torch.cuda.synchronize()
        bneb["wall_s"] = time.time() - t0
        batched_models[kernel] = (bgp, bimages)
        blaunches = dict(kff.launches)
        path_launches["batched_neb" if kernel == "RBF"
                      else "batched_dot_neb"] = blaunches
        log(f"(m2) [{card}] batched {kernel} NEB: band energies "
            f"{np.array2string(E, precision=6)} eV")
        for key in ("converged", "nsteps", "barrier", "use_base",
                    "use_surrogate", "fits", "N_energy", "N_forces",
                    "wall_s"):
            log(f"(m2) batched {kernel} {key}: card {bneb[key]}, serial "
                f"(card, this run) {serial[0][key]}, JAX CPU f64 batched "
                f"{jref.get(key, 'not run')}")
        per_step = per_k(blaunches, bneb["nsteps"])
        log(f"(m2) batched {kernel} launches a step {per_step}, serial "
            f"{per_k(serial[1], serial[0]['nsteps'])}; launches "
            f"{json.dumps(nonzero(blaunches))}")
        check_launches(blaunches, fam, f"batched {kernel} NEB",
                       absent=DOT if kernel == "RBF" else RBF)
        if not bneb["converged"] or bneb["nsteps"] > 150 or \
                abs(bneb["barrier"] - jref["barrier"]) > BARRIER_TOL:
            raise AssertionError(f"the batched {kernel} NEB did not "
                                 f"converge to the JAX batched barrier "
                                 f"within {BARRIER_TOL} eV")
    # (m3) the batched ingest at 100 structures, GP.load on the card
    path_launches["ingest"], lgp, ingest_band = run_ingest(
        T, torch, kff, K_ops, dev, log, card)
    check_launches(path_launches["ingest"], ("kff_tri", "kef_rect"),
                   "ingest", absent=DOT)

    # (n1) the incremental refit at the bench shape, in highest and
    # bf16x4: K2 and K3 on the cross block, one K1 on the new rows alone
    card = card_line()
    qe, qf = slice_request(gp, images[2], dev, f32)
    inc = run_incremental(T, torch, kff, dev, f32,
                          (qe, qf, len(images[2])), log, card)
    inc_launches = {}
    for (mode, k), c in inc.items():
        names = [kname(b, mode) for b in ("kef_rect", "kff_rect", "kff_tri")]
        check_launches(c, names, f"{mode} incremental refit of {k} rows",
                       absent=[n for n in NAMES if n not in names])
        if c[kname("kff_tri", mode)] != 1:
            raise AssertionError(f"{c[kname('kff_tri', mode)]} K1 launches "
                                 f"in the {mode} incremental refit of {k} "
                                 "rows: one, over the new rows, expected")
        for name, v in c.items():
            inc_launches[name] = inc_launches.get(name, 0) + v
    path_launches["incremental"] = inc_launches
    # (n2) the on-the-fly MD/EOS example at full width
    path_launches["md"], md_gp, md_last = run_md(T, torch, kff, K_ops, dev,
                                                 f32, log, card)
    check_launches(path_launches["md"], RBF, "MD", absent=DOT)
    # (n3) the serial NEB with opt_freq, against (i)'s barrier
    path_launches["neb_opt_freq"] = run_neb_opt_freq(
        T, torch, kff, dev, f32, log, neb["barrier"])
    check_launches(path_launches["neb_opt_freq"], RBF, "opt_freq NEB",
                   absent=DOT)

    # (o1) stress serving on the card, counted; (o2) the Hutchinson trace
    # at the bench shape; (o3) sparsify and the predictive covariance
    card = card_line()
    path_launches["stress"], stress_shapes = run_stress(
        T, torch, kff, dev, log, card, gp, images[2])
    path_launches["hutch"] = run_hutch(T, torch, kff, dev, log, card)
    check_launches(path_launches["hutch"], [
        kname(b, m) for m in ("highest", "bf16x4")
        for b in ("kff_tri_dual", "kef_rect_dual", "kff_tri_dot",
                  "kef_rect_dot")], "hutch")
    path_launches["sparsify"], path_launches["cov"] = run_sparsify_cov(
        T, torch, kff, dev, log, card, gp, images)
    check_launches(path_launches["sparsify"], ("kff_tri", "kef_rect"),
                   "sparsify", absent=DOT)

    # (k1) the precision modes on the path: set_GPR and the NEB in bf16x4
    # (RBF, then Dot), then the RBF path in bf16, each counted
    mode_models = {}
    for mode, kernel in (("bf16x4", "RBF"), ("bf16x4", "Dot"),
                         ("bf16", "RBF")):
        T.config.set_kff_precision(mode)
        fam = RBF if kernel == "RBF" else DOT
        names = [kname(b, mode) for b in fam]
        tag = f"{mode}{'_dot' if kernel == 'Dot' else ''}"
        kff.reset_launches()
        t0 = time.time()
        mgp, mimages = run_training(T, dev, f32, kernel=kernel)
        torch.cuda.synchronize()
        path_launches[f"{tag}_training"] = dict(kff.launches)
        theta = mgp.kernel.parameters()
        log(f"(k1) {mode} set_GPR(kernel={kernel!r}): {time.time() - t0:.2f}"
            f" s, N_energy={mgp.N_energy} N_forces={mgp.N_forces}; theta = "
            f"({theta[0]:.8f}, {theta[1]:.8f})")
        log(f"(k1) {mode} launches in set_GPR(kernel={kernel!r}): "
            f"{json.dumps(nonzero(kff.launches))}")
        train = (("kff_tri_dual", "kef_rect_dual") if kernel == "RBF"
                 else ("kff_tri_dot", "kef_rect_dot"))
        check_launches(kff.launches, [kname(b, mode) for b in train],
                       f"{mode} {kernel} training",
                       absent=[n for n in NAMES if n not in names])
        if not np.all(np.isfinite(theta)):
            raise AssertionError(f"non-finite theta in {mode}")
        if mode == "bf16x4":
            ref = cpu_f64_copy(T, mgp, fit=False)
            jth = (SIGMA, L_SCALE) if kernel == "RBF" else DOT_THETA
            th0 = THETA0 if kernel == "RBF" else DOT_THETA0
            for ttag, th in (("theta0", th0), ("JAX theta*", jth)):
                nll_vs_f64(mgp, ref, th, ttag, log, phase=f"(k1) {mode}",
                           gate=False)
        kff.reset_launches()
        t0 = time.time()
        try:
            mneb, E = run_neb(T, mgp, mimages)
        except RuntimeError as err:
            # bf16 alone: the dispatcher's own gate (the JAX package's,
            # dispatch.py) may refuse a refit whose training error is too
            # large; that ends the run and is its recorded outcome
            if mode != "bf16" or "training error is too large" not in \
                    str(err):
                raise
            mneb, E = None, np.asarray(list(mgp.error.values()))
            log(f"(k1) {mode} {kernel} NEB: stopped after "
                f"{time.time() - t0:.2f} s by the dispatcher's training-error "
                f"gate at refit "
                f"{mgp.fits}, N_energy={mgp.N_energy} N_forces="
                f"{mgp.N_forces}: {err} (recorded, not a gate)")
        torch.cuda.synchronize()
        path_launches[f"{tag}_neb"] = dict(kff.launches)
        jax_neb = JAX_NEB if kernel == "RBF" else JAX_DOT_NEB
        if mneb is not None:
            log(f"(k1) {mode} {kernel} NEB: {time.time() - t0:.2f} s, band "
                f"energies {np.array2string(E, precision=6)} eV")
            for key, ref_val in jax_neb.items():
                log(f"(k1) {mode} {kernel} {key}: card {mneb[key]}, JAX CPU "
                    f"f64 {ref_val}")
        log(f"(k1) {mode} launches in the {kernel} NEB: "
            f"{json.dumps(nonzero(kff.launches))}")
        check_launches(kff.launches, names, f"{mode} {kernel} NEB",
                       absent=[n for n in NAMES if n not in names])
        if not np.all(np.isfinite(E)):
            raise AssertionError(f"non-finite band energies or training "
                                 f"error in {mode}")
        if mode == "bf16x4" and (
                not mneb["converged"]
                or abs(mneb["barrier"] - jax_neb["barrier"]) > BARRIER_TOL):
            raise AssertionError(f"the {mode} {kernel} NEB did not converge "
                                 f"to the JAX barrier within {BARRIER_TOL} eV")
        if mode == "bf16x4":
            reserve_vs_f64(T, mgp, mimages, log, f"(k1) {mode} {kernel} "
                           "re-serve", gate=False)
        mode_models[tag] = mgp
    T.config.set_kff_precision("highest")

    # (b), (k2) kernels vs plain, at the paths' shapes and at the bench
    # shape, in every mode, and the card's split against the CPU's
    params = gp.kernel.params()
    dparams = dgp.kernel.params()
    te, tf, _, _ = gp._train_view()
    pe, pf = slice_request(gp, images[2], dev, f32)
    errs = {}
    slice_cases = all_cases(kff, pe, pf, te, tf, params, dparams)
    compare(torch, slice_cases, "slice", errs, log)
    for sort in (True, False):
        compare(torch, all_cases(kff, pe, pf, te, tf, params, dparams,
                                 sort=sort),
                f"slice, envs {'sorted by element' if sort else 'as packed'}",
                errs, log)
    nte, ntf, _, _ = tgp._train_view()
    compare(torch, [c for c in kernel_cases(kff, pe, pf, nte, ntf,
                                            tgp.kernel.params())
                    if c[0].endswith("_dual")], "NEB training set", errs,
            log)
    dte, dtf, _, _ = dgp._train_view()
    compare(torch, kernel_cases(kff, pe, pf, dte, dtf, dparams, "dot"),
            "Dot NEB training set", errs, log)
    # the batched paths' shapes, in every mode: the bands of 3 and 7
    # structures as the query side against the slice model's training
    # set; the batched NEBs' final bands and the band of 7 against their
    # training sets; the ingest's training set (K1 at its rows, K2 with 65
    # envs an energy point, both ways) against its band of 5 slabs
    for tag, band in bands.items():
        qe, qf = band_request(gp, band)
        compare(torch, all_cases(kff, qe, qf, te, tf, params, dparams),
                f"slice training set, {tag}", errs, log)
    for kernel, (bgp, bimages) in batched_models.items():
        bte, btf, _, _ = bgp._train_view()
        for tag, band in (("its final band", bimages[1:-1]),
                          ("band of 7", bands["band of 7"])):
            qe, qf = band_request(bgp, band)
            compare(torch, [c for mode in PREC for c in kernel_cases(
                kff, qe, qf, bte, btf, bgp.kernel.params(), kernel.lower(),
                mode)], f"batched {kernel} NEB training set, {tag}", errs,
                log)
    ite, itf, _, _ = lgp._train_view()
    qe, qf = band_request(lgp, ingest_band)
    compare(torch, all_cases(kff, qe, qf, ite, itf, lgp.kernel.params(),
                             dparams),
            "ingest training set, band of 5 slabs", errs, log)
    del lgp, ite, itf
    # the MD path's shapes: the final MD model's training set (SO3 nmax 2,
    # lmax 2: d = 9, 8 envs a point) against the last volume's 8-atom
    # request, K1 at its rows and the dual kernels of its NLL included
    mte, mtf, _, _ = md_gp._train_view()
    qe, qf = slice_request(md_gp, md_last, dev, f32)
    compare(torch, all_cases(kff, qe, qf, mte, mtf, md_gp.kernel.params(),
                             dparams),
            "MD training set, the last volume's request", errs, log)
    del md_gp, mte, mtf
    # the stress requests' shapes (o1), in every mode: each group of three
    # columns of the 9-column query side, as K2 (both ways) and K3 read it
    for tag, (qe, qf), ste, stf, sparams in stress_shapes:
        for g, fg in enumerate(column_groups(qf)):
            compare(torch, all_cases(kff, qe, fg, ste, stf, sparams, dparams,
                                     query_only=True),
                    f"{tag}, column group {g}", errs, log)
    for tag, mgp in mode_models.items():
        mode = tag.split("_")[0]
        kind = "dot" if tag.endswith("_dot") else "rbf"
        mte, mtf, _, _ = mgp._train_view()
        compare(torch, kernel_cases(kff, pe, pf, mte, mtf,
                                    mgp.kernel.params(), kind, mode),
                f"{tag} NEB training set", errs, log)
    be, bf = bench_data(torch, dev)
    bparams = {"sigma": 2.0, "l": 1.0}
    bdparams = {"sigma": 2.0, "sigma0": 2.0}
    bench_plain_ms = {}
    bench_cases = all_cases(kff, be, bf, be, bf, bparams, bdparams)
    compare(torch, bench_cases, "bench", errs, log, bench_plain_ms)
    # the (n1) shapes: each set of appended rows, sorted by element as the
    # refit sorts them (kernels.gram_sorts), against the bench training
    # side (K2 both ways, K3) and against itself (K1 on the new rows)
    for kE, kF in APPENDS:
        ne, nf = bench_data(torch, dev, kE, kF, seed=1 + kE)
        tag = f"{kE} E + {kF} F appended"
        compare(torch, all_cases(kff, ne, nf, be, bf, bparams, bdparams,
                                 sort=True, query_only=True),
                f"{tag}, against the bench training side", errs, log)
        compare(torch, all_cases(kff, ne, nf, ne, nf, bparams, bdparams,
                                 sort=True),
                f"{tag}, against themselves", errs, log)
    # the sixteen mode K2/K3 kernels also on packed operands at the bench
    # shape (bench_cases sorts both sides, as the operand builders do by
    # default at this size), one case a kernel
    seen = set()
    compare(torch, [c for c in all_cases(kff, be, bf, be, bf, bparams,
                                         bdparams, MODES, False)
                    if c[0] in MMA and not (c[0] in seen or seen.add(c[0]))],
            "bench, envs as packed", errs, log)
    for name, f in (("slice request", pf), ("bench", bf)):
        Xh, _ = kff.force_operand(f, "highest")
        for mode in MODES:
            Xm, _ = kff.force_operand(f, mode)
            if not torch.equal(Xm.cpu().view(torch.int16),
                               kff.split(Xh.cpu(), mode).view(torch.int16)):
                raise AssertionError(f"the card's {mode} split of the "
                                     f"{name} rows is not the CPU's")
            log(f"(k2) {name} force rows {tuple(Xh.shape)}: the card's "
                f"{mode} split equals the CPU split bit for bit")

    # (c), (k3) PSD: the bench covariance plus noise factorises in each
    # mode; alpha from bf16x4 is the float32 alpha
    from gpr_calculator_tpu_torch.models.gp import _noise_diag
    for mode in PREC:
        Kb = K_ops.k_self(be, bf, bparams, 2, mm_precision=mode)
        Kb.diagonal().add_(_noise_diag(be, bf, 0.01, 0.1))
        Lb, info = torch.linalg.cholesky_ex(Kb)
        phase = "(c)" if mode == "highest" else "(k3)"
        if int(info) != 0:
            raise AssertionError(f"bench covariance not PD in {mode} "
                                 f"(info={int(info)})")
        log(f"{phase} cholesky_ex of the {tuple(Kb.shape)} bench covariance "
            f"in {mode}: info=0, min diag(L)="
            f"{float(Lb.diagonal().min()):.4e}")
        del Kb, Lb
    se, sf = bench_data(torch, dev, m_e=64, m_f=192)
    sy = torch.as_tensor(np.random.RandomState(7).randn(se.m + 3 * sf.m)
                         * 0.1, dtype=f32, device=dev)

    def alpha(mode):
        K = K_ops.k_self(se, sf, bparams, 2, mm_precision=mode)
        K.diagonal().add_(_noise_diag(se, sf, 0.01, 0.1))
        return torch.cholesky_solve(sy[:, None],
                                    torch.linalg.cholesky(K))[:, 0]

    a_hi, a_x4, a_b1 = alpha("highest"), alpha("bf16x4"), alpha("bf16")
    rel_x4 = float((a_x4 - a_hi).norm() / a_hi.norm())
    rel_b1 = float((a_b1 - a_hi).norm() / a_hi.norm())
    log(f"(k3) alpha at 64 E + 192 F: |a_bf16x4 - a_highest| / |a_highest| "
        f"= {rel_x4:.3e} (limit 2e-2, and below 0.3 x the bf16 gap "
        f"{rel_b1:.3e})")
    if not (rel_x4 < 2e-2 and rel_x4 < 0.3 * max(rel_b1, 1e-9)):
        raise AssertionError("alpha from bf16x4 is not the float32 alpha")
    # the float32 floor: each mode's alpha against a float64 one (plain
    # versions on float64 data)
    se64, sf64 = to_f64(torch, se, sf)
    K64 = K_ops.k_self(se64, sf64, bparams, 2, plain=True)
    K64.diagonal().add_(_noise_diag(se64, sf64, 0.01, 0.1))
    a64 = torch.cholesky_solve(sy.double()[:, None],
                               torch.linalg.cholesky(K64))[:, 0]
    log("(k3) alpha against float64 (recorded, not a gate): " + ", ".join(
        f"{m} {float((a.double() - a64).norm() / a64.norm()):.3e}"
        for m, a in (("highest", a_hi), ("bf16x4", a_x4), ("bf16", a_b1))))

    # (e) frozen re-serve: card f32 kernels vs a CPU f64 plain model
    reserve_vs_f64(T, gp, images, log, "(e)")

    # (g) times and bounds at the slice's shapes, a mid and the bench
    # shape (the first case of each kernel; the plain version at the bench
    # shape: its one call in (b)/(k2))
    times = {}
    for name, kern, plain, (mma, ops, nbytes) in slice_cases:
        if name not in times:
            times[name] = (cuda_ms(torch, kern, 50),
                           cuda_ms(torch, plain, 10),
                           *bound(mma, ops, nbytes))
    for name, (ms, pms, bms, by) in times.items():
        log(f"(g) slice {name}: call {ms:.4f} ms, plain {pms:.4f} ms, "
            f"bound {bms:.3g} ms ({by})")
    # (g) the redesigned kernels at the slice's shapes: the wrapper call
    # above, the device time of one launch and the launch floor
    card = card_line()
    kff.launch_empty(dev)
    empty, stream = kff._lib()["kff_empty"], \
        torch.cuda.current_stream().cuda_stream
    floor_us = 1e3 * cuda_ms(torch, lambda: empty(stream), 2000)
    log(f"(g) [{card}] launch floor: an empty kernel {floor_us:.3f} us per "
        "back-to-back launch (CUDA events)")
    slice_ops = {mode: ((kff.energy_operand(pe, mode) + (pe.x.shape[1],)),
                        *(kff.force_operand(f, mode) + (f.x.shape[1],)
                          for f in (pf, tf))) for mode in PREC}
    slice_device_us = {}
    for name in HIGHEST + list(MMA) + list(TRI_MMA):
        base, mode = split_name(name)
        E1, F1, F2 = slice_ops[mode]
        prm = dparams if base.endswith("_dot") else params
        lhs = E1 if base.startswith("kef") else \
            F2 if base.startswith("kff_tri") else F1
        slice_device_us[name] = device_us(torch, kff, name, lhs, F2, prm)
        log(f"(g) [{card}] slice {name}: device {slice_device_us[name]:.2f} "
            f"us a launch (raw launches back to back), call "
            f"{1e3 * times[name][0]:.2f} us (CUDA events around the wrapper)")
    for name in ("kff_rect_bf16x4", "kef_rect_bf16x4", "kff_rect_bf16"):
        E1, F1, F2 = slice_ops[split_name(name)[1]]
        kept, anew = map_host_us(torch, kff, name,
                                 E1 if name.startswith("kef") else F1, F2,
                                 params)
        log(f"(g) [{card}] slice {name}: host us a raw launch, the lhs at "
            f"one address {kept:.2f}, at a new one each launch {anew:.2f} "
            f"(in bf16x4 its tensor map encoded anew: +{anew - kept:.2f} "
            "us)")
    at = {"mid": {}, "bench": {}}
    me, mf = bench_data(torch, dev, m_e=250, m_f=750)
    for sort in (True, False):
        compare(torch, all_cases(kff, me, mf, me, mf, bparams, bdparams,
                                 sort=sort),
                f"mid, envs {'sorted by element' if sort else 'as packed'}",
                errs, log)
    for tag, (e_, f_) in (("mid", (me, mf)), ("bench", (be, bf))):
        re_, w_ = kff.force_operand(f_)[1], kff.energy_operand(e_)[1]
        for what, args, kw in (("K1", (re_, 32, re_, 32), {"triangle": True}),
                               ("K3", (re_, 32, re_, 32), {}),
                               ("K2", (w_, 32, re_, 32, True), {})):
            some, every = kff.staged_pairs(*args, **kw)
            mine, products = kff.staged_pairs(*args, per_lhs_point=True,
                                              **kw)
            log(f"(g) {tag} {what}: {some} of {every} chunk pairs staged "
                f"({some / every:.3f}; the rest have disjoint element "
                f"ranges), {mine / products:.3f} of the (lhs point, chunk "
                "pair) products multiplied; same-element env pairs are "
                f"{pair_count(args[0], 32, re_, 32, False) / (args[0].shape[1] * re_.shape[1]):.3f}"
                " of all")
        for what, body, args, kw in (
                ("K1", "tri_mma", (re_, 32, re_, 32), {"triangle": True}),
                ("K3", "rect_mma", (re_, 32, re_, 32), {}),
                ("K2", "rect_mma", (w_, 32, re_, 32, True), {})):
            some, every, mine, products = kff.mma_pairs(*args, **kw)
            log(f"(g) {tag} {what} in the modes ({body}_kernel): {some} of "
                f"{every} chunk pairs staged ({some / every:.3f}), "
                f"{mine / products:.3f} of the warp products (16 x 8 env "
                "sub-tiles) multiplied")
    sort_readings(torch, kff, dev, log, card)
    k1_us = k1_readings(torch, kff, (("slice", tf, params, dparams, 200),
                                     ("mid", mf, bparams, bdparams, 10),
                                     ("bench", bf, bparams, bdparams, 3)),
                        log, card)
    for tag, cases in (("mid", all_cases(kff, me, mf, me, mf, bparams,
                                         bdparams)),
                       ("bench", bench_cases)):
        label = ("mid (250 E + 750 F)" if tag == "mid"
                 else "bench (1000 E + 3000 F)")
        for name, kern, plain, (mma, ops, nbytes) in cases:
            if name in at[tag]:
                continue
            ms = cuda_ms(torch, kern, 3)
            pms = (cuda_ms(torch, plain, 1) if tag == "mid"
                   else bench_plain_ms[name])
            bms, by = bound(mma, ops, nbytes)
            log(f"(g) {label}, 32 envs, {name}: kernel {ms:.3f} ms, plain "
                f"{pms:.3f} ms, bound {bms:.3f} ms ({by}; {mma:.4g} "
                f"tensor-core and {ops:.4g} fp32 operations, {nbytes:.4g} "
                "bytes)" + f"; {bms / ms:.3f} of the bound (target 0.5)")
            at[tag][name] = dict(ms=ms, plain_ms=pms, bound_ms=bms,
                                 bound_by=by)

    # (g) one NLL + gradient evaluation at the bench shape: k_self_dual
    # (K1-dual, K2-dual, K_EE), Cholesky, cholesky_inverse, traces; and
    # the same function in float64 on the card with the plain versions
    from gpr_calculator_tpu_torch.models.gp import (_nll_dot_analytic,
                                                    _nll_rbf_analytic)
    n = be.m + 3 * bf.m
    y = torch.as_tensor(np.random.RandomState(1).normal(0.0, 0.1, n),
                        dtype=f32, device=dev)
    args = ((2.0, 1.0), be, bf, y, (0.01, 0.1), 10.0, 2, False)
    dargs = ((2.0, 2.0),) + args[1:]
    def dot_k_self():
        return K_ops.k_self(be, bf, bdparams, 2, "dot", dtype=torch.float64)
    log(f"(g) bench (1000 E + 3000 F), 32 envs, NLL + gradient: "
        f"{cuda_ms(torch, lambda: _nll_rbf_analytic(*args), 3):.3f} ms "
        "per evaluation, of which k_self_dual "
        f"{cuda_ms(torch, lambda: K_ops.k_self_dual(be, bf, bparams), 3):.3f}"
        " ms; Dot NLL + gradient "
        f"{cuda_ms(torch, lambda: _nll_dot_analytic(*dargs), 3):.3f} ms, "
        f"of which k_self (float64 K_EE) {cuda_ms(torch, dot_k_self, 3):.3f}"
        " ms")
    be64, bf64 = to_f64(torch, be, bf)
    f64_nll = {}
    for label, fn, a, mode in (("RBF", _nll_rbf_analytic, args, "highest"),
                               ("Dot", _nll_dot_analytic, dargs, "highest"),
                               ("RBF", _nll_rbf_analytic, args, "bf16x4"),
                               ("Dot", _nll_dot_analytic, dargs, "bf16x4")):
        T.config.set_kff_precision(mode)
        if mode != "highest":
            log(f"(g) bench (1000 E + 3000 F), 32 envs, {label} NLL + "
                f"gradient in {mode}: "
                f"{cuda_ms(torch, lambda: fn(*a), 3):.3f} ms per evaluation")
        nll32, g32 = fn(*a)
        T.config.set_kff_precision("highest")
        if label not in f64_nll:
            f64_nll[label] = fn(a[0], be64, bf64, y.double(), *a[4:],
                                plain=True)
        nll64, g64 = f64_nll[label]
        nll32, nll64 = float(nll32), float(nll64)
        g32, g64 = g32.cpu().double().numpy(), g64.cpu().numpy()
        log(f"(g) bench {label} NLL card f32 ({mode}) {nll32:.10g} vs card "
            f"f64 (plain) {nll64:.10g}: |dNLL| = {abs(nll32 - nll64):.3e} "
            f"({abs(nll32 - nll64) / abs(nll64):.3e} relative); grad f32 "
            f"{np.array2string(g32, precision=8)}, f64 "
            f"{np.array2string(g64, precision=8)}, |dg|/|g| = "
            f"{np.linalg.norm(g32 - g64) / np.linalg.norm(g64):.3e} "
            "(recorded, not a gate)")

    # (g) one slice request's _predict_packed with the training side's
    # operands kept by the model, and rebuilt at every request
    from gpr_calculator_tpu_torch.models.gp import (_factorize,
                                                    _predict_packed)
    sargs = (pe, pf, te, tf, params, gp.alpha_, gp.L_, 2, True, "rbf")
    kept = host_ms(torch, lambda: _predict_packed(
        *sargs, train_ops=gp._train_operands()), 30)
    rebuilt = host_ms(torch, lambda: _predict_packed(*sargs), 30)
    log(f"(g) [{card}] _predict_packed, one slice request with std, host "
        f"clock to a synchronise, min / median / max of 30: training "
        f"operands kept {kept[0]:.3f} / {kept[1]:.3f} / {kept[2]:.3f} ms, "
        f"rebuilt {rebuilt[0]:.3f} / {rebuilt[1]:.3f} / {rebuilt[2]:.3f} ms")
    K_ops.reset_operand_builds()
    gp._serve_ops = None
    for img in images[:2]:
        gp.predict_structure(img, return_std=True)
    log(f"(g) two requests without a refit: operand builds "
        f"{json.dumps(K_ops.operand_builds)}")
    if K_ops.operand_builds != {"query": 2, "train": 1}:
        raise AssertionError("a model that serves twice must build its "
                             "training-side operands once")

    # (g) the weights at n = 10 000: the 13-atom request served through
    # _predict_packed from _factorize's alpha (a float64 solve, float64
    # weights, a float64 product) against a float64 solve of the same K;
    # beside it, recorded, the two float32 routes it replaces
    Kb = K_ops.k_self(be, bf, bparams, 2, dtype=torch.float64)
    Kb.diagonal().add_(_noise_diag(be, bf, 0.01, 0.1))
    a64 = torch.cholesky_solve(y.double()[:, None],
                               torch.linalg.cholesky(Kb))[:, 0]
    L_b, a_b = _factorize(be, bf, y, bparams, 0.01, 0.1, 2, "rbf")
    Kt = K_ops.k_block(pe, pf, be, bf, bparams, 2, dtype=torch.float64)
    mean64 = Kt @ a64
    natoms = len(images[2])
    lim_e, lim_f = 0.1 * 0.01 * natoms, 0.1 * 0.1

    def off(mean):
        mean = mean.double()
        return (float((mean[0] - mean64[0]).abs()) * natoms,
                float((mean[pe.m:] - mean64[pe.m:]).abs().max()))
    served, _ = _predict_packed(pe, pf, be, bf, bparams, a_b, L_b, 2, False)
    dE, dF = off(served)
    log(f"(g) bench weights from _factorize ({a_b.dtype}) against a float64 "
        f"solve of the same K: max|da| = {rel_to(a_b.double(), a64):.3e} of "
        f"max|alpha|; the 13-atom request served from both: |dE| = {dE:.3e} "
        f"eV (limit {lim_e:.3e}), max|dF| = {dF:.3e} eV/A (limit "
        f"{lim_f:.3e}); max|E| {float(mean64[0].abs()) * natoms:.3e}, "
        f"max|F| {float(mean64[pe.m:].abs().max()):.3e}")
    if not (dE <= lim_e and dF <= lim_f):
        raise AssertionError("the bench request served from _factorize's "
                             "alpha is outside the limits against a float64 "
                             "solve of the same K")
    sigma_vs_f64(torch, K_ops, pe, pf, be, bf, bparams, Kb, Kt, L_b, a_b,
                 natoms, log)
    a32 = torch.cholesky_solve(y[:, None],
                               torch.linalg.cholesky(Kb.float()))[:, 0]
    for what, a in (("a float32 solve and a float32 product", a32),
                    ("the float64 solve rounded to float32 and a float32 "
                     "product", a64.float())):
        dE, dF = off(Kt.float() @ a)
        log(f"(g) the same request from {what}: max|da| = "
            f"{rel_to(a.double(), a64):.3e} of max|alpha|, |dE| = {dE:.3e} "
            f"eV, max|dF| = {dF:.3e} eV/A (recorded)")
    del Kb, Kt, a64, a32, L_b, a_b

    # (l) the mesh-sharded builds: four shards over the cards present
    import gpr_calculator_tpu_torch.parallel as par
    from gpr_calculator_tpu_torch.parallel.dryrun import dryrun_multichip
    devices = [f"cuda:{i % torch.cuda.device_count()}"
               for i in range(N_SHARDS)]
    mesh = par.make_mesh(N_SHARDS, devices)
    log(f"(l) mesh of {mesh.size} shards over {torch.cuda.device_count()} "
        f"card(s): " + ", ".join(f"shard {i} -> {d}"
                                 for i, d in enumerate(mesh.devices)))

    # (l1) the range form of every K1 kernel and the K2/K3 stripes, in
    # every mode, against the plain version and the single launch
    for tag, (se_, sf_), with_plain in (("slice", (te, tf), True),
                                        ("mid", (me, mf), True),
                                        ("bench", (be, bf), False)):
        rbf_p, dot_p = (params, dparams) if tag == "slice" \
            else (bparams, bdparams)
        for mode in PREC:
            for kind, prm in (("rbf", rbf_p), ("dot", dot_p)):
                sharded_k1(torch, kff, par, mesh, sf_, prm, kind, mode, tag,
                           errs, log, with_plain)
                sharded_stripes(torch, kff, par, mesh, se_, sf_, prm, kind,
                                mode, tag, log)

    # (l2) the slice at full width, sharded against unsharded
    for mode in ("highest", "bf16x4"):
        sharded_bench(T, torch, K_ops, par, mesh, be, bf, pe, pf, bparams,
                      y, mode, log)

    # (l3) the main path through the entry points with the sharded route
    # forced: GP(mesh=), set_GPR, the on-the-fly NEB, each counted
    builds = par.sharded_kernels.builds
    T.config.set_sharded_gate("off")
    kff.reset_launches()
    par.sharded_kernels.reset_builds()
    t0 = time.time()
    sgp, simages = run_training(T, dev, f32, mesh=mesh)
    torch.cuda.synchronize()
    path_launches["mesh_training"] = dict(kff.launches)
    theta = sgp.kernel.parameters()
    log(f"(l3) set_GPR(mesh=): {time.time() - t0:.2f} s, N_energy="
        f"{sgp.N_energy} N_forces={sgp.N_forces}; theta = ({theta[0]:.8f}, "
        f"{theta[1]:.8f}), JAX CPU f64 ({SIGMA:.8f}, {L_SCALE:.8f}); "
        f"sharded builds {json.dumps(builds)}")
    log(f"(l3) launches in set_GPR(mesh=): {json.dumps(nonzero(kff.launches))}")

    def check_mesh_path(on_path, path):
        """Only ``on_path`` ran, and every sharded training build took
        the range form: one launch per shard that owns a tile (3 or 4 of
        the 4 shards here, the smallest training set having 3 tiles)."""
        check_launches(kff.launches, on_path, path,
                       absent=[n for n in NAMES + RANGE_NAMES
                               if n not in on_path])
        ranged = sum(kff.launches[n] for n in RANGE_NAMES)
        if not 3 * builds["self_blocks"] <= ranged \
                <= N_SHARDS * builds["self_blocks"]:
            raise AssertionError(f"{ranged} range launches for "
                                 f"{builds['self_blocks']} sharded builds "
                                 f"on the {path} path")
    check_mesh_path(("kff_tri_range", "kff_tri_dual_range", "kef_rect",
                     "kef_rect_dual", "kff_rect"), "mesh training")
    kff.reset_launches()
    par.sharded_kernels.reset_builds()
    t0 = time.time()
    sneb, E = run_neb(T, sgp, simages)
    torch.cuda.synchronize()
    path_launches["mesh_neb"] = dict(kff.launches)
    log(f"(l3) NEB with GP(mesh=): {time.time() - t0:.2f} s, band energies "
        f"{np.array2string(E, precision=6)} eV; sharded builds "
        f"{json.dumps(builds)}")
    for key, ref_val in JAX_NEB.items():
        log(f"(l3) {key}: card {sneb[key]}, JAX CPU f64 {ref_val}")
    log(f"(l3) launches in the NEB: {json.dumps(nonzero(kff.launches))}")
    check_mesh_path(("kff_tri_range", "kff_tri_dual_range", "kef_rect",
                     "kef_rect_dual", "kff_rect"), "mesh NEB")
    if builds["k_block"] <= 0:
        raise AssertionError("no served block took the sharded route")
    if not sneb["converged"] or \
            abs(sneb["barrier"] - JAX_NEB["barrier"]) > BARRIER_TOL:
        raise AssertionError(f"the mesh NEB did not converge to the JAX "
                             f"barrier within {BARRIER_TOL} eV")
    T.config.set_sharded_gate("auto")
    dryrun_multichip(N_SHARDS, devices)

    # (l) times: the sharded builds beside the single launches, and the
    # range form of each K1 kernel at the slice, mid and bench shapes
    sharded_times(torch, kff, K_ops, par, mesh, be, bf, pe, pf, bparams, y,
                  log)
    range_at = {
        "slice": range_times(torch, kff, par, mesh, tf, params, dparams, 50,
                             10),
        "mid": range_times(torch, kff, par, mesh, mf, bparams, bdparams, 3,
                           1),
        # the plain range version at the bench shape is the plain K1 (its
        # plain_ms above) and a mask: not timed again
        "bench": range_times(torch, kff, par, mesh, bf, bparams, bdparams, 3,
                             0)}
    for tag, rt in range_at.items():
        for name, (ms, pms, bms, by, per, single) in rt.items():
            log(f"(l) times {tag} {name}: shard 0 of {N_SHARDS} {ms:.4f} ms, "
                f"plain {'not timed' if pms is None else f'{pms:.4f} ms'}, "
                f"bound {bms:.3g} ms ({by}); per shard "
                f"{[round(t, 4) for t in per]} ms, sum / single launch = "
                f"{sum(per):.4f} / {single:.4f} = {sum(per) / single:.4f}")

    # (p) float64 on the card (the JAX package's default x64 mode): (p1)
    # every _f64 kernel against its plain version, (p2) set_GPR and the
    # NEBs, (p3) the 10 000-row bench, (p4) the MD example, each counted
    t_p = time.time()
    card = card_line()
    f64 = torch.float64
    f64_errs, f64_times, f64_at = f64_kernel_checks(
        torch, kff, par, dev, log, card,
        (*slice_request(gp, images[2], dev, f64), *to_f64(torch, te, tf)),
        compiler_log)
    path_launches.update(run_f64_paths(T, torch, kff, dev, log, card,
                                       f64_errs))
    path_launches.update(run_f64_bench(
        T, torch, kff, K_ops, dev, log, card,
        (*slice_request(gp, images[2], dev, f64), len(images[2])), f64_errs))
    path_launches["f64_md"], md64_gp, md64_last = run_md(
        T, torch, kff, K_ops, dev, f64, log, card, steps=F64_MD_STEPS,
        phase="(p4)", tol=F64_MD_TOL)
    check_f64_path(path_launches["f64_md"], RBF_F64, "float64 MD", RBF_F64)
    # the MD path's shapes (d = 9, 8 envs a point), both families
    f64_path_shapes(torch, kff, md64_gp,
                    slice_request(md64_gp, md64_last, dev, f64),
                    "float64 MD training set, the last volume's request",
                    f64_errs, log, kinds=("rbf", "dot"))
    del md64_gp
    log(f"(p) float64 on the card: {time.time() - t_p:.1f} s")

    def range_cell(name, tag):
        ms, pms, bms, by, per, single = range_at[tag][name]
        return dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                    per_shard_ms=per, single_launch_ms=single)

    # ms / plain_ms / bound_ms: the slice's shapes; "mid" and "bench":
    # the 2.5k and 10k bench shapes.  No single PyTorch call computes
    # these blocks, so there is no library time.  The range form of a K1
    # kernel: shard 0's tile range of the four.
    kernels = [{"name": name, "route": "cuda", "source": source_of(name),
                "replaces": replaces(name),
                "launches": sum(c[name] for c in path_launches.values()),
                "launches_by_path": {p: c[name]
                                     for p, c in path_launches.items()},
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1], "bound_ms": times[name][2],
                "bound_by": times[name][3], "library_ms": None,
                "mid": at["mid"][name], "bench": at["bench"][name],
                **({"device_us": slice_device_us[name],
                    "launch_floor_us": floor_us} if name in slice_device_us
                   else {}),
                **({"device_us_by_shape": {
                    f"{tag}_{'sorted' if srt else 'packed'}": us
                    for (tag, b, srt), us in k1_us.items() if b == name}}
                   if name.startswith("kff_tri") else {})}
               for name in NAMES]
    kernels += [{"name": name, "route": "cuda", "source": source_of(name),
                 "replaces": RANGE_REPLACES,
                 "launches": sum(c[name] for c in path_launches.values()),
                 "launches_by_path": {p: c[name]
                                      for p, c in path_launches.items()},
                 "max_abs_err": errs[name], "library_ms": None,
                 **range_cell(name, "slice"), "mid": range_cell(name, "mid"),
                 "bench": range_cell(name, "bench")}
                for name in RANGE_NAMES]
    kernels += [{"name": name, "route": "cuda", "source": source_of(name),
                 "replaces": replaces(name),
                 "launches": sum(c[name] for c in path_launches.values()),
                 "launches_by_path": {p: c[name]
                                      for p, c in path_launches.items()},
                 "max_abs_err": f64_errs[name], "ms": f64_times[name][0],
                 "plain_ms": f64_times[name][1],
                 "bound_ms": f64_times[name][2],
                 "bound_by": f64_times[name][3], "library_ms": None,
                 "mid": f64_at["mid"][name], "bench": f64_at["bench"][name]}
                for name in F64_NAMES]
    log(f"whole run: {time.time() - t_run:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
