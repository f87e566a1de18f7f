"""Smoke run of the PyTorch port (webgpufft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout's sources, holds each
kernel against its plain PyTorch version (at the shapes the paths below give
it, and at lengths that stress the radix chain: the shared-memory limit, every
odd radix, one-butterfly lengths, a ragged column count, small digits; K2's
tall tiles run the ring design, the timing lines and the kernel record name
the design of each shape), and
holds each kernel's adjoint launch (the backward of autograd) against the
plain adjoint and the dot test <K x, u> = <x, K^H u>, holds the three probe
kernels (``webgpufft_tpu_torch.probes``) against theirs, and drives seventeen
paths through the port's entry points, each with the kernels' launch counts
set to 0 just before it and read just after (each must launch the kernels
named, and no other); while a path runs, K1 and K2 also log the shape and
tables of every launch, and after the last path each logged combination is
held against the plain version once more, with the path's own tables:

- c2c: ``create_plan(...)(x)`` on the batched 1-D headline plan and a 256^3
  plan (K1, K2);
- r2c: the 256^3 batch-3 plan of the Navier-Stokes step (K1, K2);
- c2r: the 256^3 batch-6 plan of the same step (K1, K2);
- dct: dct2 and dct3 [512, 512] x 8 (K1, K2), dct2 [8, 8] x 16384 (the
  matmul route), dct4 and dst1 [32768] x 32 (the einsum route), against a
  float64 trig-matrix oracle on the card and scipy;
- fftconv: [1000, 1000] x 8 with a 25 x 25 kernel, ``linear-same`` (K1, K2),
  the 64 -> 128 channel-lane preset at [256] x 4 (K1 on the product only) and
  overlap-save on [2^20] with 129 taps (K1 on the blocks), against
  ``torch.fft`` convolutions in complex128;
- conv2d: [1024, 1024] x 8, k = 3, ``same``, complex data with a complex
  kernel and real with real, cuDNN's TF32 switched ON around the call to show
  the plan scopes it off (no kernel of the port's own);
- staging: the headline plan with a strided input and a ``whdcn`` output
  lane, an ioView crop merged into ``out=``, an exec-time input offset,
  ``inPlace`` and bf16-storage, against the unstaged plan (K1);
- ns3d: the 3-D Navier-Stokes solver (``webgpufft_tpu_torch.examples.
  navier_stokes3d``) at 256^3, nu = 2e-2, dt = 1e-2, on the embedded
  Taylor-Green vortex and the ABC flow, held against their analytic
  solutions at rel err < 1e-4 (K1, K2);
- autodiff: gradients at full size through the same entry points, launch
  counts asserted forward + backward, each against a closed form or the same
  loss written on ``torch.fft`` in float64: the headline plan (Parseval), c2c
  256^3 forward then inverse, r2c -> spectral mask -> c2r 256^3 x 3, dct2
  [512, 512] x 8, fftconv [1000, 1000] x 8 (kernel and input), conv2d
  [1024, 1024] x 8 (kernel), one Navier-Stokes step at 256^3 by reverse mode
  held against ``torch.func.jvp``, and ``torch.func.vmap`` of the headline
  plan (K1, K2);
- runtime: ``rigor: "measure"`` on four plans, a snapshot round trip that
  reuses the winners without timing, the golden corpus
  (``tests/golden_corpus.json``), the selftest, ``export_plan`` ->
  ``load_exported_plan`` and a ``trace()`` of one headline call (K1, K2);
- probes: the measurement kernels through their entry points at full size:
  ``stream_copy`` in every mode and stage count on the headline array
  (4096, 2048) and a 128 MB array, ``lines_stages`` at every stop of the
  headline chain with the last stop held against K1, ``lines_planes`` against
  K1 on the interleaved form, and K1 in place (``stream_copy``,
  ``lines_stages``, ``lines_planes``, K1);
- facade: the numpy/scipy-style functions of ``webgpufft_tpu_torch.fft`` on
  tensors on the card, each call's K1/K2 launches counted and each result
  against the library: ``fft``/``ifft`` on complex64 (4096, 1024) and
  ``fftn`` 256^3 and ``rfftn``/``irfftn`` 256^3 x 3 against ``torch.fft``,
  ``dctn`` (8, 512, 512) against float64 trig matrices, ``fftconvolve``
  (8, 1000, 1000) * (25, 25) and [2^20] * [129] (overlap-save) against
  ``torch.fft`` convolutions, ``stft``/``istft``/``welch`` on (8, 2^22) at
  nperseg 1024 (65,544 frames) against ``torch.stft`` and ``scipy.signal``,
  a ``ShortTimeFFT`` pair, ``hilbert`` ((8, 2^20): the four-step einsum
  route; (2048, 4096): K1) and ``resample_poly`` (8, 2^20) against
  ``scipy.signal`` in float64, ``torch_fft.fft2`` on (64, 1024,
  1024) with its gradient against ``torch.fft.fft2``'s, and the bridges with
  numpy in and out (``scipy.fft.fft`` under the backend, ``pyfftw.FFTW``,
  ``fftpack.rfft``) (K1, K2);
- nufft and linalg: see ``phase_nufft`` and ``phase_linalg`` (K1, K2; K1);
- signal: the DSP toolboxes (``filtering``, ``splines``, ``ndimage``,
  ``ltisys``) at full size with TF32 switched ON around them (the library
  scopes it off for its products): IIR and SOS filtering, zero-phase
  filtering, FIR ``lfilter`` and ``savgol_filter`` on (8, 2^22), ``wiener``,
  ``medfilt2d``, ``cspline2d`` and ``spline_filter`` on (2048, 2048), the
  Fourier filters on ``fft2`` spectra, the symmetric IIR smoothers and spline
  evaluation, ``lsim`` / ``dlsim`` / ``step`` / ``impulse``, ``freqz``,
  ``sosfreqz`` and the control-toolkit example, each call's K1/K2 launches
  pinned (the recurrences and the other torch-op calls launch none) and each
  result against scipy in float64 on the host (K1, K2).  After the timing
  phases, the A/B of the two IIR routes that sets
  ``filtering.IIR_ASSOC_MIN_N_CUDA``;
- distributed: the multi-GPU layer (``webgpufft_tpu_torch.parallel``) in a
  one-rank NCCL world made in this process (the card machine has one GPU,
  and NCCL takes one rank a device), meshes ``{"dp": 1}``, ``{"sp": 1}``
  and ``{"sp1": 1, "sp2": 1}``: the headline plan batch-sharded (K1), c2c
  [2^22] x 8 (four-step 2048 x 2048) and the Bluestein route at the prime
  1048573, the poisson3d example at 256^3 (slab and pencil) against its
  manufactured solution, one NS-3D step at 256^3 (slab and pencil), NS-2D at
  2048^2, dct2 / dst3 [512, 512] x 8 and dct4 [32768] x 32, fftconv
  [1000, 1000] x 8 * 25^2 ``linear-same`` (the halo route and the pencil)
  and [2^22] x 8 * 129 taps (the halo route), ``stft`` / ``istft`` /
  ``welch`` / ``csd`` of (8, 2^22) and the NUFFT types 1-3 of the nufft
  path, each against the single-device plan or call of the same spec on the
  same tensor (and ``torch.fft`` for the plain transforms), each call's
  launches pinned (``DIST_LAUNCHES``: einsum routes launch none); then each
  case timed beside its single-device call, and the world destroyed
  (gloo ranks sharing the one card cannot stand in for more cards: gloo's
  send/recv refuses CUDA tensors, PERF.md section 6).  The NS steps are also
  held by their right-hand side (``step.rhs``), the part of a step only the
  transforms make, so that the viscous part of the state cannot hide a
  wrong transform.
- examples: in the distributed path's world, ``export_distributed_plan`` ->
  ``load_exported_plan`` -> ``ep(x, mesh=...)`` of c2c [2^22] x 8, the pencil
  c2c 256^3 x 3 and the two halo fftconvs ([2^22] x 8 * 129, [1000, 1000] x 8
  * 25^2), each equal to its live plan and within 1e-5 of the single-device
  plan, a dp-only plan and a mesh of other axes refused; then the examples of
  ``webgpufft_tpu_torch/examples`` through their entry points: AOT serving of
  [1024] x 4096 built here and served by a second process, system
  identification (400 Adam steps through the fftconv plan: K1 forward and its
  adjoint launch) at n 512 and 2^20 and over dp 1 x sp 1, MRI gridding at
  128^2 (with the distributed leg) and at 256^2 with 205,824 samples, the
  NS-3D ``main`` at n 32, 10 steps of 256^3 turbulence (energy falls,
  ``max_divergence`` < 1e-4) and a 3-step advance through ``export_pipeline``
  (bit-equal to the eager run), and the facade demos, ``spectral_filter``
  also at [1024] x 65,536 beside ``torch.fft``; each case's launches pinned
  (``EXAMPLE_LAUNCHES``), each held to its JAX script's bars; then timed
  beside the yardsticks, with ms per training step beside the same loop on
  ``torch.fft``.

Two phases after the listed kernel shapes hold the kernels and the port over
their whole domain (neither is a path; their launches count for none):

- domain: every length K1 accepts and every height K2 accepts
  (``domain_lengths()``, read from ``fused.choose_split`` and
  ``fused_cols.choose_split``: 824 and 830), each launched against its plain
  version at ``TOL``: K1 forward (scale 1), inverse (unitary scale) and the
  adjoint launch on 257 lines below N = 2048 (a ragged last CTA whatever the
  lines per CTA) and 3 lines from there on, and in place wherever the chain
  has two or more passes (a one-pass chain must be refused by the wrapper
  and by the C entry point); K2 forward, inverse and adjoint on (2, H, 66),
  33 columns ragged against the tile.  Wherever the ring design serves the
  view (K2 tiles of 8192 points or more, as the C entry point reports it:
  ``fused_cols.launch_shape``), the four launches (in place included) again
  on ``ring_units(grid)`` tiles: every stage of every persistent CTA used
  and then reused twice, and a ragged last turn.  Every failure is listed
  before the phase fails; one JSON line ``{"domain": {...}}`` gives the
  counts, the launches, the ring's share of them, the worst error and
  where, and the seconds;
- fuzz: the seeded random specs of ``tests/test_torch_fuzz.py`` (the JAX
  file's draws, copied here) through the port's entry points on the card
  against float64 numpy / scipy oracles at the JAX file's tolerances: c2c
  (24 seeds), r2c / c2r (12), dct / dst (12) and fftconv (8) plans under
  ``impl: "auto"`` (K1 and K2 must both launch) and ``"xla"``, the façade
  N-D ``s=`` / ``axes=`` lane (30; both compute or both raise
  ``PlanError``), short-time / envelope (6) and the DSP toolkit (8); one JSON
  line ``{"fuzz": {...}}``.

To run either alone on the card, import ``chip_smoke`` from a script in the
repo and call ``phase_device()``, ``phase_build()`` and then
``phase_domain(torch.Generator(device="cuda").manual_seed(SEED))`` or
``phase_fuzz()``.  Each prints its seconds; PERF.md gives them, the build's
and the whole script's for the newest run, beside the 1200 s the script
must finish in.

Plans and kernels are checked against ``torch.fft`` as an independent
oracle, as are the Rader, Bluestein and four-step axes and the odd-length
r2c paths.  Then each kernel shape is timed beside its plain version, its bound
(``runtime/profile.bound_ms``: the bytes it must move, one read and one write,
over the data sheet's 3.35 TB/s, or its flops over 67 TFLOP/s if that is more) and the one
``torch.fft.fft`` call that computes the same function (cuFFT, a yardstick the
port never calls), and each plan and the solver step beside ``torch.fft``
(a DCT-II and the convolutions written on ``torch.fft`` in this script), four
facade calls beside ``plan(x)`` for the same plan and the one ``torch.fft`` /
``torch.stft`` call (idle-device and queued times), and each probe variant beside its bound and ``Tensor.copy_`` timed in the same run,
with the difference between neighbouring stops of ``lines_stages`` (what a
pass of K1's chain costs).
Every phase raises on failure, so the script exits non-zero; it never falls
back to the CPU.

Tolerance, unless a phase says otherwise: max|actual - expected| <= 1e-5 *
max|expected|, the JAX package's f32 accuracy bar.  TF32 is switched off for
this process so the plain versions and the oracle contract in full f32.

Output: one line per result; then the kernel record as one JSON object, the
``nvidia-smi`` name/power-limit line, and as the last line
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from webgpufft_tpu_torch.runtime import profile

TOL = 1e-5
NS_TOL = 1e-4      # the solver against its analytic solutions
SEED = 1234
DOT_TOL = 1e-5     # <K x, u> against <x, K^H u>, relative
JVP_TOL = 1e-4     # reverse mode against forward mode through the solver step
GRAD_RUNS = 10     # timed forward+backward calls per version
BF16_TOL = 3e-2    # a bf16-storage plan, as the JAX package's tests hold it
NS_N, NS_NU, NS_DT, NS_STEPS = 256, 2e-2, 1e-2, 2
OS_N, OS_TAPS, OS_BLOCK, OS_BLOCKS = 1 << 20, 129, 8192, 131   # the overlap-save path
HEADLINE = {"type": "c2c", "shape": [1024], "batch": 4096,
            "direction": "forward", "normalize": "unitary"}
RFFT_DIMS = (2, 3, 1)   # torch.fft.rfftn packs the last dim given: logical axis 0


def torch_fft_stepper3(n, nu, dt, device="cuda"):
    """The port's NS-3D solver with ``torch.fft.rfftn`` / ``irfftn`` (cuFFT
    on a GPU) in place of the plans, with the same packed layout: the
    yardstick and an independent oracle for the step."""
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns

    def fwd(u):
        return torch.view_as_real(torch.fft.rfftn(u, dim=RFFT_DIMS))

    def inv(u_hat):
        z = torch.view_as_complex(u_hat.contiguous())
        return torch.fft.irfftn(z, s=(n, n, n), dim=RFFT_DIMS)

    return ns.make_stepper3_around(n, nu, dt, device, fwd, inv, inv)


def rel_err(actual, expected):
    return float((actual - expected).abs().max() / expected.abs().max())


def abs_err(actual, expected):
    return float((actual - expected).abs().max())


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = profile.card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"count {torch.cuda.device_count()}")
    print(f"device: nvidia-smi name,power.limit = {smi}")
    print(f"device: allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return name, smi


def phase_build():
    from webgpufft_tpu_torch import _build
    t0 = time.perf_counter()
    fresh = {which: not _build.library_path(which).exists() for which in ("core", "probes")}
    paths = _build.build_all()   # both libraries, every nvcc at once
    for which in paths:
        _build.library(which)
    secs = time.perf_counter() - t0
    names = ", ".join(f"{'compiled' if fresh[w] else 'reused'} {p.name}" for w, p in paths.items())
    print(f"build: {secs:.2f} s ({names} with {' '.join(_build.NVCC_FLAGS)})")


def to_dev(consts):
    return {k.rsplit("/", 1)[1]: torch.as_tensor(v, device="cuda")
            for k, v in consts.items()}


def cols_tables_h2_is_1(h, direction, scale):
    """K2 tables for the degenerate split (h, 1): stage 1 is the identity."""
    from webgpufft_tpu_torch.core import dft, radix
    w1 = dft.dft_matrix(h, direction) * np.complex64(scale)
    ones = np.ones((h, 1, 1), np.float32)
    return to_dev({**radix.chain_consts(h, direction, scale, "p"),
                   "p/w1re": w1.real.astype(np.float32),
                   "p/w1im": w1.imag.astype(np.float32),
                   "p/tre": ones, "p/tim": np.zeros_like(ones),
                   "p/w2re": np.ones((1, 1), np.float32),
                   "p/w2im": np.zeros((1, 1), np.float32)})


def compare(label, kernel, plain, x, tables):
    y = kernel(x, tables)
    ref = plain(x, tables)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(y).all()), f"{label}: non-finite kernel output")
    err = rel_err(y, ref)
    aerr = abs_err(y, ref)
    print(f"{label}: max rel err {err:.3e}, max abs err {aerr:.3e} vs plain "
          f"(limit {TOL:.0e} * max|plain|)")
    require(err <= TOL, f"{label}: kernel disagrees with its plain version")
    return aerr


def phase_k1(gen):
    from webgpufft_tpu_torch.core import fused, radix
    cases = {}
    worst = 0.0
    # the headline and non-square splits; the shapes the r2c (batch 3) and c2r
    # (batch 6) paths give K1 at 256^3 (b*128*256 body lines and b*256
    # Nyquist-slab lines of 256); then lengths that stress the radix chain:
    # 128 * 128 (the shared-memory limit), every odd radix, 13 * 13 * 8, short
    # lines that take the multi-line CTA, and the small digits 8 * 8 and 8 * 16;
    # then what the dct path (512 x 4096), the fftconv path (1024 x 8192 data
    # and product lines, 1024 kernel lines, 8 product lines of the channel-lane
    # preset) and the overlap-save blocks give it; then the last axis of the
    # nufft path's 256^3 fine grid (256 x 65536 lines) and the linalg path's
    # matmul_toeplitz (8192 x 1024) and solve_toeplitz (8192 x 512) lines;
    # then the two shapes the examples path launches most: the r2c body of
    # NS-3D ``main`` at n 32 (3 * 16 * 32 lines of 32, 4 a step) and the
    # overlap-save blocks of system identification at 2^20 x 8 with 33 taps
    # (8 * 129 blocks of 8192, 3 a step); then two more long lengths whose
    # CTA fills an SM: 2079 = 3^3 * 7 * 11 (odd) and 6144 = 16 * 16 * 8 * 3
    for n, lines, direction, normalize in [
            (1024, 4096, "forward", "unitary"), (1024, 4096, "inverse", "unitary"),
            (2048, 4096, "forward", "none"), (360, 4096, "inverse", "backward"),
            (256, 3 * 128 * 256, "forward", "none"), (256, 6 * 256, "inverse", "none"),
            (16384, 512, "inverse", "backward"), (2310, 2048, "forward", "unitary"),
            (4096, 4096, "forward", "none"), (1352, 1025, "inverse", "unitary"),
            (16, 100003, "forward", "none"), (6, 77, "inverse", "backward"),
            (64, 65536, "forward", "none"), (128, 8192, "inverse", "unitary"),
            (512, 4096, "forward", "none"), (1024, 8192, "forward", "none"),
            (1024, 1024, "forward", "none"), (256, 8, "inverse", "none"),
            (OS_BLOCK, OS_BLOCKS, "forward", "none"), (OS_BLOCK, OS_BLOCKS, "inverse", "none"),
            (4, 1000, "forward", "none"), (8, 1000, "inverse", "none"),
            (256, 65536, "forward", "none"), (8192, 1024, "forward", "none"),
            (8192, 512, "inverse", "backward"),
            (32, 1536, "forward", "none"), (OS_BLOCK, 1032, "forward", "none"),
            (2079, 4096, "forward", "none"), (6144, 1024, "inverse", "unitary")]:
        scale = {"none": 1.0, "unitary": 1.0 / math.sqrt(n),
                 "backward": 1.0 / n if direction == "inverse" else 1.0}[normalize]
        tables = to_dev(fused.lines_consts(n, direction, scale, "p"))
        x = torch.randn(lines, n, 2, device="cuda", generator=gen)
        label = (f"K1 fused_lines N={n} chain={radix.radix_chain(n)} lines={lines} "
                 f"{direction} {normalize}")
        worst = max(worst, compare(label, fused.fused_lines, fused.fused_lines_reference,
                                   x, tables))
        cases[(n, lines, direction)] = (x, tables, normalize)
    return cases, worst


def phase_k2(gen):
    from webgpufft_tpu_torch.core import fused_cols, radix
    cases = {}
    worst = 0.0
    # the c2c 256^3 view and other splits; the views the r2c (batch 3) and c2r
    # (batch 6) paths give K2 at 256^3 ((b*128, 256, 512) bodies and the
    # (b, 256, 512) Nyquist slab); then a tall tile at the shared-memory limit,
    # a ragged column count (33), every odd radix, and the small-digit views
    # 8 * 16 and 8 * 8 of rank > 1 plans; then the views of the dct path
    # (8, 512, 1024), the fftconv path (data and product (8, 1024, 2048), the
    # kernel (1, 1024, 2048)), axis 0 of the 256^3 r2c/c2r plans
    # ((b, 128, 131072)) and one-butterfly heights a short axis 0 gives (3, 9);
    # then two more views of the ring design: a 4-column tile (H = 2048) and
    # an odd column count (33: 8-byte copies, a ragged last tile)
    for pre, h, lanes, direction in [
            (256, 256, 512, "forward"), (1, 256, 131072, "forward"),
            (64, 360, 512, "forward"), (256, 16, 512, "forward"),
            (3 * 128, 256, 512, "forward"), (6 * 128, 256, 512, "inverse"),
            (3, 256, 512, "forward"), (8, 16384, 64, "inverse"), (5, 2048, 66, "forward"),
            (3, 2310, 66, "inverse"), (4, 1352, 130, "forward"),
            (3 * 128, 128, 512, "forward"), (64, 64, 128, "inverse"),
            (8, 512, 1024, "forward"), (8, 1024, 2048, "forward"),
            (1, 1024, 2048, "forward"), (3, 128, 131072, "forward"),
            (6, 128, 131072, "inverse"), (8, 3, 512, "forward"), (8, 9, 512, "inverse"),
            (8, 2048, 1024, "forward"), (64, 1024, 66, "inverse")]:
        if (pre, h) == (256, 16):
            tables = cols_tables_h2_is_1(h, direction, 1.0)
            split = (16, 1)
        else:
            tables = to_dev(fused_cols.cols_consts(h, direction, 1.0, "p"))
            split = fused_cols.choose_split(h)
        x = torch.randn(pre, h, lanes, device="cuda", generator=gen)
        label = (f"K2 fused_cols view=({pre}, {h}, {lanes}) split={split} "
                 f"chain={radix.radix_chain(h)} {direction}")
        worst = max(worst, compare(label, fused_cols.fused_cols,
                                   fused_cols.fused_cols_reference, x, tables))
        cases[(pre, h, lanes)] = (x, tables, direction)
    return cases, worst


def domain_lengths():
    """Every length K1 accepts and every height K2 accepts, read from the
    port's own choosers (each splits N <= ``radix.MAX_LENGTH``): the lengths
    the ``domain`` phase launches.  Imports only the port."""
    from webgpufft_tpu_torch.core import fused, fused_cols, radix
    span = range(2, radix.MAX_LENGTH + 1)
    return ([n for n in span if fused.choose_split(n)],
            [h for h in span if fused_cols.choose_split(h)])


# ---------------------------------------------------------------------------
# domain: every length K1 and K2 accept
# ---------------------------------------------------------------------------

# K1 below N = 2048 takes up to 256 lines a CTA: 257 lines (a prime above
# every per-CTA count) leave its last CTA ragged whatever the count is; from
# N = 2048 on a CTA takes one line
DOMAIN_SHORT_LINES, DOMAIN_LONG_LINES, DOMAIN_LONG_N = 257, 3, 2048
# K2's views (2, H, 2 * 33): 33 complex columns, ragged against the
# 16-column tile and against the one-pass heights' 32
DOMAIN_PRE, DOMAIN_COLS = 2, 33
# where the ring design serves a height, one more launch of
# ring_units(grid) tiles: every one of a CTA's RING_STAGES stages
# (kRingStages of csrc/stage.cuh) filled RING_TURNS times (used, then
# reused twice) and a ragged last turn of RING_TAIL tiles
RING_STAGES, RING_TURNS, RING_TAIL = 2, 3, 7


def ring_units(grid):
    """Tiles of a ring launch on ``grid`` persistent CTAs that fills each
    CTA's every stage ``RING_TURNS`` times and ends in a ragged turn."""
    return RING_STAGES * RING_TURNS * grid + RING_TAIL


def phase_domain(gen):
    """Launch K1 at every length it accepts and K2 at every height, each
    against its plain version at ``TOL`` of max|plain|: K1 forward with
    scale 1, inverse with the unitary scale, the adjoint launch of the
    forward tables, all on a line count that leaves the last CTA ragged,
    and K1 in place (``probes.lines_inplace``) wherever the chain has two
    or more passes; where it has one, the wrapper and the C entry point must
    both refuse.  K2 forward, inverse and adjoint on (2, H, 66).  Where the
    ring design serves the view (``fused_cols.launch_shape``), the same
    three launches and K2 in place again on ``ring_units(grid)`` tiles: the
    ring turned three times with a ragged tail.  Every failure is
    collected first and all of them are printed before the phase fails.
    These launches count for no path."""
    from webgpufft_tpu_torch import _build, probes
    from webgpufft_tpu_torch.core import fused, fused_cols, radix
    t0 = time.perf_counter()
    k1_lengths, k2_heights = domain_lengths()
    before = launches()
    failures = []
    worst = {"err": 0.0, "at": None}
    ring = {"k2_heights": 0, "k2_tiles": 0}

    def check(label, run, plain):
        try:
            y = run()
            ref = plain()
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(y).all())
            err = rel_err(y, ref)
        except Exception as e:  # noqa: BLE001 - collected, the phase fails below
            failures.append(f"{label}: {type(e).__name__}: {e}")
            return
        if not finite or not err <= TOL:
            failures.append(f"{label}: max rel err {err:.3e}{'' if finite else ', non-finite'}")
        if err > worst["err"]:
            worst.update(err=err, at=label)

    for n in k1_lengths:
        lines = DOMAIN_SHORT_LINES if n < DOMAIN_LONG_N else DOMAIN_LONG_LINES
        chain = radix.radix_chain(n)
        fwd = to_dev(fused.lines_consts(n, "forward", 1.0, "p"))
        inv = to_dev(fused.lines_consts(n, "inverse", 1.0 / math.sqrt(n), "p"))
        x = torch.randn(lines, n, 2, device="cuda", generator=gen)
        label = f"K1 N={n} chain={chain} lines={lines}"
        check(f"{label} forward", lambda: fused.fused_lines(x, fwd),
              lambda: fused.fused_lines_reference(x, fwd))
        check(f"{label} inverse unitary", lambda: fused.fused_lines(x, inv),
              lambda: fused.fused_lines_reference(x, inv))
        check(f"{label} adjoint", lambda: fused.fused_lines(x, fwd, adjoint=True),
              lambda: fused.fused_lines_reference(x, fwd, adjoint=True))
        if len(chain) > 1:
            check(f"{label} in place", lambda: probes.lines_inplace(x.clone(), fwd),
                  lambda: fused.fused_lines_reference(x, fwd))
            continue
        try:
            probes.lines_inplace(x.clone(), fwd)
            failures.append(f"{label} in place: the wrapper ran a one-pass chain in place")
        except ValueError:
            pass
        rc = _build.library().wgfft_fused_lines(
            x.data_ptr(), x.data_ptr(), fwd["cw"].data_ptr(), fwd["cp"].data_ptr(), lines, n,
            *_build.chain_arg(chain), 0, torch.cuda.current_stream().cuda_stream)
        if rc != CUDA_ERROR_INVALID_VALUE:
            failures.append(f"{label} in place: the entry point returned {rc} for a one-pass "
                            f"chain, not cudaErrorInvalidValue")
    for h in k2_heights:
        fwd = to_dev(fused_cols.cols_consts(h, "forward", 1.0, "p"))
        inv = to_dev(fused_cols.cols_consts(h, "inverse", 1.0 / math.sqrt(h), "p"))
        x = torch.randn(DOMAIN_PRE, h, 2 * DOMAIN_COLS, device="cuda", generator=gen)
        label = (f"K2 H={h} split={fused_cols.choose_split(h)} chain={radix.radix_chain(h)} "
                 f"view={tuple(x.shape)}")
        check(f"{label} forward", lambda: fused_cols.fused_cols(x, fwd),
              lambda: fused_cols.fused_cols_reference(x, fwd))
        check(f"{label} inverse unitary", lambda: fused_cols.fused_cols(x, inv),
              lambda: fused_cols.fused_cols_reference(x, inv))
        check(f"{label} adjoint", lambda: fused_cols.fused_cols(x, fwd, adjoint=True),
              lambda: fused_cols.fused_cols_reference(x, fwd, adjoint=True))
        grid, tile = fused_cols.launch_shape(h, DOMAIN_COLS)
        if grid > 0:
            tiles = -(-DOMAIN_COLS // tile)
            pre = -(-ring_units(grid) // tiles)
            big = torch.randn(pre, h, 2 * DOMAIN_COLS, device="cuda", generator=gen)
            ring_label = (f"K2 H={h} chain={radix.radix_chain(h)} ring grid={grid} "
                          f"tile={tile} view={tuple(big.shape)}")
            check(f"{ring_label} forward", lambda: fused_cols.fused_cols(big, fwd),
                  lambda: fused_cols.fused_cols_reference(big, fwd))
            check(f"{ring_label} inverse unitary", lambda: fused_cols.fused_cols(big, inv),
                  lambda: fused_cols.fused_cols_reference(big, inv))
            check(f"{ring_label} adjoint",
                  lambda: fused_cols.fused_cols(big, fwd, adjoint=True),
                  lambda: fused_cols.fused_cols_reference(big, fwd, adjoint=True))
            check(f"{ring_label} in place", lambda: probes.cols_inplace(big.clone(), fwd),
                  lambda: fused_cols.fused_cols_reference(big, fwd))
            ring["k2_heights"] += 1
            ring["k2_tiles"] += pre * tiles
            del big
    after = launches()
    summary = {"k1_lengths": len(k1_lengths), "k2_heights": len(k2_heights),
               "launches": after[0] - before[0] + after[1] - before[1],
               "k1_launches": after[0] - before[0], "k2_launches": after[1] - before[1],
               "ring": ring,
               "worst_rel_err": worst["err"], "worst_at": worst["at"],
               "failures": len(failures), "seconds": round(time.perf_counter() - t0, 2)}
    for line in failures:
        print(f"domain FAIL {line}")
    print(json.dumps({"domain": summary}))
    require(not failures, f"domain: {len(failures)} launches disagree or fail (listed above)")
    return summary


# ---------------------------------------------------------------------------
# fuzz: the seeded random specs of the CPU files, on the card
# ---------------------------------------------------------------------------

# the draws of tests/test_torch_fuzz.py (copied: a script on the card
# imports nothing of tests/), same seeds and the JAX file's tolerances
FUZZ_AXIS_POOL = [2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 15, 16, 17, 20, 23, 30]
FUZZ_IMPLS = ("auto", "xla")
FUZZ_SEEDS = {"c2c": 24, "r2c/c2r": 12, "dct/dst": 12, "fftconv": 8,
              "facade nd": 30, "shorttime/envelope": 6, "dsp toolkit": 8}


def fuzz_spec(rng):
    rank = int(rng.integers(1, 5))
    shape = [int(rng.choice(FUZZ_AXIS_POOL)) for _ in range(rank)]
    while np.prod(shape) > 4096:
        shape[int(rng.integers(0, rank))] = 2
    batch = int(rng.choice([1, 2, 3, 5]))
    direction = str(rng.choice(["forward", "inverse"]))
    normalize = str(rng.choice(["none", "backward", "unitary"]))
    return shape, batch, direction, normalize


def il_np(z):
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def on_card(a, device="cuda"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def from_card(y):
    return y.detach().float().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def fuzz_plans(seed, impl):
    """The four plan lanes' draws of one seed: (label, opts, input,
    kernel, oracle of the output, tolerance); r2c gives its c2r draw too."""
    from webgpufft_tpu_torch.utils import mathref as R
    out = []
    if seed < FUZZ_SEEDS["c2c"]:
        rng = np.random.default_rng(1000 + seed)
        shape, batch, direction, normalize = fuzz_spec(rng)
        z = rng.standard_normal((batch, *shape)) + 1j * rng.standard_normal((batch, *shape))
        out.append((f"c2c seed={seed} {shape} b{batch} {direction}/{normalize}",
                    {"type": "c2c", "shape": shape, "batch": batch, "direction": direction,
                     "normalize": normalize}, il_np(z), None,
                    il_np(R.fft_nd(z, shape, direction, normalize)), 1e-5))
    if seed < FUZZ_SEEDS["r2c/c2r"]:
        rng = np.random.default_rng(2000 + seed)
        shape, batch, _, _ = fuzz_spec(rng)
        shape[0] = int(rng.choice([4, 6, 8, 9, 12, 16, 17, 30]))
        x = rng.standard_normal((batch, *shape)).astype(np.float32)
        out.append((f"r2c seed={seed} {shape} b{batch}",
                    {"type": "r2c", "shape": shape, "direction": "forward", "batch": batch},
                    x, None, il_np(R.r2c_packed(x.astype(np.float64), shape)), 1e-5))
        out.append((f"c2r seed={seed} {shape} b{batch} (of the r2c oracle)",
                    {"type": "c2r", "shape": shape, "direction": "inverse",
                     "normalize": "backward", "batch": batch},
                    il_np(R.r2c_packed(x.astype(np.float64), shape)), None, x, 1e-5))
    if seed < FUZZ_SEEDS["dct/dst"]:
        rng = np.random.default_rng(3000 + seed)
        shape, batch, direction, normalize = fuzz_spec(rng)
        kind = str(rng.choice(["dct1", "dct2", "dct3", "dct4", "dst1", "dst2", "dst3", "dst4"]))
        if kind == "dst1":
            shape = [max(s, 2) for s in shape]
        x = rng.standard_normal((batch, *shape)).astype(np.float32)
        ref = R.dct_nd(x.astype(np.float64), shape, kind, direction)
        ref = ref * R.normalize_scale(normalize, direction, int(np.prod(shape)))
        out.append((f"{kind} seed={seed} {shape} b{batch} {direction}/{normalize}",
                    {"type": kind, "shape": shape, "batch": batch, "direction": direction,
                     "normalize": normalize}, x, None, ref, 5e-5))
    if seed < FUZZ_SEEDS["fftconv"]:
        rng = np.random.default_rng(4000 + seed)
        rank = int(rng.integers(1, 4))
        shape = [int(rng.choice([4, 6, 8, 9, 12, 16])) for _ in range(rank)]
        kshape = [int(rng.integers(1, s + 1)) for s in shape]
        boundary = str(rng.choice(["circular", "linear-full", "linear-same", "linear-valid"]))
        mode = str(rng.choice(["convolution", "correlation"]))
        batch = int(rng.choice([1, 2, 3]))
        z = rng.standard_normal((batch, *shape)) + 1j * rng.standard_normal((batch, *shape))
        k = rng.standard_normal(kshape) + 1j * rng.standard_normal(kshape)
        ref = R.fftconv(z, k, shape, batch=batch, mode=mode, boundary=boundary,
                        kernel_shape=kshape)
        out.append((f"fftconv seed={seed} {shape}*{kshape} b{batch} {boundary}/{mode}",
                    {"type": "fftconv", "shape": shape, "batch": batch,
                     "fftConv": {"boundary": boundary, "mode": mode, "kernelShape": kshape}},
                    il_np(z), il_np(k), il_np(ref), 5e-5))
    return [(f"{label} {impl}", {**opts, "tuning": {"impl": impl}}, *rest)
            for label, opts, *rest in out]


def rfftn_in_given_order(x, s, axes, norm):
    """numpy 2.0's ``rfftn``, which the JAX package's façade follows: rfft
    along the last axis given, then fft along the others in the order
    given.  numpy 2.3 takes the others last to first; the two differ only
    where one of those axes repeats (a draw of the façade lane does)."""
    if axes is None:
        axes = list(range(x.ndim)) if s is None else list(range(-len(s), 0))
    if s is None:
        s = [x.shape[a] for a in axes]
    if len(s) != len(axes):
        raise ValueError("s and axes have different lengths")
    s = [x.shape[a] if m == -1 else m for m, a in zip(s, axes)]
    y = np.fft.rfft(x, s[-1], axes[-1], norm)
    for m, a in zip(s[:-1], axes[:-1]):
        y = np.fft.fft(y, m, a, norm)
    return y


def rfftn_oracle(x, s, axes, norm):
    """``np.fft.rfftn`` for the outcome kind, ``rfftn_in_given_order`` for
    the values; the two must agree where no axis but the last repeats."""
    want = np.fft.rfftn(x, s=s, axes=axes, norm=norm)
    ours = rfftn_in_given_order(x, s, axes, norm)
    rest = [a % x.ndim for a in (axes or range(x.ndim))][:-1]
    if len(set(rest)) == len(rest):
        require(ours.shape == want.shape and np.allclose(ours, want, rtol=1e-12, atol=1e-12),
                f"rfftn oracle: s={s} axes={axes} differs from numpy's")
    return ours


def fuzz_facade_nd(seed):
    """test_fuzz.py::test_fuzz_facade_nd_s_axes's draw: [(name, call,
    oracle, complex)]; rfftn's oracle is numpy 2.0's order (``rfftn_oracle``),
    whatever numpy the card has."""
    import scipy.fft as sf
    from webgpufft_tpu_torch import fftapi as F
    rng = np.random.default_rng(777000 + seed)
    nd = int(rng.integers(1, 4))
    shape = tuple(int(rng.integers(3, 12)) for _ in range(nd))
    x = rng.standard_normal(shape)
    z = x + 1j * rng.standard_normal(shape)
    if rng.random() < 0.25:
        axes = None
    else:
        k = int(rng.integers(1, nd + 2))
        axes = tuple(int(rng.integers(-nd, nd)) for _ in range(k))
    if rng.random() < 0.45:
        s = None
    else:
        base = len(axes) if axes is not None else nd
        slen = base if rng.random() < 0.8 else base + 1
        s = tuple(int(rng.choice([-1, 3, 4, 5])) for _ in range(slen))
    norm = [None, "ortho", "forward"][int(rng.integers(0, 3))]
    s_dct = None if s is None else tuple(abs(m) + 2 for m in s)
    tag = f"shape={shape} axes={axes} s={s} norm={norm}"
    return [
        (f"fftn {tag}", lambda: F.fftn(z, s=s, axes=axes, norm=norm),
         lambda: np.fft.fftn(z, s=s, axes=axes, norm=norm), True),
        (f"rfftn {tag}", lambda: F.rfftn(x, s=s, axes=axes, norm=norm),
         lambda: rfftn_oracle(x, s, axes, norm), True),
        (f"ihfftn {tag}", lambda: F.ihfftn(x, s=s, axes=axes, norm=norm),
         lambda: sf.ihfftn(x, s=s, axes=axes, norm=norm), True),
        (f"dctn {tag}", lambda: F.dctn(x, s=s_dct, axes=axes, norm=norm),
         lambda: sf.dctn(x, s=s_dct, axes=axes, norm=norm), False)]


def fuzz_shorttime(seed, record):
    """test_fuzz.py::test_fuzz_shorttime_and_envelope's draw on the card."""
    import scipy.signal as ss
    from webgpufft_tpu_torch import ShortTimeFFT
    from webgpufft_tpu_torch import fftapi as F
    r = np.random.default_rng(2000 + seed)
    n = int(r.integers(40, 300))
    x = r.standard_normal(n)
    m = int(r.integers(4, 24))
    hop = int(r.integers(1, m + 1))
    mfft = m + int(r.integers(0, 9))
    mode = str(r.choice(["onesided", "twosided", "centered"]))
    A = ShortTimeFFT(ss.windows.gaussian(m, m / 4), hop=hop, fs=5, fft_mode=mode, mfft=mfft)
    B = ss.ShortTimeFFT(ss.windows.gaussian(m, m / 4), hop=hop, fs=5, fft_mode=mode, mfft=mfft)
    tag = f"shorttime seed={seed} n={n} m={m} hop={hop} mfft={mfft} {mode}"
    S_e = B.stft(x)
    record(f"{tag} stft", F.ascomplex(from_card(A.stft(x))), S_e, 5e-4)
    if A.invertible:
        xr = from_card(A.istft(S_e.astype(np.complex64), k1=n))
        if mode == "onesided":
            record(f"{tag} istft", xr, B.istft(S_e, k1=n).real, 5e-4)
    bp0 = int(r.integers(-(n // 2), (n + 1) // 2 - 1))
    bp1 = int(r.integers(bp0 + 1, (n + 1) // 2 + 1))
    res = str(r.choice(["lowpass", "all"]))
    record(f"envelope seed={seed} n={n} band=({bp0}, {bp1}) {res}",
           from_card(F.envelope(x, (bp0, bp1), residual=res)),
           ss.envelope(x, (bp0, bp1), residual=res), 1e-4)


def fuzz_dsp(seed, record):
    """test_fuzz.py::test_fuzz_dsp_toolkit's draw on the card."""
    import scipy.signal as ss
    from webgpufft_tpu_torch import filtering as FL
    from webgpufft_tpu_torch import splines as SP
    r = np.random.default_rng(1000 + seed)
    n = int(r.integers(64, 400))
    x = r.standard_normal(n).astype(np.float32)
    ftype = str(r.choice(["butter", "cheby1", "cheby2", "ellip"]))
    order = int(r.integers(2, 7))
    btype = str(r.choice(["lowpass", "highpass", "bandpass"]))
    if btype == "bandpass":
        lo = r.uniform(0.1, 0.4)
        wn = [lo, lo + r.uniform(0.1, 0.4)]
    else:
        wn = r.uniform(0.1, 0.8)
    kw = {}
    if ftype in ("cheby1", "ellip"):
        kw["rp"] = 1.0
    if ftype in ("cheby2", "ellip"):
        kw["rs"] = 40.0
    sos = FL.iirfilter(order, wn, btype=btype, ftype=ftype, output="sos", **kw)
    sos_ref = ss.iirfilter(order, wn, btype=btype, ftype=ftype, output="sos", **kw)
    require(np.allclose(sos, sos_ref, atol=1e-9, rtol=1e-7), f"dsp seed={seed}: sos design")
    tag = f"dsp seed={seed} n={n}"
    record(f"{tag} sosfilt {ftype} {btype} order {order}", from_card(FL.sosfilt(sos, x)),
           ss.sosfilt(sos_ref, x), 5e-4)
    numtaps = int(r.integers(9, 64)) | 1
    cutoff = r.uniform(0.1, 0.9)
    taps = FL.firwin(numtaps, cutoff)
    require(np.allclose(taps, ss.firwin(numtaps, cutoff), atol=1e-13), f"{tag}: firwin")
    record(f"{tag} lfilter {numtaps} taps", from_card(FL.lfilter(taps, 1.0, x)),
           ss.lfilter(taps, [1.0], x), 5e-4)
    z1 = float(r.uniform(-0.7, 0.7))
    if abs(z1) > 0.05 and n > 60:
        c0 = float(r.uniform(0.5, 3.0))
        record(f"{tag} symiirorder1 z1={z1:.3f}",
               from_card(SP.symiirorder1(x.astype(np.float64), c0, z1)),
               ss.symiirorder1(x.astype(np.float64), c0, z1), 5e-4)


def phase_fuzz(device="cuda"):
    """The seeded random specs of ``tests/test_torch_fuzz.py`` (the JAX
    file's draws) through the port's entry points on tensors on the card,
    each against its float64 numpy / scipy oracle at the JAX file's
    tolerance (max|got - want| over max|want|; the façade N-D lane over
    max(1, max|want|)): the four plan lanes under ``impl: "auto"`` (K1/K2)
    and ``"xla"`` (einsums), the façade N-D ``s=`` / ``axes=`` lane with its
    outcome-kind rule (both compute or both raise ``PlanError``), the
    short-time / envelope lane and the DSP toolkit lane (numpy input on the
    façade's default device, ``device``).  Every failing draw is collected
    before the phase fails.  These launches count for no path."""
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch import fftapi
    from webgpufft_tpu_torch.spec import PlanError
    t0 = time.perf_counter()
    failures = []
    worst = {"err": 0.0, "at": None}
    made = {}
    draws = 0

    def record(label, got, want, tol, floor=1e-6):
        nonlocal draws
        draws += 1
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape:
            failures.append(f"{label}: shape {got.shape} != {want.shape}")
            return
        err = float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), floor))
        if not err <= tol:
            failures.append(f"{label}: err {err:.3e} > {tol:.0e}")
        if err / tol > worst["err"]:
            worst.update(err=err / tol, at=f"{label}: err {err:.3e} of limit {tol:.0e}")

    def run(lane, fn, seed, *args):
        before = launches()
        try:
            with fftapi.default_device(device):
                fn(seed, *args)
        except Exception as e:  # noqa: BLE001 - collected, the phase fails below
            failures.append(f"{lane} seed={seed}: {type(e).__name__}: {e}")
        if device == "cuda":
            torch.cuda.synchronize()
        after = launches()
        k1, k2 = made.get(lane, (0, 0))
        made[lane] = (k1 + after[0] - before[0], k2 + after[1] - before[1])

    def plans(seed, impl):
        for label, opts, x, kernel, want, tol in fuzz_plans(seed, impl):
            plan = T.create_plan(opts, device=device, cache=T.PlanCache())
            kw = {} if kernel is None else {"kernel": on_card(kernel, device)}
            record(label, from_card(plan(on_card(x, device), **kw)), want, tol)

    def facade(seed):
        nonlocal draws
        for label, ours, ref, cplx in fuzz_facade_nd(seed):
            try:
                want = ref()
            except Exception:  # noqa: BLE001 - the oracle's outcome kind
                want = None
            try:
                got = from_card(ours())
            except PlanError:
                got = None
            if (got is None) != (want is None):
                failures.append(f"facade nd seed={seed} {label}: outcome kind: port "
                                f"{'raised' if got is None else 'computed'}, oracle "
                                f"{'raised' if want is None else 'computed'}")
                continue
            if want is None:
                draws += 1     # both raise: the outcome kinds agree
                continue
            if cplx and np.iscomplexobj(want):
                got = got[..., 0] + 1j * got[..., 1]
            record(f"facade nd seed={seed} {label}", got, want, 5e-3, floor=1.0)

    for impl in FUZZ_IMPLS:
        for seed in range(max(FUZZ_SEEDS[k] for k in ("c2c", "r2c/c2r", "dct/dst", "fftconv"))):
            run(f"plans {impl}", plans, seed, impl)
    for seed in range(FUZZ_SEEDS["facade nd"]):
        run("facade nd", facade, seed)
    for seed in range(FUZZ_SEEDS["shorttime/envelope"]):
        run("shorttime/envelope", fuzz_shorttime, seed, record)
    for seed in range(FUZZ_SEEDS["dsp toolkit"]):
        run("dsp toolkit", fuzz_dsp, seed, record)
    for lane, (k1, k2) in made.items():
        print(f"fuzz {lane}: launches fused_lines {k1}, fused_cols {k2}")
    require(device != "cuda" or all(made["plans auto"]),
            f"fuzz: the auto plans launched {made['plans auto']}")
    summary = {"draws": draws, "seeds": FUZZ_SEEDS,
               "launches": {lane: {"fused_lines": k1, "fused_cols": k2}
                            for lane, (k1, k2) in made.items()},
               "worst_share_of_limit": worst["err"], "worst_at": worst["at"],
               "failures": len(failures), "seconds": round(time.perf_counter() - t0, 2)}
    for line in failures:
        print(f"fuzz FAIL {line}")
    print(json.dumps({"fuzz": summary}))
    require(not failures, f"fuzz: {len(failures)} draws disagree or fail (listed above)")
    return summary


def check_close(label, y, expected, what, tol=TOL):
    torch.cuda.synchronize()
    require(tuple(y.shape) == tuple(expected.shape),
            f"{label}: shape {tuple(y.shape)} != {tuple(expected.shape)}")
    require(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
    wide = torch.complex128 if y.is_complex() or expected.is_complex() else torch.float64
    err = rel_err(y.to(wide), expected.to(wide))
    print(f"{label}: max rel err {err:.3e} vs {what} (limit {tol:.0e} * max|expected|)")
    require(err <= tol, f"{label}: disagrees with {what}")


def check_oracle(label, y, expected):
    """Interleaved ``y`` against a complex ``torch.fft`` result."""
    check_close(label, torch.view_as_complex(y), expected, "torch.fft")


def phase_headline(gen):
    import webgpufft_tpu_torch as T
    plan = T.create_plan(HEADLINE, device="cuda")
    x = torch.randn(4096, 1024, 2, device="cuda", generator=gen)
    y = plan(x)
    require(tuple(y.shape) == (4096, 1024, 2) and y.dtype == torch.float32,
            f"headline: output {y.dtype} {tuple(y.shape)}")
    require(plan.route.mode == "pallas-fused",
            f"headline: route {plan.route.mode} {plan.route.reasons}")
    print(f"headline plan c2c [1024] b4096 forward unitary: route {plan.route.mode}, "
          f"reasons {list(plan.route.reasons)}")
    check_oracle("headline plan", y,
                 torch.fft.fft(torch.view_as_complex(x), norm="ortho"))
    return plan, x


def phase_3d(gen):
    import webgpufft_tpu_torch as T
    shape = [256, 256, 256]
    fwd = T.create_plan({"type": "c2c", "shape": shape, "batch": 1,
                         "direction": "forward", "normalize": "backward"}, device="cuda")
    inv = T.create_plan({"type": "c2c", "shape": shape, "batch": 1,
                         "direction": "inverse", "normalize": "backward"}, device="cuda")
    want = ("c2c-axis0-fused-cols", "c2c-axis1-fused-cols", "c2c-axis2-fused-lines")
    for plan in (fwd, inv):
        require(plan.route.mode == "pallas-fused"
                and all(r in plan.route.reasons for r in want),
                f"256^3: route {plan.route.mode} {plan.route.reasons}")
    print(f"3-D plan c2c 256^3 b1: route {fwd.route.mode}, reasons {list(fwd.route.reasons)}")
    x = torch.randn(1, *shape, 2, device="cuda", generator=gen)
    y = fwd(x)
    check_oracle("3-D plan forward", y,
                 torch.fft.fftn(torch.view_as_complex(x), dim=(1, 2, 3)))
    back = inv(y)
    torch.cuda.synchronize()
    err = rel_err(back, x)
    print(f"3-D plan round trip: max rel err {err:.3e} vs input (limit {TOL:.0e} * max|x|)")
    require(err <= TOL, "3-D plan round trip does not return the input")
    return fwd, x


def real_plan(kind, batch, normalize):
    import webgpufft_tpu_torch as T
    return T.create_plan({"type": kind, "shape": [NS_N] * 3, "batch": batch,
                          "direction": "forward" if kind == "r2c" else "inverse",
                          "normalize": normalize}, device="cuda")


def check_real_route(label, plan):
    kind = plan.spec.plan_type
    want = (f"{kind}-axis0-fused-cols", f"{kind}-axis1-fused-cols", f"{kind}-axis2-fused-lines")
    print(f"{label}: route {plan.route.mode}, reasons {list(plan.route.reasons)}")
    require(plan.route.mode == "pallas-fused" and all(r in plan.route.reasons for r in want),
            f"{label}: route {plan.route.mode} {plan.route.reasons}")


def phase_r2c(gen):
    """The solver's r2c plan, [256]^3 batch 3, on six fields in two calls;
    returns the fields and their packed spectra for the c2r path."""
    plan = real_plan("r2c", 3, "none")
    check_real_route("r2c 256^3 b3", plan)
    x = torch.randn(6, NS_N, NS_N, NS_N, device="cuda", generator=gen)
    y = torch.cat([plan(x[:3]), plan(x[3:])])
    require(tuple(y.shape) == (6, NS_N // 2 + 1, NS_N, NS_N, 2), f"r2c: output {tuple(y.shape)}")
    check_oracle("r2c 256^3 b3", y, torch.fft.rfftn(x, dim=RFFT_DIMS))
    return x, y


def phase_c2r(y):
    """The solver's c2r plan, [256]^3 batch 6, on the r2c spectra."""
    plan = real_plan("c2r", 6, "backward")
    check_real_route("c2r 256^3 b6", plan)
    back = plan(y)
    torch.cuda.synchronize()
    want = torch.fft.irfftn(torch.view_as_complex(y), s=(NS_N,) * 3, dim=RFFT_DIMS)
    err = rel_err(back, want)
    print(f"c2r 256^3 b6: max rel err {err:.3e} vs torch.fft (limit {TOL:.0e} * max|expected|)")
    require(bool(torch.isfinite(back).all()) and err <= TOL, "c2r disagrees with torch.fft")
    return back


def phase_real_round_trips(x, y, back):
    err = rel_err(back, x)
    print(f"r2c -> c2r round trip 256^3: max rel err {err:.3e} vs input (limit {TOL:.0e})")
    require(err <= TOL, "r2c -> c2r round trip does not return the input")
    again = real_plan("r2c", 3, "none")(back[:3])
    torch.cuda.synchronize()
    err = rel_err(again, y[:3])
    print(f"c2r -> r2c round trip 256^3: max rel err {err:.3e} vs spectrum (limit {TOL:.0e})")
    require(err <= TOL, "c2r -> r2c round trip does not return the spectrum")


def phase_axis_kinds(gen):
    """Rader, Bluestein and four-step c2c axes and the odd-n0 r2c paths
    against torch.fft."""
    import webgpufft_tpu_torch as T
    for shape, batch, kind in [([4093], 256, "rader"), ([4099], 256, "bluestein"),
                               ([1048576], 4, "four-step")]:
        plan = T.create_plan({"type": "c2c", "shape": shape, "batch": batch}, device="cuda")
        require(kind in plan.route.axis_kinds or plan.route.mode == "four-step-hbm",
                f"c2c {shape}: route {plan.route.mode} {plan.route.axis_kinds}")
        x = torch.randn(batch, *shape, 2, device="cuda", generator=gen)
        check_oracle(f"c2c {shape} b{batch} ({kind}, route {plan.route.mode})", plan(x),
                     torch.fft.fft(torch.view_as_complex(x)))
    for shape in ([17], [9, 4]):
        plan = T.create_plan({"type": "r2c", "shape": shape, "batch": 4096}, device="cuda")
        x = torch.randn(4096, *shape, device="cuda", generator=gen)
        dims = tuple(range(2, 1 + len(shape))) + (1,)
        check_oracle(f"r2c {shape} b4096 (odd n0, route {plan.route.mode})", plan(x),
                     torch.fft.rfftn(x, dim=dims))


def phase_ns3d():
    """The solver at 256^3 on two flows with analytic solutions."""
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns
    t_end = NS_DT * NS_STEPS
    for label, make in [("embedded Taylor-Green", ns.taylor_green_embedded),
                        ("ABC flow", ns.abc_flow)]:
        u = ns.run3(make(NS_N, 0.0, NS_NU, device="cuda"), NS_N, NS_NU, NS_DT, NS_STEPS,
                    device="cuda")
        ref = make(NS_N, t_end, NS_NU, device="cuda")
        torch.cuda.synchronize()
        require(tuple(u.shape) == (3, NS_N, NS_N, NS_N) and bool(torch.isfinite(u).all()),
                f"NS-3D {label}: output {tuple(u.shape)}")
        err = rel_err(u, ref)
        print(f"NS-3D {label} {NS_N}^3, nu={NS_NU}, dt={NS_DT}, {NS_STEPS} steps (t={t_end:g}): "
              f"max rel err {err:.3e} vs analytic (limit {NS_TOL:.0e})")
        require(err < NS_TOL, f"NS-3D {label} departs from its analytic solution")


def launches():
    from webgpufft_tpu_torch.core import fused, fused_cols
    return fused.fused_lines.launches, fused_cols.fused_cols.launches


def counters():
    """The wrappers that count launches, by kernel name, K1 and K2 first."""
    from webgpufft_tpu_torch import probes
    from webgpufft_tpu_torch.core import fused, fused_cols
    return {"fused_lines": fused.fused_lines, "fused_cols": fused_cols.fused_cols,
            "stream_copy": probes.stream_copy, "lines_stages": probes.lines_stages,
            "lines_planes": probes.lines_planes}


PROBE_KERNELS = ("stream_copy", "lines_stages", "lines_planes")


# path -> what it launched: K1 {(N, lines, adjoint, tables' address): tables} and
# K2 {(pre, H, L, adjoint, tables' address): tables}
PATH_SHAPES = {}


def drive(name, paths, fn, *args, k1=True, k2=True, probes=False):
    """Run one path with every launch count set to 0 just before it and
    read just after; each kernel of the path (``k1``, ``k2``, the three
    ``probes``) must have launched, and a kernel the path has none of must
    not.  ``paths[name]`` gets the counts in the order of ``counters()``,
    ``PATH_SHAPES[name]`` what K1 and K2 were given."""
    wrappers = counters()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    PATH_SHAPES[name] = ({}, {})
    wrappers["fused_lines"].seen, wrappers["fused_cols"].seen = PATH_SHAPES[name]
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    finally:
        wrappers["fused_lines"].seen = wrappers["fused_cols"].seen = None
    torch.cuda.synchronize()
    print(f"path {name} seconds: {time.perf_counter() - t0:.2f}")
    counts = {kernel: wrapper.launches for kernel, wrapper in wrappers.items()}
    print(f"path {name} launches: " + ", ".join(f"{k} {n}" for k, n in counts.items()))
    want = {"fused_lines": k1, "fused_cols": k2, **dict.fromkeys(PROBE_KERNELS, probes)}
    for kernel, n in counts.items():
        require((n > 0) == want[kernel], f"path {name}: {kernel} launched {n} times")
    paths[name] = tuple(counts.values())
    return out


def phase_path_shapes(gen):
    """Every (shape, direction of launch, table set) that a path gave K1 or
    K2, held against the plain version on a random input with the path's own
    tables: the shapes of the main paths are read from their launches, not
    from a list kept by hand.  These launches count for no path.  Returns the
    worst max abs err of each kernel."""
    from webgpufft_tpu_torch.core import fused, fused_cols
    worst = {}
    for kernel, plain, which in [(fused.fused_lines, fused.fused_lines_reference, 0),
                                 (fused_cols.fused_cols, fused_cols.fused_cols_reference, 1)]:
        seen = {}
        for path, logs in PATH_SHAPES.items():
            for key, tables in logs[which].items():
                seen.setdefault(key, (tables, []))[1].append(path)
        err = 0.0
        for (*shape, adjoint, _), (tables, on_paths) in sorted(seen.items(),
                                                              key=lambda kv: kv[0]):
            view = (shape[1], shape[0], 2) if which == 0 else tuple(shape)
            x = torch.randn(view, device="cuda", generator=gen)
            what = (f"N={shape[0]} lines={shape[1]}" if which == 0 else f"view={view}")
            label = (f"{'K1 fused_lines' if which == 0 else 'K2 fused_cols'} {what}"
                     f"{' adjoint' if adjoint else ''} as on {', '.join(on_paths)}")
            err = max(err, compare(label, lambda v, t: kernel(v, t, adjoint=adjoint),
                                   lambda v, t: plain(v, t, adjoint=adjoint), x, tables))
            del x
        worst[kernel.__name__] = err
        print(f"path shapes: {kernel.__name__} held against its plain version at "
              f"{len(seen)} (shape, adjoint, tables) combinations of the paths' own launches")
        require(seen, f"no path launched {kernel.__name__}")
    return worst


def run_counted(label, plan, *args, **kw):
    """One ``plan(...)`` call; prints and returns the launches it made."""
    y, made = counted(plan, *args, **kw)
    print(f"{label}: route {plan.route.mode}, launches fused_lines {made[0]}, "
          f"fused_cols {made[1]}, passes "
          f"{[r for r in plan.route.reasons if '-axis' in r]}")
    return y, made


# ---------------------------------------------------------------------------
# dct
# ---------------------------------------------------------------------------

def dct_oracle(x, shape, kind, direction, normalize):
    """The dense trig-matrix transform (``mathref.trig_matrix``, the matrices
    of ``mathref.dct_nd``) in float64 on the card."""
    from webgpufft_tpu_torch.utils import mathref
    y = x.double()
    for d, n in enumerate(shape):
        mdir = "forward" if kind[-1] in "14" else direction
        m = torch.as_tensor(mathref.trig_matrix(kind, n, mdir), device=x.device)
        y = torch.movedim(torch.movedim(y, 1 + d, -1) @ m.T, -1, 1 + d)
    return y * mathref.normalize_scale(normalize, direction, math.prod(shape))


def torch_fft_dct2(x, scale):
    """DCT-II (the port's convention: no factor 2) over the last two dims on
    ``torch.fft``: even/odd reorder, one complex FFT, a half-sample twist per
    axis.  The yardstick for the dct2 plan; the port never calls it."""
    for dim in (-1, -2):
        n = x.shape[dim]
        v = torch.cat([x.index_select(dim, torch.arange(0, n, 2, device=x.device)),
                       x.index_select(dim, torch.arange(n - 1 - n % 2, 0, -2, device=x.device))],
                      dim=dim)
        w = torch.exp(-0.5j * math.pi * torch.arange(n, device=x.device) / n).to(torch.complex64)
        v = torch.fft.fft(v, dim=dim)
        x = (v * (w if dim == -1 else w[:, None])).real
    return x * scale


def phase_dct(gen):
    """Returns the dct2 [512, 512] plan and its input for the timing phase."""
    import scipy.fft
    import webgpufft_tpu_torch as T
    keep = None
    for kind in ("dct2", "dct3"):
        plan = T.create_plan({"type": kind, "shape": [512, 512], "batch": 8,
                              "normalize": "unitary"}, device="cuda")
        x = torch.randn(8, 512, 512, device="cuda", generator=gen)
        y, made = run_counted(f"{kind} [512, 512] b8 unitary", plan, x)
        require(made == (1, 1) and plan.route.mode == "pallas-fused",
                f"{kind} 512^2: launches {made}, route {plan.route.reasons}")
        check_close(f"{kind} [512, 512] b8", y,
                    dct_oracle(x, (512, 512), kind, "forward", "unitary"), "float64 trig matrices")
        if kind == "dct2":
            keep = (plan, x)
            check_close("torch.fft DCT-II yardstick", torch_fft_dct2(x, 1.0 / 512), y,
                        "the dct2 plan")
    plan = T.create_plan({"type": "dct2", "shape": [8, 8], "batch": 16384,
                          "normalize": "unitary"}, device="cuda")
    x = torch.randn(16384, 8, 8, device="cuda", generator=gen)
    y, made = run_counted("dct2 [8, 8] b16384 unitary", plan, x)
    require(made == (0, 0) and "dct-axis0-matmul" in plan.route.reasons,
            f"dct2 8x8: launches {made}, route {plan.route.reasons}")
    check_close("dct2 [8, 8] b16384", y, dct_oracle(x, (8, 8), "dct2", "forward", "unitary"),
                "float64 trig matrices")
    n = 32768
    for kind, conv in (("dct4", 0.5), ("dst1", 0.5)):
        plan = T.create_plan({"type": kind, "shape": [n], "batch": 32,
                              "normalize": "unitary"}, device="cuda")
        x = torch.randn(32, n, device="cuda", generator=gen)
        y, made = run_counted(f"{kind} [{n}] b32 unitary", plan, x)
        require(made == (0, 0), f"{kind} {n}: launches {made}")
        f = scipy.fft.dct if kind == "dct4" else scipy.fft.dst
        ref = f(x.double().cpu().numpy(), type=int(kind[-1]), axis=-1) * conv / math.sqrt(n)
        check_close(f"{kind} [{n}] b32", y, torch.as_tensor(ref, device="cuda"), "scipy.fft")
    return keep


# ---------------------------------------------------------------------------
# fftconv
# ---------------------------------------------------------------------------

def torch_fft_conv(x, k, fft_shape, out_shape, out_off, dtype=torch.complex128):
    """FFT convolution of complex x (batch, *shape) with complex k on
    ``torch.fft`` at ``fft_shape``, cropped: oracle (complex128) and yardstick
    (complex64)."""
    dims = tuple(range(1, x.ndim))
    xf = torch.fft.fftn(x.to(dtype), s=fft_shape, dim=dims)
    kf = torch.fft.fftn(k.to(dtype), s=fft_shape)
    y = torch.fft.ifftn(xf * kf, dim=dims)
    crop = (slice(None),) + tuple(slice(o, o + n) for o, n in zip(out_off, out_shape))
    return y[crop]


def phase_fftconv(gen):
    """Returns (plan, x, kernel, geometry) of the 2-D path for the timing phase."""
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.utils import mathref

    # 2-D: [1000, 1000] x 8, 25 x 25 taps, linear-same -> fft shape 1024^2
    shape, kshape = [1000, 1000], [25, 25]
    plan = T.create_plan({"type": "fftconv", "shape": shape, "batch": 8,
                          "fftConv": {"kernelShape": kshape, "boundary": "linear-same"}},
                         device="cuda")
    geo = mathref.fftconv_out_shape(shape, kshape, "linear-same")
    require(tuple(geo[0]) == (1024, 1024) == plan.fft_shape, f"fftconv 2-D: fft shape {geo[0]}")
    x = torch.randn(8, 1000, 1000, 2, device="cuda", generator=gen)
    k = torch.randn(25, 25, 2, device="cuda", generator=gen)
    y, made = run_counted("fftconv [1000, 1000] b8 k25x25 linear-same", plan, x, kernel=k)
    require(made == (3, 3) and plan.route.mode == "pallas-fused",
            f"fftconv 2-D: launches {made}, route {plan.route.reasons}")
    ref = torch_fft_conv(torch.view_as_complex(x), torch.view_as_complex(k), *geo)
    check_close("fftconv [1000, 1000] b8", torch.view_as_complex(y), ref, "torch.fft complex128")
    keep = (plan, x, k, geo)
    del ref, y

    # the channel-lane preset: [256] x 4, 2 kernels, 64 -> 128 channels
    preset = T.create_fftconv_kernel_major_channel_lane_preset({
        "shape": [256], "batch": 4, "kernelCount": 2,
        "input": {"channels": 64, "channelIndex": 0},
        "output": {"channels": 128, "channelIndex": 0, "kernelStepChannels": 64}})
    plan = T.create_plan({"type": "fftconv", **preset}, device="cuda")
    lanes = 0.05 * torch.randn(4, 64, 256, 2, device="cuda", generator=gen)
    kern = 0.05 * torch.randn(2, 256, 2, device="cuda", generator=gen)
    y, made = run_counted("fftconv channel-lane preset [256] b4 kc2 64->128", plan,
                          lanes.reshape(-1, 2), kernel=kern)
    require(made == (1, 0), f"fftconv preset: launches {made} (K1 on the 8 product lines only)")
    out = y.reshape(4, 128, 256, 2)
    for kk in range(2):
        ref = mathref.fftconv(torch.view_as_complex(lanes[:, 0]).cpu().numpy(),
                              torch.view_as_complex(kern[kk]).cpu().numpy(), [256], batch=4)
        check_close(f"fftconv preset lane {64 * kk}", torch.view_as_complex(out[:, 64 * kk]),
                    torch.as_tensor(ref, device="cuda"), "mathref.fftconv")
    untouched = torch.ones(128, dtype=torch.bool, device="cuda")
    untouched[[0, 64]] = False
    require(bool((out[:, untouched] == 0).all()), "fftconv preset: an untouched lane is not 0")
    print("fftconv preset: the 126 untouched lanes are exactly 0")

    # overlap-save: [2^20] x 1, 129 taps, circular
    plan = T.create_plan({"type": "fftconv", "shape": [OS_N], "batch": 1,
                          "fftConv": {"boundary": "circular", "kernelShape": [OS_TAPS]}},
                         device="cuda")
    require(plan.route.mode == "overlap-save" and f"os-block({OS_BLOCK})" in plan.route.reasons
            and f"os-blocks({OS_BLOCKS})" in plan.route.reasons,
            f"overlap-save: route {plan.route.mode} {plan.route.reasons}")
    x = 0.05 * torch.randn(1, OS_N, 2, device="cuda", generator=gen)
    k = 0.05 * torch.randn(OS_TAPS, 2, device="cuda", generator=gen)
    y, made = run_counted(f"fftconv overlap-save [2^20] b1 k{OS_TAPS} circular", plan, x, kernel=k)
    require(made == (2, 0), f"overlap-save: launches {made} (blocks forward and inverse)")
    ref = torch_fft_conv(torch.view_as_complex(x), torch.view_as_complex(k), (OS_N,), (OS_N,),
                         (0,))
    check_close("fftconv overlap-save [2^20]", torch.view_as_complex(y), ref,
                "torch.fft complex128")
    return keep, (plan, x, k)


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------

def shifted_conv2d(x, w, pads, out_hw):
    """k^2 shifted multiply-adds in float64 (cross-correlation, zero
    boundary): x (batch, Hin, Win) and w (k, k), real or complex."""
    pt, pb, pl, pr = pads
    xp = torch.nn.functional.pad(x, (pl, pr, pt, pb))
    h, wd = out_hw
    out = torch.zeros(x.shape[0], h, wd, dtype=xp.dtype, device=x.device)
    for i in range(w.shape[0]):
        for j in range(w.shape[1]):
            out += xp[:, i:i + h, j:j + wd] * w[i, j]
    return out


def phase_conv2d(gen):
    """cuDNN's TF32 flag is switched ON around the plan calls: the plan
    itself must keep it off for its convolution.  The data (1 + 2^-12 steps)
    is what TF32's 10-bit mantissa visibly rounds wherever cuDNN picks a TF32
    algorithm; the bare call's error with the flag on is printed beside the
    plan's (for so few channels cuDNN may pick none)."""
    import webgpufft_tpu_torch as T
    shape, k = [1024, 1024], 3
    out = {}
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for ktype in ("complex", "real"):
            plan = T.create_plan({"type": "conv2d", "shape": shape, "batch": 8,
                                  "conv": {"kernelSize": k, "padding": "same",
                                           "kernelType": ktype}}, device="cuda")
            tail = (2,) if ktype == "complex" else ()
            x = 1.0 + torch.randint(0, 4096, (8, *plan.in_shape, *tail), device="cuda",
                                    generator=gen).float() / 4096.0
            w = torch.randn(k, k, *tail, device="cuda", generator=gen)
            y, made = run_counted(f"conv2d [1024, 1024] b8 k3 same, {ktype} data and kernel",
                                  plan, x, kernel=w)
            require(made == (0, 0), f"conv2d: launches {made}")
            if ktype == "complex":
                ref = shifted_conv2d(torch.view_as_complex(x).to(torch.complex128),
                                     torch.view_as_complex(w).to(torch.complex128),
                                     plan.pad, shape)
                check_close("conv2d complex (cuDNN TF32 flag on outside the plan)",
                            torch.view_as_complex(y), ref, "float64 shifted multiply-adds")
            else:
                ref = shifted_conv2d(x.double(), w.double(), plan.pad, shape)
                check_close("conv2d real (cuDNN TF32 flag on outside the plan)", y, ref,
                            "float64 shifted multiply-adds")
                bare = torch.nn.functional.conv2d(x[:, None], w[None, None], padding=1)[:, 0]
                print(f"conv2d real: the bare F.conv2d call with the TF32 flag on has max rel "
                      f"err {rel_err(bare.double(), ref):.3e} on the same data")
            out[ktype] = (plan, x, w)
    finally:
        torch.backends.cudnn.allow_tf32 = was
    return out


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------

def phase_staging(gen, headline):
    """The headline plan's options with each staging option, against the
    unstaged plan's output placed by hand."""
    import webgpufft_tpu_torch as T
    base, x = headline
    n, batch = 1024, 4096
    ref = base(x)
    opts = HEADLINE

    # (a) strided input (every second element, an offset, a padded batch
    # stride) and a whdcn output lane (channel 1 of 3)
    stride, off, bstride = 2, 5, 2 * n + 7
    plan = T.create_plan({**opts, "layout": {
        "inputStrides": [stride], "inputOffsetElements": off,
        "inputBatchStrideElements": bstride,
        "whdcn": {"output": {"channels": 3, "channelIndex": 1}}}}, device="cuda")
    flat = torch.randn(off + bstride * batch, 2, device="cuda", generator=gen)
    idx = (off + bstride * torch.arange(batch, device="cuda")[:, None]
           + stride * torch.arange(n, device="cuda")[None, :])
    flat[idx.reshape(-1)] = x.reshape(-1, 2)
    y, made = run_counted("staging (a) strided input + whdcn output lane", plan, flat)
    require(made == (1, 0), f"staging (a): launches {made}")
    # batch b's lane 1 starts at (3 b + 1) n; the flat result ends with it
    require(y.shape[0] == (3 * batch - 1) * n, f"staging (a): {y.shape[0]} flat elements")
    lanes = torch.cat([y, y.new_zeros(n, 2)]).reshape(batch, 3, n, 2)
    check_close("staging (a) lane 1", lanes[:, 1], ref, "the unstaged plan")
    require(bool((lanes[:, 0] == 0).all() and (lanes[:, 2] == 0).all()),
            "staging (a): lanes 0 and 2 are not 0")

    # (b) ioView output crop [100, 700) merged into out=, keep-outside
    plan = T.create_plan({**opts, "ioView": {"output": {"shape": [800], "offset": [-100]}}},
                         device="cuda")
    out = torch.full((batch, 800, 2), 7.5, device="cuda")
    y, made = run_counted("staging (b) ioView output + out= keep-outside", plan, x, out=out)
    require(made == (1, 0) and y is out, f"staging (b): launches {made}, returned out: {y is out}")
    check_close("staging (b) overlap", y[:, 100:], ref[:, :700], "the unstaged plan")
    require(bool((y[:, :100] == 7.5).all()), "staging (b): cells outside the overlap changed")

    # (c) exec-time input offset on the shaped side
    flat = torch.randn(33 + batch * n, 2, device="cuda", generator=gen)
    flat[33:] = x.reshape(-1, 2)
    y, made = run_counted("staging (c) input_offset_elements=33", base, flat,
                          input_offset_elements=33)
    require(made == (1, 0), f"staging (c): launches {made}")
    check_close("staging (c)", y, ref, "the unstaged plan")

    # (d) inPlace
    plan = T.create_plan({**opts, "inPlace": True}, device="cuda")
    xin = x.clone()
    y, made = run_counted("staging (d) inPlace", plan, xin)
    require(made == (1, 0) and y is xin, f"staging (d): launches {made}, in place: {y is xin}")
    check_close("staging (d)", xin, ref, "the unstaged plan")

    # (e) bf16-storage: the einsum route, f32 between the bf16 load and store
    plan = T.create_plan({**opts, "precision": "bf16-storage"}, device="cuda")
    xb = x.to(torch.bfloat16)
    y, made = run_counted("staging (e) bf16-storage", plan, xb)
    require(made == (0, 0) and y.dtype == torch.bfloat16,
            f"staging (e): launches {made}, dtype {y.dtype}")
    check_close("staging (e)", y.float(), base(xb.float()), "the f32 plan on the rounded input",
                tol=BF16_TOL)


def call_ms(fn, *args, runs=profile.RUNS):
    """Median single-call time from an idle device, host share included."""
    return profile.median(profile.time_calls(fn, *args, runs=runs))


# ---------------------------------------------------------------------------
# kernel adjoints
# ---------------------------------------------------------------------------

ADJOINT_K1 = [(1024, 4096, "forward"), (1024, 4096, "inverse"), (2048, 4096, "forward"),
              (360, 4096, "inverse"), (2310, 2048, "forward"), (OS_BLOCK, OS_BLOCKS, "forward"),
              (OS_BLOCK, OS_BLOCKS, "inverse"), (256, 3 * 128 * 256, "forward"),
              (16384, 512, "inverse"), (16, 100003, "forward"), (6, 77, "inverse")]
ADJOINT_K2 = [(256, 256, 512), (6 * 128, 256, 512), (3 * 128, 128, 512), (6, 128, 131072),
              (8, 1024, 2048), (64, 360, 512), (256, 16, 512), (8, 3, 512), (3, 2310, 66),
              (4, 1352, 130)]


def phase_adjoint(gen, k1_cases, k2_cases):
    """Each kernel's adjoint launch against the plain adjoint (the bar of
    ``compare``), and the dot test <K x, u> = <x, K^H u> in float64, over
    shapes that cover every radix set, both directions and the (h, 1)
    one-pass heights.  These launches count for no path."""
    from webgpufft_tpu_torch.core import fused, fused_cols

    def one(label, kernel, plain, x, tables):
        err = compare(f"{label} adjoint", lambda v, t: kernel(v, t, adjoint=True),
                      lambda v, t: plain(v, t, adjoint=True), x, tables)
        u = torch.randn(x.shape, device="cuda", generator=gen)
        lhs = float((kernel(x, tables).double() * u.double()).sum())
        rhs = float((x.double() * kernel(u, tables, adjoint=True).double()).sum())
        rel = abs(lhs - rhs) / max(abs(lhs), abs(rhs), 1e-30)
        # a sum of ~1e7 products of unit normals: hold the difference against
        # the norms, not against a sum that may cancel
        scale = float(kernel(x, tables).double().norm() * u.double().norm())
        print(f"{label} dot test: <Kx,u> {lhs:.6e}, <x,K^H u> {rhs:.6e}, difference "
              f"{abs(lhs - rhs) / scale:.3e} of |Kx||u| (limit {DOT_TOL:.0e})")
        require(abs(lhs - rhs) <= DOT_TOL * scale, f"{label}: dot test fails (rel {rel:.3e})")
        return err

    worst = 0.0
    for key in ADJOINT_K1:
        x, tables, _ = k1_cases[key]
        worst = max(worst, one(f"K1 fused_lines N={key[0]} lines={key[1]} {key[2]}",
                               fused.fused_lines, fused.fused_lines_reference, x, tables))
    for key in ADJOINT_K2:
        x, tables, direction = k2_cases[key]
        worst = max(worst, one(f"K2 fused_cols view={key} {direction}", fused_cols.fused_cols,
                               fused_cols.fused_cols_reference, x, tables))
    return worst


# ---------------------------------------------------------------------------
# autodiff
# ---------------------------------------------------------------------------

def counted(fn, *args, **kw):
    """``fn(...)`` and the (K1, K2) launches it made."""
    before = launches()
    out = fn(*args, **kw)
    after = launches()
    return out, (after[0] - before[0], after[1] - before[1])


def grad_case(label, made, want, pairs, tol=TOL):
    """Launch counts of one forward + backward, and each gradient against
    what it should be."""
    print(f"autodiff {label}: launches forward + backward fused_lines {made[0]}, "
          f"fused_cols {made[1]} (expected {want[0]}, {want[1]})")
    require(made == want, f"autodiff {label}: launches {made}, expected {want}")
    for name, got, expected, what in pairs:
        check_close(f"autodiff {label}: d/d{name}", got, expected, what, tol=tol)


def grad_time(label, ours, yardstick, card, what="torch.fft", forward=None):
    """Forward + backward from an idle device, ours beside the yardstick's
    (yardstick, ours, ours, yardstick), and the forward alone where given."""
    a = profile.time_calls(yardstick, runs=GRAD_RUNS, warmup=2) if yardstick else []
    b = profile.time_calls(ours, runs=GRAD_RUNS, warmup=2)
    b += profile.time_calls(ours, runs=GRAD_RUNS, warmup=0)
    a += profile.time_calls(yardstick, runs=GRAD_RUNS, warmup=0) if yardstick else []
    both = profile.median(b)
    beside = f", the same loss on {what} {profile.median(a):.4f} ms" if a else ""
    alone = ""
    if forward is not None:
        fwd = call_ms(forward, runs=GRAD_RUNS)
        alone = f"; forward alone {fwd:.4f} ms, forward+backward over forward {both / fwd:.2f}"
    print(f"time autodiff {label} forward+backward: port {both:.4f} ms{beside}{alone} [{card}]")


def phase_autodiff_timing(timers, card):
    """The gradients of the autodiff path, timed after it so that the path's
    launch counts are those of its own calls."""
    for label, ours, yardstick, what, forward in timers:
        grad_time(label, ours, yardstick, card, what=what, forward=forward)


def phase_autodiff(gen):
    """Gradients at full size through ``create_plan(...)(x)``.  Returns what
    ``phase_autodiff_timing`` times: (label, forward+backward, the same on
    the yardstick, the yardstick's name, the forward alone)."""
    import torch.nn.functional as F
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns
    from webgpufft_tpu_torch.utils import mathref
    grad = torch.autograd.grad
    timers = []

    # (a) headline, normalize none: d/dx sum |F x|^2 = 2 n x
    plan = T.create_plan({**HEADLINE, "normalize": "none"}, device="cuda")
    x = torch.randn(4096, 1024, 2, device="cuda", generator=gen).requires_grad_()
    (g,), made = counted(lambda: grad(plan(x).pow(2).sum(), x))
    grad_case("headline c2c [1024] b4096 none, sum|Fx|^2", made, (2, 0),
              [("x", g, 2.0 * 1024 * x.detach(), "2 n x")])
    timers.append(("headline c2c [1024] b4096, sum|Fx|^2",
                   lambda plan=plan, x=x: grad(plan(x).pow(2).sum(), x),
                   lambda x=x: grad(torch.view_as_real(torch.fft.fft(torch.view_as_complex(x)))
                                    .pow(2).sum(), x),
                   "torch.fft", lambda plan=plan, x=x: plan(x).pow(2).sum()))

    # (a') vmap: batch 1 over 4096 (the einsum route, batched by torch) and
    # batch 1024 over 4 (K1 through the Function's vmap rule) == batch 4096
    full = T.create_plan(HEADLINE, device="cuda")
    ref = full(x.detach())
    one = T.create_plan({**HEADLINE, "batch": 1}, device="cuda")
    y, made = counted(lambda: torch.func.vmap(lambda v: one(v))(
        x.detach().reshape(4096, 1, 1024, 2)))
    check_close("autodiff vmap of the batch-1 plan over 4096", y.reshape(4096, 1024, 2), ref,
                "the batch-4096 plan")
    print(f"autodiff vmap batch 1 over 4096: route {one.route.mode}, launches {made}")
    quarter = T.create_plan({**HEADLINE, "batch": 1024}, device="cuda")
    y, made = counted(lambda: torch.func.vmap(lambda v: quarter(v))(
        x.detach().reshape(4, 1024, 1024, 2)))
    require(made == (1, 0), f"autodiff vmap batch 1024 over 4: launches {made}")
    check_close("autodiff vmap of the batch-1024 plan over 4 (one K1 launch)",
                y.reshape(4096, 1024, 2), ref, "the batch-4096 plan", tol=1e-6)
    del g, y, ref

    # (b) c2c 256^3 forward then inverse, unitary: d/dx sum w * ifft(fft(x)) = w
    shape = [256, 256, 256]
    fwd = T.create_plan({"type": "c2c", "shape": shape, "batch": 1, "normalize": "unitary"},
                        device="cuda")
    inv = T.create_plan({"type": "c2c", "shape": shape, "batch": 1, "normalize": "unitary",
                         "direction": "inverse"}, device="cuda")
    x = torch.randn(1, *shape, 2, device="cuda", generator=gen).requires_grad_()
    w = torch.randn(1, *shape, 2, device="cuda", generator=gen)
    (g,), made = counted(lambda: grad((w * inv(fwd(x))).sum(), x))
    grad_case("c2c 256^3 forward then inverse", made, (4, 8), [("x", g, w, "w")])

    def cufft_pair(x=x, w=w):
        z = torch.fft.ifftn(torch.fft.fftn(torch.view_as_complex(x), dim=(1, 2, 3), norm="ortho"),
                            dim=(1, 2, 3), norm="ortho")
        return grad((w * torch.view_as_real(z)).sum(), x)

    timers.append(("c2c 256^3 forward then inverse",
                   lambda x=x, w=w: grad((w * inv(fwd(x))).sum(), x), cufft_pair, "torch.fft",
                   lambda x=x, w=w: (w * inv(fwd(x))).sum()))
    del g

    # (c) r2c 256^3 b3 -> spectral mask -> c2r, against torch.fft in float64
    r2c = real_plan("r2c", 3, "none")
    c2r = real_plan("c2r", 3, "backward")
    mask = ns.spectral_grids3(NS_N, "cuda")[4][..., None]
    x = torch.randn(3, NS_N, NS_N, NS_N, device="cuda", generator=gen).requires_grad_()
    w = torch.randn(3, NS_N, NS_N, NS_N, device="cuda", generator=gen)
    (g,), made = counted(lambda: grad((w * c2r(r2c(x) * mask)).sum(), x))
    xd = x.detach().double().requires_grad_()

    def cufft_real(v, wv, m):
        z = torch.fft.rfftn(v, dim=RFFT_DIMS) * m
        return grad((wv * torch.fft.irfftn(z, s=(NS_N,) * 3, dim=RFFT_DIMS)).sum(), v)

    want, = cufft_real(xd, w.double(), mask[..., 0].double())
    grad_case("r2c -> mask -> c2r 256^3 b3", made, (8, 12),
              [("x", g, want, "torch.fft in float64")])
    del xd, want, g
    timers.append(("r2c -> mask -> c2r 256^3 b3",
                   lambda x=x, w=w: grad((w * c2r(r2c(x) * mask)).sum(), x),
                   lambda x=x, w=w: cufft_real(x, w, mask[..., 0]), "torch.fft",
                   lambda x=x, w=w: (w * c2r(r2c(x) * mask)).sum()))

    # (d) dct2 [512, 512] b8 unitary: d/dx sum w * dct2(x) = the transposed
    # trig matrices on w, in float64
    plan = T.create_plan({"type": "dct2", "shape": [512, 512], "batch": 8,
                          "normalize": "unitary"}, device="cuda")
    x = torch.randn(8, 512, 512, device="cuda", generator=gen).requires_grad_()
    w = torch.randn(8, 512, 512, device="cuda", generator=gen)
    (g,), made = counted(lambda: grad((w * plan(x)).sum(), x))
    want = w.double()
    for d in (1, 2):
        m = torch.as_tensor(mathref.trig_matrix("dct2", 512, "forward"), device="cuda")
        want = torch.movedim(torch.movedim(want, d, -1) @ m, -1, d)
    want = want * mathref.normalize_scale("unitary", "forward", 512 * 512)
    grad_case("dct2 [512, 512] b8 unitary", made, (2, 2),
              [("x", g, want, "float64 transposed trig matrices")])
    timers.append(("dct2 [512, 512] b8", lambda plan=plan, x=x, w=w: grad((w * plan(x)).sum(), x),
                   lambda x=x, w=w: grad((w * torch_fft_dct2(x, 1.0 / 512)).sum(), x),
                   "torch.fft", lambda plan=plan, x=x, w=w: (w * plan(x)).sum()))
    del g, want

    # (e) fftconv [1000, 1000] b8, 25 x 25 taps: kernel and input gradients
    shape, kshape = [1000, 1000], [25, 25]
    plan = T.create_plan({"type": "fftconv", "shape": shape, "batch": 8,
                          "fftConv": {"kernelShape": kshape, "boundary": "linear-same"}},
                         device="cuda")
    geo = mathref.fftconv_out_shape(shape, kshape, "linear-same")
    x = torch.randn(8, 1000, 1000, 2, device="cuda", generator=gen).requires_grad_()
    k = torch.randn(25, 25, 2, device="cuda", generator=gen).requires_grad_()
    w = torch.randn(8, 1000, 1000, 2, device="cuda", generator=gen)
    (gx, gk), made = counted(lambda: grad((w * plan(x, kernel=k)).sum(), (x, k)))

    def cufft_conv(xv, kv, wv, dtype):
        y = torch_fft_conv(torch.view_as_complex(xv), torch.view_as_complex(kv), *geo, dtype=dtype)
        return grad((wv * torch.view_as_real(y)).sum(), (xv, kv))

    xd, kd = x.detach().double().requires_grad_(), k.detach().double().requires_grad_()
    wx, wk = cufft_conv(xd, kd, w.double(), torch.complex128)
    grad_case("fftconv [1000, 1000] b8 k25x25", made, (6, 6),
              [("x", gx, wx, "torch.fft complex128"), ("kernel", gk, wk, "torch.fft complex128")])
    del xd, kd, wx, wk, gx, gk
    timers.append(("fftconv [1000, 1000] b8 k25x25 (kernel and input)",
                   lambda plan=plan, x=x, k=k, w=w: grad((w * plan(x, kernel=k)).sum(), (x, k)),
                   lambda x=x, k=k, w=w: cufft_conv(x, k, w, torch.complex64), "torch.fft",
                   lambda plan=plan, x=x, k=k, w=w: (w * plan(x, kernel=k)).sum()))

    # (f) conv2d [1024, 1024] b8 real: kernel gradient, the caller's TF32 flag
    # ON around forward and backward
    plan = T.create_plan({"type": "conv2d", "shape": [1024, 1024], "batch": 8,
                          "conv": {"kernelSize": 3, "padding": "same", "kernelType": "real"}},
                         device="cuda")
    x = 1.0 + torch.randint(0, 4096, (8, *plan.in_shape), device="cuda",
                            generator=gen).float() / 4096.0
    k = torch.randn(3, 3, device="cuda", generator=gen).requires_grad_()
    w = torch.randn(8, 1024, 1024, device="cuda", generator=gen)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        (gk,), made = counted(lambda: grad((w * plan(x, kernel=k)).sum(), k))
        bare, = grad((w * F.conv2d(x[:, None], k[None, None], padding=1)[:, 0]).sum(), k)
    finally:
        torch.backends.cudnn.allow_tf32 = was
    kd = k.detach().double().requires_grad_()
    want, = grad((w.double() * F.conv2d(x.double()[:, None], kd[None, None], padding=1)[:, 0])
                 .sum(), kd)
    grad_case("conv2d [1024, 1024] b8 k3 real (cuDNN TF32 flag on outside)", made, (0, 0),
              [("kernel", gk, want, "float64 F.conv2d")])
    print(f"autodiff conv2d: the bare F.conv2d gradient with the TF32 flag on has max rel err "
          f"{rel_err(bare.double(), want):.3e} on the same data")
    timers.append(("conv2d [1024, 1024] b8 k3 real (kernel)",
                   lambda plan=plan, x=x, k=k, w=w: grad((w * plan(x, kernel=k)).sum(), k),
                   None, None, lambda plan=plan, x=x, k=k, w=w: (w * plan(x, kernel=k)).sum()))
    del gk, want

    # (g) one Navier-Stokes step at 256^3: the gradient of the kinetic energy
    # after the step with respect to the initial velocity, by reverse mode,
    # against forward mode along one direction
    step, to_s, to_p = ns.make_stepper3(NS_N, NS_NU, NS_DT, device="cuda")

    def energy(u0):
        u = to_p(step(to_s(u0)))
        return 0.5 * u.pow(2).sum(0).mean()

    u0 = ns.taylor_green_embedded(NS_N, 0.0, NS_NU, device="cuda") + 0.05 * torch.randn(
        3, NS_N, NS_N, NS_N, device="cuda", generator=gen)
    v = torch.randn(3, NS_N, NS_N, NS_N, device="cuda", generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g, made = counted(torch.func.grad(energy), u0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    require(made == (24, 36), f"autodiff NS-3D reverse mode: launches {made}, expected (24, 36)")
    (e, de), made_f = counted(torch.func.jvp, energy, (u0,), (v,))
    require(made_f == (24, 36), f"autodiff NS-3D forward mode: launches {made_f}")
    lhs, rhs = float(de), float((g.double() * v.double()).sum())
    rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
    print(f"autodiff NS-3D step {NS_N}^3, d(energy after the step)/d(u0): launches reverse "
          f"{made}, forward mode {made_f}; <J v> by jvp {lhs:.6e}, <v, J^T 1> by reverse mode "
          f"{rhs:.6e}, rel diff {rel:.3e} (limit {JVP_TOL:.0e}); energy {float(e):.6f}; peak "
          f"memory of the reverse pass {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB held "
          f"before it)")
    require(bool(torch.isfinite(g).all()) and rel <= JVP_TOL,
            "autodiff NS-3D: reverse and forward mode disagree")
    fstep, fto_s, fto_p = torch_fft_stepper3(NS_N, NS_NU, NS_DT)
    gf = torch.func.grad(lambda u: 0.5 * fto_p(fstep(fto_s(u))).pow(2).sum(0).mean())(u0)
    check_close("autodiff NS-3D step gradient", g, gf, "the torch.fft step's gradient",
                tol=JVP_TOL)
    del gf, g, v
    timers.append((f"NS-3D step {NS_N}^3 energy gradient (to_spectral, step, to_physical)",
                   lambda: torch.func.grad(energy)(u0),
                   lambda: torch.func.grad(
                       lambda u: 0.5 * fto_p(fstep(fto_s(u))).pow(2).sum(0).mean())(u0),
                   "the torch.fft step", lambda: energy(u0)))
    return timers


# ---------------------------------------------------------------------------
# runtime services
# ---------------------------------------------------------------------------

MEASURED = [HEADLINE,
            {"type": "c2c", "shape": [256, 256, 256], "batch": 1},
            {"type": "c2c", "shape": [1 << 20], "batch": 4},
            {"type": "r2c", "shape": [256, 256, 256], "batch": 3}]


def phase_runtime(gen, card):
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch import selftest
    from webgpufft_tpu_torch.runtime import golden, measure, trace

    # the measured planner on four plans, in a cache of its own
    cache = T.PlanCache()
    for opts in MEASURED:
        t0 = time.perf_counter()
        plan = T.create_plan({**opts, "tuning": {"rigor": "measure"}}, device="cuda", cache=cache)
        secs = time.perf_counter() - t0
        rec = cache.measured[measure.measure_key(plan.spec, "cuda")]
        note = [r for r in plan.route.reasons if r.startswith("measure")]
        print(f"runtime measure {opts['type']} {opts['shape']} b{opts['batch']}: winner "
              f"{rec['winner']}, trials_ms {json.dumps(rec.get('trials_ms'))}, note {note}, "
              f"route {plan.route.mode}, {secs:.1f} s [{card}]")
        require(len(note) == 1 and note[0].startswith("measured-winner:")
                and len(rec["trials_ms"]) >= 2, f"runtime measure {opts}: {note} {rec}")
    # snapshot -> JSON -> a fresh cache: the same winners, nothing timed
    snap = json.loads(json.dumps(T.export_plan_cache_snapshot(cache)))
    require(snap["version"] == 3 and len(snap["measured"]) == len(MEASURED)
            and snap["metadata"]["framework"].startswith("webgpufft-tpu-torch/"),
            f"runtime snapshot: {snap['metadata']} {len(snap['measured'])} measured")
    fresh = T.PlanCache()
    T.import_plan_cache_snapshot(snap, cache=fresh, build=False)
    timer = measure._call_time

    def no_timing(*_a, **_k):
        raise AssertionError("runtime snapshot: a cached decision was timed again")

    measure._call_time = no_timing
    try:
        for opts in MEASURED:
            plan = T.create_plan({**opts, "tuning": {"rigor": "measure"}}, device="cuda",
                                 cache=fresh)
            rec = cache.measured[measure.measure_key(plan.spec, "cuda")]
            require(f"measured-cached:{rec['winner']}" in plan.route.reasons,
                    f"runtime snapshot {opts}: {plan.route.reasons}")
            for key, val in (rec["overrides"] or {}).items():
                require(getattr(plan.spec.tuning, key) == val, f"runtime snapshot {opts}: {key}")
    finally:
        measure._call_time = timer
    print(f"runtime snapshot: {len(snap['specs'])} specs and {len(snap['measured'])} measured "
          f"decisions exported, imported into a fresh cache, the {len(MEASURED)} winners came "
          f"back as measured-cached with nothing timed")
    n = T.import_plan_cache_snapshot(snap, cache=T.PlanCache(), device="cuda")
    print(f"runtime snapshot: {n} plans rebuilt on the card by a building import")
    del cache, fresh

    # the committed golden corpus on the card
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden_corpus.json")
    arts = golden.load_artifacts(path)
    results, made = counted(lambda: [golden.compare_golden(a, atol_scale=1e-4, device="cuda")
                                     for a in arts])
    worst = max(r["max_rel_err"] for r in results)
    print(f"runtime golden corpus: {sum(r['ok'] for r in results)} of {len(results)} artifacts "
          f"pass on the card at 1e-4, worst max rel err {worst:.3e}, launches {made}")
    require(len(results) == 15 and all(r["ok"] for r in results),
            f"runtime golden corpus: {[r for r in results if not r['ok']]}")

    require(selftest.run(device="cuda"), "runtime selftest failed")

    # export -> load of the headline plan: bit-equal output
    plan = T.create_plan(HEADLINE, device="cuda")
    x = torch.randn(4096, 1024, 2, device="cuda", generator=gen)
    blob = T.export_plan(plan)
    loaded = T.load_exported_plan(blob, device="cuda")
    require(torch.equal(loaded(x), plan(x)) and loaded.route_mode == "pallas-fused",
            "runtime export: the loaded plan's output differs")
    print(f"runtime export_plan -> load_exported_plan: headline plan, {len(blob)} bytes, "
          f"output bit-equal, route {loaded.route_mode}")

    # a trace of one headline call
    with tempfile.TemporaryDirectory() as tmp:
        with trace.trace(os.path.join(tmp, "trace")) as prof:
            plan(x)
        text = open(prof.trace_path).read()
        require("wgfft:c2c" in text and "fused_lines_kernel" in text,
                "runtime trace: the plan's span or the kernel's name is missing")
        print(f"runtime trace: {os.path.basename(prof.trace_path)} ({len(text)} bytes) names "
              f"wgfft:c2c and fused_lines_kernel")
    stats = trace.plan_stats(plan, x)
    print(f"runtime plan_stats headline: {json.dumps(stats)}")
    require(stats["fused_lines_launches"] == 1 and stats["fused_cols_launches"] == 0,
            f"runtime plan_stats: {stats}")
    mem = trace.memory_stats()
    require(mem is not None and "allocated_bytes.all.peak" in mem, "runtime memory_stats")


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

COPY_SHAPES = [(4096, 2048), (16384, 2048)]    # the headline array, and 128 MB
COPY_SCALE = 1.000001
STAGES_SHAPES = [(1024, 4096), (2048, 4096), (4096, 4096), (256, 98304), (360, 4096)]
PLANES_SHAPES = [(1024, 4096), (256, 98304), (4096, 4096)]
CUDA_ERROR_INVALID_VALUE = 1


def copy_variants():
    """Every mode and stage count of ``stream_copy``."""
    from webgpufft_tpu_torch.probes import stream
    yield {"mode": "direct"}
    for mode in ("cp_async", "bulk"):
        for stages in stream.STAGE_COUNTS:
            yield {"mode": mode, "stages": stages}


def variant_name(kw):
    return " ".join(f"{k}={v}" for k, v in kw.items())


def lines_case(gen, n, lines):
    from webgpufft_tpu_torch.core import fused
    tables = to_dev(fused.lines_consts(n, "forward", 1.0 / math.sqrt(n), "p"))
    return torch.randn(lines, n, 2, device="cuda", generator=gen), tables


def to_planes(x):
    return torch.stack(x.unbind(-1), dim=1).contiguous()


def phase_probe_kernels(gen):
    """Each probe kernel against its plain version: ``stream_copy`` bit for
    bit (every mode and stage count, plain and scaled, both arrays),
    ``lines_stages`` at every stop of five shapes, ``lines_planes`` and K1 in
    place at three, and that K1's entry point refuses a one-pass chain in
    place.  Returns the worst max abs error of each probe and the cases for
    the timing phase.  These launches count for no path."""
    from webgpufft_tpu_torch import _build
    from webgpufft_tpu_torch.core import fused, radix
    from webgpufft_tpu_torch.probes import planes, stages, stream
    worst = dict.fromkeys(PROBE_KERNELS, 0.0)
    copies = [torch.randn(*shape, device="cuda", generator=gen) for shape in COPY_SHAPES]
    for x in copies:
        for kw in copy_variants():
            for scale in (None, COPY_SCALE):
                y = stream.stream_copy(x, scale, **kw)
                torch.cuda.synchronize()
                same = torch.equal(y, stream.stream_copy_reference(x, scale))
                print(f"P1 stream_copy {tuple(x.shape)} {variant_name(kw)}"
                      f"{' scaled' if scale else ''}: bit-equal to plain: {same}")
                require(same, f"stream_copy {kw} scale={scale}: differs from its plain version")
    lines_cases = {}
    for n, lines in STAGES_SHAPES:
        x, tables = lines_cases[(n, lines)] = lines_case(gen, n, lines)
        chain = radix.radix_chain(n)
        for stop in range(len(chain) + 1):
            worst["lines_stages"] = max(worst["lines_stages"], compare(
                f"P2 lines_stages N={n} chain={chain} lines={lines} stop={stop}",
                lambda v, t, stop=stop: stages.lines_stages(v, t, stop),
                lambda v, t, stop=stop: stages.lines_stages_reference(v, t, stop), x, tables))
    for n, lines in PLANES_SHAPES:
        x, tables = lines_cases[(n, lines)]
        worst["lines_planes"] = max(worst["lines_planes"], compare(
            f"P3 lines_planes N={n} lines={lines}", planes.lines_planes,
            planes.lines_planes_reference, to_planes(x), tables))
        compare(f"P3 K1 in place N={n} lines={lines}",
                lambda v, t: planes.lines_inplace(v.clone(), t), fused.fused_lines_reference,
                x, tables)
    # a one-pass chain has no barrier between its reads and writes: refused
    x, tables = lines_case(gen, 16, 4096)
    rc = _build.library().wgfft_fused_lines(
        x.data_ptr(), x.data_ptr(), tables["cw"].data_ptr(), tables["cp"].data_ptr(), 4096, 16,
        *_build.chain_arg(radix.radix_chain(16)), 0, torch.cuda.current_stream().cuda_stream)
    print(f"P3 K1 in place N=16 (one pass): entry point returned {rc} "
          f"(cudaErrorInvalidValue = {CUDA_ERROR_INVALID_VALUE})")
    require(rc == CUDA_ERROR_INVALID_VALUE, "K1 ran a one-pass chain in place")
    return worst, copies, lines_cases


def phase_probes(copies, lines_cases):
    """The probes path: every probe through its entry point at full size."""
    from webgpufft_tpu_torch import probes
    from webgpufft_tpu_torch.core import fused, radix
    for x in copies:
        for kw in copy_variants():
            for scale in (None, COPY_SCALE):
                y = probes.stream_copy(x, scale, **kw)
                require(y.shape == x.shape and torch.equal(y, x if scale is None else x * scale),
                        f"probes: stream_copy {kw} scale={scale} is not the copy")
    print(f"probes: stream_copy on {COPY_SHAPES}, {len(list(copy_variants()))} variants, plain "
          f"and scaled: every output is the copy")
    x, tables = lines_cases[(1024, 4096)]
    k1 = fused.fused_lines(x, tables)
    check_oracle("probes: K1 N=1024 x 4096", k1,
                 torch.fft.fft(torch.view_as_complex(x), norm="ortho"))
    count = len(radix.radix_chain(1024))
    for stop in range(count + 1):
        y = probes.lines_stages(x, tables, stop)
        require(tuple(y.shape) == tuple(x.shape) and bool(torch.isfinite(y).all()),
                f"probes: lines_stages stop={stop} output")
        if stop == 0:
            require(torch.equal(y, x), "probes: lines_stages stop=0 is not the copy")
    check_close(f"probes: lines_stages stop={count} (every pass)", y, k1, "K1")
    yp = probes.lines_planes(to_planes(x), tables)
    check_close("probes: lines_planes", torch.stack(yp.unbind(1), dim=-1), k1,
                "K1 on the interleaved form")
    work = x.clone()
    same = torch.equal(probes.lines_inplace(work, tables), k1)
    print(f"probes: K1 in place bit-equal to K1 out of place: {same}")
    require(same, "probes: K1 in place differs from K1 out of place")


def timed(fn, *args, runs=profile.RUNS):
    return profile.median(profile.time_queued(fn, *args, runs=runs))


def phase_probe_timing(copies, lines_cases, card):
    """Every probe variant beside its bound and ``Tensor.copy_`` timed in the
    same run; for ``lines_stages`` the difference between neighbouring
    stops.  Returns the record of each probe's headline shape."""
    from webgpufft_tpu_torch.core import fused, radix
    from webgpufft_tpu_torch.probes import planes, stages, stream
    out = {}
    for x in copies:
        nbytes = 8 * x.numel()
        bound, bound_by = profile.bound_ms(nbytes, 0.0)
        y = torch.empty_like(x)
        copy_ms = timed(lambda: y.copy_(x))
        ceiling = profile.measured_copy_ceiling_gbps(x)
        print(f"time stream_copy {tuple(x.shape)}: bound {bound:.4f} ms ({nbytes} bytes at "
              f"3.35 TB/s), Tensor.copy_ {copy_ms:.4f} ms, elementwise ceiling {ceiling:.0f} GB/s "
              f"[{card}]")
        for kw in copy_variants():
            ms = timed(lambda: stream.stream_copy(x, **kw))
            sm = timed(lambda: stream.stream_copy(x, COPY_SCALE, **kw))
            print(f"time stream_copy {tuple(x.shape)} {variant_name(kw)}: {ms:.4f} ms "
                  f"({nbytes / ms / 1e6:.1f} GB/s, roofline share {bound / ms:.2f}, Tensor.copy_ "
                  f"over it {copy_ms / ms:.2f}), scaled {sm:.4f} ms [{card}]")
            if tuple(x.shape) == COPY_SHAPES[0] and kw["mode"] == "direct":
                out["stream_copy"] = {
                    "ms": ms, "plain_ms": timed(stream.stream_copy_reference, x),
                    "bound_ms": bound, "bound_by": bound_by, "library_ms": copy_ms}
    for (n, lines) in STAGES_SHAPES:
        x, tables = lines_cases[(n, lines)]
        chain = radix.radix_chain(n)
        nbytes = 16 * n * lines
        bound, bound_by = profile.bound_ms(nbytes, 5.0 * n * math.log2(n) * lines)
        y = torch.empty_like(x)
        copy_ms = timed(lambda: y.copy_(x))
        k1 = timed(fused.fused_lines, x, tables)
        print(f"time lines_stages N={n} lines={lines} chain={chain}: bound {bound:.4f} ms, "
              f"Tensor.copy_ {copy_ms:.4f} ms, K1 {k1:.4f} ms [{card}]")
        before = None
        for stop in range(len(chain) + 1):
            ms = timed(stages.lines_stages, x, tables, stop)
            delta = "" if before is None else f", + {ms - before:.4f} ms over stop {stop - 1}"
            what = "copy" if stop == 0 else f"radix {chain[stop - 1]}"
            print(f"time lines_stages N={n} lines={lines} stop={stop} ({what}): {ms:.4f} ms "
                  f"(roofline share {bound / ms:.2f}{delta}) [{card}]")
            before = ms
        if (n, lines) == STAGES_SHAPES[0]:
            z = torch.view_as_complex(x)
            out["lines_stages"] = {
                "ms": before, "bound_ms": bound, "bound_by": bound_by,
                "plain_ms": timed(stages.lines_stages_reference, x, tables, len(chain), runs=4),
                "library_ms": timed(lambda: torch.fft.fft(z, norm="ortho"))}
    for (n, lines) in PLANES_SHAPES:
        x, tables = lines_cases[(n, lines)]
        xp, work = to_planes(x), x.clone()
        bound, bound_by = profile.bound_ms(16 * n * lines, 5.0 * n * math.log2(n) * lines)
        k1 = timed(fused.fused_lines, x, tables)
        pm = timed(planes.lines_planes, xp, tables)
        im = timed(planes.lines_inplace, work, tables)
        pm += timed(planes.lines_planes, xp, tables)
        k1 += timed(fused.fused_lines, x, tables)
        k1, pm = k1 / 2, pm / 2
        print(f"time lines_planes N={n} lines={lines}: planes {pm:.4f} ms (roofline share "
              f"{bound / pm:.2f}), K1 interleaved {k1:.4f} ms, K1 in place {im:.4f} ms, bound "
              f"{bound:.4f} ms [{card}]")
        if (n, lines) == PLANES_SHAPES[0]:
            out["lines_planes"] = {
                "ms": pm, "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
                "plain_ms": timed(planes.lines_planes_reference, xp, tables, runs=8)}
    return out


def fft_norm(direction, normalize):
    """The ``norm`` of torch.fft that matches a plan's normalize."""
    if normalize == "unitary":
        return "ortho"
    unscaled = "backward" if direction == "forward" else "forward"
    return unscaled if normalize == "none" else "backward"


def time_kernel(label, kernel, plain, library, args, n, transforms, card):
    """One kernel shape: the kernel's device time beside its plain version's
    and the library call's (plain, library, kernel, kernel, library, plain:
    medians over both blocks of each), its bound, and the single-call time
    from an idle device, host share included."""
    nbytes = 16 * n * transforms                       # one read, one write
    flops = 5.0 * n * math.log2(n) * transforms        # a radix-2 FFT's count
    bound, bound_by = profile.bound_ms(nbytes, flops)
    p = profile.time_queued(plain, *args, runs=8)
    f = profile.time_queued(library, args[0])
    k = profile.time_queued(kernel, *args)
    k += profile.time_queued(kernel, *args)
    am = profile.median(profile.time_queued(lambda v, t: kernel(v, t, adjoint=True), *args))
    f += profile.time_queued(library, args[0])
    p += profile.time_queued(plain, *args, runs=8)
    km, pm, fm = profile.median(k), profile.median(p), profile.median(f)
    idle = call_ms(kernel, *args)
    print(f"time {label}: kernel {km:.4f} ms ({nbytes / km / 1e6:.1f} GB/s, "
          f"roofline share {bound / km:.2f}), adjoint launch {am:.4f} ms, "
          f"plain {pm:.4f} ms, bound {bound:.4f} ms by "
          f"{bound_by} ({nbytes} bytes at 3.35 TB/s), torch.fft.fft (cuFFT) {fm:.4f} ms; "
          f"one call from idle {idle:.4f} ms [{card}]")
    return {"ms": km, "plain_ms": pm, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": fm, "adjoint_ms": am}


def phase_timing(k1_cases, k2_cases, headline, volume, card):
    from webgpufft_tpu_torch.core import fused, fused_cols
    out = {}
    for (n, lines, direction), (x, t, normalize) in k1_cases.items():
        if ("K1", n, lines) in out:
            continue  # same work as the other direction, timed already
        fft = torch.fft.fft if direction == "forward" else torch.fft.ifft
        norm = fft_norm(direction, normalize)
        out[("K1", n, lines)] = time_kernel(
            f"K1 fused_lines N={n} lines={lines} design=direct", fused.fused_lines,
            fused.fused_lines_reference,
            lambda v, fft=fft, norm=norm: fft(torch.view_as_complex(v), dim=-1, norm=norm),
            (x, t), n, lines, card)
        out[("K1", n, lines)]["design"] = "direct"
    for (pre, h, lanes), (x, t, direction) in k2_cases.items():
        fft = torch.fft.fft if direction == "forward" else torch.fft.ifft
        norm = fft_norm(direction, "none")
        grid, tile = fused_cols.launch_shape(h, lanes // 2)
        design = "ring" if grid > 0 else "direct"
        out[("K2", pre, h, lanes)] = time_kernel(
            f"K2 fused_cols view=({pre}, {h}, {lanes}) design={design} tile={tile}",
            fused_cols.fused_cols, fused_cols.fused_cols_reference,
            lambda v, fft=fft, norm=norm: fft(
                torch.view_as_complex(v.view(v.shape[0], v.shape[1], -1, 2)), dim=1, norm=norm),
            (x, t), h, pre * lanes // 2, card)
        out[("K2", pre, h, lanes)]["design"] = design
        out[("K2", pre, h, lanes)]["tile"] = tile
    # what Function.apply costs a caller who never differentiates: the
    # headline plan's one kernel pass from an idle device, launched directly
    # (what an untracked call does) and through the Function
    x, tables, _ = k1_cases[(1024, 4096, "forward")]
    direct = profile.time_calls(fused.fused_lines, x, tables)
    via = profile.time_calls(fused.FusedLines.apply, x, tables, False)
    via += profile.time_calls(fused.FusedLines.apply, x, tables, False)
    listed = fused.table_list(tables)
    op = profile.time_calls(fused.fused_lines_op, x, listed, False)
    op += profile.time_calls(fused.fused_lines_op, x, listed, False)
    direct += profile.time_calls(fused.fused_lines, x, tables)
    print(f"time K1 N=1024 lines=4096 one call from idle: direct launch (untracked input) "
          f"{profile.median(direct):.4f} ms, through FusedLines.apply "
          f"{profile.median(via):.4f} ms, through the op torch.ops.wgfft.fused_lines "
          f"{profile.median(op):.4f} ms [{card}]")
    for label, (plan, x), oracle in [
            ("headline plan(x) c2c [1024] b4096", headline,
             lambda z: torch.fft.fft(z, norm="ortho")),
            ("3-D plan(x) c2c 256^3 b1", volume,
             lambda z: torch.fft.fftn(z, dim=(1, 2, 3)))]:
        pm = call_ms(plan, x)
        fm = call_ms(lambda v: torch.view_as_real(oracle(torch.view_as_complex(v))), x)
        nbytes = 8 * x.numel()
        print(f"time {label}: {pm:.4f} ms ({nbytes / pm / 1e6:.1f} GB/s); torch.fft "
              f"(cuFFT) yardstick {fm:.4f} ms ({nbytes / fm / 1e6:.1f} GB/s), "
              f"min-bytes {nbytes} [{card}]")
    return out


def phase_new_plan_timing(dct, conv, overlap, conv2d, card):
    """The dct2, fftconv and conv2d plans beside a yardstick on ``torch.fft``
    (or, for conv2d, the bare library call the plan wraps)."""
    plan, x = dct
    pm = call_ms(plan, x)
    fm = call_ms(torch_fft_dct2, x, 1.0 / 512)
    print(f"time dct2 [512, 512] b8 plan(x): {pm:.4f} ms; DCT-II on torch.fft (cuFFT) "
          f"{fm:.4f} ms [{card}]")
    plan, x, k, geo = conv
    pm = call_ms(lambda: plan(x, kernel=k))
    xc, kc = torch.view_as_complex(x), torch.view_as_complex(k)
    fm = call_ms(lambda: torch_fft_conv(xc, kc, *geo, dtype=torch.complex64))
    print(f"time fftconv [1000, 1000] b8 k25x25 plan(x, kernel): {pm:.4f} ms; the same on "
          f"torch.fft (cuFFT, complex64) {fm:.4f} ms [{card}]")
    plan, x, k = overlap
    pm = call_ms(lambda: plan(x, kernel=k))
    xc, kc = torch.view_as_complex(x), torch.view_as_complex(k)
    fm = call_ms(lambda: torch_fft_conv(xc, kc, (OS_N,), (OS_N,), (0,), dtype=torch.complex64))
    print(f"time fftconv overlap-save [2^20] k{OS_TAPS} plan(x, kernel): {pm:.4f} ms; one "
          f"length-2^20 convolution on torch.fft (cuFFT, complex64) {fm:.4f} ms [{card}]")
    for ktype, (plan, x, w) in conv2d.items():
        pm = call_ms(lambda: plan(x, kernel=w))
        print(f"time conv2d [1024, 1024] b8 k3 {ktype} plan(x, kernel): {pm:.4f} ms [{card}]")


def phase_solver_timing(gen, x, y, card):
    """The solver's plans beside torch.fft, and one solver step beside the
    same step on torch.fft.rfftn/irfftn (ms per step, CUDA events)."""
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns
    r2c, c2r = real_plan("r2c", 3, "none"), real_plan("c2r", 6, "backward")
    x3 = x[:3].contiguous()
    for label, plan, arg, plain in [
            ("r2c 256^3 b3", r2c, x3, lambda v: torch.fft.rfftn(v, dim=RFFT_DIMS)),
            ("c2r 256^3 b6", c2r, y,
             lambda v: torch.fft.irfftn(torch.view_as_complex(v), s=(NS_N,) * 3, dim=RFFT_DIMS))]:
        pm = call_ms(plan, arg)
        fm = call_ms(plain, arg)
        print(f"time {label} plan(x): {pm:.4f} ms; torch.fft (cuFFT) {fm:.4f} ms [{card}]")
    step, to_s, _ = ns.make_stepper3(NS_N, NS_NU, NS_DT, device="cuda")
    fstep, _, _ = torch_fft_stepper3(NS_N, NS_NU, NS_DT)
    u_hat = to_s(0.1 * torch.randn(3, NS_N, NS_N, NS_N, device="cuda", generator=gen))
    err = rel_err(step(u_hat), fstep(u_hat))
    print(f"NS-3D step {NS_N}^3: max rel err {err:.3e} vs the torch.fft step "
          f"(limit {TOL:.0e} * max|expected|)")
    require(err <= TOL, "NS-3D step disagrees with the torch.fft step")
    p = profile.time_calls(fstep, u_hat)
    k = profile.time_calls(step, u_hat)
    k += profile.time_calls(step, u_hat)
    p += profile.time_calls(fstep, u_hat)
    km, pm = profile.median(k), profile.median(p)
    print(f"time NS-3D step {NS_N}^3 (RK2: 2 x (c2r b6 + r2c b3) + pointwise): "
          f"port {km:.4f} ms/step, torch.fft step {pm:.4f} ms/step [{card}]")
    return km, pm


# ---------------------------------------------------------------------------
# the functional facade
# ---------------------------------------------------------------------------

FACADE_STFT = dict(nperseg=1024, noverlap=512)


def as_complex(y):
    """Interleaved (..., 2) facade output as a complex tensor (a copy only
    where a restored axis order left it non-contiguous)."""
    return torch.view_as_complex(y.contiguous())


def facade_call(label, fn, *args, expect=None, **kw):
    """One facade call with its own K1/K2 launch count: a facade call on the
    card launches the kernels or the phase fails.  ``expect`` pins the
    counts to those the same transform makes through ``create_plan``;
    ``(0, 0)`` names a call whose plan runs the einsum route on the card."""
    out, made = counted(fn, *args, **kw)
    print(f"facade {label}: launches fused_lines {made[0]}, fused_cols {made[1]}")
    require(made[0] + made[1] > 0 or expect == (0, 0), f"facade {label}: no kernel launched")
    if expect is not None:
        require(made == expect, f"facade {label}: launches {made}, expected {expect}")
    return out


def host64(t):
    return t.detach().double().cpu().numpy()


def phase_facade(gen):
    """The numpy/scipy-style facade and its bridges at full size, each result
    against the library: returns what the timing phase needs."""
    import scipy.fft
    import scipy.fftpack
    import scipy.signal
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch import fft as wfft
    from webgpufft_tpu_torch import fftpack, pyfftw, torch_fft
    from webgpufft_tpu_torch.utils import mathref
    on_card = torch.device("cuda", torch.cuda.current_device())

    # c2c: the headline as one call on a complex64 tensor, and 256^3
    z = torch.randn(4096, 1024, dtype=torch.complex64, device="cuda", generator=gen)
    y = facade_call("fft (4096, 1024) complex64", wfft.fft, z, expect=(1, 0))
    require(y.device == on_card and y.dtype == torch.float32 and tuple(y.shape) == (4096, 1024, 2),
            f"facade fft: output {y.dtype} {tuple(y.shape)} on {y.device}")
    check_oracle("facade fft (4096, 1024)", y, torch.fft.fft(z))
    back = facade_call("ifft (4096, 1024)", wfft.ifft, y, expect=(1, 0))
    check_oracle("facade ifft(fft(z))", back, z)
    v = torch.randn(256, 256, 256, dtype=torch.complex64, device="cuda", generator=gen)
    y = facade_call("fftn 256^3", wfft.fftn, v, expect=(1, 2))
    check_oracle("facade fftn 256^3", y, torch.fft.fftn(v))
    keep = {"fft": z}
    del y, back, v

    # r2c / c2r over three axes of a batch of three volumes
    x = torch.randn(3, NS_N, NS_N, NS_N, device="cuda", generator=gen)
    # numpy packs the LAST axis: a 1-D r2c over it (K1 twice: the half-length
    # transform and its untangling pass run as lines) and a 2-D c2c over the
    # other two (K2, K1), not the 3-D r2c plan that packs logical axis 0
    y = facade_call("rfftn (3, 256, 256, 256)", wfft.rfftn, x, axes=(1, 2, 3), expect=(2, 1))
    check_oracle("facade rfftn 256^3 x 3", y.contiguous(), torch.fft.rfftn(x, dim=(1, 2, 3)))
    back = facade_call("irfftn (3, 256, 256, 129)", wfft.irfftn, y, s=(NS_N,) * 3,
                       axes=(1, 2, 3), expect=(2, 1))
    check_close("facade irfftn 256^3 x 3", back,
                torch.fft.irfftn(as_complex(y), s=(NS_N,) * 3, dim=(1, 2, 3)), "torch.fft")
    check_close("facade irfftn(rfftn(x))", back, x, "the input")
    keep["rfftn"] = x
    del y, back

    # dct: scipy's ortho DCT-II from the plan convention's float64 oracle
    # (no factor 2): per axis sqrt(2/N), and 1/sqrt(2) more on bin 0
    x = torch.randn(8, 512, 512, device="cuda", generator=gen)
    y = facade_call("dctn type 2 ortho (8, 512, 512)", wfft.dctn, x, type=2, axes=(1, 2),
                    norm="ortho", expect=(2, 0))      # scipy's dctn: one 1-D dct per axis
    want = dct_oracle(x, (512, 512), "dct2", "forward", "none") * (2.0 / 512)
    want[:, 0, :] *= math.sqrt(0.5)
    want[:, :, 0] *= math.sqrt(0.5)
    check_close("facade dctn (8, 512, 512)", y, want, "float64 trig matrices")
    check_close("facade dctn [0]", y[0],
                torch.as_tensor(scipy.fft.dctn(host64(x[0]), type=2, norm="ortho"), device="cuda"),
                "scipy.fft.dctn")
    del x, y, want

    # convolutions: 2-D same-mode with a broadcast kernel, and the long 1-D
    # call that the plan layer routes to overlap-save
    shape, kshape = [1000, 1000], [25, 25]
    x = torch.randn(8, 1000, 1000, device="cuda", generator=gen)
    k = torch.randn(1, 25, 25, device="cuda", generator=gen)
    y = facade_call("fftconvolve same (8, 1000, 1000) * (1, 25, 25)", wfft.fftconvolve, x, k,
                    mode="same", axes=(1, 2), expect=(3, 3))
    geo = mathref.fftconv_out_shape(shape, kshape, "linear-same")
    ref = torch_fft_conv(x.to(torch.complex64), k[0].to(torch.complex64), *geo)
    check_close("facade fftconvolve (8, 1000, 1000)", y, ref.real, "torch.fft complex128")
    keep["conv"] = (x, k, geo)
    del y, ref
    x1 = 0.05 * torch.randn(OS_N, device="cuda", generator=gen)
    k1 = 0.05 * torch.randn(OS_TAPS, device="cuda", generator=gen)
    plan = T.create_plan({"type": "fftconv", "shape": [OS_N], "batch": 1,
                          "fftConv": {"boundary": "linear-same", "kernelShape": [OS_TAPS]}},
                         device="cuda")
    require(plan.route.mode == "overlap-save", f"facade 1-D convolution: route {plan.route.mode}")
    y = facade_call(f"fftconvolve same [2^20] * [{OS_TAPS}] (overlap-save)", wfft.fftconvolve,
                    x1, k1, mode="same", expect=(2, 0))
    geo1 = mathref.fftconv_out_shape([OS_N], [OS_TAPS], "linear-same")
    ref = torch_fft_conv(x1[None].to(torch.complex64), k1.to(torch.complex64), *geo1)[0]
    check_close("facade fftconvolve [2^20]", y, ref.real, "torch.fft complex128")
    del x1, k1, y, ref

    # short-time transforms on 8 signals of 2^22 samples: 65,544 frames of
    # 1024 through the r2c plan
    sig = torch.randn(8, 1 << 22, device="cuda", generator=gen)
    win = torch.as_tensor(wfft.get_window("hann", 1024), device="cuda")
    f, t, Z = facade_call("stft (8, 2^22) nperseg 1024 noverlap 512", wfft.stft, sig,
                          expect=(1, 0), **FACADE_STFT)
    want = torch.stft(sig, n_fft=1024, hop_length=512, window=win, center=True,
                      pad_mode="constant", onesided=True, return_complex=True) / win.sum()
    require(tuple(Z.shape) == (8, 513, 8193, 2) and len(f) == 513 and len(t) == 8193,
            f"facade stft: output {tuple(Z.shape)}")
    check_oracle("facade stft (8, 2^22)", Z.contiguous(), want)
    del want
    _, back = facade_call("istft (8, 513, 8193)", wfft.istft, Z, expect=(1, 0), **FACADE_STFT)
    check_close("facade istft(stft(x))", back[:, :1 << 22], sig, "the input")
    del Z, back
    f, P = facade_call("welch (8, 2^22) nperseg 1024", wfft.welch, sig, expect=(1, 0),
                       **FACADE_STFT)
    fs, Ps = scipy.signal.welch(host64(sig), **FACADE_STFT)
    require(np.allclose(f, fs), "facade welch: frequency grid")
    check_close("facade welch (8, 2^22)", P, torch.as_tensor(Ps, device="cuda"),
                "scipy.signal.welch float64")
    keep["stft"] = (sig, win)
    short = sig[:, :1 << 20].contiguous()
    hann = scipy.signal.windows.hann(1024, sym=False)
    stf = T.ShortTimeFFT(hann, hop=256, fs=1.0)
    S = facade_call("ShortTimeFFT(hann(1024), hop=256).stft (8, 2^20)", stf.stft, short,
                    expect=(1, 0))
    ref = scipy.signal.ShortTimeFFT(hann, hop=256, fs=1.0).stft(host64(short[0]))
    check_oracle("facade ShortTimeFFT.stft [0]", S[0].contiguous(),
                 torch.as_tensor(ref, device="cuda"))
    back = facade_call("ShortTimeFFT.istft", stf.istft, S, k1=1 << 20, interleaved=True,
                       expect=(1, 0))
    check_close("facade ShortTimeFFT istft(stft(x))", back, short, "the input")
    del S, back, ref

    # analytic signal and polyphase resampling against scipy.signal in float64
    # a [2^20] c2c axis is the plan layer's four-step route, which runs on
    # einsums on the card (no kernel takes it, as on the axis-kinds check);
    # the same signals as 2048 rows of 4096 go through K1 both ways
    plan = T.create_plan(type="c2c", shape=[1 << 20], batch=8, direction="forward",
                         normalize="none", device="cuda")
    require(plan.route.mode == "four-step-hbm", f"facade hilbert: route {plan.route.mode}")
    y = facade_call("hilbert (8, 2^20) (four-step, einsum route)", wfft.hilbert, short,
                    expect=(0, 0))
    check_oracle("facade hilbert (8, 2^20)", y,
                 torch.as_tensor(scipy.signal.hilbert(host64(short)), device="cuda"))
    rows = short.reshape(2048, 4096)
    y = facade_call("hilbert (2048, 4096)", wfft.hilbert, rows, expect=(2, 0))
    check_oracle("facade hilbert (2048, 4096)", y,
                 torch.as_tensor(scipy.signal.hilbert(host64(rows)), device="cuda"))
    y = facade_call("resample_poly(x, 3, 2) (8, 2^20)", wfft.resample_poly, short, 3, 2, axis=-1,
                    expect=(2, 0))      # the zero-stuffed signal through overlap-save
    check_close("facade resample_poly (8, 2^20)", y,
                torch.as_tensor(scipy.signal.resample_poly(host64(short), 3, 2, axis=-1),
                                device="cuda"), "scipy.signal.resample_poly float64")
    del y, short

    # the native torch namespace: value and gradient of sum |Y|^2
    zg = torch.randn(64, 1024, 1024, dtype=torch.complex64, device="cuda",
                     generator=gen).requires_grad_(True)
    Y = facade_call("torch_fft.fft2 (64, 1024, 1024) complex64", torch_fft.fft2, zg,
                    expect=(1, 1))
    require(Y.dtype == torch.complex64 and Y.device == on_card and Y.requires_grad,
            f"torch_fft.fft2: output {Y.dtype} on {Y.device}")
    g, = facade_call("torch.autograd.grad through torch_fft.fft2", torch.autograd.grad,
                     torch.view_as_real(Y).pow(2).sum(), zg, expect=(1, 1))
    check_close("torch_fft.fft2 (64, 1024, 1024)", Y.detach(), torch.fft.fft2(zg.detach()),
                "torch.fft.fft2")
    del Y
    zr = zg.detach().clone().requires_grad_(True)
    gr, = torch.autograd.grad(torch.view_as_real(torch.fft.fft2(zr)).pow(2).sum(), zr)
    check_close("torch_fft.fft2 gradient of sum |Y|^2", g, gr, "torch.fft.fft2's gradient")
    del zg, zr, g, gr

    # the bridges: numpy in and out, the transform on the card
    zn = z.cpu().numpy()
    want = np.fft.fft(zn.astype(np.complex128))

    def host_check(label, got, expected, what):
        require(isinstance(got, np.ndarray), f"{label}: returned {type(got).__name__}")
        check_close(label, torch.as_tensor(got), torch.as_tensor(expected), what)

    def via_scipy():
        with scipy.fft.set_backend(T.scipy_fft_backend()):
            return scipy.fft.fft(zn)
    got = facade_call("scipy.fft.fft under scipy_fft_backend()", via_scipy, expect=(1, 0))
    require(got.dtype == np.complex64, f"scipy backend: dtype {got.dtype}")
    host_check("scipy.fft.fft (4096, 1024) via the backend", got, want, "numpy.fft float64")
    out = np.zeros_like(zn)
    obj = facade_call("pyfftw.FFTW plan + execute", pyfftw.FFTW, zn, out, expect=(1, 0))
    got = facade_call("pyfftw.FFTW()", obj, expect=(1, 0))
    require(got is out, "pyfftw.FFTW: output array not written in place")
    host_check("pyfftw.FFTW (4096, 1024)", got, want, "numpy.fft float64")
    xr = zn.real.copy()
    got = facade_call("fftpack.rfft (4096, 1024)", fftpack.rfft, xr, expect=(1, 0))
    require(got.device == on_card, f"fftpack.rfft: result on {got.device}")
    check_close("fftpack.rfft (4096, 1024)", got,
                torch.as_tensor(scipy.fftpack.rfft(xr.astype(np.float64)), device="cuda"),
                "scipy.fftpack.rfft float64")
    torch.cuda.empty_cache()
    return keep


def phase_facade_timing(keep, card):
    """Each of four facade calls from an idle device (``call_ms``: the host's
    share included) and queued behind device work (``time_queued``: device
    time) beside ``plan(x)`` for the same plan and the one library call."""
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch import fft as wfft

    def row(label, facade, plan_call, library, what, plans="plan(x)", staged=None):
        """``plan_call`` runs the plans the facade call builds, on inputs
        already laid out for them; ``staged`` (where given) also does the
        device work the facade does around them, so that facade - staged is
        the host's share alone."""
        fm, pm, lm = call_ms(facade), call_ms(plan_call), call_ms(library)
        fq = profile.median(profile.time_queued(facade))
        pq = profile.median(profile.time_queued(plan_call))
        around = ""
        if staged is not None:
            sm = call_ms(staged)
            sq = profile.median(profile.time_queued(staged))
            around = (f"; with the facade's device work around the plan {sm:.4f} ms idle / "
                      f"{sq:.4f} ms queued; facade - that {fm - sm:.4f} ms")
        print(f"time facade {label}: facade {fm:.4f} ms idle / {fq:.4f} ms queued; {plans} "
              f"{pm:.4f} ms idle / {pq:.4f} ms queued; facade - {plans} {fm - pm:.4f} ms"
              f"{around}; {what} {lm:.4f} ms [{card}]")

    z = keep["fft"]
    zi = torch.view_as_real(z)
    plan = T.create_plan(type="c2c", shape=[1024], batch=4096, direction="forward",
                         normalize="none", device="cuda")
    row("fft (4096, 1024)", lambda: wfft.fft(z), lambda: plan(zi), lambda: torch.fft.fft(z),
        "torch.fft.fft")

    # numpy's rfftn packs the last axis: the facade builds a 1-D r2c plan over
    # it and a 2-D c2c plan over the other two, with one transposing copy
    # between them (the 3-D r2c plan of the r2c path packs axis 0 and is
    # another decomposition, timed by phase_solver_timing)
    x = keep["rfftn"]
    n = NS_N
    half = n // 2 + 1
    plan_r = T.create_plan(type="r2c", shape=[n], batch=3 * n * n, direction="forward",
                           normalize="none", device="cuda")
    plan_c = T.create_plan(type="c2c", shape=[n, n], batch=3 * half, direction="forward",
                           normalize="none", device="cuda")
    lines = x.reshape(-1, n)

    def rfftn_plans():
        y = plan_r(lines).reshape(3, n, n, half, 2)
        return plan_c(y.movedim((1, 2), (2, 3)).reshape(3 * half, n, n, 2))
    check_close("the two plans of rfftn back to back",
                rfftn_plans().reshape(3, half, n, n, 2).movedim((2, 3), (1, 2)),
                wfft.rfftn(x, axes=(1, 2, 3)), "the facade call")
    row("rfftn 256^3 x 3", lambda: wfft.rfftn(x, axes=(1, 2, 3)), rfftn_plans,
        lambda: torch.fft.rfftn(x, dim=(1, 2, 3)), "torch.fft.rfftn",
        plans="its r2c [256] and c2c [256, 256] plans back to back")

    sig, win = keep["stft"]

    def framed():
        return (torch.nn.functional.pad(sig, (512, 512)).unfold(-1, 1024, 512) * win).reshape(
            -1, 1024)
    frames = framed()
    planf = T.create_plan(type="r2c", shape=[1024], batch=frames.shape[0], direction="forward",
                          normalize="none", device="cuda")
    row("stft (8, 2^22) nperseg 1024 noverlap 512", lambda: wfft.stft(sig, **FACADE_STFT),
        lambda: planf(frames),
        lambda: torch.stft(sig, n_fft=1024, hop_length=512, window=win, center=True,
                           pad_mode="constant", onesided=True, return_complex=True),
        "torch.stft", plans="plan(frames) on frames already made",
        staged=lambda: planf(framed()) / 512.0)
    del frames

    xc, k, geo = keep["conv"]
    planc = T.create_plan({"type": "fftconv", "shape": [1000, 1000], "batch": 8,
                           "fftConv": {"kernelShape": [25, 25], "boundary": "linear-same"}},
                          device="cuda")
    xi = torch.stack([xc, torch.zeros_like(xc)], -1)
    ki = torch.stack([k[0], torch.zeros_like(k[0])], -1)
    xz, kz = xc.to(torch.complex64), k[0].to(torch.complex64)
    row("fftconvolve same (8, 1000, 1000) * (25, 25)",
        lambda: wfft.fftconvolve(xc, k, mode="same", axes=(1, 2)),
        lambda: planc(xi, kernel=ki),
        lambda: torch_fft_conv(xz, kz, *geo, dtype=torch.complex64),
        "the same on torch.fft (complex64)")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# nufft and linalg (with the pipeline export)
# ---------------------------------------------------------------------------

NU_EPS = 1e-6
NU_TOL = 2e-5      # tests/test_nufft.py's bar for types 1 and 2 (_rel of max|ref|)
NU3_TOL = 1e-5     # ... and for type 3
NU_SUBSET = 512    # modes or targets held against the direct float64 sum
NU2_MODES, NU2_SPOKES, NU2_SAMPLES, NU2_COILS = (256, 256), 256, 512, 8
NU3_MODES, NU3_POINTS = (128, 128, 128), 1 << 18
# targets in [-NU1_BAND, NU1_BAND): a spread grid of 4116 and an inner fine grid of
# 8232.  The band was chosen so that the call reaches K1: a band of 2048 gives
# 16464, past K1's 16384, and runs on einsums with no kernel (ROADMAP R6).
# K1 takes >= 8 lines
NU1_POINTS, NU1_BAND, NU1_SETS = 1 << 16, 1024.0, 8
LA_TOL, LA_RES_TOL = 5e-4, 1e-4   # tests/test_linalg.py's bars (_rel; residual)
LA_CIRC = (16384, 512)            # n, right-hand sides
LA_MATMUL = (4097, 4096, 1024)    # rows, columns, right-hand sides: p = 8192
LA_SOLVE = (4096, 256)
PIPE_SHAPE, PIPE_STFT = (8, 1 << 20), dict(nperseg=1024, noverlap=512)
HEAVY = dict(runs=3, warmup=1)             # time_calls of a long call
HEAVY_QUEUED = dict(runs=2, queued=3, warmup=1)


class TorchFftFacade:
    """The port's ``fftapi`` with ``fft``/``ifft``/``fftn``/``ifftn`` on
    ``torch.fft`` (interleaved in and out, the same arguments): swapped into
    ``nufft`` and ``linalg`` it gives the yardstick, the same spread,
    interpolation and tables around cuFFT.  Every other name is the port's."""

    def __getattr__(self, name):
        from webgpufft_tpu_torch import fftapi
        return getattr(fftapi, name)

    @staticmethod
    def _call(fn, x, interleaved, **kw):
        from webgpufft_tpu_torch import fftapi
        z = torch.view_as_complex(fftapi.asinterleaved(x, interleaved).contiguous())
        return torch.view_as_real(fn(z, **kw))

    def fft(self, x, n=None, axis=-1, norm=None, *, interleaved=None):
        return self._call(torch.fft.fft, x, interleaved, n=n, dim=axis, norm=norm)

    def ifft(self, x, n=None, axis=-1, norm=None, *, interleaved=None):
        return self._call(torch.fft.ifft, x, interleaved, n=n, dim=axis, norm=norm)

    def fftn(self, x, s=None, axes=None, norm=None, *, interleaved=None):
        return self._call(torch.fft.fftn, x, interleaved, s=s, dim=axes, norm=norm)

    def ifftn(self, x, s=None, axes=None, norm=None, *, interleaved=None):
        return self._call(torch.fft.ifftn, x, interleaved, s=s, dim=axes, norm=norm)


class on_torch_fft:
    """Within the block, ``nufft`` and ``linalg`` transform on ``torch.fft``."""

    def __enter__(self):
        from webgpufft_tpu_torch import linalg, nufft
        self.saved = [(m, m.fftapi) for m in (nufft, linalg)]
        for m, _ in self.saved:
            m.fftapi = TorchFftFacade()

    def __exit__(self, *exc):
        for m, f in self.saved:
            m.fftapi = f


def radial_points(spokes, samples):
    """A radial k-space trajectory in radians: ``spokes`` lines through the
    centre at angles pi * s / spokes, ``samples`` points on each."""
    theta = np.pi * np.arange(spokes) / spokes
    r = np.linspace(-np.pi, np.pi, samples, endpoint=False)
    return ((r[None, :] * np.cos(theta)[:, None]).ravel(),
            (r[None, :] * np.sin(theta)[:, None]).ravel())


def cmcl(n):
    return torch.arange(-(n // 2), (n + 1) // 2, device="cuda", dtype=torch.float64)


def nu_check(label, got, ref, tol):
    """``got`` (complex) against the direct float64 sum ``ref``: max|got -
    ref| / max|ref|, as tests/test_nufft.py's ``_rel``."""
    torch.cuda.synchronize()
    require(bool(torch.isfinite(torch.view_as_real(got)).all()), f"{label}: non-finite output")
    err = rel_err(got.to(torch.complex128), ref)
    print(f"{label}: max rel err {err:.3e} vs the direct float64 sum on the card over "
          f"{ref.numel()} values (limit {tol:.0e} * max|ref|)")
    require(err < tol, f"{label}: disagrees with the direct sum")
    return err


def phase_nufft(gen):
    """Types 1 and 2 in 2-D (radial MRI k-space: 256 spokes x 512 samples, 8
    coils, 256^2 modes) and 3-D (2^18 points, 128^3 modes) and type 3 in 1-D
    (2^16 sources and targets, 8 strength sets), eps 1e-6, each call's K1/K2 launches
    asserted, each result against the direct float64 sum over 512 random
    modes or targets, and the type-1/type-2 dot test."""
    import webgpufft_tpu_torch as T
    nu = T.nufft
    rng = np.random.default_rng(SEED)
    keep = {}

    x, y = radial_points(NU2_SPOKES, NU2_SAMPLES)
    m = x.size
    c = torch.randn(NU2_COILS, m, 2, device="cuda", generator=gen)
    out = facade_call("nufft2d1 256^2 modes, 2^17 radial points x 8 coils", nu.nufft2d1,
                      x, y, c, NU2_MODES, eps=NU_EPS, expect=(1, 1))
    require(tuple(out.shape) == (NU2_COILS, *NU2_MODES, 2), f"nufft2d1: {tuple(out.shape)}")
    q = torch.as_tensor(rng.integers(0, NU2_MODES[0] * NU2_MODES[1], NU_SUBSET), device="cuda")
    k1 = cmcl(NU2_MODES[0])[q // NU2_MODES[1]]
    k2 = cmcl(NU2_MODES[1])[q % NU2_MODES[1]]
    xd, yd = (torch.as_tensor(v, device="cuda") for v in (x, y))
    cz = torch.view_as_complex(c).to(torch.complex128)
    ref = cz @ torch.exp(1j * (k1[:, None] * xd[None, :] + k2[:, None] * yd[None, :])).T
    got = torch.view_as_complex(out).reshape(NU2_COILS, -1)[:, q]
    keep["nufft2d1"] = nu_check("nufft2d1 against the direct sum", got, ref, NU_TOL)

    f = torch.randn(NU2_COILS, *NU2_MODES, 2, device="cuda", generator=gen)
    vals = facade_call("nufft2d2 256^2 modes x 8 coils, 2^17 radial points", nu.nufft2d2,
                       x, y, f, eps=NU_EPS, expect=(1, 1))
    require(tuple(vals.shape) == (NU2_COILS, m, 2), f"nufft2d2: {tuple(vals.shape)}")
    j = torch.as_tensor(rng.integers(0, m, NU_SUBSET), device="cuda")
    e1 = torch.exp(-1j * xd[j, None] * cmcl(NU2_MODES[0])[None, :])
    e2 = torch.exp(-1j * yd[j, None] * cmcl(NU2_MODES[1])[None, :])
    fz = torch.view_as_complex(f).to(torch.complex128)
    ref = torch.einsum("bkq,qk->bq", torch.einsum("bkl,ql->bkq", fz, e2), e1)
    keep["nufft2d2"] = nu_check("nufft2d2 against the direct sum",
                                torch.view_as_complex(vals)[:, j], ref, NU_TOL)
    # <A c, f> = <c, A^H f>: type 1 (isign +1) and type 2 (isign -1) are adjoint
    lhs = complex((fz.conj() * torch.view_as_complex(out).to(torch.complex128)).sum())
    rhs = complex((torch.view_as_complex(vals).to(torch.complex128).conj() * cz).sum())
    scale = float(fz.abs().pow(2).sum().sqrt() * torch.view_as_complex(out).abs().pow(2)
                  .sum().sqrt())
    print(f"nufft dot test: <f, A c> {lhs:.6e}, <A^H f, c> {rhs:.6e}, difference "
          f"{abs(lhs - rhs) / scale:.3e} of |f||A c| (limit {DOT_TOL:.0e})")
    require(abs(lhs - rhs) <= DOT_TOL * scale, "nufft: type 1 and type 2 are not adjoint")
    keep["2d"] = (x, y, c, f)
    del e1, e2, fz, cz, ref

    x3 = [rng.uniform(0, 2 * np.pi, NU3_POINTS) for _ in range(3)]
    c3 = torch.randn(NU3_POINTS, 2, device="cuda", generator=gen)
    out3 = facade_call("nufft3d1 128^3 modes, 2^18 points", nu.nufft3d1, *x3, c3, NU3_MODES,
                       eps=NU_EPS, expect=(1, 2))
    require(tuple(out3.shape) == (*NU3_MODES, 2), f"nufft3d1: {tuple(out3.shape)}")
    n3 = NU3_MODES[0]
    q = torch.as_tensor(rng.integers(0, n3 ** 3, NU_SUBSET), device="cuda")
    ks = [cmcl(n3)[q // (n3 * n3)], cmcl(n3)[(q // n3) % n3], cmcl(n3)[q % n3]]
    xs = [torch.as_tensor(v, device="cuda") for v in x3]
    phase = sum(k[:, None] * p[None, :] for k, p in zip(ks, xs))
    ref = torch.exp(1j * phase) @ torch.view_as_complex(c3).to(torch.complex128)
    del phase
    keep["nufft3d1"] = nu_check("nufft3d1 against the direct sum",
                                torch.view_as_complex(out3).reshape(-1)[q], ref, NU_TOL)
    f3 = torch.randn(*NU3_MODES, 2, device="cuda", generator=gen)
    vals3 = facade_call("nufft3d2 128^3 modes, 2^18 points", nu.nufft3d2, *x3, f3,
                        eps=NU_EPS, expect=(1, 2))
    require(tuple(vals3.shape) == (NU3_POINTS, 2), f"nufft3d2: {tuple(vals3.shape)}")
    j = torch.as_tensor(rng.integers(0, NU3_POINTS, NU_SUBSET), device="cuda")
    es = [torch.exp(-1j * p[j, None] * cmcl(n3)[None, :]) for p in xs]
    f3z = torch.view_as_complex(f3).to(torch.complex128)
    ref = torch.einsum("kq,qk->q", torch.einsum(
        "klq,ql->kq", torch.einsum("klm,qm->klq", f3z, es[2]), es[1]), es[0])
    keep["nufft3d2"] = nu_check("nufft3d2 against the direct sum",
                                torch.view_as_complex(vals3)[j], ref, NU_TOL)
    keep["3d"] = (x3, c3, f3)
    del es, f3z, xs, ref

    xt = rng.uniform(-np.pi, np.pi, NU1_POINTS)
    st = rng.uniform(-NU1_BAND, NU1_BAND, NU1_POINTS)
    ct = torch.randn(NU1_SETS, NU1_POINTS, 2, device="cuda", generator=gen)
    out1 = facade_call("nufft1d3 2^16 sources x 8 strength sets, 2^16 targets", nu.nufft1d3,
                       xt, ct, st, eps=NU_EPS, expect=(1, 0))
    q = torch.as_tensor(rng.integers(0, NU1_POINTS, NU_SUBSET), device="cuda")
    sd, xd1 = (torch.as_tensor(v, device="cuda") for v in (st, xt))
    ref = torch.view_as_complex(ct).to(torch.complex128) @ torch.exp(
        1j * sd[q, None] * xd1[None, :]).T
    keep["nufft1d3"] = nu_check("nufft1d3 against the direct sum",
                                torch.view_as_complex(out1)[:, q], ref, NU3_TOL)
    keep["1d3"] = (xt, ct, st)
    torch.cuda.empty_cache()
    return keep


def pipeline_fn(sig):
    """The exported pipeline: stft -> spectral mask -> istft."""
    from webgpufft_tpu_torch import fft as wfft
    _, _, z = wfft.stft(sig, **PIPE_STFT)
    z = z * ((z[..., 0] ** 2 + z[..., 1] ** 2) > 1e-3)[..., None]
    return wfft.istft(z, **PIPE_STFT)[1][..., :sig.shape[-1]]


def phase_linalg(gen):
    """solve_circulant, matmul_toeplitz and solve_toeplitz on the card, each
    against scipy.linalg in float64 on the host, and the export of
    stft -> mask -> istft: saved, loaded and called, against the eager
    call."""
    import scipy.linalg as sla
    import webgpufft_tpu_torch as T
    la = T.linalg
    keep = {}

    n, rhs = LA_CIRC
    c = 0.5 ** np.arange(n)
    b = torch.randn(n, rhs, device="cuda", generator=gen)
    x = facade_call(f"solve_circulant n={n}, {rhs} right-hand sides", la.solve_circulant, c, b,
                    expect=(2, 0))
    want = sla.solve_circulant(c, host64(b))
    check_close(f"solve_circulant n={n}", x, torch.as_tensor(want, device="cuda"),
                "scipy.linalg float64", tol=LA_TOL)
    keep["solve_circulant"] = (c, b)

    rows, cols, rhs = LA_MATMUL
    cc, rr = (torch.randn(k, device="cuda", generator=gen, dtype=torch.float64).cpu().numpy()
              for k in (rows, cols))
    xm = torch.randn(cols, rhs, device="cuda", generator=gen)
    y = facade_call(f"matmul_toeplitz ({rows} x {cols}) @ ({cols}, {rhs})", la.matmul_toeplitz,
                    (cc, rr), xm, expect=(2, 0))
    want = sla.matmul_toeplitz((cc, rr), host64(xm))
    check_close(f"matmul_toeplitz ({rows} x {cols})", y, torch.as_tensor(want, device="cuda"),
                "scipy.linalg float64", tol=LA_TOL)
    keep["matmul_toeplitz"] = ((cc, rr), xm)

    n, rhs = LA_SOLVE
    ct = 0.5 ** np.arange(n)
    bt = torch.randn(n, rhs, device="cuda", generator=gen)
    xt = facade_call(f"solve_toeplitz n={n}, {rhs} right-hand sides", la.solve_toeplitz, ct, bt,
                     expect=(4, 0))
    bh = host64(bt)
    want = sla.solve_toeplitz(ct, bh)
    check_close(f"solve_toeplitz n={n}", xt, torch.as_tensor(want, device="cuda"),
                "scipy.linalg float64", tol=LA_TOL)
    res = sla.matmul_toeplitz(ct, host64(xt)) - bh
    err = float(np.abs(res).max() / np.abs(bh).max())
    print(f"solve_toeplitz n={n}: residual |T x - b| {err:.3e} of max|b| "
          f"(limit {LA_RES_TOL:.0e})")
    require(err < LA_RES_TOL, "solve_toeplitz: the solution does not solve the system")
    keep["solve_toeplitz"] = (ct, bt)

    sig = torch.randn(*PIPE_SHAPE, device="cuda", generator=gen)
    t0 = time.perf_counter()
    blob = T.export_pipeline(pipeline_fn, sig)
    secs = time.perf_counter() - t0
    pipe = T.load_exported_pipeline(blob)
    code = pipe.program.graph_module.code
    print(f"pipeline export stft -> mask -> istft (8, 2^20): {len(blob)} bytes in "
          f"{secs:.2f} s, platforms {pipe.platforms}, shapes {pipe.shapes}; the program calls "
          f"wgfft::fused_lines {code.count('torch.ops.wgfft.fused_lines')} times, "
          f"wgfft::fused_cols {code.count('torch.ops.wgfft.fused_cols')} times")
    require(pipe.platforms == ("cuda",), f"pipeline: platforms {pipe.platforms}")
    got = facade_call("loaded pipeline call", pipe, sig)
    want = pipeline_fn(sig)
    torch.cuda.synchronize()
    err = abs_err(got, want)
    print(f"loaded pipeline: max abs err {err:.3e} vs the eager call (limit 1e-06)")
    require(tuple(got.shape) == tuple(want.shape) and err < 1e-6,
            "loaded pipeline disagrees with the eager call")
    keep["pipeline"] = (pipe, sig)
    torch.cuda.empty_cache()
    return keep


def timed_pair(label, port, yardstick, what, card):
    """A new call from idle and queued beside its yardstick, both ways;
    returns the port's idle ms."""
    pm = profile.median(profile.time_calls(port, **HEAVY))
    ym = profile.median(profile.time_calls(yardstick, **HEAVY))
    pq = profile.median(profile.time_queued(port, **HEAVY_QUEUED))
    yq = profile.median(profile.time_queued(yardstick, **HEAVY_QUEUED))
    print(f"time {label}: port {pm:.4f} ms idle / {pq:.4f} ms queued; {what} {ym:.4f} ms "
          f"idle / {yq:.4f} ms queued [{card}]")
    return pm


def nufft_split(label, points, ns, eps, isign, b, card, strengths=None, modes=None):
    """Device time of each stage of one type-1 (``strengths``) or type-2
    (``modes``) call: spread, fine-grid FFT, interpolation, and what the
    mode extraction / placement and deconvolution add."""
    from webgpufft_tpu_torch import nufft as nu
    msp, mrs, hs, taus, total = nu._geometry(ns, eps)
    pts = nu._points_nd(*points)
    axes = tuple(range(1, len(ns) + 1)) if len(ns) > 1 else None
    grid = torch.randn(b, *mrs, 2, device="cuda")

    def q(fn):
        return profile.median(profile.time_queued(fn, **HEAVY_QUEUED))
    fft_ms = q(lambda: nu._fine_dft(grid, isign, axes))
    if strengths is not None:
        ci, _ = nu._as_strengths(strengths, pts[0].shape[0], strengths.device)
        spread = q(lambda: nu._spread(ci, pts, hs, taus, msp, mrs, total))
        tail = q(lambda: nu._modes_from_grid(grid.reshape(b, -1, 2), ns, mrs, hs, taus, isign))
        print(f"time {label} split: spread (index_add) {spread:.4f} ms, fine-grid FFT "
              f"{fft_ms:.4f} ms, FFT + mode extraction + deconvolution {tail:.4f} ms "
              f"(queued device time; {mrs} fine grid x {b}, {(2 * msp) ** len(ns)} taps a point, "
              f"{nu._point_step(b, pts[0].shape[0], (2 * msp) ** len(ns))} points a chunk) [{card}]")
        return {"spread_ms": spread, "fft_ms": fft_ms, "tail_ms": tail}
    fb, _, _ = nu._as_modes(modes, len(ns), modes.device)
    head = q(lambda: nu._grid_from_modes(fb, ns, mrs, hs, taus, isign))
    interp = q(lambda: nu._interp(grid.reshape(b, -1, 2), pts, hs, taus, msp, mrs))
    print(f"time {label} split: deconvolution + mode placement + fine-grid FFT {head:.4f} ms, "
          f"fine-grid FFT {fft_ms:.4f} ms, interpolation (gather) {interp:.4f} ms "
          f"(queued device time) [{card}]")
    return {"head_ms": head, "fft_ms": fft_ms, "interp_ms": interp}


def phase_nufft_timing(keep, card):
    import webgpufft_tpu_torch as T
    nu = T.nufft
    x, y, c, f = keep["2d"]
    x3, c3, f3 = keep["3d"]
    xt, ct, st = keep["1d3"]
    what = "the same spread/interp around torch.fft"
    for label, fn in [
            ("nufft2d1 256^2, 2^17 points x 8", lambda: nu.nufft2d1(x, y, c, NU2_MODES)),
            ("nufft2d2 256^2 x 8, 2^17 points", lambda: nu.nufft2d2(x, y, f)),
            ("nufft3d1 128^3, 2^18 points", lambda: nu.nufft3d1(*x3, c3, NU3_MODES)),
            ("nufft3d2 128^3, 2^18 points", lambda: nu.nufft3d2(*x3, f3)),
            ("nufft1d3 2^16 -> 2^16 x 8", lambda: nu.nufft1d3(xt, ct, st))]:
        def yard(fn=fn):
            with on_torch_fft():
                return fn()
        check_close(f"{label}: the yardstick", yard(), fn(), "the port")
        timed_pair(label, fn, yard, what, card)
    nufft_split("nufft2d1 256^2, 2^17 points x 8", (x, y), NU2_MODES, NU_EPS, 1, NU2_COILS, card,
                strengths=c)
    nufft_split("nufft2d2 256^2 x 8, 2^17 points", (x, y), NU2_MODES, NU_EPS, -1, NU2_COILS, card,
                modes=f)
    nufft_split("nufft3d1 128^3, 2^18 points", x3, NU3_MODES, NU_EPS, 1, 1, card, strengths=c3)
    nufft_split("nufft3d2 128^3, 2^18 points", x3, NU3_MODES, NU_EPS, -1, 1, card, modes=f3)
    torch.cuda.empty_cache()


def phase_linalg_timing(keep, card):
    import scipy.linalg as sla
    import webgpufft_tpu_torch as T
    la = T.linalg
    what = "the same on torch.fft"
    c, b = keep["solve_circulant"]
    timed_pair("solve_circulant n=16384 x 512", lambda: la.solve_circulant(c, b),
               lambda: yard_call(la.solve_circulant, c, b), what, card)
    op, xm = keep["matmul_toeplitz"]
    timed_pair("matmul_toeplitz (4097 x 4096) @ (4096, 1024)", lambda: la.matmul_toeplitz(op, xm),
               lambda: yard_call(la.matmul_toeplitz, op, xm), what, card)
    ct, bt = keep["solve_toeplitz"]
    timed_pair("solve_toeplitz n=4096 x 256", lambda: la.solve_toeplitz(ct, bt),
               lambda: yard_call(la.solve_toeplitz, ct, bt), what, card)
    dense = torch.as_tensor(sla.toeplitz(ct), device="cuda", dtype=torch.float32)
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for the dense solve")
    dm = profile.median(profile.time_calls(torch.linalg.solve, dense, bt, **HEAVY))
    dq = profile.median(profile.time_queued(torch.linalg.solve, dense, bt, **HEAVY_QUEUED))
    err = rel_err(torch.linalg.solve(dense, bt), la.solve_toeplitz(ct, bt))
    print(f"time solve_toeplitz n=4096 x 256: torch.linalg.solve on the dense matrix (f32, TF32 "
          f"off) {dm:.4f} ms idle / {dq:.4f} ms queued; its max rel err vs the port's "
          f"{err:.3e} [{card}]")
    pipe, sig = keep["pipeline"]
    timed_pair("pipeline stft -> mask -> istft (8, 2^20)", lambda: pipe(sig),
               lambda: pipeline_fn(sig), "the eager facade calls", card)
    torch.cuda.empty_cache()


def yard_call(fn, *args):
    with on_torch_fft():
        return fn(*args)


# ---------------------------------------------------------------------------
# signal: the DSP toolboxes (filtering, splines, ndimage, ltisys)
# ---------------------------------------------------------------------------

SIG_SHAPE = (8, 1 << 22)          # the facade's stft signal: 8 channels of 2^22 samples
SIG_SUBSET = [0, 5]               # channels held against scipy in float64 on the host
SIG_IMAGE = (2048, 2048)
SIG_SPECTRA = (8, 1024, 1024)
SIG_SYMIIR = (64, 1 << 16)
SIG_EVAL_POINTS = 1 << 20
SIG_SS = (8, 2, 10 ** 4)          # states, inputs, steps of the simulated system
SIG_FREQZ_N = 1 << 16
SIG_PRECISION = 1e-6              # the spline boundary sums' truncation, both sides
# bars, as fractions of max|ref|: the JAX package's tests' (tests/test_filtering.py,
# test_splines.py, test_ndimage.py, test_ltisys.py, test_iirdesign.py:211)
SIG_TOL = {"filter": 1e-5, "filtfilt": 5e-4, "sosfiltfilt": 5e-4, "wiener": 1e-4,
           "spline": 1e-5, "smoothing spline": 1e-4, "ndimage": 3e-5, "freqz": 3e-5,
           "lsim": 2e-4, "response": 5e-4, "example": 1e-5}
# the (K1, K2) launches of each call of the signal path that runs the plan
# layer (the calls that launch none are marked in phase_signal): overlap-save
# blocks forward and back on K1; fft2 / ifft2 one K2 pass (axis 1) and one K1
# pass (axis 2) each
SIGNAL_LAUNCHES = {
    "lfilter firwin(129, 0.2), (8, 2^22)": (2, 0),
    "savgol_filter 101, 3, interp, (8, 2^22)": (2, 0),
    "spline_filter lmbda 5, (2048, 2048)": (3, 0),
    "fft2 (8, 1024, 1024)": (1, 1),
    **{f"ifft2 after {name}": (1, 1) for name in ("fourier_gaussian", "fourier_uniform",
                                                   "fourier_ellipsoid", "fourier_shift")}}
IIR_AB_N = [1 << k for k in range(3, 15)]   # the gate's A/B: 2^3 .. 2^14 samples
IIR_AB_LINES = 8


def sig_check(label, got, want, tol):
    """A card result (tensor, or numpy from a host-returning call) against
    a float64 host reference: max|got - want| / max|want| <= tol."""
    torch.cuda.synchronize()
    g = got.detach().double().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float64)
    want = np.asarray(want)
    if np.iscomplexobj(want):
        g = g[..., 0] + 1j * g[..., 1]
    require(g.shape == want.shape, f"{label}: shape {g.shape}, expected {want.shape}")
    require(bool(np.isfinite(g).all()), f"{label}: non-finite output")
    err = float(np.abs(g - want).max() / max(np.abs(want).max(), 1e-30))
    print(f"signal {label}: max rel err {err:.3e} vs scipy float64 on the host "
          f"(limit {tol:.0e} * max|ref|)")
    require(err <= tol, f"signal {label}: disagrees with scipy")
    return err


def sig_call(label, fn, *args, none=False, **kw):
    """One call of the signal path with its own (K1, K2) count: (0, 0) for
    a call marked ``none``, else pinned by SIGNAL_LAUNCHES; the TF32 flag the
    path switched on must be on again after it (the library scopes it off
    for its products only)."""
    out = facade_call(label, fn, *args, expect=(0, 0) if none else SIGNAL_LAUNCHES.get(label),
                      **kw)
    require(torch.backends.cuda.matmul.allow_tf32, f"{label}: left TF32 switched off")
    return out


def host_ms(fn, *args, **kw):
    """(result, ms) of one host call (scipy on the host's CPU)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, (time.perf_counter() - t0) * 1e3


def stable_system(rng, states, inputs, outputs):
    """A random continuous system whose slowest pole has real part -0.5."""
    M = rng.standard_normal((states, states))
    A = M - (np.linalg.eigvals(M).real.max() + 0.5) * np.eye(states)
    return (A, rng.standard_normal((states, inputs)), rng.standard_normal((outputs, states)),
            np.zeros((outputs, inputs)))


def phase_signal(gen):
    """The DSP toolboxes at full size on the card, TF32 switched ON around
    the path (the library scopes it off around its own products), each call's
    K1/K2 launches counted and each result against scipy in float64 on the
    host: returns what the timing phase needs."""
    import scipy.ndimage as ndi
    import scipy.signal as ss
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch import fft as wfft
    from webgpufft_tpu_torch.examples import control_toolkit
    F, SP, N, L = T.filtering, T.splines, T.ndimage, T.ltisys
    rng = np.random.default_rng(SEED)
    keep, scipy_ms = {}, {}
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        # -- the (8, 2^22) signal: IIR on the recurrences, FIR on the plan layer's
        # convolution.  The IIR calls launch nothing (0, 0): their recurrence is
        # torch products and adds, the parallel prefix above IIR_ASSOC_MIN_N_CUDA
        x = torch.randn(*SIG_SHAPE, device="cuda", generator=gen)
        xh = host64(x[SIG_SUBSET])
        sos8 = F.butter(8, 0.1, output="sos")
        ba4 = F.butter(4, 0.2)
        fir = F.firwin(129, 0.2)
        calls = [
            ("sosfilt butter(8, 0.1) sos, (8, 2^22)", "filter", True,
             lambda: F.sosfilt(sos8, x), lambda: ss.sosfilt(sos8, xh)),
            ("sosfiltfilt butter(8, 0.1) sos, (8, 2^22)", "sosfiltfilt", True,
             lambda: F.sosfiltfilt(sos8, x), lambda: ss.sosfiltfilt(sos8, xh)),
            ("filtfilt butter(4, 0.2) ba, (8, 2^22)", "filtfilt", True,
             lambda: F.filtfilt(*ba4, x), lambda: ss.filtfilt(*ba4, xh)),
            ("lfilter firwin(129, 0.2), (8, 2^22)", "filter", False,
             lambda: F.lfilter(fir, 1.0, x), lambda: ss.lfilter(fir, 1.0, xh)),
            ("savgol_filter 101, 3, interp, (8, 2^22)", "filter", False,
             lambda: F.savgol_filter(x, 101, 3), lambda: ss.savgol_filter(xh, 101, 3))]
        for label, bar, none, port, oracle in calls:
            y = sig_call(label, port, none=none)
            want, scipy_ms[label] = host_ms(oracle)
            sig_check(label, y[SIG_SUBSET], want, SIG_TOL[bar])
            keep[label] = port
            del y
        keep["signal"] = (x, sos8, fir)

        # -- the (2048, 2048) image.  cspline2d's recurrences and medfilt2d's
        # sort are torch ops (0, 0); the box sums of wiener are a plan-layer
        # convolution at the exact linear length 2048 + 4 = 2052 = 2^2 * 3^3 *
        # 19 on both axes, which K1/K2 do not take (smooth lengths only): the
        # plan runs Bluestein einsums, as the JAX package does, and launches
        # nothing (ROADMAP R8); spline_filter's separable FIR reaches K1 only
        # in part of its two convolutions
        img = torch.randn(*SIG_IMAGE, device="cuda", generator=gen)
        ih = host64(img)
        for label, bar, none, port, oracle in [
                ("wiener 5 x 5, (2048, 2048)", "wiener", True,
                 lambda: F.wiener(img, (5, 5)), lambda: ss.wiener(ih, (5, 5))),
                ("cspline2d lamb 0, (2048, 2048)", "spline", True,
                 lambda: SP.cspline2d(img, 0.0, SIG_PRECISION),
                 lambda: ss.cspline2d(ih, 0.0, SIG_PRECISION)),
                ("cspline2d lamb 0.5, (2048, 2048)", "smoothing spline", True,
                 lambda: SP.cspline2d(img, 0.5, SIG_PRECISION),
                 lambda: ss.cspline2d(ih, 0.5, SIG_PRECISION)),
                ("spline_filter lmbda 5, (2048, 2048)", "smoothing spline", False,
                 lambda: SP.spline_filter(img), lambda: ss.spline_filter(ih))]:
            y = sig_call(label, port, none=none)
            want, scipy_ms[label] = host_ms(oracle)
            sig_check(label, y, want, SIG_TOL[bar])
            keep[label] = port
        label = "medfilt2d 5 x 5, (2048, 2048)"
        y = sig_call(label, F.medfilt2d, img, 5, none=True)
        want, scipy_ms[label] = host_ms(ss.medfilt2d, ih.astype(np.float32), 5)
        torch.cuda.synchronize()
        diff = int((y.cpu().numpy() != want).sum())
        print(f"signal {label}: {diff} elements differ from scipy.signal.medfilt2d "
              "(order statistics are exact: limit 0)")
        require(diff == 0, f"signal {label}: differs from scipy")
        keep[label] = lambda: F.medfilt2d(img, 5)

        # -- Fourier-domain filters on fft2 spectra: the filters are table
        # multiplies (0, 0); fft2 and ifft2 launch K1/K2
        img8 = torch.randn(*SIG_SPECTRA, device="cuda", generator=gen)
        X = sig_call("fft2 (8, 1024, 1024)", wfft.fft2, img8)
        Xh = host64(X)
        Xh = Xh[..., 0] + 1j * Xh[..., 1]
        for name, arg in [("fourier_gaussian", (0.0, 4.0, 4.0)),
                          ("fourier_uniform", (1.0, 9.0, 5.0)),
                          ("fourier_ellipsoid", (1.0, 8.0, 8.0)),
                          ("fourier_shift", (0.0, 3.5, -2.25))]:
            label = f"{name} {arg} on fft2 (8, 1024, 1024)"
            Y = sig_call(label, getattr(N, name), X, arg, none=True)
            want = getattr(ndi, name)(Xh, arg)
            sig_check(label, Y, want, SIG_TOL["ndimage"])
            back = sig_call(f"ifft2 after {name}", wfft.ifft2, Y)
            sig_check(f"ifft2 after {name}", back, np.fft.ifft2(want), SIG_TOL["ndimage"])
            keep[label] = (getattr(N, name), X, arg)
            del Y, back
        del Xh

        # -- splines: the symmetric IIR smoothers and the prefilter run the
        # recurrences, the evaluation a gather: none launches a kernel
        s64 = torch.randn(*SIG_SYMIIR, device="cuda", generator=gen)
        sh = host64(s64)
        sig1 = s64[0]
        for label, port, oracle in [
                ("symiirorder1 c0 2, z1 0.4, (64, 2^16)",
                 lambda: SP.symiirorder1(s64, 2.0, 0.4, SIG_PRECISION),
                 lambda: ss.symiirorder1(sh, 2.0, 0.4, SIG_PRECISION)),
                ("symiirorder2 r 0.5, omega 0.3, (64, 2^16)",
                 lambda: SP.symiirorder2(s64, 0.5, 0.3, SIG_PRECISION),
                 lambda: ss.symiirorder2(sh, 0.5, 0.3, SIG_PRECISION)),
                ("cspline1d 2^16", lambda: SP.cspline1d(sig1), lambda: ss.cspline1d(sh[0]))]:
            y = sig_call(label, port, none=True)
            want, scipy_ms[label] = host_ms(oracle)
            sig_check(label, y, want, SIG_TOL["spline"])
            keep[label] = port
        cj = SP.cspline1d(sig1)
        # positions drawn as float32 values: the evaluation runs at float32
        # positions (as the JAX package's), after a float64 mirror fold that is
        # exact on them, so scipy sees the same points
        newx = rng.uniform(-10.0, SIG_SYMIIR[1] + 10.0, SIG_EVAL_POINTS).astype(np.float32)
        newx = newx.astype(np.float64)
        label = "cspline1d_eval at 2^20 points"
        y = sig_call(label, SP.cspline1d_eval, cj, newx, none=True)
        want, scipy_ms[label] = host_ms(ss.cspline1d_eval, host64(cj), newx)
        sig_check(label, y, want, SIG_TOL["spline"])
        keep[label] = lambda: SP.cspline1d_eval(cj, newx)

        # -- state space (control simulation): numpy in and out, the recurrence
        # on the card, two launches of torch ops a step and no kernel of the port
        states, inputs, steps = SIG_SS
        sysc = stable_system(rng, states, inputs, inputs)
        Tt = np.linspace(0.0, 20.0, steps)
        U = np.stack([np.sin(2 * np.pi * 0.3 * Tt), np.sign(np.sin(Tt))], -1)
        label = f"lsim {states} states, {inputs} inputs, {steps} steps"
        _, yl, xl = sig_call(label, L.lsim, sysc, U, Tt, none=True)
        (_, ye, xe), scipy_ms[label] = host_ms(ss.lsim, sysc, U, Tt)
        sig_check(label + " y", yl, ye, SIG_TOL["lsim"])
        sig_check(label + " x", xl, xe, SIG_TOL["lsim"])
        keep[label] = (lambda: L.lsim(sysc, U, Tt), steps)
        sysd = L.cont2discrete(sysc, float(Tt[1] - Tt[0]))
        label = f"dlsim {states} states, {inputs} inputs, {steps} steps"
        _, yd, xd = sig_call(label, L.dlsim, sysd, U, none=True)
        (_, ye, xe), scipy_ms[label] = host_ms(ss.dlsim, sysd, U)
        sig_check(label + " y", yd, ye, SIG_TOL["lsim"])
        sig_check(label + " x", xd, xe, SIG_TOL["lsim"])
        keep[label] = (lambda: L.dlsim(sysd, U), steps)
        siso = (sysc[0], sysc[1][:, :1], sysc[2][:1], sysc[3][:1, :1])
        for name in ("step", "impulse"):
            label = f"{name} {states} states, defaults"
            t_, y_ = sig_call(label, getattr(L, name), siso, none=True)
            (te, ye), scipy_ms[label] = host_ms(getattr(ss, name), siso)
            sig_check(label, y_, ye, SIG_TOL["response"])
            require(np.allclose(t_, te), f"{label}: time grid differs from scipy's")

        # -- analysis: freqz's integer grid is one FFT of 2 * 2^16 points on a
        # single line, a length K1 does not take (N <= 16384): the plan runs the
        # four-step einsum route (ROADMAP R6), so these calls launch nothing
        label = "freqz firwin(129, 0.2), worN 2^16"
        w, h = sig_call(label, F.freqz, fir, worN=SIG_FREQZ_N, none=True)
        (we, he), scipy_ms[label] = host_ms(ss.freqz, fir, worN=SIG_FREQZ_N)
        require(np.allclose(w, we), f"{label}: grid differs")
        sig_check(label, h, he, SIG_TOL["freqz"])
        label = "sosfreqz butter(8, 0.1), worN 2^16"
        w, h = sig_call(label, F.sosfreqz, sos8, worN=SIG_FREQZ_N, none=True)
        (we, he), scipy_ms[label] = host_ms(ss.sosfreqz, sos8, worN=SIG_FREQZ_N)
        sig_check(label, h, he, SIG_TOL["freqz"])

        # -- the example, on the card against the same workflow on the CPU.  It
        # launches nothing: its two FIR convolutions of a 4000-sample signal
        # have full lengths 4120 and 4092, which the plan layer transforms on
        # its Bluestein einsum route (as the JAX package does; K1 takes smooth
        # lengths only), and the rest is recurrences and host design
        ex = sig_call("examples.control_toolkit", control_toolkit.run, "cuda", False, none=True)
        ref = control_toolkit.run("cpu", verbose=False)
        for name in ("y_ellip", "y_remez", "y_kaiser", "y_open", "y_closed", "yd"):
            got = ex[name].cpu() if isinstance(ex[name], torch.Tensor) else ex[name]
            want = ref[name].numpy() if isinstance(ref[name], torch.Tensor) else ref[name]
            sig_check(f"examples.control_toolkit {name} (card against the CPU run)",
                      got, want, SIG_TOL["example"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    keep["scipy_ms"] = scipy_ms
    torch.cuda.empty_cache()
    return keep


def phase_iir_ab(card):
    """The IIR gate's A/B: the sequential loop and the parallel prefix, K = 2
    and 4 (butter(K, 0.2) in ba form), on IIR_AB_LINES lines at each length
    of IIR_AB_N, from an idle device, each against scipy in float64.  The
    crossover is the shortest length from which the prefix wins at every
    longer one; the module's IIR_ASSOC_MIN_N_CUDA is set from it."""
    import scipy.signal as ss
    from webgpufft_tpu_torch import filtering as F
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    crossovers = {}
    for K in (2, 4):
        b, a = ss.butter(K, 0.2)
        wins = []
        for n in IIR_AB_N:
            x = torch.randn(IIR_AB_LINES, n, device="cuda", generator=gen)
            z0 = torch.zeros(IIR_AB_LINES, K, device="cuda")
            want = ss.lfilter(b, a, host64(x))
            runs = dict(runs=3, warmup=1) if n >= 1 << 12 else dict(runs=9, warmup=2)
            row = {}
            for route, fn in (("seq", F._iir_seq), ("assoc", F._iir_assoc)):
                ms = profile.median(profile.time_calls(fn, b, a, x, z0, **runs))
                y, _ = fn(b, a, x, z0)
                torch.cuda.synchronize()
                err = float(np.abs(host64(y) - want).max() / np.abs(want).max())
                row[route] = (ms, err)
            wins.append(row["assoc"][0] < row["seq"][0])
            print(f"iir A/B K={K} n={n} x {IIR_AB_LINES}: sequential {row['seq'][0]:.4f} ms "
                  f"({row['seq'][0] * 1e3 / n:.2f} us/sample, err {row['seq'][1]:.3e}), "
                  f"parallel prefix {row['assoc'][0]:.4f} ms (err {row['assoc'][1]:.3e}) [{card}]")
        cross = next((n for i, n in enumerate(IIR_AB_N) if all(wins[i:])), None)
        crossovers[K] = cross
        print(f"iir A/B K={K}: the parallel prefix wins from n = {cross} on [{card}]")
    print(f"iir gate: IIR_ASSOC_MIN_N_CUDA = {F.IIR_ASSOC_MIN_N_CUDA} in the module; this run's "
          f"crossovers {crossovers} [{card}]")
    return crossovers


def phase_signal_timing(keep, card):
    """Each call of the signal path from idle and queued beside scipy's host
    time on the subset it was checked on; the FIR calls beside a torch.fft
    convolution; one section of the parallel prefix at full size; lsim's ms a
    step; K1's share of the FIR call."""
    from webgpufft_tpu_torch import filtering as F
    from webgpufft_tpu_torch.core import fused
    scipy_ms = keep.pop("scipy_ms")
    x, sos8, fir = keep.pop("signal")
    for label, item in keep.items():
        if isinstance(item, tuple) and len(item) == 2:      # a simulation: (call, steps)
            fn, steps = item
            ms = profile.median(profile.time_calls(fn, **HEAVY))
            print(f"time signal {label}: {ms:.4f} ms idle, {ms / steps * 1e3:.3f} us a step; "
                  f"scipy {scipy_ms[label]:.4f} ms on the host [{card}]")
            continue
        if isinstance(item, tuple):                          # a Fourier filter: (fn, X, arg)
            fn, X, arg = item
            item = (lambda fn=fn, X=X, arg=arg: fn(X, arg))
        ms = profile.median(profile.time_calls(item, **HEAVY))
        q = profile.median(profile.time_queued(item, **HEAVY_QUEUED))
        extra = (f"; scipy {scipy_ms[label]:.4f} ms on the host"
                 f"{' for channels ' + str(SIG_SUBSET) if '(8, 2^22)' in label else ''}"
                 if label in scipy_ms else "")
        print(f"time signal {label}: {ms:.4f} ms idle / {q:.4f} ms queued{extra} [{card}]")
    # the FIR call beside one torch.fft convolution of the same signal
    n = x.shape[-1]
    nfft = 1 << (n + fir.size - 1).bit_length()
    h = torch.as_tensor(fir, device="cuda", dtype=torch.float32)

    def torch_fft_fir():
        return torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(h, nfft), nfft)[..., :n]
    check_close("lfilter FIR: the torch.fft yardstick", torch_fft_fir(), F.lfilter(fir, 1.0, x),
                "the port")
    timed_pair("lfilter firwin(129, 0.2), (8, 2^22)", lambda: F.lfilter(fir, 1.0, x),
               torch_fft_fir, "one torch.fft rfft convolution", card)
    # K1's share of the FIR call: its launches' shapes and tables, each timed alone
    seen = {}
    fused.fused_lines.seen = seen
    try:
        _, made = counted(F.lfilter, fir, 1.0, x)
    finally:
        fused.fused_lines.seen = None
    k1_ms = 0.0
    for (nn, lines, adjoint, _), tables in seen.items():
        xin = torch.randn(lines, nn, 2, device="cuda")
        k1_ms += profile.median(profile.time_queued(
            lambda: fused.fused_lines(xin, tables, adjoint=adjoint), **HEAVY_QUEUED))
        del xin
    call_q = profile.median(profile.time_queued(F.lfilter, fir, 1.0, x, **HEAVY_QUEUED))
    print(f"time signal lfilter FIR: K1 {made[0]} launches at {len(seen)} shapes "
          f"{sorted((k[0], k[1]) for k in seen)}, {k1_ms:.4f} ms of the call's {call_q:.4f} ms "
          f"queued ({k1_ms / call_q:.3f}) [{card}]")
    # one section of the parallel prefix and of the sequential loop's first
    # samples at full size
    b, a = sos8[0, :3], sos8[0, 3:]
    z0 = torch.zeros(x.shape[0], 2, device="cuda")
    ms = profile.median(profile.time_calls(F._iir_assoc, b, a, x, z0, **HEAVY))
    q = profile.median(profile.time_queued(F._iir_assoc, b, a, x, z0, **HEAVY_QUEUED))
    print(f"time signal parallel prefix, one section (K = 2) of (8, 2^22): {ms:.4f} ms idle / "
          f"{q:.4f} ms queued, {(n - 1).bit_length()} levels [{card}]")
    del seen
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# distributed (the multi-GPU layer at world size 1 on NCCL)
# ---------------------------------------------------------------------------

# the (K1, K2) launches of each distributed call: the dp case and the calls
# whose local stages are the port's plans or facade (the halo convolutions'
# local fftconv plan, the STFT family's rfft / irfft, the NUFFT fine grid);
# (0, 0) where the JAX route is einsums (every four-step digit stage and
# riding axis)
DIST_LAUNCHES = {
    "dp headline [1024] x 4096": (1, 0),
    "sp c2c [2^22] x 8": (0, 0),
    "sp c2c Bluestein [1048573] x 2": (0, 0),
    "poisson3d 256^3 slab": (0, 0),
    "poisson3d 256^3 pencil": (0, 0),
    "NS-3D step 256^3 slab": (0, 0),
    "NS-3D step 256^3 pencil": (0, 0),
    "NS-2D 2048^2 slab, 4 steps": (0, 0),
    "dct2 [512, 512] x 8": (0, 0),
    "dst3 [512, 512] x 8": (0, 0),
    "dct4 [32768] x 32": (0, 0),
    "fftconv [1000, 1000] x 8 * 25^2 linear-same, sp (halo)": (3, 3),
    "fftconv [1000, 1000] x 8 * 25^2 linear-same, pencil": (0, 0),
    "fftconv [2^22] x 8 * 129 linear-same, halo": (2, 0),
    "stft (8, 2^22)": (1, 0),
    "istft (8, 2^22)": (1, 0),
    "welch (8, 2^22)": (1, 0),
    "csd (8, 2^22)": (2, 0),
    "nufft type 1, 256^2 modes, 2^17 radial points x 8 coils": (1, 1),
    "nufft type 2, 256^2 modes x 8 coils, 2^17 radial points": (1, 1),
    "nufft type 3, 2^16 sources x 8 sets, 2^16 targets": (1, 0),
}
DIST_NS2D = (2048, 1e-3, 1e-3, 4)      # n, nu, dt, steps
DIST_STFT = dict(nperseg=1024, noverlap=512)
DIST_NS_TOL = 1e-4                      # the examples' bar for a trajectory


def dist_world():
    """A one-rank NCCL world in this process, on cuda:0; a failed init
    raises (nothing falls back to gloo or to the CPU)."""
    import datetime
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev, timeout=datetime.timedelta(seconds=60))
    require(dist.get_backend() == "nccl", f"distributed: backend {dist.get_backend()}")
    print(f"distributed: NCCL world of {dist.get_world_size()} rank on {dev}")


def dist_case(keep, label, dist_fn, single_fn, what, tol=TOL, oracle=None):
    """One distributed call (its launches pinned by DIST_LAUNCHES) held
    against the single-device call of the same spec on the same input, and
    against ``oracle`` (a torch.fft result or the signal) where given.
    Keeps both calls, and what they read, for the timing phase."""
    y, made = counted(dist_fn)
    want = DIST_LAUNCHES[label]
    print(f"distributed {label}: launches fused_lines {made[0]}, fused_cols {made[1]} "
          f"(expected {want[0]}, {want[1]})")
    require(made == want, f"distributed {label}: launches {made}")
    ref = single_fn()
    check_close(f"distributed {label}", y, ref, what, tol=tol)
    if oracle is not None:
        check_close(f"distributed {label}", y, oracle[0], oracle[1], tol=tol)
    keep.append((label, dist_fn, single_fn))
    return y


def ns_rhs(label, step_d, step_s, state):
    """A distributed NS stepper against the single-device one by its
    right-hand side (the nonlinear term the transforms make, without the
    viscous factor that dominates a step), at 1e-5 of its own max."""
    check_close(f"distributed {label} right-hand side", step_d.rhs(state),
                step_s.rhs(state), "the single-device right-hand side", tol=1e-5)


def phase_distributed(gen):
    """The sixteenth path: ``parallel/`` at world size 1 on NCCL, each
    case at full size through ``create_distributed_plan`` or a builder,
    held against the single-device plan of the same spec on the same
    tensor (and ``torch.fft`` where the function is a plain transform)."""
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch import fft as wfft
    from webgpufft_tpu_torch.examples import navier_stokes2d as ns2
    from webgpufft_tpu_torch.examples import navier_stokes3d as ns3
    from webgpufft_tpu_torch.examples import poisson3d
    from webgpufft_tpu_torch.parallel import (build_distributed_csd, build_distributed_istft,
                                              build_distributed_stft, build_distributed_welch,
                                              create_distributed_plan, make_mesh, nufft as pnu,
                                              sharded)
    dist_world()
    sp = make_mesh({"sp": 1})
    dp = make_mesh({"dp": 1})
    pen = make_mesh({"sp1": 1, "sp2": 1})
    require(sp.device_type == "cuda", "distributed: the mesh is not on the card")
    keep = []

    def plan_pair(opts, mesh, batch_axis=None, seq_axis=None):
        d = create_distributed_plan(opts, mesh=mesh, batch_axis=batch_axis, seq_axis=seq_axis)
        print(f"distributed plan {opts['type']} {opts['shape']} x {opts.get('batch', 1)}: "
              f"{d.route.mode} {d.route.impl} {list(d.route.reasons)}")
        require(d.route.impl == "torch+nccl", f"distributed: impl {d.route.impl}")
        return d, T.create_plan(opts, device="cuda")

    # dp: the headline over {"dp": 1}
    d, s = plan_pair(HEADLINE, dp, batch_axis="dp")
    x = torch.randn(4096, 1024, 2, device="cuda", generator=gen)
    dist_case(keep, "dp headline [1024] x 4096", lambda d=d, x=x: d(x).full_tensor(),
              lambda s=s, x=x: s(x),
              "the single-device plan",
              oracle=(torch.view_as_real(torch.fft.fft(torch.view_as_complex(x), norm="ortho")),
                      "torch.fft"))

    # sp c2c: four-step 2048 x 2048, and the Bluestein route at a prime
    for label, n, b in [("sp c2c [2^22] x 8", 1 << 22, 8),
                        ("sp c2c Bluestein [1048573] x 2", 1048573, 2)]:
        opts = {"type": "c2c", "shape": [n], "batch": b}
        d, s = plan_pair(opts, sp, seq_axis="sp")
        xs = torch.randn(b, n, 2, device="cuda", generator=gen)
        dist_case(keep, label, lambda d=d, xs=xs: d(xs).full_tensor(),
                  lambda s=s, xs=xs: s(xs), "the single-device plan",
                  oracle=(torch.view_as_real(torch.fft.fft(torch.view_as_complex(xs))),
                          "torch.fft"))

    # r2c / c2r: poisson3d at 256^3 against its manufactured solution, slab
    # and pencil, each solve against the same solve on single-device plans
    n = NS_N
    u_star, f = poisson3d.manufactured(n, SEED)
    inv_sym = torch.from_numpy(poisson3d.inverse_symbol(n)).cuda()
    ft = torch.from_numpy(f).cuda()
    s_fwd = T.create_plan({"type": "r2c", "shape": [n] * 3, "batch": 1}, device="cuda")
    s_inv = T.create_plan({"type": "c2r", "shape": [n] * 3, "batch": 1,
                           "direction": "inverse", "normalize": "backward"}, device="cuda")

    def single_solve():
        return s_inv(s_fwd(ft[None]) * inv_sym[None, ..., None])[0]

    for label, mesh, axes in [("poisson3d 256^3 slab", sp, "sp"),
                              ("poisson3d 256^3 pencil", pen, ("sp1", "sp2"))]:
        u = dist_case(keep, label,
                      lambda mesh=mesh, axes=axes: poisson3d.solve(ft, mesh, axes, inv_sym)[0],
                      single_solve, "the single-device solve")
        un = u.cpu().numpy()
        res = float(np.max(np.abs(poisson3d.lap(un) - f)) / np.max(np.abs(f)))
        err = float(np.max(np.abs(un - u_star)) / np.max(np.abs(u_star)))
        print(f"distributed {label}: residual {res:.3e}, error vs the manufactured "
              f"solution {err:.3e} (limit 1e-4)")
        require(res < 1e-4 and err < 1e-4, f"distributed {label}: Poisson solve is off")

    # NS-3D: one step at 256^3 over the slab and the pencil mesh
    step_s, to_s, _ = ns3.make_stepper3(NS_N, NS_NU, NS_DT, device="cuda")
    u_hat = to_s(ns3.abc_flow(NS_N, 0.0, NS_NU, device="cuda")
                 + 0.1 * torch.randn(3, NS_N, NS_N, NS_N, device="cuda", generator=gen))
    for label, mesh, axes in [("NS-3D step 256^3 slab", sp, "sp"),
                              ("NS-3D step 256^3 pencil", pen, ("sp1", "sp2"))]:
        step_d, _, _ = ns3.make_stepper3(NS_N, NS_NU, NS_DT, mesh=mesh, seq_axis=axes)
        dist_case(keep, label, lambda step_d=step_d: step_d(u_hat),
                  lambda: step_s(u_hat), "the single-device step")
        ns_rhs(label, step_d, step_s, u_hat)

    # NS-2D 2048^2: one right-hand side, then a short trajectory over the
    # slab mesh
    n2, nu2, dt2, steps2 = DIST_NS2D
    w0 = torch.randn(n2, n2, device="cuda", generator=gen)
    w0 = (w0 - w0.mean()).cpu().numpy()
    step2_s, to2_s, _ = ns2.make_stepper(n2, nu2, dt2, device="cuda")
    step2_d, _, _ = ns2.make_stepper(n2, nu2, dt2, mesh=sp)
    ns_rhs("NS-2D step 2048^2 slab", step2_d, step2_s, to2_s(w0))
    dist_case(keep, "NS-2D 2048^2 slab, 4 steps",
              lambda: torch.from_numpy(ns2.run(w0, n2, nu2, dt2, steps2, mesh=sp)),
              lambda: torch.from_numpy(ns2.run(w0, n2, nu2, dt2, steps2, device="cuda")),
              "the single-device run", tol=DIST_NS_TOL)

    # trig
    for label, kind, shape, b, direction in [
            ("dct2 [512, 512] x 8", "dct2", [512, 512], 8, "forward"),
            ("dst3 [512, 512] x 8", "dst3", [512, 512], 8, "forward"),
            ("dct4 [32768] x 32", "dct4", [32768], 32, "forward")]:
        opts = {"type": kind, "shape": shape, "batch": b, "direction": direction,
                "normalize": "unitary"}
        d, s = plan_pair(opts, sp, seq_axis="sp")
        xr = torch.randn(b, *shape, device="cuda", generator=gen)
        dist_case(keep, label, lambda d=d, xr=xr: d(xr).full_tensor(),
                  lambda s=s, xr=xr: s(xr), "the single-device plan")

    # fftconv: the 2-D case on the sp mesh (the halo route) and on the
    # pencil, and the 1-D halo route with 129 taps
    opts = {"type": "fftconv", "shape": [1000, 1000], "batch": 8,
            "fftConv": {"boundary": "linear-same", "kernelShape": [25, 25]}}
    xc = torch.randn(8, 1000, 1000, 2, device="cuda", generator=gen)
    kc = torch.randn(25, 25, 2, device="cuda", generator=gen)
    for label, mesh, axes in [
            ("fftconv [1000, 1000] x 8 * 25^2 linear-same, sp (halo)", sp, "sp"),
            ("fftconv [1000, 1000] x 8 * 25^2 linear-same, pencil", pen, ("sp1", "sp2"))]:
        d, s = plan_pair(opts, mesh, seq_axis=axes)
        dist_case(keep, label, lambda d=d: d(xc, kernel=kc).full_tensor(),
                  lambda s=s: s(xc, kernel=kc), "the single-device plan")
    opts = {"type": "fftconv", "shape": [1 << 22], "batch": 8,
            "fftConv": {"boundary": "linear-same", "kernelShape": [129]}}
    d, s = plan_pair(opts, sp, seq_axis="sp")
    require(any(r.startswith("fftconv-halo") for r in d.route.reasons),
            f"distributed fftconv [2^22]: not the halo route {d.route.reasons}")
    x1 = torch.randn(8, 1 << 22, 2, device="cuda", generator=gen)
    k1 = torch.randn(129, 2, device="cuda", generator=gen)
    dist_case(keep, "fftconv [2^22] x 8 * 129 linear-same, halo",
              lambda d=d: d(x1, kernel=k1).full_tensor(), lambda s=s: s(x1, kernel=k1),
              "the single-device plan")

    # sequence-parallel spectral analysis against the facade on the card
    sig = torch.randn(8, 1 << 22, device="cuda", generator=gen)
    sig2 = torch.randn(8, 1 << 22, device="cuda", generator=gen)
    n_sig = sig.shape[-1]
    _, _, stft = build_distributed_stft(n_sig, sp, "sp", **DIST_STFT)
    z = dist_case(keep, "stft (8, 2^22)", lambda: stft(sig).full_tensor(),
                  lambda: wfft.stft(sig, **DIST_STFT)[2], "the facade's stft")
    istft = build_distributed_istft(n_sig, sp, "sp", **DIST_STFT)
    dist_case(keep, "istft (8, 2^22)", lambda: istft(z).full_tensor(),
              lambda: wfft.istft(z, **DIST_STFT)[1][..., :n_sig], "the facade's istft",
              tol=2e-5, oracle=(sig, "the signal"))
    _, welch = build_distributed_welch(n_sig, sp, "sp", **DIST_STFT)
    dist_case(keep, "welch (8, 2^22)", lambda: welch(sig).full_tensor(),
              lambda: wfft.welch(sig, **DIST_STFT)[1], "the facade's welch")
    _, csd = build_distributed_csd(n_sig, sp, "sp", **DIST_STFT)
    dist_case(keep, "csd (8, 2^22)", lambda: csd(sig, sig2).full_tensor(),
              lambda: wfft.csd(sig, sig2, **DIST_STFT)[1], "the facade's csd")

    # NUFFT: types 1 and 2 on the radial trajectory of the nufft path, type 3
    # at its 1-D size
    nu = T.nufft
    x, y = radial_points(NU2_SPOKES, NU2_SAMPLES)
    c = torch.randn(NU2_COILS, x.size, 2, device="cuda", generator=gen)
    f2 = torch.randn(NU2_COILS, *NU2_MODES, 2, device="cuda", generator=gen)
    t1 = pnu.build_distributed_nufft_type1((x, y), NU2_MODES, sp, eps=NU_EPS)
    t2 = pnu.build_distributed_nufft_type2((x, y), NU2_MODES, sp, eps=NU_EPS)
    dist_case(keep, "nufft type 1, 256^2 modes, 2^17 radial points x 8 coils",
              lambda: t1(c).full_tensor(), lambda: nu.nufft2d1(x, y, c, NU2_MODES, eps=NU_EPS),
              "the single-device nufft2d1")
    dist_case(keep, "nufft type 2, 256^2 modes x 8 coils, 2^17 radial points",
              lambda: t2(f2).full_tensor(), lambda: nu.nufft2d2(x, y, f2, eps=NU_EPS),
              "the single-device nufft2d2")
    rng = np.random.default_rng(SEED)
    xt = rng.uniform(-np.pi, np.pi, NU1_POINTS)
    st = rng.uniform(-NU1_BAND, NU1_BAND, NU1_POINTS)
    ct = torch.randn(NU1_SETS, NU1_POINTS, 2, device="cuda", generator=gen)
    t3 = pnu.build_distributed_nufft_type3(xt, st, sp, eps=NU_EPS)
    dist_case(keep, "nufft type 3, 2^16 sources x 8 sets, 2^16 targets",
              lambda: t3(ct).full_tensor(), lambda: nu.nufft1d3(xt, ct, st, eps=NU_EPS),
              "the single-device nufft1d3")
    require(sharded.axis_size(sp, "sp") == 1, "distributed: world size is not 1")
    return keep


def phase_distributed_timing(keep, card):
    """Each distributed call idle and queued beside the single-device call
    of the same spec: at world size 1 the difference is what the
    distributed route's structure costs against the local route.  Then the
    world is destroyed."""
    import torch.distributed as dist
    out = {}
    for label, dist_fn, single_fn in keep:
        out[label] = timed_pair(f"distributed {label}", dist_fn, single_fn,
                                "single-device", card)
    keep.clear()
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    print("distributed: NCCL world destroyed")
    return out


# ---------------------------------------------------------------------------
# examples (the seventeenth path): the distributed export, the examples of
# webgpufft_tpu_torch/examples at full size
# ---------------------------------------------------------------------------

# the (K1, K2) launches of each case of the examples path, in this process:
# the einsum routes launch none (c2c [2^22] on four-step digit stages, the
# pencil's digit stages, fftconv at 544 = 32 * 17 and 136 = 8 * 17 on
# Bluestein); a
# training step at 2^20 launches K1 twice forward (the overlap-save blocks
# and their inverse) and once adjoint (the inverse's, for the gradient with
# respect to the kernel); the dp 1 x sp 1 run is the halo route's local plan
# on K1, plus one forward for the layout of the observations
EXAMPLE_LAUNCHES = {
    "export sp c2c [2^22] x 8": (0, 0),
    "export pencil c2c 256^3 x 3": (0, 0),
    "export fftconv [2^22] x 8 * 129 linear-same, halo": (2, 0),
    "export fftconv [1000, 1000] x 8 * 25^2 linear-same, halo": (3, 3),
    "aot_serving [1024] x 4096 unitary (build)": (0, 0),
    "system_identification n 512, 400 steps": (0, 0),
    "system_identification n 2^20, 400 steps": (1200, 0),
    "system_identification n 512, 400 steps, dp 1 x sp 1": (1202, 0),
    "mri_gridding 128^2, 200 x 256, sp 1": (37, 37),
    "mri_gridding 256^2, 402 x 512": (35, 35),
    "navier_stokes3d main n 32": (1300, 650),
    "NS-3D 256^3 turbulence, 10 steps": (88, 132),
    "NS-3D 256^3 export_pipeline, 3 steps": (24, 36),
    "spectral_filter [1024] x 8": (2, 0),
    "spectral_filter [1024] x 65536": (2, 0),
    "image_blur_fftconv 128^2 * 9^2": (0, 0),
    "scipy_style": (12, 0),
    "signal_toolkit": (4, 0),
}
SYSID = dict(klen=33, batch=8, steps=400, lr=2e-2, noise=1e-3)   # the example's own
SYSID_BIG_N = 1 << 20
MRI_BIG = (256, 402, 512)               # n, spokes, reads: 205,824 samples
SERVE_BATCH = 4096                      # the headline plan's batch
FILTER_BIG = (1024, 65536)              # the facade's 1-D r2c shape (PERF.md section 5)


def example_case(label, fn):
    """One case of the examples path, its launches pinned by
    EXAMPLE_LAUNCHES."""
    out, made = counted(fn)
    torch.cuda.synchronize()
    want = EXAMPLE_LAUNCHES[label]
    print(f"examples {label}: launches fused_lines {made[0]}, fused_cols {made[1]} "
          f"(expected {want[0]}, {want[1]})")
    require(made == want, f"examples {label}: launches {made}")
    return out


def equal_or_close(label, got, live):
    """The served output against the live plan's: bit for bit, or (a route
    that sums in a varying order) within 1e-6 of max|live|."""
    if torch.equal(got, live):
        print(f"examples {label}: served output equals the live plan's bit for bit")
        return
    err = rel_err(got, live)
    print(f"examples {label}: served output within {err:.3e} of max|live| of the live plan's")
    require(err <= 1e-6, f"examples {label}: served output departs from the live plan's")


def export_case(keep, label, opts, mesh, seq_axis, x, k=None):
    """export_distributed_plan -> load_exported_plan -> ep(x, mesh=) against
    the live distributed plan and the single-device plan of the spec."""
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.parallel import create_distributed_plan
    live = create_distributed_plan(opts, mesh=mesh, seq_axis=seq_axis)
    single = T.create_plan(opts, device="cuda")
    kw = {} if k is None else {"kernel": k}
    t0 = time.perf_counter()
    blob = T.export_distributed_plan(live)
    t1 = time.perf_counter()
    ep = T.load_exported_plan(blob)
    t2 = time.perf_counter()
    ep._plan_on(mesh)
    t3 = time.perf_counter()
    print(f"examples {label}: {len(blob)} bytes, export {t1 - t0:.4f} s, load {t2 - t1:.4f} s, "
          f"rebuild on the serving mesh {t3 - t2:.4f} s, record {ep.distributed}, route "
          f"{ep.route_mode}")
    require(ep.distributed["nr_devices"] == 1 and ep.route_mode == live.route.mode,
            f"examples {label}: record {ep.distributed}")
    y = example_case(label, lambda: ep(x, k, mesh=mesh).full_tensor())
    equal_or_close(label, y, live(x, **kw).full_tensor())
    check_close(f"examples {label}", y, single(x, **kw), "the single-device plan")
    keep.append((f"export {label[7:]}", lambda: ep(x, k, mesh=mesh),
                 lambda: live(x, **kw), "the live distributed plan"))
    return ep


def torch_fft_model(n, klen):
    """The system-identification model on ``torch.fft`` (the yardstick):
    linear-same convolution of real probes with a real kernel."""
    m = n + klen - 1

    def model(k, xi):
        xf = torch.fft.rfft(xi[..., 0], n=m)
        return torch.fft.irfft(xf * torch.fft.rfft(k, n=m), n=m)[..., klen // 2:klen // 2 + n]
    return model


def sysid_case(label, sysid, n, mesh=None):
    """One training run of the example, held to its bars; returns k_hat."""
    k_hat, k_true, losses = example_case(label, lambda: sysid.run(n, mesh=mesh, device="cuda",
                                                                  **SYSID))
    err = float(np.max(np.abs(k_hat - k_true)) / np.max(np.abs(k_true)))
    print(f"examples {label}: loss {losses[0]:.3e} -> {losses[-1]:.3e}, kernel rel err "
          f"{err:.3e} (limits 1e-5, 2e-2)")
    require(bool(np.isfinite(losses).all()) and losses[-1] < 1e-5 and err < 2e-2,
            f"examples {label}: training missed its bars")
    return k_hat


def phase_examples(gen):
    """The seventeenth path: the distributed export in the NCCL world of the
    distributed path, then each example of ``webgpufft_tpu_torch/examples``
    through its own entry points at full size, each held to the JAX
    script's bars.  Returns what ``phase_examples_timing`` times."""
    import torch.distributed as dist
    import webgpufft_tpu_torch as T
    from webgpufft_tpu_torch.examples import (aot_serving, image_blur_fftconv, mri_gridding,
                                              navier_stokes3d as ns3, scipy_style,
                                              signal_toolkit, spectral_filter,
                                              system_identification as sysid)
    from webgpufft_tpu_torch.parallel import create_distributed_plan, make_mesh
    require(dist.is_initialized() and dist.get_backend() == "nccl",
            "examples: the distributed path's NCCL world is not up")
    sp, dp = make_mesh({"sp": 1}), make_mesh({"dp": 1})
    pen = make_mesh({"sp1": 1, "sp2": 1})
    keep = []

    # --- the distributed export at the distributed path's shapes
    x22 = torch.randn(8, 1 << 22, 2, device="cuda", generator=gen)
    ep = export_case(keep, "export sp c2c [2^22] x 8",
                     {"type": "c2c", "shape": [1 << 22], "batch": 8}, sp, "sp", x22)
    vol = torch.randn(3, NS_N, NS_N, NS_N, 2, device="cuda", generator=gen)
    export_case(keep, "export pencil c2c 256^3 x 3",
                {"type": "c2c", "shape": [NS_N] * 3, "batch": 3}, pen, ("sp1", "sp2"), vol)
    del vol
    export_case(keep, "export fftconv [2^22] x 8 * 129 linear-same, halo",
                {"type": "fftconv", "shape": [1 << 22], "batch": 8,
                 "fftConv": {"boundary": "linear-same", "kernelShape": [129]}}, sp, "sp",
                x22, torch.randn(129, 2, device="cuda", generator=gen))
    export_case(keep, "export fftconv [1000, 1000] x 8 * 25^2 linear-same, halo",
                {"type": "fftconv", "shape": [1000, 1000], "batch": 8,
                 "fftConv": {"boundary": "linear-same", "kernelShape": [25, 25]}}, sp, "sp",
                torch.randn(8, 1000, 1000, 2, device="cuda", generator=gen),
                torch.randn(25, 25, 2, device="cuda", generator=gen))
    for what, call, match in [
            ("a dp-only plan", lambda: T.export_distributed_plan(
                create_distributed_plan(HEADLINE, mesh=dp, batch_axis="dp")), "export_plan"),
            ("a mesh of other axes", lambda: ep(x22, mesh=dp), "mesh axes")]:
        try:
            call()
            raised = None
        except T.PlanError as e:
            raised = str(e)
        print(f"examples export: {what} raises PlanError: {raised!r}")
        require(raised is not None and match in raised, f"examples export: {what} not refused")

    # --- AOT serving: built here, served by a second process on the card
    served = example_case("aot_serving [1024] x 4096 unitary (build)",
                          lambda: aot_serving.run("cuda", batch=SERVE_BATCH))
    print(f"examples aot_serving: the serving process launched fused_lines "
          f"{served['served_launches'][0]}, fused_cols {served['served_launches'][1]}; "
          f"route {served['route']}")
    require(served["served_launches"] == (1, 0), "examples aot_serving: serving launches")
    xs = torch.from_numpy(aot_serving.request(SERVE_BATCH)).cuda()
    check_close("examples aot_serving", torch.from_numpy(served["y"]).cuda(),
                torch.view_as_real(torch.fft.fft(torch.view_as_complex(xs), norm="ortho")),
                "torch.fft")

    # --- system identification: the example's size, 2^20, dp 1 x sp 1
    k512 = sysid_case("system_identification n 512, 400 steps", sysid, 512)
    sysid_case("system_identification n 2^20, 400 steps", sysid, SYSID_BIG_N)
    kd = sysid_case("system_identification n 512, 400 steps, dp 1 x sp 1", sysid, 512,
                    mesh=make_mesh({"dp": 1, "sp": 1}))
    dk = float(np.max(np.abs(kd - k512)) / np.max(np.abs(k512)))
    print(f"examples system_identification: dp 1 x sp 1 kernel vs one device {dk:.3e} "
          f"(limit 1e-4)")
    require(dk < 1e-4, "examples system_identification: distributed kernel departs")

    # --- MRI gridding: the example's size with its distributed leg, then 256^2
    r = example_case("mri_gridding 128^2, 200 x 256, sp 1",
                     lambda: mri_gridding.run("cuda", mesh=sp, verbose=False))
    print(f"examples mri_gridding 128^2: NDFT pin {r['ndft']:.3e}, gridding RMSE "
          f"{r['rmse_grid']:.4f}, CG RMSE {r['rmse_cg']:.4f}, distributed forward / adjoint "
          f"{r['dist_fwd']:.3e} / {r['dist_adj']:.3e} (limits 2e-5, 0.12, 0.035, 1e-5, 5e-5)")
    require(r["rmse_grid"] < 0.12 and r["rmse_cg"] < 0.035, "examples mri_gridding: RMSE")
    n, spokes, reads = MRI_BIG
    r = example_case(f"mri_gridding 256^2, 402 x 512",
                     lambda: mri_gridding.run("cuda", n, spokes, reads, verbose=False))
    print(f"examples mri_gridding {n}^2, {spokes} x {reads} = {spokes * reads} samples: NDFT pin "
          f"{r['ndft']:.3e} (limit 2e-5), gridding RMSE {r['rmse_grid']:.4f}, CG RMSE "
          f"{r['rmse_cg']:.4f}")
    require(r["rmse_cg"] < r["rmse_grid"], "examples mri_gridding 256^2: CG is not below gridding")

    # --- NS-3D: main at n 32, turbulence at 256^3, the exported 3-step advance
    out = example_case("navier_stokes3d main n 32",
                       lambda: ns3.main(["--device", "cuda", "--n", "32"]))
    print(f"examples navier_stokes3d main: {out}")

    def turbulence():
        u0 = torch.randn(3, NS_N, NS_N, NS_N, device="cuda", generator=gen)
        e0 = ns3.kinetic_energy(ns3.run3(u0, NS_N, NS_NU, NS_DT, 0, device="cuda"))
        u1 = ns3.run3(u0, NS_N, NS_NU, NS_DT, 10, device="cuda")
        return e0, ns3.kinetic_energy(u1), ns3.max_divergence(u1, NS_N)
    e0, e1, dv = example_case("NS-3D 256^3 turbulence, 10 steps", turbulence)
    print(f"examples NS-3D 256^3 turbulence: KE {e0:.6f} -> {e1:.6f}, max spectral divergence "
          f"{dv:.3e} (limit 1e-4)")
    require(e1 < e0 and dv < 1e-4, "examples NS-3D turbulence: invariants")
    step, to_s, _ = ns3.make_stepper3(NS_N, NS_NU, NS_DT, device="cuda")
    u_hat = to_s(ns3.taylor_green_embedded(NS_N, 0.0, NS_NU, device="cuda"))

    def advance(v):
        for _ in range(3):
            v = step(v)
        return v

    t0 = time.perf_counter()
    blob = T.export_pipeline(advance, u_hat)
    program = T.load_exported_pipeline(blob)
    print(f"examples NS-3D export_pipeline: {len(blob)} bytes, export + load "
          f"{time.perf_counter() - t0:.2f} s")
    served = example_case("NS-3D 256^3 export_pipeline, 3 steps", lambda: program(u_hat))
    require(torch.equal(served, advance(u_hat)),
            "examples NS-3D export_pipeline: the loaded program departs from the eager run")
    print("examples NS-3D export_pipeline: the loaded program equals the eager run bit for bit")
    keep.append(("NS-3D 256^3, 3 steps, loaded program", lambda: program(u_hat),
                 lambda: advance(u_hat), "the eager run"))

    # --- the facade demos at their own sizes, and the filter at [1024] x 65536
    example_case("spectral_filter [1024] x 8", lambda: spectral_filter.run("cuda"))
    example_case("image_blur_fftconv 128^2 * 9^2", lambda: image_blur_fftconv.run("cuda"))
    for name, mod in [("scipy_style", scipy_style), ("signal_toolkit", signal_toolkit)]:
        got = example_case(name, lambda mod=mod: mod.run("cuda", verbose=False))
        want = mod.run("cpu", verbose=False)
        for key, value in got.items():
            a, b = (torch.as_tensor(np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v))
                    for v in (value, want[key]))
            if a.is_complex():
                a, b = torch.view_as_real(a), torch.view_as_real(b)
            require(a.shape == b.shape, f"examples {name} {key}: shape")
            if a.dtype in (torch.bool, torch.int64, torch.int32):
                require(torch.equal(a, b), f"examples {name} {key}: differs from the CPU run")
            elif a.numel():
                check_close(f"examples {name} {key}", a.double(), b.double(),
                            "the same script on the CPU")
    n, b = FILTER_BIG
    lowpass = spectral_filter.make_filter(n, b, 20, "cuda")
    sig = torch.randn(b, n, device="cuda", generator=gen)
    mask = (torch.arange(n // 2 + 1, device="cuda") <= 20).to(torch.complex64)

    def yard():
        return torch.fft.irfft(torch.fft.rfft(sig) * mask, n=n)
    y = example_case("spectral_filter [1024] x 65536", lambda: lowpass(sig))
    check_close("examples spectral_filter [1024] x 65536", y, yard(), "torch.fft")
    keep.append(("spectral_filter [1024] x 65536", lambda: lowpass(sig), yard, "torch.fft"))
    return keep


def phase_examples_timing(keep, card):
    """The examples path's calls from idle and queued beside their
    yardsticks, then ms per training step of system identification at 2^20
    beside the same loop with the convolution on ``torch.fft``, and K1
    launches per step, forward and adjoint."""
    from webgpufft_tpu_torch.examples import mri_gridding, system_identification as sysid
    for label, port, yardstick, what in keep:
        timed_pair(f"examples {label}", port, yardstick, what, card)
    n, spokes, reads = MRI_BIG
    kx, ky, _ = mri_gridding.radial_trajectory(spokes, reads)
    fwd, adj = mri_gridding.operators(kx, ky, n)
    f = torch.from_numpy(np.stack([mri_gridding.shepp_logan_lite(n),
                                   np.zeros((n, n))], -1).astype(np.float32)).cuda()

    def aha():
        return adj(fwd(f))

    def aha_yard():
        with on_torch_fft():
            return aha()
    check_close("examples MRI AHA: the yardstick", aha_yard(), aha(), "the port")
    timed_pair(f"examples mri_gridding AHA {n}^2, {spokes * reads} samples", aha, aha_yard,
               "the same spread/interp around torch.fft", card)
    keep.clear()

    x, k_true, eps = sysid.make_problem(SYSID_BIG_N, SYSID["klen"], SYSID["batch"],
                                        SYSID["noise"])
    xt = torch.from_numpy(x).cuda()
    xi = torch.stack([xt, torch.zeros_like(xt)], -1)
    y = torch.from_numpy(sysid.observations(x, k_true, eps)).cuda()
    model, _ = sysid.make_model(SYSID_BIG_N, SYSID["klen"], SYSID["batch"], device="cuda")
    steps = {}
    for name, mdl in [("port", model), ("torch.fft", torch_fft_model(SYSID_BIG_N,
                                                                     SYSID["klen"]))]:
        k = torch.zeros(SYSID["klen"], device="cuda", requires_grad=True)
        opt = torch.optim.Adam([k], lr=SYSID["lr"])

        def step(mdl=mdl, k=k, opt=opt):
            opt.zero_grad(set_to_none=True)
            loss = ((mdl(k, xi) - y) ** 2).mean()
            loss.backward()
            opt.step()
        steps[name] = step
    with torch.no_grad():
        check_close("examples system_identification: the yardstick model",
                    torch_fft_model(SYSID_BIG_N, SYSID["klen"])(torch.from_numpy(k_true).cuda(), xi),
                    model(torch.from_numpy(k_true).cuda(), xi), "the port's model")
    _, fwd_made = counted(lambda: model(torch.zeros(SYSID["klen"], device="cuda"), xi))
    _, step_made = counted(steps["port"])
    print(f"examples system_identification n 2^20 x 8: launches per training step fused_lines "
          f"{step_made[0]} (forward {fwd_made[0]}, adjoint {step_made[0] - fwd_made[0]}), "
          f"fused_cols {step_made[1]}")
    a = profile.time_calls(steps["torch.fft"], runs=GRAD_RUNS, warmup=2)
    p = profile.time_calls(steps["port"], runs=GRAD_RUNS, warmup=2)
    p += profile.time_calls(steps["port"], runs=GRAD_RUNS, warmup=0)
    a += profile.time_calls(steps["torch.fft"], runs=GRAD_RUNS, warmup=0)
    print(f"time examples system_identification n 2^20 x 8, klen 33: training step "
          f"(forward + backward + Adam) port {profile.median(p):.4f} ms, the same loop on "
          f"torch.fft {profile.median(a):.4f} ms [{card}]")
    torch.cuda.empty_cache()


def main():
    card_name, smi = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase_build()
    k1_cases, k1_err = phase_k1(gen)
    k2_cases, k2_err = phase_k2(gen)
    phase_domain(gen)
    phase_fuzz()
    adj_err = phase_adjoint(gen, k1_cases, k2_cases)
    print(f"kernel adjoints: worst max abs err vs the plain adjoint {adj_err:.3e}")
    probe_err, copies, lines_cases = phase_probe_kernels(gen)

    # the main paths: the counts of each are launches made by its own
    # entry-point calls only
    paths = {}
    headline, volume = drive("c2c", paths, lambda: (phase_headline(gen), phase_3d(gen)))
    x, y = drive("r2c", paths, phase_r2c, gen)
    back = drive("c2r", paths, phase_c2r, y)
    phase_real_round_trips(x, y, back)
    del back
    phase_axis_kinds(gen)
    dct = drive("dct", paths, phase_dct, gen)
    conv, overlap = drive("fftconv", paths, phase_fftconv, gen)
    conv2d = drive("conv2d", paths, phase_conv2d, gen, k1=False, k2=False)
    drive("staging", paths, phase_staging, gen, headline, k2=False)
    drive("ns3d", paths, phase_ns3d)
    grad_timers = drive("autodiff", paths, phase_autodiff, gen)
    # forward + backward of every sub-phase: headline 2, vmap and its reference
    # 2, c2c pair 4 + 8, r2c -> c2r 8 + 12, dct2 2 + 2, fftconv 6 + 6, the
    # solver gradient 24 + 36 by reverse and again by forward mode
    require(paths["autodiff"][:2] == (72, 100), f"path autodiff: launches {paths['autodiff']}")
    drive("runtime", paths, phase_runtime, gen, smi)
    drive("probes", paths, phase_probes, copies, lines_cases, k2=False, probes=True)
    facade = drive("facade", paths, phase_facade, gen)
    nufft = drive("nufft", paths, phase_nufft, gen)
    linalg = drive("linalg", paths, phase_linalg, gen, k2=False)
    signal = drive("signal", paths, phase_signal, gen)
    dist_keep = drive("distributed", paths, phase_distributed, gen)
    example_keep = drive("examples", paths, phase_examples, gen)
    phase_examples_timing(example_keep, smi)
    phase_distributed_timing(dist_keep, smi)
    path_err = phase_path_shapes(gen)
    k1_err = max(k1_err, path_err["fused_lines"])
    k2_err = max(k2_err, path_err["fused_cols"])
    PATH_SHAPES.clear()

    times = phase_timing(k1_cases, k2_cases, headline, volume, smi)
    phase_new_plan_timing(dct, conv, overlap, conv2d, smi)
    del dct, conv, overlap, conv2d
    phase_solver_timing(gen, x, y, smi)
    del x, y
    phase_autodiff_timing(grad_timers, smi)
    probe_times = phase_probe_timing(copies, lines_cases, smi)
    phase_facade_timing(facade, smi)
    del facade
    phase_nufft_timing(nufft, smi)
    phase_linalg_timing(linalg, smi)
    del nufft, linalg
    phase_signal_timing(signal, smi)
    del signal
    phase_iir_ab(smi)
    # each kernel's record carries the times of its headline shape, and
    # under "shapes" those of every shape timed
    order = list(counters())
    by_path = {name: {p: c[order.index(name)] for p, c in paths.items()} for name in order}
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"webgpufft_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name],
         "max_abs_err": err, "shape": shape, **times[key],
         "shapes": [{"shape": list(k[1:]), **v} for k, v in times.items() if k[0] == key[0]]}
        for name, src, replaces, err, shape, key in [
            ("fused_lines", "fused_lines.cu", "webgpufft_tpu/core/fused.py:223",
             k1_err, "N=1024 x 4096 lines", ("K1", 1024, 4096)),
            ("fused_cols", "fused_cols.cu", "webgpufft_tpu/core/fused_cols.py:161",
             k2_err, "view (256, 256, 512)", ("K2", 256, 256, 512))]] + [
        {"name": name, "route": "cuda", "source": f"webgpufft_tpu_torch/csrc/probes/{src}",
         "replaces": replaces, "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name], "max_abs_err": probe_err[name], "shape": shape,
         **probe_times[name]}
        for name, src, replaces, shape in [
            ("stream_copy", "stream_copy.cu",
             "benches/r12_pallas_dma.py:63, benches/r12_pallas_dma.py:130, "
             "benches/r26_pallas_endgame.py:160, benches/r2_perf_experiments.py:225, "
             "benches/r2_perf_experiments.py:253, benches/r2_perf_experiments.py:274",
             "(4096, 2048) f32, mode direct"),
            ("lines_stages", "lines_stages.cu", "benches/r2_pallas_probe.py:80",
             "N=1024 x 4096 lines, every pass"),
            ("lines_planes", "lines_planes.cu",
             "benches/r26_pallas_endgame.py:139, benches/r26_pallas_endgame.py:223",
             "N=1024 x 4096 lines, planes")]]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
