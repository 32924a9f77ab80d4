"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. environment: the card's name and power limit (nvidia-smi), torch, CUDA
   and nvcc versions, and whether triton imports;
2. build: the CUDA kernel library (nvcc) and the host codec (g++), timed;
3. the kernel against its plain PyTorch version on the card, masked and
   all-defined, at small and ragged shapes: masks bitwise, values bit for
   bit on defined points (NaN where NaN);
4. the main path: 3 requests through ``staging.run_derived_fields_np`` at
   the 32-level 719x929 AROME size (undef lanes live, fully defined, undef
   lanes live), each compared with the plain version on the same CUDA
   tensors, bit for bit; the kernel must have been launched exactly 3
   times;
5. times on this card: kernel and plain medians (CUDA events; the kernel
   also as the launch alone), effective GB/s, a device copy's GB/s for
   scale, and one request on page-locked blocks split into decode, H2D,
   kernel, D2H and encode (the first, allocating request apart; beside
   it the parent design's pageable copies of the same blocks);
6. the column-interpolation kernel and the two suite kernels against
   their plain versions on the card, at phase 3's shapes and a 137-level
   column (137, 9, 150): masked and all-defined, ln p and p, targets above
   the top and below the surface, a non-monotone column; every valid mode
   of every suite family in one request, with out-of-table temperatures,
   undefined p / ps points and p <= 0 on the a-level path.  Masks and
   values must be equal (NaN where NaN);
7. the isobaric path at BASELINE config 4's full size, 137x719x929 -> the
   11 standard surfaces: ``derived_fields_isobaric(fused=True,
   stacked=True)`` must launch the interpolation kernel and the pipeline
   kernel once each and equal the plain composition bit for bit, and the
   interpolation kernel its plain version on config 4's ps and on a smooth
   ps of the same range; then its times, split into the two kernels (each
   also as the launch alone), and the interpolation on the smooth ps;
8. the suite entry: 3 requests through ``staging.run_hlevel_suite_np`` at
   32x719x929 with BASELINE config 2's request set (undef lanes live,
   fully defined, undef lanes live; 3 launches, the all-defined route as
   the decode counts say, outputs equal to the plain version's), and
   ``alevel_suite_fused`` once at config 2's own 10x719x929 with a
   pressure field (both kernels bit for bit); then the two kernels' times
   through their wrappers, the launch alone (queued behind a busy wait) on
   these inputs and on smooth fields, and one request split;
9. vessel icing: the MINCOG (alt 1 and 2) and ModStall kernels against
   their plain versions at (1, 1), (3, 37), (37, 61), (9, 131), (64, 256)
   and 719x929 on friendly inputs, adversarial ones with planted pw == 0
   and sal == 0 points, and vs = 0, and on the tile schedule's corners
   (tests/icing_corner_cases.py: a gated-off tile, all and no sign
   changes, 81 heights, a tile and a point, ModStall items near the
   128-step cap) (values equal, NaN where NaN); 3 requests through
   ``staging.run_vessel_icing_np`` at 719x929 with the operational 19
   heights (scattered undefs, fully defined, scattered undefs; each
   kernel launched exactly 3 times; outputs equal to the plain route's);
   the port's ModStall against the 719x929 oracle golden (rtol / atol
   2e-3); then the kernels' and plain versions' times with the SM clock,
   their registers and shared memory, the warp-efficiency model's
   predicted speed-up beside the measured one over the per-point kernels,
   and one request split into decode, H2D, prologues, kernels, D2H and
   encode;
10. measurement probes (``mi_fieldcalc_tpu_torch/tools/``, kernels in
   ``csrc/probes.cu``): P1 (B1's bytes at the best rate this card gives
   them) at phase 3's shapes, at widths 4k+1 and 4k+3 over an odd row
   count, and at 32x719x929 at every blocks-an-SM cap, P2 (x + 1 into nbuf
   outputs) at a ragged shape, every case of its sweep and on an x one
   float off its 16-byte boundary, P3 (halo windows) at 32x256, a ragged
   and a single-row case and B1's shape, P4 (the solver constructs) at
   64x256, at 719x929, on one lane and on two 719x929 launches back to
   back, each equal to its plain version bit for bit; then,
   with the probes' launch counts zeroed before and read after (each must
   be > 0): B1 against P1 in turns on phase 5's inputs, masked and
   all-defined (B1 first held to its plain version), B1's time over P1's
   and both against the bytes bound at the published 3.35 TB/s; P2's
   sweep in GB/s beside ``torch.add(x, 1)``, each one-buffer row over it;
   P3 beside P2's one buffer; P4 against its bytes, its operations by
   branch of tanh_f32 (at the published rate and the issue rate) and its
   chain floor (capped lanes launched alone), its bound the largest; and one
   masked ``run_derived_fields_np`` request under
   ``utils.profiling.trace``: the device's busy share of the request and
   B1 found in the trace by name (or, where the trace holds no device
   events, the share from CUDA events around H2D, kernel and D2H, and a
   line that says so);
11. the operator surface (plain PyTorch on the card): every small golden
   (``tests/goldens/goldens.npz``, 180 cases) and the large ones but
   phase 9's ModStall (4 at 719x929) through the port on ``cuda:0``
   (``tests/torch_conformance.py``), each under its case's own contract
   (mask exact where ``mask_exact``, values within the case's rtol /
   atol), the pass count printed; BASELINE config 1
   (``derived_fields_plevel`` at 96x128 and 719x929, 2% undefined) and
   config 3 (the 8-field stencil set at 721x1440, 0.5% undefined), each
   output held to the port on the CPU on the same inputs (masks bitwise,
   values within RTOL) and timed (CUDA events, median of 10); and the
   ensemble model, ``ensemble_derived_summary(fused=True)`` at 8 members x
   32 levels x 719x929 (each member the headline's inputs from its own
   seed): B1's launch count zeroed before and read after (it must rise by
   exactly 8), each member's B1 output bit for bit equal to
   ``derived_fields_plain``, the summary equal to the ``fused=False``
   route's (masks bitwise, defined values bit for bit), then its time
   split into the 8 launches, the member stack and the reductions, and
   ``torch.cuda.max_memory_allocated``.  The kernels line lists B1 a
   second time for this path (``"path": "ensemble_derived_summary"``);
   and the stencils that take map factors and coriolis
   (``plevelgwind_xcomp`` / ``_ycomp``, ``plevelgvort``, ``ilevelgwind``,
   ``momentum_x/y_coordinate``) called with numbers at 719x929, each bit
   for bit the same call with full planes of those numbers;
12. the stream: the page-locked and pageable copy rates of a 1 GiB buffer
   each way; the serving request's own steps as they overlap (decode,
   queueing, each chunk's wait and encode), its planes encoded in one call
   and in chunks, and what writing fresh output pages costs; six
   32x719x929 requests (masked and all-defined mixed) through
   ``run_derived_fields_np`` and twice through ``stream_derived_fields_np``
   with every kernel's count zeroed before the first (B1 exactly 6, no
   other kernel), every streamed dict byte for byte the serial entry's, the
   time between yields; the stream under ``torch.profiler`` (busy share,
   H2D, D2H and B1; B1 must be in the trace); and B1 on step 1's inputs
   against its plain version (the kernels line lists B1 a third time,
   ``"path": "stream_derived_fields_np"``);
13. the drop-in api (``mi_fieldcalc_tpu_torch.api``): every function once
   on the card at 719x929 (``tests/torch_api_cases.py``; the icing ones on
   phase 9's request 1) with every kernel's count zeroed before and read
   after (B5 and B6 exactly once each, no other kernel), each output held
   to the same call on the CPU (sentinels equal, values within RTOL and
   2e-6 of the field's largest magnitude) and vesselIcingMincog /
   vesselIcingModStall bit for bit to the plain operators on the card; then
   B5 and B6 alone on the api's decoded inputs against their plain
   versions (the kernels line lists them again with ``"path":
   "api.vesselIcingMincog"`` / ``"api.vesselIcingModStall"``);
14. call-storm batching (``api.batch``, ``mi_fieldcalc_tpu_torch/batch.py``):
   the 22-call storm of ``tools/perf_lab_batch.py`` at 96x128 and 719x929
   eagerly, at its first flush (record, warm-up, capture of one CUDA
   graph, replay) and replayed, every output byte for byte the eager api
   call's, with the replay's split (record, stacking into the page-locked
   block, H2D, replay, output copy, D2H); the icing storm (MINCOG alt 1
   and 2, ModStall) on phase 9's request 1 in one graph, byte for byte the
   eager calls and bit for bit the plain operators, the wrappers' counts
   zeroed just before its first flush and read after it (the warm-up's and
   the capture's launches), and B5 twice and B6 once in a
   ``torch.profiler`` trace of one replay, which runs no Python: those are
   the batch path's launches (the kernels line lists B5 and B6 a third
   time, ``"path": "api.batch (CUDA graph replay)"``); six forecast cycles
   at 719x929 with the input cache in four modes (fetch everything,
   pipelined, a 3-of-22 subset, bfloat16), each cycle held to the eager
   calls, the cache's hits and misses and the graphs' captures and
   replays to the plan, a replayed cycle's device busy share; the device
   memory each cached program keeps (its graph's pool and static inputs,
   from the allocator's snapshot), and what clearing the program cache
   returns.  A failed capture fails the phase; nothing
   falls back to eager calls;
15. the sharded pipeline (``mi_fieldcalc_tpu_torch/parallel/``): (a) B1
   with per-shard offsets at 32x719x929, masked and all-defined, on each
   shard of the (2, 2), (4, 1) and (1, 4) grids: the shard's block and a
   radius-2 halo ring cut from the global tensors (zeros, mask False,
   beyond the physical edges, as the exchange delivers them), launched,
   cropped and stitched, and the overlap geometry (the block alone, then
   the seam strips patched in, rows before columns), each stitched result
   bit for bit the unsharded launch at every point, the launches counted;
   each shard's launches timed beside their bytes bound and the unsharded
   launch, and the plain version under a shard's offsets; (b) the sharded
   path at world size 1 under NCCL (``parallel.distributed.initialize``
   on a free port of 127.0.0.1): ``derived_fields_fused_sharded`` with
   overlap off and on, ``derived_fields_isobaric_sharded`` at phase 7's
   137x719x929 -> 11, ``ensemble_summary_sharded`` at phase 11's
   ensemble, and ``shapiro2_filter`` through ``run_sharded``, each equal
   to its unsharded call, with B1 / B2 counted (1 / 0, 1 / 0, 1 / 1, 8 /
   0); the process group is destroyed at the end.  The kernels line lists
   B1 twice more (``"path": "derived_fields_fused_sharded"`` and ``"...
   (overlap)"``): the launches of (b), the time and bound of shard (0, 0)
   of (2, 2) in (a).  One card cannot show an exchange between ranks;
16. the rest of the JAX surface: (a) B2 at 40 fields x 137x719x929 -> the
   11 standard surfaces (phase 7's four column fields, 0.5% undefined,
   each copy shifted by its index in value and mask), masked and
   all-defined, under each JAX variant name (``"inplace"`` in one call;
   ``"packed"`` and ``"carrysel"`` must refuse 40 fields as the JAX
   function does and take them as calls of 31 and 9), each result bit for
   bit its plain version at every point in 2 launches; the launch alone
   (median of 10) beside its bytes bound and 10x phase 7's 4-field
   launch (the kernels line lists B2 again, ``"path":
   "hlevel_to_plevel_fused (40 fields)"``); (b) the tour
   ``examples/forecast_products_torch.py`` on the card with every
   kernel's count zeroed before and read after (B1 twice, in its sharded
   section and its aligned ingest, B4 once, no other kernel), then on the
   CPU: every number it returns equal (floats within RTOL); B1 as its
   sharded section launches it and B4 as its suite does, bit for bit their
   plain versions and timed (the kernels line lists both with ``"path":
   "forecast_products_torch"``);
17. the aligned ingest (``align=True``: the inputs re-gridded onto the
   aligned product grid, 719x929 -> 720x1024, by the codec's resampling
   decode): (a) two ``run_derived_fields_np`` requests at 32x719x929
   (undefined lanes live, fully defined), ``run_hlevel_suite_np`` with
   config 2's set, ``run_vessel_icing_np`` on phase 9's request 1 and 3
   steps of ``stream_derived_fields_np``, every kernel's count zeroed
   before and read after (B1 5, B4, B5 and B6 once each, no other
   kernel), every product on 720x1024; each entry then on the CPU: the
   stager's re-gridded input block byte for byte the card's, products
   with the same sentinels and values within RTOL and 2e-6 of the field's
   largest magnitude; each streamed step byte for byte the single call;
   (b) B1 (both requests), B4, B5 and B6 on the aligned inputs bit for bit
   their plain versions; B1 and P1 in turns on the masked request at
   720x1024 and at 719x929, B4's launch alone at both, B5 and B6 at
   720x1024, each beside its bound (the kernels line lists the four again
   with ``"path": "... (align=True)"``); (c) the masked request split,
   ragged and aligned in turns, and the codec's plain decode of the four
   stacks against its resampling decode.

Every kernel's record carries its bound (``bound_ms``): the larger of the
bytes it must move over the card's published memory rate and the float32
operations these inputs need over its published float32 rate (3.35 TB/s
and 67 TFLOP/s for the H100 SXM; ``utils.profiling``).  ``copy_bound_ms``
keeps the bound of the records before phase 10: the bytes over this run's
device-copy rate and the operations over the card's un-fused float32 issue
rate, SMs x 128 x the maximum SM clock, read from the card in this run (the
kernels are built -fmad=false, so an add and a multiply never share an
instruction; the data sheet's 67 TFLOP/s counts a fused multiply-add as
two).

    python3 chip_smoke.py --icing-times DIR [DIR ...]
    python3 chip_smoke.py --suite-times DIR [DIR ...]
    python3 chip_smoke.py --pipeline-times DIR [DIR ...]
    python3 chip_smoke.py --interp-times DIR [DIR ...]

time one family of kernels alone in each checkout DIR in turn (for two
versions on one card: parent, change, change, parent), each first held
to its plain version, with the SM clock before and after, and the ptxas
lines and SASS instruction counts (cuobjdump) of the family's kernels as
built: B5 and B6 on phase 9's request 1; B3 (config 2, 10x719x929, a p
field) and B4 (the suite entry's request 1, 32x719x929) on random and
smooth fields, masked and all-defined, bit for bit, the launch alone and
through the wrapper; B1 at 32x719x929 (phase 5's inputs, masked and
all-defined) and on the isobaric path's 11 surfaces (phase 7's), and B2 at
config 4 on its random and on a smooth ps, masked and all-defined, each
bit for bit, the launch alone and through the wrapper.  Each DIR needs only
its ``mi_fieldcalc_tpu_torch/``.

    python3 chip_smoke.py --interp-ab DIR_A DIR_B

compares B2 at config 4 in two checkouts within one process: both
packages loaded side by side, each held to its plain version, the card
warmed by 3 s of both launches, then 10 rounds in alternating order (A B,
B A, ...) of 30 timed launches a case and checkout; the quartiles of each
checkout's times and of its round medians, and each library's SASS counts.

    python3 chip_smoke.py --probes-ab DIR_A DIR_B [DIR ...]

is the same for the probes in two or more checkouts (the rounds and
counts are one helper, ``ab_rounds``): P1 masked and all-defined at
32x719x929 at every cap of ``bench_copy.CAPS`` (phase 5's inputs), P2 at
``PROBE_AB_ADD1``, ``torch.add(x, 1)`` in the same rounds, and P4 at
719x929, at 64x256 and on one capped lane alone; each checkout's best cap,
P2 over ``torch.add``, each P4 case over the first checkout's in every
round, the probes' ptxas lines and every kernel's SASS counts (B1-B6 too)
are logged.  B1 / P1 is phase 10's, where the two are timed in turns.

A line ``record: {...}`` holds every number measured.  The second-to-last
line is a JSON object with the kernels' records, the last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
NLEV, NY, NX = 32, 719, 929
SHAPES = ((3, 37, 61), (2, 33, 135), (1, 3, 3), (2, 5, 929), (4, 64, 256))
RTOL = 2e-5
#: float32 lanes per SM of Hopper (4 sub-partitions x 32): one add or one
#: multiply each per clock.  The operation side of every kernel's bound is
#: SMs x this x the maximum SM clock (phase_env), the un-fused rate
FP32_LANES_PER_SM = 128
#: the data sheet's H100 SXM float32 rate, FMA counted as two operations:
#: the bounds of earlier records, printed beside the corrected ones
PEAK_F32_FMA = 67e12
#: float32 operations per unit of work of B1-B4, counted low from the CUDA
#: sources (adds, multiplies, divisions; compares and selects not
#: counted): the bytes side bounds these kernels by a wide margin
OPS_B1_POINT = 150          # per point and level, all 12 outputs
OPS_B2_STEP = 2             # per column, target and search step (p_k)
OPS_B2_TARGET = 80          # per column and target: two logs, the weights
OPS_SUITE_OUTPUT = 20       # per output point of B3 / B4
OPS_COPY_POINT = 30         # per point of the copy probe P1: its 18 adds
                            # into s and the 12 of s + k
NAMES = ("p", "th", "rh", "td", "thetae", "ducting", "wspeed", "vort", "div",
         "tadv", "gradt", "tfp")
#: phase 6's shapes: phase 3's and a 137-level column
KERNEL_SHAPES = SHAPES + ((137, 9, 150),)
#: BASELINE config 4 (tools/baseline_configs.py:209-249) and config 2
#: (:130-174) at full size; the suite entry's requests at phase 4's size
ISO_SHAPE = (137, 719, 929)
A_SUITE_SHAPE = (10, 719, 929)
SUITE_SHAPE = (32, 719, 929)
CONFIG2 = {"temps": (3, 4), "hums_q": (1, 5, 9), "hums_rh": (3, 7, 11)}
#: every valid mode of every suite family (ops/fused_suite.py _VALID)
ALL_MODES = {"temps": (1, 2, 3, 4, 5), "hums_q": (1, 2, 5, 6, 9, 10),
             "hums_rh": (3, 4, 7, 8, 11, 12), "thes": (1, 2),
             "ducts_q": (1, 2), "ducts_rh": (3, 4)}


def log(*args) -> None:
    print(*args, flush=True)


def hbm_bytes(nlev: int, ny: int, nx: int) -> int:
    """Each input read once and each output written once, values and
    masks (the byte count of bench.py:84-93)."""
    pts3, pts2 = nlev * ny * nx, ny * nx
    reads = 4 * pts3 * 5 + pts2 * 5 + 3 * pts2 * 4 + 2 * nlev * 4
    return reads + 12 * pts3 * 5


def layout_bytes(nlev: int, ny: int, nx: int, all_defined: bool) -> int:
    """Bytes the kernel's own layout moves at least once: 4 value stacks
    (+ 4 mask stacks), ps (+ mask), 2 map planes, 12 value planes and 9 (or
    2) mask planes."""
    pts3, pts2 = nlev * ny * nx, ny * nx
    if all_defined:
        return 4 * pts3 * 4 + pts2 * 4 + 2 * pts2 * 4 + 12 * pts3 * 4 + 2 * pts3
    return 4 * pts3 * 5 + pts2 * 5 + 2 * pts2 * 4 + 12 * pts3 * 4 + 9 * pts3


def make_inputs(nlev, ny, nx, seed, undefs, kind="scattered"):
    """Seeded sentinel numpy inputs (the 10 arguments of the pipeline).
    ``scattered``: the kernel tests' pattern (test_fused.py), undefs at
    ~1/37 of points, corners, a 500 K point and an undefined ps point;
    ``column``: the benchmark's pattern (__graft_entry__.py), one undefined
    temperature column."""
    rng = np.random.default_rng(seed)
    tk = rng.normal(275.0, 15.0, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    u = rng.normal(0.0, 12.0, (nlev, ny, nx)).astype(np.float32)
    v = rng.normal(0.0, 12.0, (nlev, ny, nx)).astype(np.float32)
    ps = rng.normal(1000.0, 15.0, (ny, nx)).astype(np.float32)
    if undefs and kind == "scattered":
        for arr in (tk, q, u, v):
            arr.reshape(-1)[rng.integers(0, arr.size, arr.size // 37)] = 1e35
        tk[0, 0, 0] = 1e35
        tk[-1, -1, -1] = 1e35
        tk[0, min(1, ny - 1), min(1, nx - 1)] = 500.0
        ps[ny // 2, nx // 2] = 1e35
    elif undefs:
        tk[:, ny // 3, nx // 3] = 1e35
    alevel = np.linspace(0.0, 50.0, nlev).astype(np.float32)
    blevel = np.linspace(1.0, 0.5, nlev).astype(np.float32)
    if kind == "scattered":
        xm = rng.uniform(3e-7, 5e-7, (ny, nx)).astype(np.float32)
        ym = rng.uniform(3e-7, 5e-7, (ny, nx)).astype(np.float32)
    else:
        xm = np.full((ny, nx), 4.0e-7, np.float32)
        ym = np.full((ny, nx), 3.6e-7, np.float32)
    fc = np.full((ny, nx), 1.2e-4, np.float32)
    return tk, q, u, v, ps, alevel, blevel, xm, ym, fc


def sentinel(rng, lo, hi, shape, undef_frac: float) -> np.ndarray:
    """Uniform float32 values with ``undef_frac`` of them set to 1e35."""
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    if undef_frac:
        a[rng.random(shape) < undef_frac] = np.float32(1e35)
    return a


def make_column_inputs(nlev, ny, nx, seed, undef_frac, undef_ps=False):
    """BASELINE config 4's inputs (tools/baseline_configs.py:216-233):
    T 220-300 K, q, u, v with ``undef_frac`` undefined points, ps
    950-1030 hPa (one undefined point with ``undef_ps``), and the hybrid
    law ``a = linspace(50, 300)``, ``b = linspace(0, 0.7)**1.5``, whose
    model top is 50 hPa and whose lowest level lies near 900 hPa."""
    rng = np.random.default_rng(seed)
    shape = (nlev, ny, nx)
    tk = sentinel(rng, 220.0, 300.0, shape, undef_frac)
    q = sentinel(rng, 1e-4, 1e-2, shape, undef_frac)
    u = sentinel(rng, -40.0, 40.0, shape, undef_frac)
    v = sentinel(rng, -40.0, 40.0, shape, undef_frac)
    ps = rng.uniform(950.0, 1030.0, (ny, nx)).astype(np.float32)
    if undef_ps:
        ps[ny // 2, nx // 2] = np.float32(1e35)
    alevel = np.linspace(50.0, 300.0, nlev).astype(np.float32)
    blevel = (np.linspace(0.0, 0.7, nlev) ** 1.5).astype(np.float32)
    xm = np.full((ny, nx), 4.0e-7, np.float32)
    fc = np.full((ny, nx), 1.2e-4, np.float32)
    return tk, q, u, v, ps, alevel, blevel, xm, xm.copy(), fc


def smooth_ps(ny, nx, seed) -> np.ndarray:
    """A surface pressure of config 4's range (950-1030 hPa) that varies
    slowly over the grid, as a model's does: one wave along x times one
    along y, so neighbouring columns bracket each target at the same or
    the next level."""
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0.0, 2.0 * np.pi, 2)
    y = np.arange(ny, dtype=np.float64)[:, None] / ny
    x = np.arange(nx, dtype=np.float64)[None, :] / nx
    return (990.0 + 40.0 * np.sin(2.0 * np.pi * x + ph[0])
            * np.cos(2.0 * np.pi * y + ph[1])).astype(np.float32)


def make_suite_inputs(nlev, ny, nx, seed, undef_frac, plant=True):
    """BASELINE config 2's inputs (tools/baseline_configs.py:135-147): T
    250-300 K, q, RH 5-95 % with ``undef_frac`` undefined points and a
    pressure field p 300-1000 hPa; plus ps 950-1030 hPa and hybrid
    coefficients for the h-level suite.  ``plant`` adds temperatures
    beyond both ends of the saturation table, p = 0 and p < 0, and (with
    undefined points) an undefined p and ps point."""
    rng = np.random.default_rng(seed)
    shape = (nlev, ny, nx)
    tk = sentinel(rng, 250.0, 300.0, shape, undef_frac)
    q = sentinel(rng, 1e-4, 1e-2, shape, undef_frac)
    rh = sentinel(rng, 5.0, 95.0, shape, undef_frac)
    p = rng.uniform(300.0, 1000.0, shape).astype(np.float32)
    ps = rng.uniform(950.0, 1030.0, (ny, nx)).astype(np.float32)
    if plant:
        tk[0, 0, 0] = 520.0
        tk[-1, -1, -1] = 100.0
        p[0, min(1, ny - 1), min(1, nx - 1)] = 0.0
        p[-1, -1, 0] = -5.0
        if undef_frac:
            p[0, ny // 2, nx // 2] = np.float32(1e35)
            ps[ny // 2, nx // 2] = np.float32(1e35)
    alevel = np.linspace(30.0, 0.0, nlev).astype(np.float32)
    blevel = np.linspace(0.02, 1.0, nlev).astype(np.float32)
    return tk, q, rh, p, ps, alevel, blevel


def make_smooth_suite_inputs(nlev, ny, nx, seed, undef_frac):
    """:func:`make_suite_inputs`'s ranges as model fields have them:
    slowly varying along x and y (a few waves across the grid, ~0.1 K from
    one x point to the next), so the 32 points of a warp fall into one or
    two saturation-table bins; ``undef_frac`` scattered undefined points."""
    rng = np.random.default_rng(seed)
    shape = (nlev, ny, nx)
    k = np.arange(nlev, dtype=np.float64)[:, None, None] / max(nlev - 1, 1)
    y = np.arange(ny, dtype=np.float64)[None, :, None] / ny
    x = np.arange(nx, dtype=np.float64)[None, None, :] / nx
    ph = rng.uniform(0.0, 2.0 * np.pi, 4)
    wave = [np.sin(2.0 * np.pi * (3.0 * x + 2.0 * y) + ph[i] + 3.0 * k)
            * np.cos(np.pi * (2.0 * y - x) + ph[i]) for i in range(3)]

    def field(w, lo, hi):
        a = (lo + (hi - lo) * (0.5 + 0.5 * w)).astype(np.float32)
        if undef_frac:
            a[rng.random(shape) < undef_frac] = np.float32(1e35)
        return a

    tk = field(wave[0], 250.0, 300.0)
    q = field(wave[1], 1e-4, 1e-2)
    rh = field(wave[2], 5.0, 95.0)
    swell = np.sin(2.0 * np.pi * (x + y) + ph[3])
    p = np.clip(300.0 + 700.0 * k + 20.0 * swell, 300.0, 1000.0).astype(
        np.float32)
    ps = (990.0 + 40.0 * swell[0]).astype(np.float32)
    alevel = np.linspace(30.0, 0.0, nlev).astype(np.float32)
    blevel = np.linspace(0.02, 1.0, nlev).astype(np.float32)
    return tk, q, rh, p, ps, alevel, blevel


def value_err(got, ref, label: str) -> float:
    """Max |kernel - plain| (NaN equal to NaN, equal infinities equal);
    raises where they differ by more than RTOL relative."""
    import torch
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    err = torch.where(same, torch.zeros_like(got), (got - ref).abs())
    bad = ~same & ~(err <= RTOL * ref.abs())
    if bool(bad.any()):
        k = int(bad.reshape(-1).nonzero()[0, 0])
        raise AssertionError(
            f"{label}: {int(bad.sum())} values outside rtol {RTOL}, e.g. "
            f"kernel {float(got.reshape(-1)[k])!r} plain "
            f"{float(ref.reshape(-1)[k])!r}")
    return float(err.max()) if err.numel() else 0.0


def compare_fields(got, ref, label: str, defined_only: bool) -> float:
    """Kernel vs plain lists of Fields: masks bitwise, values by
    :func:`value_err` on every point or on the defined points; returns the
    max abs error."""
    import torch
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} outputs, plain "
                             f"{len(ref)}")
    worst = 0.0
    for k, (g, r) in enumerate(zip(got, ref)):
        if not torch.equal(g.mask, r.mask):
            raise AssertionError(f"{label} output {k}: masks differ at "
                                 f"{int((g.mask != r.mask).sum())} points")
        gv, rv = ((g.values[g.mask], r.values[r.mask]) if defined_only
                  else (g.values, r.values))
        worst = max(worst, value_err(gv, rv, f"{label} output {k}"))
    return worst


def time_ms(fn, reps: int, warmup: bool = True) -> list:
    """Per-run device times of ``fn`` in ms (CUDA events), after a warm-up
    run unless ``warmup`` is False."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def same_bits(a, b):
    """Where two float32 tensors are equal bit for bit, or both NaN."""
    import torch
    return (a.view(torch.int32) == b.view(torch.int32)) | (
        torch.isnan(a) & torch.isnan(b))


def compare_stacked(got, ref, label: str) -> dict:
    """B1 vs its plain version on the card: masks bitwise, values bit for
    bit on defined points (NaN where NaN); raises otherwise.  Returns
    per-output max relative and absolute errors (0.0) and whether the
    values are equal at every point too (``every_point``)."""
    import torch
    from mi_fieldcalc_tpu_torch.models.pipeline import DerivedFieldsStacked
    if got.masks.shape != ref.masks.shape or not torch.equal(got.masks,
                                                             ref.masks):
        diff = int((got.masks != ref.masks).sum()) \
            if got.masks.shape == ref.masks.shape else -1
        raise AssertionError(f"{label}: masks differ at {diff} points")
    rel, absd = {}, {}
    for i, name in enumerate(NAMES):
        m = DerivedFieldsStacked.mask_plane(got.masks, i, got.values[i])
        g, r = got.values[i][m], ref.values[i][m]
        bad = ~same_bits(g, r)
        if bool(bad.any()):
            k = int(bad.nonzero()[0, 0])
            raise AssertionError(
                f"{label} {name}: {int(bad.sum())} defined values not bit "
                f"for bit, e.g. kernel {float(g[k])!r} plain {float(r[k])!r}")
        rel[name] = absd[name] = 0.0
    every = bool(same_bits(got.values, ref.values).all())
    return {"max_rel": rel, "max_abs": absd, "every_point": every}


def compare_fields_exact(got, ref, label: str) -> bool:
    """B2 vs its plain version (lists of Fields): masks bitwise, values bit
    for bit at every point (NaN where NaN); raises otherwise."""
    import torch
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} outputs, plain "
                             f"{len(ref)}")
    for k, (g, r) in enumerate(zip(got, ref)):
        if not torch.equal(g.mask, r.mask):
            raise AssertionError(f"{label} output {k}: masks differ at "
                                 f"{int((g.mask != r.mask).sum())} points")
        bad = ~same_bits(g.values, r.values)
        if bool(bad.any()):
            raise AssertionError(f"{label} output {k}: {int(bad.sum())} "
                                 f"values not bit for bit")
    return True


def compare_dicts(got: dict, ref: dict, label: str) -> None:
    """B1's sentinel dicts: identical undef positions, values bit for bit
    (NaN where NaN)."""
    for name in NAMES:
        g, r = got[name], ref[name]
        if g.shape != r.shape:
            raise AssertionError(f"{label} {name}: shape {g.shape} != "
                                 f"{r.shape}")
        ug, ur = g == np.float32(1e35), r == np.float32(1e35)
        if not np.array_equal(ug, ur):
            raise AssertionError(f"{label} {name}: undef positions differ "
                                 f"at {int((ug != ur).sum())} points")
        ok = (g.view(np.int32) == r.view(np.int32)) | (
            np.isnan(g) & np.isnan(r))
        if not ok.all():
            raise AssertionError(f"{label} {name}: {int((~ok).sum())} "
                                 f"values not bit for bit")


def check_physics(out: dict, nlev: int, ny: int, nx: int) -> None:
    """The repo's own sanity bounds on a request's outputs: the expected
    shape, finite defined values, and plausible magnitudes on the
    benchmark inputs (theta and dewpoint in Kelvin, wind speed >= 0)."""
    for name in NAMES:
        a = out[name]
        if a.shape != (nlev, ny, nx) or a.dtype != np.float32:
            raise AssertionError(f"{name}: {a.shape} {a.dtype}")
        d = a[a != np.float32(1e35)]
        if d.size < a.size // 2 or not np.isfinite(d).all():
            raise AssertionError(f"{name}: too few or non-finite values")
    th = out["th"][out["th"] != np.float32(1e35)]
    td = out["td"][out["td"] != np.float32(1e35)]
    if not (150.0 < np.median(th) < 600.0 and 150.0 < np.median(td) < 400.0
            and out["wspeed"].min() >= 0.0):
        raise AssertionError("outputs outside physical bounds")


def encode_stacked(out) -> dict:
    """A pipeline result (a ``DerivedFieldsStacked`` on any device) as the
    serving entry's sentinel dict, through a stager of its own."""
    from mi_fieldcalc_tpu_torch import staging
    return staging._encode_step(staging._fetch(out, staging.HostStager(4)),
                                1e35)


def icing_fields(args, dev) -> tuple:
    """The 11 icing inputs decoded and uploaded as the serving entry
    does."""
    from mi_fieldcalc_tpu_torch import staging
    stager = staging.HostStager(11, pin=dev.type == "cuda")
    stager.decode(*args)
    return staging._icing_upload_step(stager, dev)


def icing_runs(fields, alt: int) -> dict:
    """B5 (MINCOG with ``alt``) and B6 on decoded icing Fields at
    ICING_SCAL: ``{name: (launch, plain, nplanes, nflags)}``, the launch
    alone and ``plain(trips=None)``, the plain version, on the same
    prologue planes; ``nplanes`` / ``nflags`` the planes and flags the
    kernel reads."""
    import math
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    from mi_fieldcalc_tpu_torch.ops.icing import _mincog_decay, _number
    vs, alpha, zmin, zmax = ICING_SCAL
    vsca = float(vs * math.cos(alpha))
    decay = _mincog_decay(zmin, _number(zmin, zmax))
    g5, p5, sh5, sk5 = F._mincog_prologue(*fields, vs, alpha)
    g6, p6, sh6 = F._modstall_prologue(*fields)
    return {
        "mincog": (lambda: F._launch(
            F.vessel_icing_mincog_fused, F._PLANES, p5, (g5, sh5, sk5),
            decay, vsca, alt),
            lambda trips=None: F._mincog_plain(g5, p5, sh5, sk5, vsca, alt,
                                               decay, trips), 17, 3),
        "modstall": (lambda: F._launch(
            F.vessel_icing_modstall_fused, F._MS_PLANES, p6, (g6, sh6),
            decay, vsca, None),
            lambda trips=None: F._modstall_plain(g6, p6, sh6, vsca, decay,
                                                 trips), 12, 2)}


def request_split(reps: int, dev, decode, upload, compute, fetch,
                  encode) -> tuple:
    """One serving request ``reps + 1`` times, split into decode, H2D,
    kernel, D2H (every chunk copied) and encode on the host clock around
    synchronised steps; beside them the parent design's pageable copies
    of the same blocks (``from_numpy(...).to(device)`` in, ``.cpu()`` into
    fresh host tensors out).  Returns the first (allocating) request's
    split and the median of the others'."""
    import torch
    keys = ("decode", "h2d", "kernel", "d2h", "encode", "total",
            "pageable_h2d", "pageable_d2h")
    parts = {k: [] for k in keys}
    for _ in range(reps + 1):
        marks = []

        def mark():
            torch.cuda.synchronize(dev)
            marks.append(time.perf_counter())

        mark()
        host, ad = decode()
        mark()
        staged = upload(host)
        mark()
        out = compute(staged, ad)
        mark()
        fetched = fetch(out)
        mark()
        encode(fetched)
        mark()
        # pageable copies of the blocks: CUDA recognises page-locked
        # memory, so a copy straight from the stager would run as one
        pageable = [np.array(host.values), np.array(host.mask)]
        mark()
        for a in pageable:
            torch.from_numpy(a).to(dev)
        mark()
        out.values.cpu()
        out.masks.cpu()
        mark()
        dts = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        for key, dt in zip(keys, dts[:5] + [sum(dts[:5])] + dts[6:]):
            parts[key].append(dt)
        del host, staged, out, fetched
    first = {k: v[0] for k, v in parts.items()}
    return first, {k: statistics.median(v[1:]) for k, v in parts.items()}


def phase_env() -> tuple:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f32_rate = sms * FP32_LANES_PER_SM * clock * 1e6
    log(f"float32 issue rate: {sms} SMs x {FP32_LANES_PER_SM} lanes x "
        f"{clock:.0f} MHz = {f32_rate / 1e12:.2f} T operations/s")
    from mi_fieldcalc_tpu_torch._build import find_nvcc
    nvcc = find_nvcc()
    nvcc_v = "not found"
    if nvcc:
        nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True,
                                text=True, timeout=60).stdout.strip()
        nvcc_v = nvcc_v.splitlines()[-1]
    try:
        import triton
        tri = f"imports ({triton.__version__})"
    except ImportError as e:
        tri = f"does not import ({e})"
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch CUDA {torch.version.cuda}  nvcc: {nvcc} ({nvcc_v})")
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}  triton {tri}")
    return smi, {"nvcc": nvcc_v, "triton": tri, "torch": torch.__version__,
                 "torch_cuda": torch.version.cuda, "sms": sms,
                 "max_sm_clock_mhz": clock, "f32_rate": f32_rate}


def phase_build() -> dict:
    from mi_fieldcalc_tpu_torch import _build, native
    t = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    t_cuda = time.perf_counter() - t
    t = time.perf_counter()
    codec = native.codec()
    t_host = time.perf_counter() - t
    log(f"build: CUDA library {lib.name} in {t_cuda:.2f} s; host codec "
        f"'{codec}' in {t_host:.2f} s")
    report = Path(str(lib) + ".log")
    if report.is_file():
        for line in report.read_text().splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log("  ptxas: " + line.strip())
    if codec != "native":
        raise AssertionError("the native host codec did not build")
    return {"cuda_build_s": t_cuda, "host_codec_s": t_host, "codec": codec}


def phase_kernel(dev, shapes=SHAPES) -> dict:
    import torch
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.ops import fused
    worst = {}
    for shape in shapes:
        for all_defined in (False, True):
            raw = make_inputs(*shape, seed=sum(shape),
                              undefs=not all_defined)
            args = tuple(from_sentinel(a, device=dev) for a in raw[:5]) + \
                tuple(torch.as_tensor(a, device=dev) for a in raw[5:])
            got = fused.derived_fields_fused(*args, all_defined=all_defined)
            ref = fused.derived_fields_plain(*args, all_defined=all_defined)
            label = f"{shape} {'all_defined' if all_defined else 'masked'}"
            errs = compare_stacked(got, ref, label)
            log(f"kernel == plain {label}: max rel err " + " ".join(
                f"{k}={v:.1e}" for k, v in errs["max_rel"].items()))
            for k, v in errs["max_rel"].items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def phase_main_path(dev, nlev=NLEV, ny=NY, nx=NX) -> dict:
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.ops import fused
    requests = [("undef lanes live", make_inputs(nlev, ny, nx, 1, True,
                                                 "column"), False),
                ("fully defined", make_inputs(nlev, ny, nx, 2, False,
                                              "column"), True),
                ("undef lanes live", make_inputs(nlev, ny, nx, 3, True,
                                                 "scattered"), False)]
    fused.derived_fields_fused.launches = 0
    outs, buffers = [], []
    for _, args, _ in requests:
        outs.append(staging.run_derived_fields_np(*args, device=dev))
        stager = staging._stager_cache(4, 1e35, True)
        buffers.append((id(stager), id(stager.values), stager.pin))
    torch.cuda.synchronize(dev)
    launches = fused.derived_fields_fused.launches
    log(f"main path: 3 requests at {nlev}x{ny}x{nx}, kernel launches "
        f"{launches}")
    if launches != 3:
        raise AssertionError(f"expected 3 kernel launches, got {launches}")
    if len(set(buffers)) != 1:
        raise AssertionError("the host stager was not reused")

    max_abs = 0.0
    for k, ((label, args, want_ad), out) in enumerate(zip(requests, outs)):
        host, all_defined = staging._decode_step(
            args, staging.HostStager(4), 1e35)
        if all_defined != want_ad:
            raise AssertionError(f"request {k + 1}: all_defined routed "
                                 f"{all_defined}, expected {want_ad}")
        staged = staging._upload_step(host, dev)
        plain = fused.derived_fields_plain(*staged, all_defined=all_defined)
        if k == 0:
            kern = fused.derived_fields_fused(*staged)
            errs = compare_stacked(kern, plain, "full size masked")
            max_abs = max(errs["max_abs"].values())
            del kern
        ref = encode_stacked(plain)
        del plain, staged
        compare_dicts(out, ref, f"request {k + 1}")
        check_physics(out, nlev, ny, nx)
        log(f"request {k + 1} ({label}, all_defined={all_defined}): "
            f"12 outputs == plain version")
    return {"launches": launches, "max_abs_err": max_abs}


def phase_times(dev, smi: str, nlev=NLEV, ny=NY, nx=NX, reps=10,
                request_reps=5) -> dict:
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.ops import fused
    res = {"card": smi, "shape": [nlev, ny, nx]}
    for label, undefs in (("masked", True), ("all_defined", False)):
        args = make_inputs(nlev, ny, nx, 4, undefs, "column")
        host, ad = staging._decode_step(args, staging.HostStager(4), 1e35)
        staged = staging._upload_step(host, dev)
        k = time_ms(lambda: fused.derived_fields_fused(
            *staged, all_defined=ad), reps)
        alone = time_device_ms(lambda: fused._launch(*staged[:9], ad), reps)
        p = time_ms(lambda: fused.derived_fields_plain(
            *staged, all_defined=ad), reps)
        km, pm = statistics.median(k), statistics.median(p)
        res[label] = {
            "kernel_ms": km, "kernel_ms_all": k, "plain_ms": pm,
            "plain_ms_all": p, "launch_ms": statistics.median(alone),
            "launch_ms_all": alone,
            "gbps_bench_bytes": hbm_bytes(nlev, ny, nx) / km / 1e6,
            "gbps_layout_bytes": layout_bytes(nlev, ny, nx, ad) / km / 1e6}
        log(f"[{smi}] {label}: kernel median {km:.4f} ms (the launch "
            f"alone {res[label]['launch_ms']:.4f} ms), plain "
            f"{pm:.4f} ms ({pm / km:.1f}x), "
            f"{res[label]['gbps_bench_bytes']:.1f} GB/s by bench.py's byte "
            f"count, {res[label]['gbps_layout_bytes']:.1f} GB/s by the "
            f"kernel layout's bytes")
        del staged
    # a device-to-device copy of the step's size, for scale
    n = hbm_bytes(nlev, ny, nx) // 8
    src = torch.empty(n, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    c = statistics.median(time_ms(lambda: dst.copy_(src), reps))
    res["copy_gbps"] = 2 * 4 * n / c / 1e6
    log(f"[{smi}] device copy of {2 * 4 * n / 1e9:.2f} GB moved: "
        f"{res['copy_gbps']:.1f} GB/s")
    del src, dst

    for label, undefs in (("masked", True), ("all_defined", False)):
        args = make_inputs(nlev, ny, nx, 5, undefs, "column")
        stager = staging.HostStager(4, pin=True)
        first, med = request_split(
            request_reps, dev,
            lambda: staging._decode_step(args, stager, 1e35),
            lambda host: staging._upload_step(host, dev),
            staging._compute,
            lambda out: staging._fetch(out, stager),
            lambda fetched: staging._encode_step(fetched, 1e35))
        res[f"request_{label}_ms"] = med
        res[f"request_{label}_first_ms"] = first
        log(f"[{smi}] request ({label}, page-locked blocks) median of "
            f"{request_reps}, ms: " + " ".join(
                f"{k}={v:.2f}" for k, v in med.items())
            + "; the first (allocating) request: " + " ".join(
                f"{k}={v:.2f}" for k, v in first.items()))
    return res


def phase_new_kernels(dev) -> dict:
    """The column-interpolation kernel (B2) and the a- and h-level suite
    kernels (B3, B4) against their plain versions at KERNEL_SHAPES."""
    import torch
    from mi_fieldcalc_tpu_torch.field import Field, from_sentinel
    from mi_fieldcalc_tpu_torch.models import STANDARD_PLEVELS
    from mi_fieldcalc_tpu_torch.ops import fused_suite as fs
    from mi_fieldcalc_tpu_torch.ops import vertical_fused as vf

    def on(a):
        return torch.as_tensor(a, device=dev)

    # 20 hPa lies above the model top, 1100 hPa below every surface
    targets = STANDARD_PLEVELS + (20.0, 1100.0)
    worst = {"interp": 0.0, "alevel_suite": 0.0, "hlevel_suite": 0.0}
    for shape in KERNEL_SHAPES:
        for all_defined in (False, True):
            raw = make_column_inputs(*shape, seed=sum(shape),
                                     undef_frac=0.0 if all_defined else 0.03,
                                     undef_ps=not all_defined)
            fields = tuple(from_sentinel(a, device=dev) for a in raw[:4])
            ps = from_sentinel(raw[4], device=dev)
            a, b = on(raw[5]), on(raw[6])
            kind = "all_defined" if all_defined else "masked"
            for log_p in (True, False):
                label = f"interp {shape} {kind} log_p={log_p}"
                got = vf.hlevel_to_plevel_fused(fields, ps, a, b, targets,
                                                log_p=log_p,
                                                all_defined=all_defined)
                ref = vf.hlevel_to_plevel_plain(fields, ps, a, b, targets,
                                                log_p, all_defined)
                compare_fields_exact(got, ref, label)
            del fields, ps
    log(f"interp == plain bit for bit at {len(KERNEL_SHAPES)} shapes x "
        f"masked/all-defined x ln p/p")

    # one column whose pressure is not monotone: 57 hPa is bracketed by
    # levels (0, 1) and (2, 3); the last bracket wins
    al = np.array([10, 60, 50, 60, 80, 100, 120, 100, 50], np.float32)
    bl = np.array([0, 0, .1, .2, .3, .45, .6, .8, 1.0], np.float32)
    rng = np.random.default_rng(3)
    psv = rng.uniform(980.0, 1030.0, (4, 5)).astype(np.float32)
    psv[1, 2] = 50.0
    col = al + bl * psv[1, 2]
    if [k for k in range(8) if col[k] <= 57.0 < col[k + 1]] != [0, 2]:
        raise AssertionError("the non-monotone column is not set up")
    fv = rng.normal(0.0, 1.0, (9, 4, 5)).astype(np.float32)
    f = Field(on(fv), torch.ones(fv.shape, dtype=torch.bool, device=dev))
    psf = Field(on(psv), torch.ones(psv.shape, dtype=torch.bool, device=dev))
    nm_targets = (57.0, 500.0, 850.0)
    got = vf.hlevel_to_plevel_fused((f,), psf, on(al), on(bl), nm_targets)
    ref = vf.hlevel_to_plevel_plain((f,), psf, on(al), on(bl), nm_targets)
    compare_fields_exact(got, ref, "interp non-monotone column")
    x0, x1 = np.log(col[2]), np.log(col[3])
    want = fv[2, 1, 2] + (fv[3, 1, 2] - fv[2, 1, 2]) * (
        (np.log(57.0) - x0) / (x1 - x0))
    if not (bool(got[0].mask[0, 1, 2])
            and abs(float(got[0].values[0, 1, 2]) - want) < 1e-5):
        raise AssertionError("non-monotone column: not the last bracket")
    log("interp == plain on a non-monotone column (last bracket wins)")

    reqs = fs._build_reqs("chip_smoke", **ALL_MODES)
    for shape in KERNEL_SHAPES:
        for all_defined in (False, True):
            tk, q, rh, p, psv, al, bl = make_suite_inputs(
                *shape, seed=sum(shape) + 1,
                undef_frac=0.0 if all_defined else 0.03)
            t, q, rh, p, ps = (from_sentinel(x, device=dev)
                               for x in (tk, q, rh, p, psv))
            a, b = on(al), on(bl)
            kind = "all_defined" if all_defined else "masked"
            for name, got, ref in (
                    ("alevel_suite", fs.alevel_suite_stacked(
                        t, q, rh, p, reqs, all_defined),
                     fs.alevel_suite_plain(t, q, rh, p, reqs, all_defined)),
                    ("hlevel_suite", fs.hlevel_suite_stacked(
                        t, q, rh, ps, a, b, reqs, all_defined),
                     fs.hlevel_suite_plain(t, q, rh, ps, a, b, reqs,
                                           all_defined))):
                label = f"{name} {shape} {kind}"
                if got.mask_map != ref.mask_map or not torch.equal(
                        got.masks, ref.masks):
                    raise AssertionError(f"{label}: mask planes differ")
                worst[name] = max(worst[name], compare_fields(
                    got.as_fields(), ref.as_fields(), label,
                    defined_only=True))
                if worst[name] != 0.0:
                    raise AssertionError(f"{label}: not bit for bit "
                                         f"(max abs err {worst[name]!r})")
    log(f"alevel / hlevel suite == plain, {len(reqs)} modes in one request, "
        f"at {len(KERNEL_SHAPES)} shapes x masked/all-defined: max abs err "
        f"{worst['alevel_suite']!r} / {worst['hlevel_suite']!r}")
    return worst


def interp_bytes(nvar, nlev, nt, ny, nx, all_defined: bool) -> dict:
    """B2's bytes moved once: the whole level stack (values and masks),
    ps, and the outputs; and the bracket-only reads (two levels per field
    and target) the kernel makes."""
    pts, m = ny * nx, 0 if all_defined else 1
    out = nvar * nt * pts * 4 + (1 if all_defined else nvar) * nt * pts
    return {"stack": nvar * nlev * pts * (4 + m) + pts * (4 + m) + out,
            "bracket": 2 * nvar * nt * pts * (4 + m) + pts * (4 + m) + out}


def suite_bytes(nin3, nout, nplanes, nlev, ny, nx, ps_plane: bool,
                all_defined: bool) -> int:
    """B3 / B4's bytes moved once: ``nin3`` input stacks (values and
    masks), ps (B4), ``nout`` value planes and ``nplanes`` mask planes."""
    pts3, pts2, m = nlev * ny * nx, ny * nx, 0 if all_defined else 1
    return (nin3 * pts3 * (4 + m) + (pts2 * (4 + m) if ps_plane else 0)
            + nout * pts3 * 4 + nplanes * pts3)


def phase_isobaric(dev, smi: str, copy_gbps: float, reps=10) -> dict:
    """BASELINE config 4 at full size through derived_fields_isobaric."""
    import torch
    from mi_fieldcalc_tpu_torch.field import Field, from_sentinel
    from mi_fieldcalc_tpu_torch.models import (STANDARD_PLEVELS,
                                               derived_fields_isobaric)
    from mi_fieldcalc_tpu_torch.ops import fused
    from mi_fieldcalc_tpu_torch.ops import vertical_fused as vf

    nlev, ny, nx = ISO_SHAPE
    nt = len(STANDARD_PLEVELS)
    raw = make_column_inputs(nlev, ny, nx, seed=3, undef_frac=0.005)
    torch.cuda.reset_peak_memory_stats(dev)
    args = tuple(from_sentinel(a, device=dev) for a in raw[:5]) + tuple(
        torch.as_tensor(a, device=dev) for a in raw[5:])
    del raw
    in_gb = sum(f.values.numel() * 5 for f in args[:4]) / 1e9
    fused.derived_fields_fused.launches = 0
    vf.hlevel_to_plevel_fused.launches = 0
    out = derived_fields_isobaric(*args, plevels=STANDARD_PLEVELS,
                                  fused=True, stacked=True)
    torch.cuda.synchronize(dev)
    launches = {"interp": vf.hlevel_to_plevel_fused.launches,
                "derived_fields": fused.derived_fields_fused.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"isobaric path {nlev}x{ny}x{nx} -> {nt} levels: launches "
        f"{launches}, inputs {in_gb:.2f} GB on the card, peak device "
        f"memory {peak_gb:.2f} GB")
    if launches != {"interp": 1, "derived_fields": 1}:
        raise AssertionError(f"expected one launch of each kernel, got "
                             f"{launches}")
    # the plain composition on the same tensors
    tk, q, u, v, ps, a, b, xm, ym, fc = args
    interp = vf.hlevel_to_plevel_plain((tk, q, u, v), ps, a, b,
                                       STANDARD_PLEVELS)
    plain = fused.derived_fields_plain(
        *iso_surface_args(interp, xm, ym, fc, dev))
    errs = compare_stacked(out, plain, "isobaric full size")
    max_abs = max(errs["max_abs"].values())
    res = encode_stacked(out)
    check_physics(res, nt, ny, nx)
    log(f"isobaric path == plain composition (max abs err {max_abs!r}); "
        f"outputs within the physical bounds")
    del out, plain, res

    # B2 alone at full size, bit for bit: on these inputs and on a smooth
    # ps of the same range (neighbouring columns share their brackets)
    fields4 = (tk, q, u, v)
    kern = vf.hlevel_to_plevel_fused(fields4, ps, a, b, STANDARD_PLEVELS)
    compare_fields_exact(kern, interp, "interp full size")
    del interp
    ps_s = Field(torch.as_tensor(smooth_ps(ny, nx, 3), device=dev), ps.mask)
    compare_fields_exact(
        vf.hlevel_to_plevel_fused(fields4, ps_s, a, b, STANDARD_PLEVELS),
        vf.hlevel_to_plevel_plain(fields4, ps_s, a, b, STANDARD_PLEVELS),
        "interp full size, smooth ps")
    log("interp == plain bit for bit at full size on the random and the "
        "smooth ps")

    # times: the two kernels and their plain versions, on these tensors
    t_b2 = time_ms(lambda: vf.hlevel_to_plevel_fused(
        fields4, ps, a, b, STANDARD_PLEVELS), reps)
    l_b2 = time_device_ms(lambda: vf._launch(
        fields4, ps, a, b, STANDARD_PLEVELS, True, False), reps)
    s_b2 = time_ms(lambda: vf.hlevel_to_plevel_fused(
        fields4, ps_s, a, b, STANDARD_PLEVELS), reps)
    ls_b2 = time_device_ms(lambda: vf._launch(
        fields4, ps_s, a, b, STANDARD_PLEVELS, True, False), reps)
    p_b2 = time_ms(lambda: vf.hlevel_to_plevel_plain(
        fields4, ps, a, b, STANDARD_PLEVELS), reps)
    sargs = iso_surface_args(kern, xm, ym, fc, dev)
    t_b1 = time_ms(lambda: fused.derived_fields_fused(*sargs), reps)
    l_b1 = time_device_ms(lambda: fused._launch(*sargs[:9], False), reps)
    p_b1 = time_ms(lambda: fused.derived_fields_plain(*sargs), reps)
    runs = (("interp_ms", t_b2), ("interp_launch_ms", l_b2),
            ("interp_smooth_ms", s_b2), ("interp_smooth_launch_ms", ls_b2),
            ("interp_plain_ms", p_b2), ("derived_fields_ms", t_b1),
            ("derived_fields_launch_ms", l_b1),
            ("derived_fields_plain_ms", p_b1))
    med = {k: statistics.median(x) for k, x in runs}
    nb = interp_bytes(4, nlev, nt, ny, nx, False)
    gbps = {k: v / med["interp_ms"] / 1e6 for k, v in nb.items()}
    log(f"[{smi}] isobaric step: interp kernel {med['interp_ms']:.4f} ms "
        f"(the launch alone {med['interp_launch_ms']:.4f} ms; smooth ps "
        f"{med['interp_smooth_ms']:.4f} / "
        f"{med['interp_smooth_launch_ms']:.4f} ms; plain "
        f"{med['interp_plain_ms']:.3f} ms), pipeline kernel on the "
        f"{nt} surfaces {med['derived_fields_ms']:.4f} ms (the launch alone "
        f"{med['derived_fields_launch_ms']:.4f} ms; plain "
        f"{med['derived_fields_plain_ms']:.3f} ms); interp "
        f"{gbps['stack']:.1f} GB/s by whole-stack bytes "
        f"({nb['stack'] / 1e9:.3f} GB), {gbps['bracket']:.1f} GB/s by "
        f"bracket-read bytes; device copy {copy_gbps:.1f} GB/s")
    return {"launches": launches, "max_abs_err": max_abs,
            "inputs_gb": in_gb, "peak_device_gb": peak_gb,
            "times": {**med, **{k + "_all": x for k, x in runs}},
            "interp_gbps": gbps, "interp_bytes": nb}


def check_suite_physics(out: dict, nlev: int, ny: int, nx: int) -> None:
    """Shape, finite defined values, and theta / dewpoints (K) within
    plausible bounds on config 2's inputs."""
    for name, a in out.items():
        if a.shape != (nlev, ny, nx) or a.dtype != np.float32:
            raise AssertionError(f"{name}: {a.shape} {a.dtype}")
        d = a[a != np.float32(1e35)]
        if d.size < a.size // 2 or not np.isfinite(d).all():
            raise AssertionError(f"{name}: too few or non-finite values")
    for name, lo, hi in (("temp3", 200.0, 600.0), ("hum_q9", 150.0, 400.0),
                         ("hum_rh11", 150.0, 400.0)):
        a = out[name]
        if not lo < float(np.median(a[a != np.float32(1e35)])) < hi:
            raise AssertionError(f"{name}: outside physical bounds")


def config2_reqs(fs) -> tuple:
    """BASELINE config 2's request list, validated by ``fs``
    (ops/fused_suite.py)."""
    return fs._build_reqs("chip_smoke", *(CONFIG2.get(k, ()) for k in (
        "temps", "hums_q", "hums_rh", "thes", "ducts_q", "ducts_rh")))


def suite_case(dev, name: str, shape, kind: str, all_defined: bool):
    """B3 (``name`` "alevel", with a pressure field) or B4 ("hlevel") on
    config 2's request set: ``(launch, wrapper, plain)``, the kernel's
    launch through its wrapper's ``_launch`` (no argument checks on the
    host), the public stacked wrapper (the measure of the kernels line) and
    the plain version, all on the same CUDA tensors.  ``kind`` "random"
    takes phase 8's inputs (:func:`make_suite_inputs`: B3's seed 1, B4's
    request 1, 2% undefined; all-defined: seeds 2 / 12, none undefined),
    "smooth" :func:`make_smooth_suite_inputs` with the same seeds."""
    import torch
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.ops import fused_suite as fs
    reqs = config2_reqs(fs)
    seed = (1 if name == "alevel" else 11) + int(all_defined)
    frac = 0.0 if all_defined else 0.02
    if kind == "random":
        raw = make_suite_inputs(*shape, seed, frac, plant=False)
    else:
        raw = make_smooth_suite_inputs(*shape, seed, frac)
    t, q, rh, p, ps = (from_sentinel(x, device=dev) for x in raw[:5])
    if name == "alevel":
        return (lambda: fs._launch(False, t, q, rh, p, None, None, reqs,
                                   all_defined),
                lambda: fs.alevel_suite_stacked(t, q, rh, p, reqs,
                                                all_defined),
                lambda: fs.alevel_suite_plain(t, q, rh, p, reqs,
                                              all_defined))
    a, b = (torch.as_tensor(x, device=dev) for x in raw[5:])
    return (lambda: fs._launch(True, t, q, rh, ps, a, b, reqs, all_defined),
            lambda: fs.hlevel_suite_stacked(t, q, rh, ps, a, b, reqs,
                                            all_defined),
            lambda: fs.hlevel_suite_plain(t, q, rh, ps, a, b, reqs,
                                          all_defined))


def compare_suite_exact(got, ref, label: str) -> bool:
    """Kernel vs plain suite outputs (``SuiteStacked``): mask planes equal,
    values equal bit for bit on the defined points (NaN where NaN); raises
    otherwise.  Returns whether the values are equal at every point too."""
    import torch

    def same(a, b):
        return (a.view(torch.int32) == b.view(torch.int32)) | (
            torch.isnan(a) & torch.isnan(b))

    if got.mask_map != ref.mask_map or not torch.equal(got.masks,
                                                       ref.masks):
        raise AssertionError(f"{label}: mask planes differ")
    for k, (g, r) in enumerate(zip(got.as_fields(), ref.as_fields())):
        bad = ~same(g.values, r.values) & r.mask
        if bool(bad.any()):
            raise AssertionError(f"{label} output {k}: {int(bad.sum())} "
                                 f"defined values differ")
    return bool(same(got.values, ref.values).all())


def time_device_ms(fn, reps: int) -> list:
    """Device times of ``fn`` in ms (CUDA events), each run queued behind
    a ~1 ms busy wait on the stream, so that the host's time to enqueue it
    falls outside the events: the kernel's own time."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def time_case(launch, wrapper, check) -> dict:
    """One case of a ``TIME_CASES`` family: ``check()`` holds the kernel to
    its plain version (raises otherwise; returns whether the values are
    equal at every point too), then 20 launches to warm up and the median
    of 30 device times of the launch alone (:func:`time_device_ms`, ``ms``)
    and of 30 through the wrapper (:func:`time_ms`, ``wrapper_ms``)."""
    every = check()
    for _ in range(20):
        launch()
    ms = time_device_ms(launch, 30)
    wms = time_ms(wrapper, 30)
    return {"ms": statistics.median(ms), "ms_all": ms,
            "wrapper_ms": statistics.median(wms), "wrapper_ms_all": wms,
            "equal": True, "equal_every_point": every}


def iso_surface_args(interp_out, xm, ym, fc, dev) -> tuple:
    """B1's arguments on the isobaric path (derived_fields_isobaric): the
    interpolated stacks, a zero all-defined ps and the surfaces as alevel
    with blevel = 0."""
    import torch
    from mi_fieldcalc_tpu_torch.field import Field
    from mi_fieldcalc_tpu_torch.models import STANDARD_PLEVELS
    ny, nx = interp_out[0].values.shape[-2:]
    nt = len(STANDARD_PLEVELS)
    ps1 = Field(torch.zeros((ny, nx), dtype=torch.float32, device=dev),
                torch.ones((ny, nx), dtype=torch.bool, device=dev))
    return (*interp_out, ps1,
            torch.tensor(STANDARD_PLEVELS, dtype=torch.float32, device=dev),
            torch.zeros(nt, dtype=torch.float32, device=dev), xm, ym, fc)


def pipeline_time_cases(dev) -> dict:
    """B1 at the headline 32x719x929 on phase 5's inputs, masked and
    all-defined, and on the isobaric path's 11 surfaces of 719x929 (B2's
    output at config 4, phase 7's inputs), each held to its plain version
    bit for bit (:func:`compare_stacked`), then timed (:func:`time_case`)."""
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.models import STANDARD_PLEVELS
    from mi_fieldcalc_tpu_torch.ops import fused
    from mi_fieldcalc_tpu_torch.ops import vertical_fused as vf
    cases = []
    for label, undefs in (("masked", True), ("all_defined", False)):
        args = make_inputs(NLEV, NY, NX, 4, undefs, "column")
        host, ad = staging._decode_step(args, staging.HostStager(4), 1e35)
        cases.append((f"{NLEV} levels {label}",
                      staging._upload_step(host, dev), ad))
        del host
    raw = make_column_inputs(*ISO_SHAPE, seed=3, undef_frac=0.005)
    col = tuple(from_sentinel(a, device=dev) for a in raw[:5])
    a, b, xm, ym, fc = (torch.as_tensor(x, device=dev) for x in raw[5:])
    del raw
    interp = vf.hlevel_to_plevel_fused(col[:4], col[4], a, b,
                                       STANDARD_PLEVELS)
    del col
    cases.append((f"{len(STANDARD_PLEVELS)} surfaces masked",
                  iso_surface_args(interp, xm, ym, fc, dev), False))
    out = {}
    for label, args, ad in cases:
        def check():
            return compare_stacked(
                fused._launch(*args[:9], ad),
                fused.derived_fields_plain(*args, all_defined=ad),
                f"pipeline {label}")["every_point"]

        out[label] = time_case(
            lambda: fused._launch(*args[:9], ad),
            lambda: fused.derived_fields_fused(*args, all_defined=ad), check)
    return out


def interp_time_cases(dev) -> dict:
    """B2 at BASELINE config 4 (137x719x929 -> the 11 surfaces, phase 7's
    inputs) with its uniform random ps and with :func:`smooth_ps` of the
    same range, masked and all-defined (the all-defined route reads no
    mask; the values are the same), ln p; each held to its plain version
    bit for bit (:func:`compare_fields_exact`), then timed
    (:func:`time_case`)."""
    import torch
    from mi_fieldcalc_tpu_torch.field import Field, from_sentinel
    from mi_fieldcalc_tpu_torch.models import STANDARD_PLEVELS
    from mi_fieldcalc_tpu_torch.ops import vertical_fused as vf
    nlev, ny, nx = ISO_SHAPE
    raw = make_column_inputs(nlev, ny, nx, seed=3, undef_frac=0.005)
    fields = tuple(from_sentinel(x, device=dev) for x in raw[:4])
    ps = from_sentinel(raw[4], device=dev)
    a, b = (torch.as_tensor(x, device=dev) for x in raw[5:7])
    del raw
    tg = STANDARD_PLEVELS
    out = {}
    for kind in ("random", "smooth"):
        if kind == "smooth":
            ps = Field(torch.as_tensor(smooth_ps(ny, nx, 3), device=dev),
                       ps.mask)
        for ad in (False, True):
            label = f"config4 {kind} ps {'all_defined' if ad else 'masked'}"
            out[label] = time_case(
                lambda: vf._launch(fields, ps, a, b, tg, True, ad),
                lambda: vf.hlevel_to_plevel_fused(fields, ps, a, b, tg,
                                                  all_defined=ad),
                lambda: compare_fields_exact(
                    vf._launch(fields, ps, a, b, tg, True, ad),
                    vf.hlevel_to_plevel_plain(fields, ps, a, b, tg, True, ad),
                    f"interp {label}"))
    return out


def suite_time_cases(dev, routes=(False, True)) -> dict:
    """B3 at config 2's own 10x719x929 with a p field and B4 on the suite
    entry's request-1 inputs at 32x719x929, random and smooth fields, in
    each route of ``routes`` (all-defined or not): each held to its plain
    version (:func:`compare_suite_exact`), then timed (:func:`time_case`,
    ``wrapper_ms`` through the stacked wrapper)."""
    out = {}
    for name, shape in (("alevel", A_SUITE_SHAPE), ("hlevel", SUITE_SHAPE)):
        for kind in ("random", "smooth"):
            for ad in routes:
                label = f"{name} {kind} {'all_defined' if ad else 'masked'}"
                launch, wrapper, plain = suite_case(dev, name, shape, kind, ad)
                out[label] = time_case(launch, wrapper,
                                       lambda: compare_suite_exact(
                                           launch(), plain(), label))
                del launch, wrapper, plain
    return out


def phase_suites(dev, smi: str, copy_gbps: float, reps=10,
                 request_reps=3) -> dict:
    """The suite entry (B4) and the a-level suite (B3) at full size."""
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.ops import fused_suite as fs

    nlev, ny, nx = SUITE_SHAPE
    reqs = config2_reqs(fs)
    requests = [("undef lanes live", 11, 0.02, False),
                ("fully defined", 12, 0.0, True),
                ("undef lanes live", 13, 0.005, False)]
    inputs = [make_suite_inputs(nlev, ny, nx, seed, frac, plant=False)
              for _, seed, frac, _ in requests]
    fs.hlevel_suite_fused.launches = 0
    outs = []
    for tk, q, rh, _, ps, al, bl in inputs:
        outs.append(staging.run_hlevel_suite_np(tk, q, rh, ps, al, bl,
                                                device=dev, **CONFIG2))
    torch.cuda.synchronize(dev)
    h_launches = fs.hlevel_suite_fused.launches
    log(f"suite entry: 3 requests at {nlev}x{ny}x{nx}, {len(reqs)} outputs "
        f"each, suite kernel launches {h_launches}")
    if h_launches != 3:
        raise AssertionError(f"expected 3 suite kernel launches, got "
                             f"{h_launches}")
    h_err = 0.0
    for k, ((label, _, _, want_ad), (tk, q, rh, _, ps, al, bl), out) in \
            enumerate(zip(requests, inputs, outs)):
        host, ad = staging._suite_decode_step(
            tk, q, rh, ps, al, bl, reqs, staging.HostStager(3), 1e35)
        if ad != want_ad:
            raise AssertionError(f"suite request {k + 1}: all_defined routed "
                                 f"{ad}, expected {want_ad}")
        staged = staging._suite_upload_step(host, reqs, dev)
        plain = fs.hlevel_suite_plain(*staged, reqs, ad)
        if k == 0:
            kern = fs.hlevel_suite_stacked(*staged, reqs, ad)
            h_err = compare_fields(kern.as_fields(), plain.as_fields(),
                                   "suite full size masked",
                                   defined_only=True)
            del kern
        ref = staging._suite_encode_step(
            staging._suite_fetch(plain, staging.HostStager(3)), reqs, 1e35)
        del plain, staged
        if list(out) != list(ref):
            raise AssertionError(f"suite request {k + 1}: keys {list(out)}")
        for name in out:
            g, r = out[name], ref[name]
            if not np.array_equal(g == np.float32(1e35),
                                  r == np.float32(1e35)):
                raise AssertionError(f"suite request {k + 1} {name}: undef "
                                     f"positions differ")
            value_err(torch.from_numpy(g), torch.from_numpy(r),
                      f"suite request {k + 1} {name}")
        check_suite_physics(out, nlev, ny, nx)
        log(f"suite request {k + 1} ({label}, all_defined={ad}): "
            f"{len(out)} outputs == plain version")

    # the a-level suite once at config 2's own shape, with a p field
    an, ay, ax = A_SUITE_SHAPE
    tk, q, rh, p, _, _, _ = make_suite_inputs(an, ay, ax, 1, 0.02,
                                              plant=False)
    t, q, rh, p = (from_sentinel(x, device=dev) for x in (tk, q, rh, p))
    fs.alevel_suite_fused.launches = 0
    a_out = fs.alevel_suite_fused(t, q, rh, p, **CONFIG2)
    torch.cuda.synchronize(dev)
    a_launches = fs.alevel_suite_fused.launches
    if a_launches != 1:
        raise AssertionError(f"expected 1 a-level suite launch, got "
                             f"{a_launches}")
    a_err = compare_fields(a_out, fs.alevel_suite_plain(
        t, q, rh, p, reqs).as_fields(), "alevel suite full size",
        defined_only=True)
    del a_out
    log(f"alevel_suite_fused at {an}x{ay}x{ax}: 1 launch, == plain "
        f"(max abs err {a_err!r})")
    if h_err != 0.0 or a_err != 0.0:
        raise AssertionError(f"suite kernels at full size not bit for bit: "
                             f"max abs err {h_err!r} / {a_err!r}")

    # times: B3 on these tensors, B4 on request 1's
    k3 = time_ms(lambda: fs.alevel_suite_stacked(t, q, rh, p, reqs), reps)
    p3 = time_ms(lambda: fs.alevel_suite_plain(t, q, rh, p, reqs), reps)
    del t, q, rh, p
    tk, q, rh, _, ps, al, bl = inputs[0]
    host, ad = staging._suite_decode_step(tk, q, rh, ps, al, bl, reqs,
                                          staging.HostStager(3), 1e35)
    staged = staging._suite_upload_step(host, reqs, dev)
    k4 = time_ms(lambda: fs.hlevel_suite_stacked(*staged, reqs, ad), reps)
    p4 = time_ms(lambda: fs.hlevel_suite_plain(*staged, reqs, ad), reps)
    del staged
    # the launch alone, on these inputs and on smooth fields
    alone = suite_time_cases(dev, routes=(False,))
    nout = len(reqs)
    b3 = suite_bytes(4, nout, nout, an, ay, ax, False, False)
    b4 = suite_bytes(3, nout, nout, nlev, ny, nx, True, False)
    med = {"alevel_ms": statistics.median(k3),
           "alevel_plain_ms": statistics.median(p3),
           "hlevel_ms": statistics.median(k4),
           "hlevel_plain_ms": statistics.median(p4)}
    for name in ("alevel", "hlevel"):
        med[f"{name}_launch_ms"] = alone[f"{name} random masked"]["ms"]
        med[f"{name}_smooth_launch_ms"] = alone[f"{name} smooth masked"]["ms"]
    gbps = {"alevel": b3 / med["alevel_ms"] / 1e6,
            "hlevel": b4 / med["hlevel_ms"] / 1e6}
    log(f"[{smi}] alevel suite {an}x{ay}x{ax} masked: kernel "
        f"{med['alevel_ms']:.4f} ms (the launch alone "
        f"{med['alevel_launch_ms']:.4f} ms, on smooth fields "
        f"{med['alevel_smooth_launch_ms']:.4f} ms), plain "
        f"{med['alevel_plain_ms']:.3f} ms, "
        f"{gbps['alevel']:.1f} GB/s ({b3 / 1e9:.3f} GB); hlevel suite "
        f"{nlev}x{ny}x{nx} masked: kernel {med['hlevel_ms']:.4f} ms (the "
        f"launch alone {med['hlevel_launch_ms']:.4f} ms, on smooth fields "
        f"{med['hlevel_smooth_launch_ms']:.4f} ms), plain "
        f"{med['hlevel_plain_ms']:.3f} ms, {gbps['hlevel']:.1f} GB/s "
        f"({b4 / 1e9:.3f} GB); device copy {copy_gbps:.1f} GB/s")

    # one masked suite request, split
    stager = staging.HostStager(3, pin=True)
    first, split = request_split(
        request_reps, dev,
        lambda: staging._suite_decode_step(tk, q, rh, ps, al, bl, reqs,
                                           stager, 1e35),
        lambda host: staging._suite_upload_step(host, reqs, dev),
        lambda staged, ad: staging._suite_compute(staged, reqs, ad),
        lambda out: staging._suite_fetch(out, stager),
        lambda fetched: staging._suite_encode_step(fetched, reqs, 1e35))
    split["first"] = first
    log(f"[{smi}] suite request (masked, page-locked blocks) median of "
        f"{request_reps}, ms: " + " ".join(
            f"{k}={v:.2f}" for k, v in split.items() if k != "first")
        + f"; the first (allocating) request: {first}")
    return {"hlevel_launches": h_launches, "alevel_launches": a_launches,
            "hlevel_max_abs_err": h_err, "alevel_max_abs_err": a_err,
            "times": {**med, "alevel_ms_all": k3, "alevel_plain_ms_all": p3,
                      "hlevel_ms_all": k4, "hlevel_plain_ms_all": p4,
                      "alone": alone},
            "gbps": gbps, "bytes": {"alevel": b3, "hlevel": b4},
            "request_ms": split}


# ---------------------------------------------------------------- phase 9

#: the operational vessel-icing request: 719x929 (tools/perf_lab_mincog.py:
#: 27), vs 5 m/s, alpha 0.52, heights 2..11 m in 0.5 m steps = 19
#: (tools/perf_lab_mincog_fused.py:54)
ICING_SHAPE = (719, 929)
ICING_SCAL = (5.0, 0.52, 2.0, 11.0)
#: the JAX package's adversarial scalars: vs = 0 makes vr = c
ICING_VS0 = (0.0, 0.0, 1.0, 4.0)
ICING_SHAPES = ((1, 1), (3, 37), (37, 61), (9, 131), (64, 256), ICING_SHAPE)
#: float32 operations per unit of B5 / B6 work, counted from
#: csrc/vessel_icing.cu and common.cuh: each add, subtract, multiply,
#: divide, sqrt and floor is one; compares, selects, fabs and negation are
#: not counted.  Only what the function needs is charged: loop-invariant
#: and shared subexpressions once, each lane's own branch (the lane counts
#: of the plain version, ops/icing.py _count), the cheaper branch where a
#: lane's branch is not recorded.  exp_f32 23, log_f32 28, icing_f1 27;
#: tanh_f32 per evaluation by its branch, the polynomial 12 or the exp
#: form 27 (0 beyond |x| = 9).
OPS_TANH_POLY = 12
OPS_TANH_EXP = 27
OPS_WAVE_WARM = 3           # per warmup lane-step of the wave fixed point
OPS_WAVE_NEWTON = 14        # per Newton lane-step (slope, threshold, step)
OPS_WAVE_CAP = 68 + 17 * 78 + 2    # the 17-node cap prediction, its 69
#                                    tanh evaluations counted apart
OPS_WAVE_STALL = 5          # MINCOG's stall test (shares the cap's slope)
OPS_MINCOG_LANE = 50 * 137 + 38    # 50 RK steps + the per-lane setup
OPS_MINCOG_ALT2 = 59        # alt 2's group-velocity liquid water content
OPS_MINCOG_HEIGHT = 5       # per solved lane-height, any branch
OPS_MINCOG_RES = 50         # the heat-balance residual, value only
OPS_MINCOG_RES_D = 70       # the residual with its derivative
#: per lane-height by branch: the safeguarded Newton (bracket ends, secant
#: start, 8 steps, N at the root; the midpoint fallback is not charged),
#: no sign change (the bracket ends only), sal == 0 (the closed form)
OPS_MINCOG_ROOT = 2 * OPS_MINCOG_RES + 8 + 8 * (OPS_MINCOG_RES_D + 2) + 6
OPS_MINCOG_NOROOT = 2 * OPS_MINCOG_RES
OPS_MINCOG_SAL0 = OPS_MINCOG_RES + 3
OPS_MS_LANE = 50 * 138 + 35     # 50 RK steps + the per-lane setup
OPS_MS_HEIGHT = 8           # per lane and height outside the loop
OPS_MS_WARM = 40            # per warmup freezing-fraction lane-step
OPS_MS_NEWTON = 68          # per lane-step after it (slope, root, floor)
OPS_MS_CAP = 108            # per lane-height through the cap resolution
#: the kernels' tile (kBlock of csrc/vessel_icing.cu) and ModStall's steps
#: per round between compactions (kRound)
ICING_TILE = 256
ICING_ROUND = 4
#: the one-thread-per-point kernels that the tile schedule replaced, on
#: phase 9's request-1 inputs, ms (CUDA events, median of 10; NVIDIA H100
#: 80GB HBM3, 700 W; three runs, PERF.md section 6)
PER_POINT_KERNEL_MS = {"mincog": (1.333, 1.248, 1.281),
                 "modstall": (1.220, 1.229, 1.230)}


def _warp_paid(group, cost) -> float:
    """Lane-slots paid when a list runs in warps: the entries of each
    group (contiguous, in order) fill warps of 32, and a warp runs as long
    as its costliest lane; returns 32 x the largest cost of each warp,
    summed."""
    import torch
    if group.numel() == 0:
        return 0.0
    idx = torch.arange(group.numel(), device=group.device)
    start = torch.full((int(group.max()) + 1,), group.numel(),
                       dtype=idx.dtype, device=group.device)
    start = start.scatter_reduce(0, group, idx, "amin")
    warp = group * (group.numel() // 32 + 1) + (idx - start[group]) // 32
    _, inv = torch.unique(warp, return_inverse=True)
    top = torch.zeros(int(inv.max()) + 1, dtype=torch.float64,
                      device=group.device)
    return 32.0 * float(top.scatter_reduce(0, inv, cost.double(), "amax")
                        .sum())


def icing_warp_model(lanes: dict, number: int, alt,
                     tile: int = ICING_TILE,
                     round_steps: int = ICING_ROUND) -> dict:
    """Warp efficiency of the two kernel designs on one input, from the
    plain version's per-lane counts (``ops/icing.py`` ``_count`` with
    ``trips["lanes"]``) weighted by the ``OPS_*`` counts: the operations
    the lanes need over the lane-slots their warps pay (32 x the costliest
    lane of each warp, phase by phase).  B5 with ``alt`` 1 or 2, B6 with
    ``alt`` None.

    - ``per_point``: one thread per point, warps of 32 consecutive
      points; the warp pays each phase's costliest lane: the wave loop,
      the cap decision, the RK and setup, and per height the bracket ends,
      the Newton solve (or the freezing-fraction steps and the cap) and
      the sum.  ``per_point_total`` is the same with one maximum over each
      lane's whole work.
    - ``tiled``: the tile schedule: per tile of ``tile`` points, warps over
      the compacted lists (shallow points, cap decisions, live points,
      items point-major, sign-change items, ModStall's unfinished items
      round by round of ``round_steps`` steps, cap items, solved points).
    Idle time at a block's barriers is not charged (other blocks on the
    SM fill it); nor are shared-memory traffic and index arithmetic."""
    import torch
    flat = {k: v.reshape(-1).to(torch.int64) for k, v in lanes.items()}
    dev = flat["live"].device
    npts = flat["live"].numel()
    zero = torch.zeros(npts, dtype=torch.int64, device=dev)

    def get(key):
        return flat.get(key, zero)

    mincog = alt is not None
    live, solved = get("live"), get("solved")
    wave = (get("wave_warm") * OPS_WAVE_WARM
            + get("wave_newton") * OPS_WAVE_NEWTON
            + get("tanh_poly") * OPS_TANH_POLY
            + get("tanh_exp") * OPS_TANH_EXP)
    cap = (get("cap") * (OPS_WAVE_CAP + (OPS_WAVE_STALL if mincog else 0))
           + get(("tanh_poly", "cap")) * OPS_TANH_POLY
           + get(("tanh_exp", "cap")) * OPS_TANH_EXP)
    lane = solved * ((OPS_MINCOG_LANE + (OPS_MINCOG_ALT2 if alt == 2 else 0))
                     if mincog else OPS_MS_LANE)
    per_height = OPS_MINCOG_HEIGHT if mincog else OPS_MS_HEIGHT

    def stack(key):                    # [npts, number]
        return torch.stack([get((key, k)) for k in range(number)], 1)

    if mincog:
        root = stack("h_root")
        first = (stack("h_sal0") * OPS_MINCOG_SAL0
                 + (root + stack("h_noroot")) * OPS_MINCOG_NOROOT)
        second = root * (OPS_MINCOG_ROOT - OPS_MINCOG_NOROOT)
    else:
        warm, newt = stack("height_warm"), stack("height_newton")
        first = warm * OPS_MS_WARM + newt * OPS_MS_NEWTON
        second = stack("height_cap") * OPS_MS_CAP
    summ = (solved * per_height)[:, None].expand(npts, number)
    useful = float((wave + cap + lane).sum() + (first + second + summ).sum())

    point = torch.arange(npts, device=dev)
    warp32 = point // 32
    phases = [wave, cap, lane] + [x[:, k] for k in range(number)
                                  for x in (first, second, summ)]
    old = sum(_warp_paid(warp32, x) for x in phases)
    total = wave + cap + lane + (first + second + summ).sum(1)
    old_total = _warp_paid(warp32, total)

    blk = point // tile
    item_blk = blk[:, None].expand(npts, number)
    on = solved.bool()

    def listed(mask, cost, group=blk):
        m = mask.reshape(-1).bool()
        return _warp_paid(group.reshape(-1)[m], cost.reshape(-1)[m])

    new = (listed(wave > 0, wave) + listed(cap > 0, cap)
           + listed(live, lane) + listed(on, summ.sum(1)))
    items = on[:, None].expand(npts, number)
    if mincog:
        new += listed(items, first, item_blk) + listed(second > 0, second,
                                                       item_blk)
    else:
        steps = warm + newt
        for j0 in range(0, int(steps.max()) if steps.numel() else 0,
                        round_steps):
            run = (steps - j0).clamp(0, round_steps)
            unit = OPS_MS_WARM if j0 < 32 else OPS_MS_NEWTON
            new += listed(items & (steps > j0), run * unit, item_blk)
        new += listed(second > 0, second, item_blk)
    return {"useful_ops": useful, "per_point": useful / old,
            "per_point_total": useful / old_total, "tiled": useful / new,
            "speedup": old / new}


def icing_prediction(rows: int = 96) -> dict:
    """The warp model on the first ``rows`` rows of phase 9's request-1
    inputs, through the plain versions on the CPU (no card needed), and
    the kernel times it predicts from the per-point kernels':
    ``python3 -c 'import chip_smoke; chip_smoke.icing_prediction()'``."""
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    from mi_fieldcalc_tpu_torch.ops.icing import _number
    _, args, _ = icing_requests()[0]
    fields = [from_sentinel(np.ascontiguousarray(a[:rows])) for a in args]
    number = _number(*ICING_SCAL[2:])
    out = {}
    for name, alt in (("mincog", 1), ("modstall", None)):
        trips = {"lanes": {}}
        if alt is None:
            F.vessel_icing_modstall_plain(*fields, *ICING_SCAL, trips=trips)
        else:
            F.vessel_icing_mincog_plain(*fields, *ICING_SCAL, alt,
                                        trips=trips)
        model = icing_warp_model(trips.pop("lanes"), number, alt)
        before = statistics.median(PER_POINT_KERNEL_MS[name])
        out[name] = {**model, "per_point_ms": before,
                     "predicted_ms": before / model["speedup"]}
        log(f"{name}, request 1's first {rows} rows: " + json.dumps(
            out[name]))
    return out


def make_icing_inputs(ny, nx, seed, undef_frac=1 / 23, adversarial=False,
                      plant=False):
    """The 11 sentinel inputs (sal, wave, x_wind, y_wind, airtemp, rh, sst,
    p, pw, aice, depth) in the JAX package's kernel-test ranges
    (tests/test_icing_fused.py:20-43): ice cover up to 0.5 (gated-off
    points), waves from 0.1 m (from 0 when ``adversarial``: skip points),
    and with ``adversarial`` long periods over shallow water (the wave
    fixed point's Newton phase and cap).  ``plant`` sets pw == 0 on every
    7th point and sal == 0 on every 11th."""
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return sentinel(rng, lo, hi, (ny, nx), undef_frac)

    a = [f(0.0, 35.0), f(0.0 if adversarial else 0.1, 8.0),
         f(-25.0, 25.0), f(-25.0, 25.0), f(-25.0, 2.0), f(0.3, 1.0),
         f(-1.0, 8.0), f(960.0, 1040.0),
         f(6.0, 14.0) if adversarial else f(2.0, 12.0), f(0.0, 0.5),
         f(2.0, 40.0) if adversarial else f(5.0, 500.0)]
    if plant:
        a[8].reshape(-1)[::7] = 0.0
        a[0].reshape(-1)[3::11] = 0.0
    return a


def icing_equal(got, ref, label: str) -> float:
    """Kernel vs plain Fields: masks bitwise, values equal (NaN where NaN);
    returns the max abs error over the points that are not both NaN."""
    import torch
    if not torch.equal(got.mask, ref.mask):
        raise AssertionError(f"{label}: masks differ at "
                             f"{int((got.mask != ref.mask).sum())} points")
    g, r = got.values, ref.values
    same = (g == r) | (torch.isnan(g) & torch.isnan(r))
    if not bool(same.all()):
        k = int((~same).reshape(-1).nonzero()[0, 0])
        raise AssertionError(
            f"{label}: {int((~same).sum())} values differ, e.g. kernel "
            f"{float(g.reshape(-1)[k])!r} plain {float(r.reshape(-1)[k])!r}")
    both_nan = torch.isnan(g) & torch.isnan(r)
    return float(torch.where(both_nan, torch.zeros_like(g),
                             (g - r).abs()).max())


def phase_icing_kernels(dev) -> dict:
    """B5 and B6 against their plain versions at ICING_SHAPES, and on an
    empty grid (no launch); the worst error of each kernel."""
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    cases, worst = 0, {"mincog": 0.0, "modstall": 0.0}
    for shape in ICING_SHAPES:
        for kind, adversarial, scal in (("friendly", False, ICING_SCAL),
                                        ("adversarial", True, ICING_SCAL),
                                        ("vs=0", True, ICING_VS0)):
            raw = make_icing_inputs(*shape, seed=sum(shape) + len(kind),
                                    adversarial=adversarial,
                                    plant=adversarial)
            fields = [from_sentinel(a, device=dev) for a in raw]
            for alt in (1, 2):
                worst["mincog"] = max(worst["mincog"], icing_equal(
                    F.vessel_icing_mincog_fused(*fields, *scal, alt),
                    F.vessel_icing_mincog_plain(*fields, *scal, alt),
                    f"mincog alt {alt} {shape} {kind}"))
                cases += 1
            worst["modstall"] = max(worst["modstall"], icing_equal(
                F.vessel_icing_modstall_fused(*fields, *scal),
                F.vessel_icing_modstall_plain(*fields, *scal),
                f"modstall {shape} {kind}"))
            cases += 1
            del fields
    # the tile schedule's corners (tests/icing_corner_cases.py)
    sys.path.insert(0, str(ROOT / "tests"))
    import icing_corner_cases as corners
    from mi_fieldcalc_tpu_torch.field import Field
    for kind in corners.KINDS:
        raw, scal = corners.corner_inputs(kind)
        fields = [from_sentinel(a, device=dev) for a in raw]
        for alt in (1, 2):
            worst["mincog"] = max(worst["mincog"], icing_equal(
                F.vessel_icing_mincog_fused(*fields, *scal, alt),
                F.vessel_icing_mincog_plain(*fields, *scal, alt),
                f"mincog alt {alt} corner {kind}"))
        worst["modstall"] = max(worst["modstall"], icing_equal(
            F.vessel_icing_modstall_fused(*fields, *scal),
            F.vessel_icing_modstall_plain(*fields, *scal),
            f"modstall corner {kind}"))
        cases += 3
    gate, planes, shallow, vsca, decay = corners.modstall_cap_planes(dev)
    worst["modstall"] = max(worst["modstall"], icing_equal(
        Field(F._launch(F.vessel_icing_modstall_fused, F._MS_PLANES, planes,
                        (gate, shallow), decay, vsca, None), gate),
        Field(F._modstall_plain(gate, planes, shallow, vsca, decay, None),
              gate), "modstall corner near_cap"))
    cases += 1
    empty = [from_sentinel(np.zeros((0, 7), np.float32), device=dev)] * 11
    before = (F.vessel_icing_mincog_fused.launches,
              F.vessel_icing_modstall_fused.launches)
    for out in (F.vessel_icing_mincog_fused(*empty, *ICING_SCAL, 1),
                F.vessel_icing_modstall_fused(*empty, *ICING_SCAL)):
        if tuple(out.values.shape) != (0, 7):
            raise AssertionError(f"empty grid: shape {out.values.shape}")
    if before != (F.vessel_icing_mincog_fused.launches,
                  F.vessel_icing_modstall_fused.launches):
        raise AssertionError("empty grid: a kernel was launched")
    log(f"mincog (alt 1, 2) and modstall kernels == plain versions in "
        f"{cases} cases at {len(ICING_SHAPES)} shapes x friendly / "
        f"adversarial with pw == 0 and sal == 0 / vs = 0 and the scheduling "
        f"corners {corners.KINDS + ('near_cap',)}: max abs err {worst!r}; "
        f"an empty grid launches nothing")
    return {"cases": cases, "max_abs_err": worst}


def icing_requests():
    """Phase 9's three requests at ICING_SHAPE: (label, inputs, alt)."""
    return [("scattered undefs", make_icing_inputs(*ICING_SHAPE, 41, 0.01), 1),
            ("fully defined", make_icing_inputs(*ICING_SHAPE, 42, 0.0), 2),
            ("scattered undefs", make_icing_inputs(*ICING_SHAPE, 43, 0.002),
             1)]


def icing_plain_request(args, dev, alt: int) -> dict:
    """One request through the plain route on the card: the same decode
    and upload, the plain versions in place of the two kernels."""
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    fields = icing_fields(args, dev)
    outs = dict(zip(("overland", "mertins"), staging._icing_products(
        fields, *ICING_SCAL, alt, ("overland", "mertins"))))
    outs["modstall"] = F.vessel_icing_modstall_plain(*fields, *ICING_SCAL)
    outs["mincog"] = F.vessel_icing_mincog_plain(*fields, *ICING_SCAL, alt)
    return {k: f.to_sentinel().cpu().numpy() for k, f in outs.items()}


def check_icing_physics(out: dict, ny: int, nx: int) -> None:
    """The repo's own bounds on phase 9's outputs: the shape, finite
    defined values, gated-off points present, Mertins on its discrete
    rates, and the two solvers' rates non-negative (|ice| / number) with
    icing present (Overland's cubic is signed)."""
    for name, a in out.items():
        if a.shape != (ny, nx) or a.dtype != np.float32:
            raise AssertionError(f"{name}: {a.shape} {a.dtype}")
        d = a[a != np.float32(1e35)]
        if not (0 < d.size < a.size and np.isfinite(d).all()):
            raise AssertionError(f"{name}: undefined or non-finite rates")
        rates = np.float32([0.0, 0.8333, 2.0833, 4.375, 6.25])
        if name == "mertins" and not np.isin(d, rates).all():
            raise AssertionError("mertins: a rate outside its table")
        if name in ("mincog", "modstall") and not (
                (d >= 0).all() and (d > 0).any()):
            raise AssertionError(f"{name}: rates outside the physical bounds")


def phase_icing_path(dev) -> dict:
    """3 requests through run_vessel_icing_np, each against the plain
    route; the launch counts of both kernels."""
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    requests = icing_requests()
    F.vessel_icing_mincog_fused.launches = 0
    F.vessel_icing_modstall_fused.launches = 0
    outs = [staging.run_vessel_icing_np(*args, *ICING_SCAL, alt=alt,
                                        device=dev)
            for _, args, alt in requests]
    torch.cuda.synchronize(dev)
    launches = {"mincog": F.vessel_icing_mincog_fused.launches,
                "modstall": F.vessel_icing_modstall_fused.launches}
    log(f"icing entry: 3 requests at {ICING_SHAPE[0]}x{ICING_SHAPE[1]}, "
        f"{int((ICING_SCAL[3] - ICING_SCAL[2]) * 2 + 1)} heights, launches "
        f"{launches}")
    if launches != {"mincog": 3, "modstall": 3}:
        raise AssertionError(f"expected 3 launches of each kernel, got "
                             f"{launches}")
    for k, ((label, args, alt), out) in enumerate(zip(requests, outs)):
        ref = icing_plain_request(args, dev, alt)
        if list(out) != list(staging.ICING_PRODUCTS):
            raise AssertionError(f"icing request {k + 1}: keys {list(out)}")
        for name in out:
            g, r = out[name], ref[name]
            same = (g.view(np.int32) == r.view(np.int32)) | (
                np.isnan(g) & np.isnan(r))
            if not same.all():
                raise AssertionError(
                    f"icing request {k + 1} {name}: {int((~same).sum())} "
                    f"points differ from the plain route")
        check_icing_physics(out, *ICING_SHAPE)
        undef = [int((o == np.float32(1e35)).sum()) for o in out.values()]
        log(f"icing request {k + 1} ({label}, alt {alt}): 4 products == "
            f"plain route, undefined points {undef}")
    return {"launches": launches}


def phase_icing_golden(dev) -> dict:
    """The port's ModStall at 719x929 against the compiled reference's
    golden (tests/conformance_cases.py:372-377, tests/goldens/
    goldens_large.npz), on the points both define."""
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    sys.path.insert(0, str(ROOT / "tests"))
    from conformance_cases import LARGE_CASES, case_inputs
    case = next(c for c in LARGE_CASES
                if c.name == "large_vesselIcingModStall")
    fields = [from_sentinel(a, device=dev) for a in case_inputs(case)]
    s = case.scalars
    out = F.vessel_icing_modstall_fused(*fields, s["vs"], s["alpha"],
                                        s["zmin"], s["zmax"])
    with np.load(ROOT / "tests" / "goldens" / "goldens_large.npz") as g:
        ref = g[case.name + "__out"]
    mask = out.mask.cpu().numpy()
    vals = out.values.cpu().numpy()
    both = mask & (ref != np.float32(1e35)) & ~np.isnan(ref)
    err = np.abs(vals[both] - ref[both])
    bad = ~(err <= case.atol + case.rtol * np.abs(ref[both]))
    log(f"modstall at 719x929 vs the oracle golden: {int(both.sum())} "
        f"points both defined, max abs err {float(err.max())!r}, "
        f"{int(bad.sum())} outside rtol/atol {case.rtol}")
    if not both.any() or bad.any():
        raise AssertionError("modstall disagrees with the 719x929 golden")
    return {"points": int(both.sum()), "max_abs_err": float(err.max()),
            "rtol": case.rtol, "atol": case.atol}


def icing_bound(trips: dict, number: int, npts: int, nplanes: int,
                nflags: int, copy_gbps: float, f32_rate: float, alt) -> dict:
    """The least time for B5 (``alt`` 1 or 2) or B6 (``alt`` None) on
    these inputs: bytes (planes and flags read once, the output written
    once) over the copy rate, float32 operations (the lane counts the
    plain version recorded) over the un-fused issue rate ``f32_rate``
    (``ops_ms_fma``: over the data sheet's 67 TFLOP/s, as earlier
    records did)."""
    def n(key):
        return trips.get(key, 0)

    nbytes = npts * (4 * nplanes + nflags + 4)
    ops = (n("wave_warm") * OPS_WAVE_WARM + n("wave_newton") * OPS_WAVE_NEWTON
           + n("cap") * OPS_WAVE_CAP + n("tanh_poly") * OPS_TANH_POLY
           + n("tanh_exp") * OPS_TANH_EXP)
    if alt is not None:
        ops += (n("cap") * OPS_WAVE_STALL
                + n("solved") * (OPS_MINCOG_LANE + number * OPS_MINCOG_HEIGHT
                                 + (OPS_MINCOG_ALT2 if alt == 2 else 0))
                + n("h_root") * OPS_MINCOG_ROOT
                + n("h_noroot") * OPS_MINCOG_NOROOT
                + n("h_sal0") * OPS_MINCOG_SAL0)
    else:
        ops += (n("solved") * (OPS_MS_LANE + number * OPS_MS_HEIGHT)
                + n("height_warm") * OPS_MS_WARM
                + n("height_newton") * OPS_MS_NEWTON
                + n("height_cap") * OPS_MS_CAP)
    b_ms = nbytes / copy_gbps / 1e6
    o_ms = ops / f32_rate * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": b_ms, "ops_ms": o_ms,
            "ops_ms_fma": ops / PEAK_F32_FMA * 1e3,
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def sm_clock() -> float:
    """The card's SM clock now, MHz (nvidia-smi)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])


def icing_attributes() -> dict:
    """Registers, static shared memory per block, spilled bytes per thread
    and block size of B5 and B6 as compiled (cudaFuncGetAttributes)."""
    import ctypes
    from mi_fieldcalc_tpu_torch._build import load_library
    lib = load_library()
    res = {}
    for which, name in enumerate(("mincog", "modstall")):
        vals = [ctypes.c_int() for _ in range(4)]
        err = lib.mf_vessel_icing_attributes(which,
                                             *[ctypes.byref(v) for v in vals])
        if err != 0:
            raise AssertionError(f"{name}: cudaFuncGetAttributes failed")
        res[name] = dict(zip(("registers", "shared_bytes", "local_bytes",
                              "block"), (v.value for v in vals)))
    return res


def phase_icing_times(dev, smi: str, copy_gbps: float, f32_rate: float,
                      reps=10, plain_reps=3, request_reps=3) -> dict:
    """Kernel and plain times on request 1's inputs, the bounds, the
    kernels' resources, the warp-efficiency model against the measured
    speed-up over the per-point kernels, and one request split."""
    import math
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.field import Field
    from mi_fieldcalc_tpu_torch.ops import icing_fused as F
    from mi_fieldcalc_tpu_torch.ops.icing import _mincog_decay, _number
    vs, alpha, zmin, zmax = ICING_SCAL
    vsca = float(vs * math.cos(alpha))
    number = _number(zmin, zmax)
    decay = _mincog_decay(zmin, number)
    _, args, _ = icing_requests()[0]
    fields = icing_fields(args, dev)
    npts = fields[0].values.numel()
    res = {"card": smi, "shape": list(ICING_SHAPE), "heights": number,
           "resources": icing_attributes()}
    runs = icing_runs(fields, 1)
    for name, (launch, plain, nplanes, nflags) in runs.items():
        for _ in range(20):               # the card at its clocks
            launch()
        clocks = [sm_clock()]
        k = time_ms(launch, reps)
        clocks.append(sm_clock())
        trips = {"lanes": {}}
        plain(trips)                      # the plain version's warm-up
        model = icing_warp_model(trips.pop("lanes"), number,
                                 1 if name == "mincog" else None,
                                 tile=res["resources"][name]["block"])
        p = time_ms(plain, plain_reps, warmup=False)
        bound = icing_bound(trips, number, npts, nplanes, nflags, copy_gbps,
                            f32_rate, 1 if name == "mincog" else None)
        kms = statistics.median(k)
        before = statistics.median(PER_POINT_KERNEL_MS[name])
        res[name] = {"kernel_ms": kms, "kernel_ms_all": k,
                     "plain_ms": statistics.median(p), "plain_ms_all": p,
                     "sm_clock_mhz": clocks, "trips": trips,
                     "warp_model": model,
                     "speedup_over_per_point": before / kms, **bound}
        log(f"[{smi}] {name} {ICING_SHAPE[0]}x{ICING_SHAPE[1]}, {number} "
            f"heights: kernel {kms:.4f} ms, plain "
            f"{res[name]['plain_ms']:.1f} ms; bound {bound['bound_ms']:.4f} "
            f"ms by {bound['bound_by']} ({bound['ops']:.3e} ops -> "
            f"{bound['ops_ms']:.4f} ms, {bound['ops_ms_fma']:.4f} ms at 67 "
            f"TFLOP/s; {bound['bytes'] / 1e6:.1f} MB -> "
            f"{bound['bytes_ms']:.4f} ms), SM clock {clocks} MHz before "
            f"and after; kernel at "
            f"{bound['bound_ms'] / kms:.1%} of it; lane counts {trips}")
        log(f"[{smi}] {name} resources {res['resources'][name]}; warp "
            f"efficiency per point {model['per_point']:.3f} (one maximum "
            f"per lane: {model['per_point_total']:.3f}), tiled "
            f"{model['tiled']:.3f}: predicted speed-up "
            f"{model['speedup']:.2f}x; measured over the per-point "
            f"kernels' median {before:.3f} ms: {before / kms:.2f}x")
    del runs, fields

    # one request, split (host clock around synchronised steps)
    stager = staging.HostStager(11, pin=True)
    keys = ("decode", "h2d", "overland_mertins", "mincog_prologue",
            "mincog_kernel", "modstall_prologue", "modstall_kernel",
            "d2h", "encode", "total")
    parts = {k: [] for k in keys}
    for _ in range(request_reps):
        marks = []

        def mark():
            torch.cuda.synchronize(dev)
            marks.append(time.perf_counter())

        mark()
        stager.decode(*args)
        mark()
        fields = staging._icing_upload_step(stager, dev)
        mark()
        outs = staging._icing_products(fields, *ICING_SCAL, 1,
                                       ("overland", "mertins"))
        mark()
        g5, p5, sh5, sk5 = F._mincog_prologue(*fields, vs, alpha)
        mark()
        mc = F._launch(F.vessel_icing_mincog_fused, F._PLANES, p5,
                       (g5, sh5, sk5), decay, vsca, 1)
        mark()
        g6, p6, sh6 = F._modstall_prologue(*fields)
        mark()
        ms = F._launch(F.vessel_icing_modstall_fused, F._MS_PLANES, p6,
                       (g6, sh6), decay, vsca, None)
        mark()
        fetched = staging._icing_fetch(
            outs + [Field(ms, g6), Field(mc, g5)], stager)
        mark()
        staging._encode_planes(fetched, staging.ICING_PRODUCTS, 1e35)
        mark()
        for key, a, b in zip(keys, marks, marks[1:]):
            parts[key].append((b - a) * 1e3)
        parts["total"].append((marks[-1] - marks[0]) * 1e3)
        del fields, outs, p5, p6, fetched
    split = {k: statistics.median(v) for k, v in parts.items()}
    res["request_ms"] = split
    log(f"[{smi}] icing request (scattered undefs, alt 1) median of "
        f"{request_reps}, ms: " + " ".join(f"{k}={v:.2f}"
                                          for k, v in split.items()))
    return res


def icing_time_cases(dev) -> dict:
    """B5 and B6 on phase 9's request 1, held to their plain versions
    (values equal, NaN where NaN), then timed after 20 launches that bring
    the card to its clocks (CUDA events, median of 30)."""
    import torch
    _, args, _ = icing_requests()[0]
    out = {}
    for name, (kernel, plain, _, _) in icing_runs(icing_fields(args, dev),
                                                  1).items():
        got, ref = kernel(), plain()
        same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
        for _ in range(20):
            kernel()
        ms = time_ms(kernel, 30)
        out[name] = {"ms": statistics.median(ms), "ms_all": ms,
                     "equal": bool(same.all())}
    return out


# --------------------------------------------------------------- phase 10
#: P1's shapes: phase 3's, the headline, and the headline's width 4k+1 and
#: the next 4k+3 over an odd row count (the last strip runs past ny); P3's
#: ragged and single-row cases beside the tool's 32x256 and B1's shape
PROBE_COPY_WIDTHS = ((3, 17, 4 * 232 + 1), (3, 17, 4 * 232 + 3))
PROBE_WINDOW_CASES = (((32, 256), 8), ((2, 37, 300), 8), ((1, 1, 5), 32))


def _exact(got, ref, label: str) -> float:
    """The probe equals its plain version bit for bit (raises otherwise);
    returns the largest absolute difference of the float outputs, 0.0."""
    import torch
    from mi_fieldcalc_tpu_torch.tools import _lab
    _lab.assert_same(got, ref, label)
    got = (got,) if isinstance(got, torch.Tensor) else got
    ref = (ref,) if isinstance(ref, torch.Tensor) else ref
    return max(float((g - r).abs().max()) for g, r in zip(got, ref)
               if g.dtype == torch.float32)


def phase_probe_kernels(dev) -> dict:
    """Each probe kernel against its plain version on the card, bit for
    bit: P1 at phase 3's shapes, PROBE_COPY_WIDTHS and the headline
    32x719x929 (there at every cap of ``bench_copy.CAPS``), masked and
    all-defined; P2 at a ragged shape, every case of its sweep at
    32x719x929, and on an x one float past its allocation's 16-byte
    boundary (the outputs on theirs: 4-byte accesses) in a flat and a
    tiled case, and at 70000 one-row units of 1024 floats (more row blocks
    than a grid's y may hold); P3 at PROBE_WINDOW_CASES and B1's shape with each window
    height; P4 at the tool's 64x256, at 719x929, on one lane and on two
    719x929 launches back to back, all five launched before any is read.
    Returns each probe's largest absolute difference (0.0)."""
    from mi_fieldcalc_tpu_torch.tools import (
        bench_copy, perf_lab_dma, perf_lab_element, probe_mincog_kernel)
    import torch
    err = {"copy": 0.0, "add1": 0.0, "window": 0.0, "solver": 0.0}
    copy_shapes = SHAPES + PROBE_COPY_WIDTHS + ((NLEV, NY, NX),)
    for shape in copy_shapes:
        for ad in (False, True):
            args = bench_copy.probe_inputs(*shape, seed=sum(shape),
                                           all_defined=ad, device=dev)
            sel = args[:5] + args[7:9]
            ref = bench_copy.copy_probe_plain(*sel, ad)
            for cap in (bench_copy.CAPS if shape == (NLEV, NY, NX)
                        else (None,)):
                err["copy"] = max(err["copy"], _exact(
                    bench_copy.copy_probe(*sel, ad, cap), ref,
                    f"copy {shape} {ad} cap {cap}"))
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((3, 37, 41), generator=gen, device=dev)
    cases = [(x, 8, 3, 256)] + [(None, *c) for c in perf_lab_dma.cases(NY)]
    x = torch.randn((NLEV, NY, NX), generator=gen, device=dev)
    shifted = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    cases += [(shifted, NY, 1, 256), (shifted, 48, 2, 256),
              (torch.randn((1, 70000, 1024), generator=gen, device=dev), 1,
               1, 32)]
    for xc, ty, nbuf, threads in cases:
        xc = x if xc is None else xc
        err["add1"] = max(err["add1"], _exact(
            perf_lab_dma.add1(xc, nbuf, ty, threads),
            perf_lab_dma.add1_plain(xc, nbuf),
            f"add1 {tuple(xc.shape)} ty={ty} nbuf={nbuf} "
            f"at {xc.data_ptr() % 16} bytes past 16"))
    del x, shifted
    for shape, ty in PROBE_WINDOW_CASES:
        x = torch.randn(shape, generator=gen, device=dev)
        y = torch.randn((1,) * (3 - len(shape)) + shape, generator=gen,
                        device=dev)
        err["window"] = max(err["window"], _exact(
            perf_lab_element.window(x, y, ty),
            perf_lab_element.window_plain(x, y, ty), f"window {shape}"))
    x, y = perf_lab_element.b1_inputs(dev)
    for ty in perf_lab_element.B1_TYS:
        err["window"] = max(err["window"], _exact(
            perf_lab_element.window(x, y, ty),
            perf_lab_element.window_plain(x, y, ty), f"window ty={ty}"))
    del x, y
    m = probe_mincog_kernel
    solver_cases = [m.solver_inputs(shape, seed, dev) for shape, seed in (
        (m.TOOL_SHAPE, 0), (m.GRID_SHAPE, 0), ((1, 1), 0), (m.GRID_SHAPE, 1),
        (m.GRID_SHAPE, 2))]
    # the last two back to back: both launched before either is read
    outs = [m.solver(*case) for case in solver_cases]
    for out, case, label in zip(outs, solver_cases, (
            "64x256", "719x929", "one lane", "719x929 back to back, first",
            "719x929 back to back, second")):
        err["solver"] = max(err["solver"], _exact(
            out, m.solver_plain(*case), f"solver {label}"))
    del outs, solver_cases
    log("probe kernels == plain versions bit for bit: P1 at "
        f"{len(copy_shapes)} shapes x 2 routes, P2 at {len(cases)} cases, "
        f"P3 at {len(PROBE_WINDOW_CASES) + 2}, P4 at 64x256, 719x929, one "
        f"lane and a back-to-back pair; max abs err {err}")
    return err


#: capped lanes of P4's 719x929 inputs each launched alone for its chain
#: floor
CHAIN_LANES = 8


def solver_chain(dev, smi: str, reps: int) -> dict:
    """P4's chain floor: :data:`CHAIN_LANES` lanes of the 719x929 inputs
    that run to the 100-iteration cap, spread over the grid, each launched
    alone (n = 1) and held to the plain version; ``ms`` the slowest
    median.  Beside them a lane that freezes on its first iteration (c0 =
    1, a = 20: tanh_f32 gives 1 beyond 9, so c_new = c) launched alone,
    and the time an iteration adds, (slowest - that) / 99."""
    import torch
    from mi_fieldcalc_tpu_torch.tools import probe_mincog_kernel as m
    c0, a, decay = m.solver_inputs(m.GRID_SHAPE, 0, dev)
    c0, a = c0.flatten(), a.flatten()
    trips, done = m.solver_trips(c0, a)
    capped = torch.nonzero(~done).flatten()
    pick = capped[torch.linspace(0, len(capped) - 1, CHAIN_LANES,
                                 device=dev).long()].tolist()
    lanes = [(c0[i:i + 1], a[i:i + 1]) for i in pick]
    one = (torch.ones(1, device=dev), torch.full((1,), 20.0, device=dev))
    assert int(m.solver_trips(*one)[0]) == 1
    assert all(int(trips[i]) == m.MAX_ITER for i in pick)
    times = []
    for lc0, la in lanes + [one]:
        _exact(m.solver(lc0, la, decay), m.solver_plain(lc0, la, decay),
               f"solver lane c0={float(lc0)} a={float(la)}")
        times.append(statistics.median(time_device_ms(
            lambda: m.solver(lc0, la, decay), reps)))
    ms, one_ms = max(times[:-1]), times[-1]
    res = {"lanes": pick, "capped_ms": times[:-1], "ms": ms,
           "one_trip_ms": one_ms,
           "iteration_us": (ms - one_ms) / (m.MAX_ITER - 1) * 1e3}
    log(f"[{smi}] P4 chain floor: {CHAIN_LANES} capped lanes alone "
        f"{min(times[:-1]):.4f}-{ms:.4f} ms, a lane frozen at its first "
        f"iteration {one_ms:.4f} ms: {res['iteration_us']:.4f} us an "
        f"iteration of the slowest")
    return res


def phase_probe_times(dev, smi: str, f32_rate: float, reps=10) -> dict:
    """The measurement path: B1 against P1 in turns at 32x719x929 on
    phase 5's inputs, masked and all-defined; P2's sweep; P3 at the tool's
    shape and at B1's beside P2's one buffer; P4 at the tool's shape and
    719x929 against its bytes, its operations by branch of tanh_f32 (at
    the published rate and at ``f32_rate``, the un-fused issue rate: the
    kernel is built -fmad=false) and its chain floor
    (:func:`solver_chain`), its bound the largest of the three.  Kernel
    times are the launch alone (queued behind a busy wait), median of
    ``reps``; plain times through CUDA events.  The probes' launch counts
    are zeroed before and read after, and each must be > 0.  Bounds at the
    card's published rates (``utils.profiling``)."""
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.ops import fused
    from mi_fieldcalc_tpu_torch.tools import (
        bench_copy, perf_lab_dma, perf_lab_element, probe_mincog_kernel)
    from mi_fieldcalc_tpu_torch.utils.profiling import (
        device_f32_flops, device_hbm_gbps)
    hbm, peak = device_hbm_gbps(dev), device_f32_flops(dev)
    wrappers = {"copy": bench_copy.copy_probe, "add1": perf_lab_dma.add1,
                "window": perf_lab_element.window,
                "solver": probe_mincog_kernel.solver}
    for w in wrappers.values():
        w.launches = 0
    res = {"card": smi, "hbm_bytes_per_s": hbm, "f32_flops": peak}
    log(f"[{smi}] published rates: {hbm / 1e12:.2f} TB/s, "
        f"{peak / 1e12:.0f} TFLOP/s float32")

    # P1 and B1 in turns, B1 first held to its plain version
    for label, undefs in (("masked", True), ("all_defined", False)):
        args = make_inputs(NLEV, NY, NX, 4, undefs, "column")
        host, ad = staging._decode_step(args, staging.HostStager(4), 1e35)
        staged = staging._upload_step(host, dev)
        compare_stacked(fused.derived_fields_fused(*staged, all_defined=ad),
                        fused.derived_fields_plain(*staged, all_defined=ad),
                        f"B1 {label} (phase 10)")
        r = bench_copy.b1_against_copy(staged, ad, rounds=3, reps=reps)
        nb = bench_copy.copy_bytes(NLEV, NY, NX, ad)
        bound = nb / hbm * 1e3
        r.update(bytes=nb, bound_ms=bound,
                 probe_of_bound=bound / r["probe_ms"],
                 b1_of_bound=bound / r["b1_ms"])
        if label == "masked":
            sel = staged[:5] + staged[7:9]
            r["plain_ms"] = statistics.median(time_ms(
                lambda: bench_copy.copy_probe_plain(*sel, ad), reps))
        res[f"copy_{label}"] = r
        log(f"[{smi}] {label}: P1 (copy probe) {r['probe_ms']:.4f} ms "
            f"({r['probe_cap']}), B1 {r['b1_ms']:.4f} ms, B1 / P1 "
            f"{r['b1_over_probe']:.3f} (medians {r['medians']}, rounds "
            f"{r['rounds']}); bytes bound {bound:.4f} ms "
            f"({nb / 1e9:.3f} GB at {hbm / 1e12:.2f} TB/s): P1 at "
            f"{r['probe_of_bound']:.1%}, B1 at {r['b1_of_bound']:.1%}")
        del staged, host

    # P2: the sweep
    x = torch.randn((NLEV, NY, NX), generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    rows = perf_lab_dma.sweep(x, reps)
    one = next(r for r in rows if (r["ty"], r["nbuf"], r["threads"])
               == (48, 1, 256))
    res["add1"] = {"rows": rows, "ms": one["ms"],
                   "library_ms": rows[0]["ms"],
                   "over_library": one["ms"] / rows[0]["ms"],
                   "plain_ms": statistics.median(time_ms(
                       lambda: perf_lab_dma.add1_plain(x), reps)),
                   "bytes": 8 * x.numel(), "bound_ms": 8 * x.numel() / hbm
                   * 1e3}
    for r in rows:
        what = (r["case"] if r["ty"] is None else
                f"{r['case']} ty={r['ty']} bufs={r['nbuf']} "
                f"threads={r['threads']}")
        log(f"[{smi}] P2 {what}: {r['ms']:.4f} ms, {r['gbps']:.1f} GB/s"
            + ("" if r["ty"] is None or r["nbuf"] != 1 else
               f", {r['ms'] / rows[0]['ms']:.3f}x torch.add"))
    log(f"[{smi}] P2 / torch.add(x, 1) at ty 48, 1 buffer, 256 threads: "
        f"{res['add1']['over_library']:.3f}; B1 / P1: masked "
        f"{res['copy_masked']['b1_over_probe']:.3f}, all-defined "
        f"{res['copy_all_defined']['b1_over_probe']:.3f}")

    # P3: the tool's case and B1's shape beside P2's one buffer
    xt = torch.arange(32 * 256, dtype=torch.float32,
                      device=dev).reshape(32, 256)
    yt = torch.ones((1, 32, 256), dtype=torch.float32, device=dev)
    tool_ms = statistics.median(time_device_ms(
        lambda: perf_lab_element.window(xt, yt, 8), reps))
    y = torch.randn(x.shape, generator=torch.Generator(device=dev)
                    .manual_seed(1), device=dev)
    b1s = perf_lab_element.at_b1_shape(x, y, reps)
    nb = b1s["ty8"]["bytes"]
    res["window"] = {"tool_ms": tool_ms, "b1_shape": b1s,
                     "ms": b1s["ty8"]["ms"], "bytes": nb,
                     "bound_ms": nb / hbm * 1e3,
                     "plain_ms": statistics.median(time_ms(
                         lambda: perf_lab_element.window_plain(x, y, 8),
                         reps))}
    log(f"[{smi}] P3 32x256 TY 8: {tool_ms:.4f} ms (launch-bound); at "
        f"{NLEV}x{NY}x{NX}: " + ", ".join(
            f"{k} {v['ms']:.4f} ms ({v['gbps']:.1f} GB/s)"
            for k, v in b1s.items()))
    del x, y

    # P4 against its bytes, its operations by branch and its chain floor
    m = probe_mincog_kernel
    chain = solver_chain(dev, smi, reps)
    res["solver"] = {"chain": chain}
    for key, shape in (("tool", m.TOOL_SHAPE), ("grid", m.GRID_SHAPE)):
        c0, a, decay = m.solver_inputs(shape, 0, dev)
        trips, done = m.solver_trips(c0, a)
        branches = m.solver_branches(c0, a)
        ops = m.solver_ops(branches, c0.numel())
        nb = 12 * c0.numel() + 4 * len(m.DECAY)
        ms = statistics.median(time_device_ms(
            lambda: m.solver(c0, a, decay), reps))
        pms = statistics.median(time_ms(
            lambda: m.solver_plain(c0, a, decay), 3))
        floors = {"bytes": nb / hbm * 1e3, "operations": ops / peak * 1e3,
                  "chain": chain["ms"]}
        by = max(floors, key=floors.get)
        res["solver"][key] = {
            "shape": list(shape), "ms": ms, "plain_ms": pms, "ops": ops,
            "bytes": nb, "branches": branches,
            "unconverged": int((~done).sum()),
            "lane_iterations": int(trips.sum()),
            "bytes_ms": floors["bytes"], "ops_ms": floors["operations"],
            "ops_issue_rate_ms": ops / f32_rate * 1e3,
            "chain_ms": chain["ms"], "bound_ms": floors[by], "bound_by": by}
        log(f"[{smi}] P4 {shape}: {ms:.4f} ms (plain {pms:.3f} ms); "
            f"{int(trips.sum())} lane-iterations {branches}, "
            f"{int((~done).sum())} lanes at the cap; {ops:.3e} operations "
            f"-> {floors['operations']:.4f} ms at {peak / 1e12:.0f} "
            f"TFLOP/s, {ops / f32_rate * 1e3:.4f} ms at "
            f"{f32_rate / 1e12:.2f}e12/s; {nb / 1e6:.1f} MB -> "
            f"{floors['bytes']:.4f} ms; chain floor {chain['ms']:.4f} ms; "
            f"bound {floors[by]:.4f} ms by {by} ({floors[by] / ms:.1%} of "
            f"it)")
    res["launches"] = {k: w.launches for k, w in wrappers.items()}
    log(f"measurement path launches: {res['launches']}")
    if not all(res["launches"].values()):
        raise AssertionError(f"a probe kernel was not launched on the "
                             f"measurement path: {res['launches']}")
    return res


def phase_request_trace(dev, smi: str) -> dict:
    """One masked ``run_derived_fields_np`` request at 32x719x929 (phase
    5's inputs) under ``utils.profiling.trace``: the device's busy share
    of the request's wall time and B1 found in the trace by name.  Where
    the trace holds no device events, the share comes from CUDA events
    around the request's H2D, kernel and D2H steps instead, and the
    record says which method gave it."""
    import tempfile
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.utils.profiling import (
        device_busy_ms, device_events, trace)
    args = make_inputs(NLEV, NY, NX, 5, True, "column")
    ref = staging.run_derived_fields_np(*args, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    staging.run_derived_fields_np(*args, device=dev)
    torch.cuda.synchronize(dev)
    wall_untraced = (time.perf_counter() - t0) * 1e3
    events = []
    with tempfile.TemporaryDirectory() as d:
        try:
            with trace(d) as prof:
                t0 = time.perf_counter()
                out = staging.run_derived_fields_np(*args, device=dev)
                torch.cuda.synchronize(dev)
                wall = (time.perf_counter() - t0) * 1e3
            events = device_events(prof.trace_path)
            busy = device_busy_ms(prof.trace_path)
        except RuntimeError as e:
            log(f"torch.profiler did not trace the request: {e!r}")
    res = {"wall_untraced_ms": wall_untraced}
    if events:
        compare_dicts(out, ref, "traced request")
        by = {}
        for _, cat, _, dur in events:
            by[cat] = by.get(cat, 0.0) + dur / 1e3
        b1 = [e for e in events if "derived_fields_kernel" in e[0]]
        if len(b1) != 1:
            raise AssertionError(f"B1 found {len(b1)} times in the trace")
        res.update(method="torch.profiler trace (kernel, gpu_memcpy, "
                   "gpu_memset intervals)", wall_ms=wall, busy_ms=busy,
                   by_category_ms=by, b1_trace_ms=b1[0][3] / 1e3,
                   b1_name=b1[0][0], device_events=len(events))
    else:
        log("no device events in the torch.profiler trace: the busy share "
            "is taken from CUDA events around H2D, kernel and D2H")
        stager = staging._stager_cache(4, 1e35, True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        host, ad = staging._decode_step(args, stager, 1e35)
        ev[0].record()
        staged = staging._upload_step(host, dev)
        ev[1].record()
        ev[2].record()
        out_dev = staging._compute(staged, ad)
        ev[3].record()
        ev[4].record()
        fetched = staging._fetch(out_dev, stager)
        ev[5].record(stager.streams(dev)[1])
        staging._encode_step(fetched, 1e35)
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
        parts = [ev[k].elapsed_time(ev[k + 1]) for k in (0, 2, 4)]
        res.update(method="CUDA events around H2D, kernel and D2H",
                   wall_ms=wall, busy_ms=sum(parts),
                   by_category_ms=dict(zip(("h2d", "kernel", "d2h"), parts)))
    res["busy_share"] = res["busy_ms"] / res["wall_ms"]
    res["busy_share_untraced"] = res["busy_ms"] / wall_untraced
    log(f"[{smi}] request ({res['method']}): device busy "
        f"{res['busy_ms']:.3f} ms of the measured request's "
        f"{res['wall_ms']:.2f} ms ({res['busy_share']:.2%}); of an "
        f"untraced request's {wall_untraced:.2f} ms "
        f"{res['busy_share_untraced']:.2%}; by kind "
        f"{res['by_category_ms']}" + (
            f"; B1 '{res['b1_name']}' {res['b1_trace_ms']:.4f} ms"
            if "b1_name" in res else ""))
    return res


# --------------------------------------------------------------- phase 11
#: BASELINE config 1 (tools/baseline_configs.py:57-77) at its own 96x128
#: and at the 719x929 AROME grid, and config 3 (:177-206) on the global
#: 0.25 degree grid
CONFIG1_SHAPES = ((96, 128), (719, 929))
CONFIG3_SHAPE = (721, 1440)
#: the ensemble model: members x levels x the AROME grid
ENSEMBLE_SHAPE = (8, 32, 719, 929)
#: phase 9 replays this large golden through the icing kernels
ICING_LARGE_GOLDEN = "large_vesselIcingModStall"


def _golden_modules():
    """The golden cases and the port's adapter (``tests/``), numpy and the
    port only."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import conformance_cases
    import torch_conformance
    return conformance_cases, torch_conformance


def phase_goldens(dev) -> dict:
    """Every small golden and the large ones but phase 9's through the
    port on the card, each under its case's own contract (mask exact where
    ``mask_exact``, values within the case's rtol / atol)."""
    import torch
    cc, tc = _golden_modules()
    goldens = np.load(ROOT / "tests" / "goldens" / "goldens.npz")
    large = np.load(ROOT / "tests" / "goldens" / "goldens_large.npz")
    t0 = time.perf_counter()
    passed, failed = {"small": 0, "large": 0}, []
    for kind, cases, store in (
            ("small", cc.CASES, goldens),
            ("large", [c for c in cc.LARGE_CASES
                       if c.name != ICING_LARGE_GOLDEN], large)):
        for case in cases:
            try:
                out = tc.port_case(case, cc.case_inputs(case), device=dev)
                for key, field in tc.outputs(case, out):
                    if field.values.device != dev:
                        raise AssertionError(f"{key} on "
                                             f"{field.values.device}")
                    tc.check(case, field, store[key])
                passed[kind] += 1
            except Exception as e:  # noqa: BLE001  (every failure listed)
                failed.append(f"{case.name}: {type(e).__name__}: "
                              f"{str(e).splitlines()[0] if str(e) else ''}")
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    n_small, n_large = len(cc.CASES), len(cc.LARGE_CASES) - 1
    log(f"goldens on the card: {passed['small']} of {n_small} small and "
        f"{passed['large']} of {n_large} large pass ({secs:.1f} s)")
    if failed:
        for line in failed:
            log("  golden failed: " + line)
        raise AssertionError(f"{len(failed)} goldens failed on the card")
    return {**passed, "cases_small": n_small, "cases_large": n_large,
            "seconds": secs}


def config1_inputs(ny, nx, seed):
    """Config 1's fields (T 250-300 K and q 1e-4-1e-2 with 2% undefined,
    as tools/baseline_configs.py:62-64) and winds of config 3's range with
    the same share, on 850 hPa; map factors and coriolis of config 3."""
    rng = np.random.default_rng(seed)
    fields = (sentinel(rng, 250.0, 300.0, (ny, nx), 0.02),
              sentinel(rng, 1e-4, 1e-2, (ny, nx), 0.02),
              sentinel(rng, -30.0, 30.0, (ny, nx), 0.02),
              sentinel(rng, -30.0, 30.0, (ny, nx), 0.02))
    maps = (np.full((ny, nx), 4e-6, np.float32),) * 2 + (
        np.full((ny, nx), 1.2e-4, np.float32),)
    return fields, maps


def config3_inputs(seed=2):
    """Config 3's fields (tools/baseline_configs.py:181-189): z, u, v and
    T with 0.5% undefined, constant map factors and coriolis."""
    rng = np.random.default_rng(seed)
    shape = CONFIG3_SHAPE
    fields = (sentinel(rng, 4800.0, 5900.0, shape, 0.005),
              sentinel(rng, -30.0, 30.0, shape, 0.005),
              sentinel(rng, -30.0, 30.0, shape, 0.005),
              sentinel(rng, 250.0, 300.0, shape, 0.005))
    maps = (np.full(shape, 4e-6, np.float32),) * 2 + (
        np.full(shape, 1.2e-4, np.float32),)
    return fields, maps


def config1_step(fields, maps):
    """Config 1 on the port: ``derived_fields_plevel`` at 850 hPa."""
    from mi_fieldcalc_tpu_torch.models import derived_fields_plevel
    tk, q, u, v = fields
    return derived_fields_plevel(tk, q, u, v, 850.0, *maps)


def config3_step(fields, maps):
    """Config 3's 8-field stencil set: geostrophic wind x / y, vorticity,
    divergence and gradient modes 1-4."""
    from mi_fieldcalc_tpu_torch import ops
    z, u, v, tk = fields
    xm, ym, fc = maps
    outs = [ops.plevelgwind_xcomp(z, xm, ym, fc),
            ops.plevelgwind_ycomp(z, xm, ym, fc),
            ops.relvort(u, v, xm, ym), ops.divergence(u, v, xm, ym)]
    outs += [ops.gradient(tk, xm, ym, compute=c) for c in (1, 2, 3, 4)]
    return dict(zip(("gwind_x", "gwind_y", "vort", "div", "dfdx", "dfdy",
                     "gradt", "laplacian"), outs))


def phase_number_args(dev) -> dict:
    """Number-valued map factors and coriolis on the card: each stencil
    that takes them, called with numbers, equals bit for bit the same call
    with full planes of those numbers (the route the goldens hold), masks
    and values at every point; coriolis above and (clamped by the momentum
    coordinates) below ``fcoriolis_min``, both signs."""
    import torch
    from mi_fieldcalc_tpu_torch.field import f32, from_sentinel
    from mi_fieldcalc_tpu_torch import ops

    ny, nx = ICING_SHAPE
    rng = np.random.default_rng(5)
    z = from_sentinel(sentinel(rng, 5000.0, 5800.0, (ny, nx), 0.01),
                      device=dev)
    wind = from_sentinel(sentinel(rng, -30.0, 30.0, (ny, nx), 0.01),
                         device=dev)
    calls = {
        "plevelgwind_xcomp": lambda x, y, c: ops.plevelgwind_xcomp(
            z, x, y, c),
        "plevelgwind_ycomp": lambda x, y, c: ops.plevelgwind_ycomp(
            z, x, y, c),
        "plevelgvort": lambda x, y, c: ops.plevelgvort(z, x, y, c),
        "ilevelgwind": lambda x, y, c: ops.ilevelgwind(z, x, y, c),
        "momentum_x_coordinate": lambda x, y, c: ops.momentum_x_coordinate(
            wind, x, c, 1e-4),
        "momentum_y_coordinate": lambda x, y, c: ops.momentum_y_coordinate(
            wind, y, c, 1e-4),
    }
    checked = []
    for fc in (1.2e-4, -5e-5):
        nums = (1.1e-5, 0.9e-5, fc)
        planes = [torch.full((ny, nx), f32(x), device=dev) for x in nums]
        for name, fn in calls.items():
            got, ref = fn(*nums), fn(*planes)
            for k, (g, r) in enumerate(zip(
                    got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,))):
                if not (torch.equal(g.mask, r.mask)
                        and bool(same_bits(g.values, r.values).all())):
                    raise AssertionError(f"{name} (fc {fc}) output {k}: "
                                         f"numbers differ from planes")
            checked.append(f"{name} fc={fc}")
    log(f"number-valued map factors and coriolis == full planes bit for "
        f"bit at {ny}x{nx}: {len(checked)} calls ({', '.join(calls)})")
    return {"checked": checked}


def phase_configs(dev, smi: str, reps=10) -> dict:
    """BASELINE configs 1 and 3 on the card, each output held to the port
    on the CPU on the same inputs (masks bitwise, values within RTOL: the
    card's sqrt is correctly rounded, PyTorch's CPU one is not), then
    timed (CUDA events, median of ``reps``)."""
    import torch
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    res = {"card": smi}
    cases = [(f"config1_{ny}x{nx}", config1_step,
              config1_inputs(ny, nx, seed=ny)) for ny, nx in CONFIG1_SHAPES]
    cases.append(("config3_{}x{}".format(*CONFIG3_SHAPE), config3_step,
                  config3_inputs()))
    for label, step, (fields, maps) in cases:
        def on(device):
            return ([from_sentinel(a, device=device) for a in fields],
                    [torch.as_tensor(m, device=device) for m in maps])
        card, cpu = step(*on(dev)), step(*on("cpu"))
        worst = 0.0
        for name in card:
            g, r = card[name], cpu[name]
            if g.values.device != dev:
                raise AssertionError(f"{label} {name} on {g.values.device}")
            worst = max(worst, compare_fields(
                [type(g)(g.values.cpu(), g.mask.cpu())], [r],
                f"{label} {name}", defined_only=True))
            if not bool(g.mask.any()):
                raise AssertionError(f"{label} {name}: nothing defined")
        args = on(dev)
        t = time_ms(lambda: step(*args), reps)
        res[label] = {"outputs": sorted(card), "max_abs_err_vs_cpu": worst,
                      "ms": statistics.median(t), "ms_all": t,
                      "points": int(np.prod(fields[0].shape))}
        log(f"[{smi}] {label}: {len(card)} outputs == the CPU port "
            f"(masks bitwise, max abs err {worst:.3g}); median "
            f"{res[label]['ms']:.4f} ms of {reps}")
        del card, cpu, args
    return res


def ensemble_inputs(dev):
    """The ensemble's member stacks on the card: each member the
    headline's inputs (``make_inputs``, the column pattern) from its own
    seed; the hybrid coefficients and maps of member 0."""
    import torch
    from mi_fieldcalc_tpu_torch.field import Field, from_sentinel
    nmem, nlev, ny, nx = ENSEMBLE_SHAPE
    stacks = [Field(torch.empty((nmem,) + shape, dtype=torch.float32,
                                device=dev),
                    torch.empty((nmem,) + shape, dtype=torch.bool,
                                device=dev))
              for shape in [(nlev, ny, nx)] * 4 + [(ny, nx)]]
    for m in range(nmem):
        raw = make_inputs(nlev, ny, nx, 40 + m, True, "column")
        for stack, a in zip(stacks, raw[:5]):
            f = from_sentinel(a, device=dev)
            stack.values[m] = f.values
            stack.mask[m] = f.mask
        if m == 0:
            rest = [torch.as_tensor(a, device=dev) for a in raw[5:]]
    return stacks + rest


def phase_ensemble(dev, smi: str, reps=10) -> dict:
    """``ensemble_derived_summary(fused=True)`` at ENSEMBLE_SHAPE: B1
    launched once per member (its count zeroed just before and read just
    after), each member's stacked output bit for bit equal to
    ``derived_fields_plain``, the summary equal to the ``fused=False``
    route's (masks bitwise, values bit for bit); then its time, split into
    the member launches and the reductions, and its peak memory."""
    import torch
    from mi_fieldcalc_tpu_torch.field import Field
    from mi_fieldcalc_tpu_torch.models import ensemble
    from mi_fieldcalc_tpu_torch.ops import fused
    nmem = ENSEMBLE_SHAPE[0]
    t0 = time.perf_counter()
    args = ensemble_inputs(dev)
    t_in = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)

    fused.derived_fields_fused.launches = 0
    summ = ensemble.ensemble_derived_summary(*args, fused=True)
    torch.cuda.synchronize(dev)
    launches = fused.derived_fields_fused.launches
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"ensemble {'x'.join(map(str, ENSEMBLE_SHAPE))}: B1 launches "
        f"{launches}; peak {peak / 2**30:.2f} GiB allocated (inputs "
        f"{base / 2**30:.2f} GiB)")
    if launches != nmem:
        raise AssertionError(f"expected {nmem} B1 launches, got {launches}")

    def member(m):
        return [Field(f.values[m], f.mask[m]) for f in args[:5]] + args[5:]

    for m in range(nmem):
        errs = compare_stacked(fused.derived_fields_fused(*member(m)),
                               fused.derived_fields_plain(*member(m)),
                               f"ensemble member {m}")
    log(f"ensemble: each of the {nmem} members' B1 output == "
        f"derived_fields_plain bit for bit (every point: "
        f"{errs['every_point']})")

    plain = ensemble.ensemble_derived_summary(*args, fused=False)
    pairs = [(f"mean.{n}", g, r) for n, g, r in zip(NAMES, summ.mean,
                                                     plain.mean)]
    pairs += [(f"spread.{n}", g, r) for n, g, r in zip(NAMES, summ.spread,
                                                       plain.spread)]
    pairs += [("prob_wind", summ.prob_wind, plain.prob_wind),
              ("prob_t_freeze", summ.prob_t_freeze, plain.prob_t_freeze)]
    every = True
    for label, g, r in pairs:
        if not torch.equal(g.mask, r.mask):
            raise AssertionError(f"ensemble {label}: masks differ")
        if not bool(g.mask.any()):
            raise AssertionError(f"ensemble {label}: nothing defined")
        if not bool(same_bits(g.values[g.mask], r.values[r.mask]).all()):
            raise AssertionError(f"ensemble {label}: defined values not "
                                 f"bit for bit")
        every = every and bool(same_bits(g.values, r.values).all())
        if not bool(torch.isfinite(g.values[g.mask]).any()):
            raise AssertionError(f"ensemble {label}: no finite value")
    log(f"ensemble: summary (fused) == summary (fused=False): "
        f"{len(pairs)} fields, masks bitwise, defined values bit for bit "
        f"(every point: {every})")
    del summ, plain

    total = time_ms(lambda: ensemble.ensemble_derived_summary(
        *args, fused=True), reps)
    members = [member(m) for m in range(nmem)]
    b1 = time_ms(lambda: [fused.derived_fields_fused(*a) for a in members],
                 reps)
    plain_one = time_ms(lambda: fused.derived_fields_plain(*members[0]), 3)
    out = ensemble.ensemble_member_fields(*args, fused=True)
    red = time_ms(lambda: ensemble.ensemble_summary(out), reps)
    del out
    plain_total = time_ms(lambda: ensemble.ensemble_derived_summary(
        *args, fused=False), 3)
    res = {"card": smi, "shape": list(ENSEMBLE_SHAPE), "launches": launches,
           "max_abs_err": 0.0, "every_point": every,
           "inputs_s": t_in, "peak_bytes": peak, "input_bytes": base,
           "total_ms": statistics.median(total), "total_ms_all": total,
           "b1_launches_ms": statistics.median(b1), "b1_launches_ms_all": b1,
           "b1_per_member_ms": statistics.median(b1) / nmem,
           "plain_member_ms": statistics.median(plain_one),
           "reductions_ms": statistics.median(red), "reductions_ms_all": red,
           "plain_total_ms": statistics.median(plain_total)}
    res["gather_ms"] = (res["total_ms"] - res["b1_launches_ms"]
                        - res["reductions_ms"])
    # the reductions' bytes bound: the 12 member stacks (values and masks)
    # read once, the 26 summary fields written once, at the published rate
    from mi_fieldcalc_tpu_torch.utils.profiling import device_hbm_gbps
    pts = int(np.prod(ENSEMBLE_SHAPE[1:]))
    res["reductions_bytes"] = 12 * nmem * pts * 5 + 26 * pts * 5
    res["reductions_bound_ms"] = (res["reductions_bytes"]
                                  / device_hbm_gbps(dev) * 1e3)
    log(f"[{smi}] ensemble summary (fused) median of {reps}: "
        f"{res['total_ms']:.3f} ms = {nmem} B1 launches "
        f"{res['b1_launches_ms']:.3f} ms ({res['b1_per_member_ms']:.4f} ms "
        f"each) + reductions {res['reductions_ms']:.3f} ms + the member "
        f"stack {res['gather_ms']:.3f} ms (the reductions' bytes bound "
        f"{res['reductions_bound_ms']:.3f} ms); fused=False "
        f"{res['plain_total_ms']:.3f} ms (median of 3); peak "
        f"{peak / 2**30:.2f} GiB")
    return res


# --------------------------------------------------------------- phase 12
#: the stream: 6 headline requests from their own seeds, masked and
#: all-defined mixed so the route switches mid-stream
STREAM_STEPS = ((21, True, "column"), (22, False, "column"),
                (23, True, "scattered"), (24, True, "column"),
                (25, False, "column"), (26, True, "scattered"))
#: bytes of the page-locked buffer whose copies give the transfer rates
RATE_BYTES = 2 ** 30


def kernel_wrappers() -> dict:
    """Every path kernel's wrapper, by name: their ``launches`` counts."""
    from mi_fieldcalc_tpu_torch.ops import fused, fused_suite
    from mi_fieldcalc_tpu_torch.ops import icing_fused, vertical_fused
    return {w.__name__: w for w in (
        fused.derived_fields_fused, vertical_fused.hlevel_to_plevel_fused,
        fused_suite.alevel_suite_fused, fused_suite.hlevel_suite_fused,
        icing_fused.vessel_icing_mincog_fused,
        icing_fused.vessel_icing_modstall_fused)}


def zero_launches() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {k: w.launches for k, w in kernel_wrappers().items()}


def copy_rates(dev, smi: str, nbytes=RATE_BYTES, reps=5) -> dict:
    """H2D and D2H of one ``nbytes`` page-locked buffer, and of one
    pageable buffer (touched first), each way (CUDA events, median of
    ``reps``), in GB/s; and the time to page-lock the buffer."""
    import torch
    t0 = time.perf_counter()
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    alloc_ms = (time.perf_counter() - t0) * 1e3
    pageable = torch.zeros(nbytes, dtype=torch.uint8)
    d = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    res = {"bytes": nbytes, "pin_alloc_ms": alloc_ms}
    for key, fn in (
            ("pinned_h2d", lambda: d.copy_(pinned, non_blocking=True)),
            ("pinned_d2h", lambda: pinned.copy_(d, non_blocking=True)),
            ("pageable_h2d", lambda: d.copy_(pageable)),
            ("pageable_d2h", lambda: pageable.copy_(d))):
        ms = statistics.median(time_ms(fn, reps))
        res[key + "_ms"] = ms
        res[key + "_gbps"] = nbytes / ms / 1e6
    del pinned, pageable, d
    log(f"[{smi}] copies of {nbytes / 2**30:.0f} GiB: page-locked H2D "
        f"{res['pinned_h2d_gbps']:.2f} GB/s, D2H "
        f"{res['pinned_d2h_gbps']:.2f} GB/s; pageable H2D "
        f"{res['pageable_h2d_gbps']:.2f} GB/s, D2H "
        f"{res['pageable_d2h_gbps']:.2f} GB/s; page-locking the buffer "
        f"{alloc_ms:.1f} ms")
    return res


def identical_dicts(got: dict, ref: dict, label: str) -> None:
    """Two sentinel dicts equal byte for byte, key by key, in order."""
    if list(got) != list(ref):
        raise AssertionError(f"{label}: keys {list(got)} != {list(ref)}")
    for name, r in ref.items():
        g = got[name]
        if g.dtype != r.dtype or g.shape != r.shape or not np.array_equal(
                g.view(np.uint32), r.view(np.uint32)):
            raise AssertionError(f"{label} {name}: not byte for byte the "
                                 f"serial entry's")


def overlap_split(dev, steps) -> dict:
    """The serving request as ``run_derived_fields_np`` runs it, on the
    calling thread's stager, timed on the host clock with no
    synchronisation between its steps: decode, the queued upload, kernel
    and chunked fetch, and per chunk the wait for its copy and its encode.
    Then the last request's fetched planes encoded again in one call and
    in its chunks, in turns."""
    import torch
    from mi_fieldcalc_tpu_torch import native, staging
    stager = staging._stager_cache(4, 1e35, True)
    rows = []
    for s in steps:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        host, ad = staging._decode_step(s, stager, 1e35)
        t1 = time.perf_counter()
        fetched = staging._fetch(
            staging._compute(staging._upload_step(host, dev), ad), stager)
        t2 = time.perf_counter()
        wait = enc = 0.0
        ny, nx = fetched.values.shape[-2:]
        for lo, hi, ev in fetched.chunks:
            a = time.perf_counter()
            if ev is not None:          # None: a CPU rehearsal
                ev.synchronize()
            b = time.perf_counter()
            native.encode_trim_batch(fetched.values[lo:hi], fetched.masks,
                                     ny, nx, fetched.mask_map[lo:hi], 1e35)
            wait += b - a
            enc += time.perf_counter() - b
        rows.append({"decode": (t1 - t0) * 1e3, "enqueue": (t2 - t1) * 1e3,
                     "wait": wait * 1e3, "encode": enc * 1e3,
                     "total": (time.perf_counter() - t0) * 1e3})
    one, chunked = [], []
    for _ in range(3):
        a = time.perf_counter()
        native.encode_trim_batch(fetched.values, fetched.masks, ny, nx,
                                 fetched.mask_map, 1e35)
        b = time.perf_counter()
        staging._encode_step(fetched, 1e35)
        one.append((b - a) * 1e3)
        chunked.append((time.perf_counter() - b) * 1e3)
    return {"requests": rows, "chunks": len(fetched.chunks),
            "median": {k: round(statistics.median(r[k] for r in rows), 2)
                       for k in rows[0]},
            "encode_one_ms": statistics.median(one),
            "encode_chunked_ms": statistics.median(chunked),
            "encode_one_ms_all": one, "encode_chunked_ms_all": chunked}


def fresh_touch_ms(ny: int, nx: int, nlev: int, planes: int) -> dict:
    """Host ms to write ``planes`` fresh float32 ``[nlev, ny, nx]`` arrays
    once (the pages faulted in, as the encode's fresh outputs are) and to
    write them again (the pages resident)."""
    arrays = [np.empty((nlev, ny, nx), np.float32) for _ in range(planes)]
    t0 = time.perf_counter()
    for a in arrays:
        a.fill(1.0)
    t1 = time.perf_counter()
    for a in arrays:
        a.fill(2.0)
    t2 = time.perf_counter()
    return {"fresh_ms": (t1 - t0) * 1e3, "again_ms": (t2 - t1) * 1e3}


def phase_stream(dev, smi: str, reps=10) -> dict:
    """``stream_derived_fields_np`` over STREAM_STEPS at 32x719x929: the
    page-locked and pageable copy rates of this host; the serving
    request's own steps as they overlap, and what fresh output pages cost;
    the serial entry on every step; the stream twice (the first allocates
    its stager pair), B1's launches counted over the first, every streamed
    dict byte for byte the serial entry's; the time between yields; the
    stream under ``torch.profiler`` (busy share, copies by direction, B1);
    and B1 on step 1's inputs against its plain version."""
    import os
    import tempfile
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.ops import fused
    from mi_fieldcalc_tpu_torch.utils.profiling import device_events, trace
    res = {"card": smi, "shape": [NLEV, NY, NX], "steps": len(STREAM_STEPS),
           "host_cores": os.cpu_count(),
           "affinity_cores": len(os.sched_getaffinity(0)),
           "rates": copy_rates(dev, smi)}
    steps = [make_inputs(NLEV, NY, NX, seed, undefs, kind)
             for seed, undefs, kind in STREAM_STEPS]
    probe = staging.HostStager(4)
    routes = [staging._decode_step(s, probe, 1e35)[1] for s in steps]
    del probe
    if routes != [not u for _, u, _ in STREAM_STEPS]:
        raise AssertionError(f"stream routes {routes}")

    res["overlap"] = overlap_split(dev, steps[:3])
    res["page_faults"] = fresh_touch_ms(NY, NX, NLEV, 12)
    log(f"[{smi}] the serving request's own steps (no synchronisation "
        f"between them), ms: {res['overlap']['median']}; encoding a "
        f"fetched request in one call {res['overlap']['encode_one_ms']:.2f} "
        f"ms, in its {res['overlap']['chunks']} chunks "
        f"{res['overlap']['encode_chunked_ms']:.2f} ms; 12 fresh "
        f"{NLEV}x{NY}x{NX} float32 planes written once "
        f"{res['page_faults']['fresh_ms']:.2f} ms, again "
        f"{res['page_faults']['again_ms']:.2f} ms")
    refs, serial_ms = [], []
    for s in steps:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        refs.append(staging.run_derived_fields_np(*s, device=dev))
        torch.cuda.synchronize(dev)
        serial_ms.append((time.perf_counter() - t0) * 1e3)
    res["serial_steps_ms"] = serial_ms

    def stream():
        """The timed stream; its dicts are checked after the last yield,
        so the time between yields is the stream's own."""
        marks, outs = [time.perf_counter()], []
        for out in staging.stream_derived_fields_np(steps, device=dev):
            marks.append(time.perf_counter())
            outs.append(out)
        if len(outs) != len(steps):
            raise AssertionError(f"the stream yielded {len(outs)} of "
                                 f"{len(steps)}")
        for k, out in enumerate(outs):
            identical_dicts(out, refs[k], f"streamed step {k + 1}")
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

    zero_launches()
    first = stream()
    res["launches"] = read_launches()
    want = dict.fromkeys(res["launches"], 0)
    want["derived_fields_fused"] = len(steps)
    if res["launches"] != want:
        raise AssertionError(f"stream launches {res['launches']}")
    second = stream()
    res["stream_first_ms"] = first
    res["stream_ms"] = second
    res["stream_total_ms"] = sum(second)
    res["stream_per_step_ms"] = sum(second) / len(steps)
    res["stream_steady_ms"] = statistics.median(second[1:])
    log(f"[{smi}] stream of {len(steps)} steps at {NLEV}x{NY}x{NX} "
        f"(routes {routes}), every streamed dict byte for byte the serial "
        f"entry's; B1 launches {res['launches']['derived_fields_fused']}; "
        f"ms between yields {[round(x, 2) for x in second]} (the first "
        f"stream, allocating its stagers: "
        f"{[round(x, 2) for x in first]}): {res['stream_per_step_ms']:.2f} "
        f"ms a step over the whole stream, {res['stream_steady_ms']:.2f} "
        f"ms in steady state; serial requests {serial_ms} ms; "
        f"{res['host_cores']} host cores ({res['affinity_cores']} usable)")

    # the stream under torch.profiler: the device's busy share
    with tempfile.TemporaryDirectory() as d:
        with trace(d) as prof:
            wall = sum(stream())
        events = device_events(prof.trace_path)
    if not events:
        raise AssertionError("no device events in the stream's trace")
    busy, end, by = 0.0, float("-inf"), {}
    for name, cat, start, dur in events:
        stop = start + dur
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        key = ("B1" if "derived_fields_kernel" in name else
               "h2d" if "HtoD" in name else "d2h" if "DtoH" in name else
               cat)
        by[key] = by.get(key, 0.0) + dur / 1e3
    res["trace"] = {"wall_ms": wall, "busy_ms": busy / 1e3,
                    "busy_share": busy / 1e3 / wall, "by_kind_ms": by,
                    "b1_share": by.get("B1", 0.0) / wall,
                    "b1_events": sum("derived_fields_kernel" in e[0]
                                     for e in events)}
    # the launch counts above are the check; a trace may drop an event
    if not res["trace"]["b1_events"]:
        raise AssertionError("B1 not found in the stream's trace")
    log(f"[{smi}] traced stream: device busy {busy / 1e3:.2f} ms of "
        f"{wall:.2f} ms ({res['trace']['busy_share']:.2%}); B1 "
        f"{res['trace']['b1_share']:.2%} ({res['trace']['b1_events']} of "
        f"{len(steps)} launches in the trace); by kind {by}")
    del refs

    # B1 on step 1's inputs, against its plain version
    stager = staging.HostStager(4, pin=True)
    host, ad = staging._decode_step(steps[0], stager, 1e35)
    staged = staging._upload_step(host, dev)
    errs = compare_stacked(
        fused.derived_fields_fused(*staged, all_defined=ad),
        fused.derived_fields_plain(*staged, all_defined=ad),
        "B1 stream step 1")
    k = time_ms(lambda: fused.derived_fields_fused(*staged, all_defined=ad),
                reps)
    p = time_ms(lambda: fused.derived_fields_plain(*staged, all_defined=ad),
                3)
    res["b1"] = {"kernel_ms": statistics.median(k), "kernel_ms_all": k,
                 "plain_ms": statistics.median(p),
                 "max_abs_err": max(errs["max_abs"].values())}
    log(f"[{smi}] B1 on stream step 1: {res['b1']['kernel_ms']:.4f} ms, "
        f"plain {res['b1']['plain_ms']:.2f} ms")
    return res


# --------------------------------------------------------------- phase 13
def api_modules():
    """The drop-in api and its inputs' adapter (``tests/``)."""
    _golden_modules()
    import torch_api_cases
    from mi_fieldcalc_tpu_torch import api
    return api, torch_api_cases


#: the api functions that run a kernel on CUDA: the kernel's wrapper and
#: the plain operator of the same request
API_KERNELS = {"vesselIcingMincog": ("vessel_icing_mincog_fused",
                                     "vessel_icing_mincog", "mincog"),
               "vesselIcingModStall": ("vessel_icing_modstall_fused",
                                       "vessel_icing_modstall", "modstall")}


def api_requests() -> dict:
    """Every api function's call at 719x929: ``(arrays, scalars)``, the
    scalars None where the function's golden case gives them.  The icing
    functions take phase 9's request 1 (its physical wave periods; the
    small cases' ones would put ~1.3% of this grid in the solvers' slow
    band) with ICING_SCAL, MINCOG with alt 1."""
    api, cases = api_modules()
    _, args, alt = icing_requests()[0]
    sal, _, xw, yw, at, _, sst, _, _, aice, _ = args
    scal = dict(zip(("vs", "alpha", "zmin", "zmax"), ICING_SCAL))
    req = {}
    for name in cases.api_names(api.__all__):
        if name in ("vesselIcingOverland", "vesselIcingMertins"):
            req[name] = ((at, sst, xw, yw, sal, aice), {})
        elif name == "vesselIcingModStall":
            req[name] = (args, scal)
        elif name == "vesselIcingMincog":
            req[name] = (args, dict(scal, alt=alt))
        else:
            req[name] = (cases.api_inputs(name, ICING_SHAPE), None)
    return req


def api_run(name: str, request, device):
    api, cases = api_modules()
    arrays, scal = request
    if scal is None:
        return cases.api_call(api, name, arrays, device=device)
    return getattr(api, name)(*arrays, **scal, device=device)


def api_mismatch(got, ref, exact: bool):
    """None where the api outputs agree (the same sentinel points; values
    bit for bit where ``exact``, else within RTOL and 2e-6 of the field's
    largest magnitude), else what differs."""
    if got is None or ref is None:
        return f"returned None (card: {got is None}, reference: "\
               f"{ref is None})"
    gs = got if isinstance(got, tuple) else (got,)
    rs = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(gs, rs):
        if g.shape != r.shape:
            return f"shape {g.shape} != {r.shape}"
        ug, ur = g == np.float32(1e35), r == np.float32(1e35)
        if not np.array_equal(ug, ur):
            return f"undefined points differ at {int((ug != ur).sum())}"
        d = ~ur
        if exact:
            bad = int((g.view(np.uint32) != r.view(np.uint32)).sum())
        elif d.any():
            tol = RTOL * np.abs(r[d]) + 2e-6 * float(np.abs(r[d]).max())
            bad = int((np.abs(g[d] - r[d]) > tol).sum())
        else:
            bad = 0
        if bad:
            return f"{bad} values differ"
    return None


def phase_api(dev, smi: str, copy_gbps: float, f32_rate: float,
              reps=10) -> dict:
    """Every drop-in api function once on the card at 719x929, the
    kernels' launch counts zeroed before and read after (B5 and B6 once
    each, no other kernel); each output then held to the same call on the
    CPU (sentinels equal, values within RTOL and 2e-6 of the field's
    largest magnitude), and vesselIcingMincog / vesselIcingModStall to the
    plain operators on the card, bit for bit.  Then B5 and B6 alone on the
    api's decoded inputs against their plain versions, with the operation
    counts of these inputs."""
    import torch
    from mi_fieldcalc_tpu_torch import ops
    from mi_fieldcalc_tpu_torch.ops.icing import _number
    api, _ = api_modules()
    requests = api_requests()
    for name, req in requests.items():          # a warm-up of each op
        api_run(name, req, dev)
    torch.cuda.synchronize(dev)
    outs, wall = {}, {}
    zero_launches()
    for name, req in requests.items():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        outs[name] = api_run(name, req, dev)
        torch.cuda.synchronize(dev)
        wall[name] = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    for wrapper, _, _ in API_KERNELS.values():
        want[wrapper] = 1
    if launches != want:
        raise AssertionError(f"api launches {launches}, expected {want}")
    log(f"[{smi}] api: {len(requests)} functions once each on the card at "
        f"{ICING_SHAPE[0]}x{ICING_SHAPE[1]}, {sum(wall.values()):.1f} ms "
        f"in all; launches {launches}")

    failures, res = {}, {"card": smi, "wall_ms": wall,
                         "launches": launches}
    plain_route_ms = {}
    for name, req in requests.items():
        if name in API_KERNELS:
            _, op, _ = API_KERNELS[name]
            arrays, scal = req
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            ref = api._wrap(getattr(ops, op), 1e35, *arrays,
                            scalars=tuple(scal.values()), device=dev)
            torch.cuda.synchronize(dev)
            plain_route_ms[name] = (time.perf_counter() - t0) * 1e3
            bad = api_mismatch(outs[name], ref, exact=True)
        else:
            bad = api_mismatch(outs[name], api_run(name, req, "cpu"),
                               exact=False)
        if bad:
            failures[name] = bad
    if failures:
        raise AssertionError(f"api outputs on the card differ: {failures}")
    log(f"[{smi}] api: {len(requests) - len(API_KERNELS)} functions equal "
        f"to the CPU's calls; vesselIcingMincog / vesselIcingModStall bit "
        f"for bit the plain operators' on the card ("
        + ", ".join(f"{n} {wall[n]:.2f} ms, plain route "
                    f"{plain_route_ms[n]:.2f} ms" for n in API_KERNELS)
        + ")")

    # B5 and B6 alone on the api's decoded inputs
    number = _number(*ICING_SCAL[2:])
    arrays, scal = requests["vesselIcingMincog"]
    fields = [api._decode(np.ascontiguousarray(a, np.float32), 1e35, dev)
              for a in arrays]
    runs = icing_runs(fields, scal["alt"])
    for name, (_, _, key) in API_KERNELS.items():
        launch, plain, nplanes, nflags = runs[key]
        if not same_bits(launch(), plain()).all():
            raise AssertionError(f"{name}: the kernel differs from its plain "
                                 f"version on the api's inputs")
        trips = {}
        plain(trips)
        k = time_ms(launch, reps)
        p = time_ms(plain, 1, warmup=False)
        bound = icing_bound(trips, number, fields[0].values.numel(), nplanes,
                            nflags, copy_gbps, f32_rate,
                            scal["alt"] if key == "mincog" else None)
        res[key] = {
            "api_ms": wall[name], "plain_route_ms": plain_route_ms[name],
            "kernel_ms": statistics.median(k), "kernel_ms_all": k,
            "plain_ms": statistics.median(p), "max_abs_err": 0.0,
            "bytes": bound["bytes"], "ops": bound["ops"]}
        log(f"[{smi}] {name} on the api's inputs: kernel "
            f"{statistics.median(k):.4f} ms, plain "
            f"{statistics.median(p):.1f} ms; the api call {wall[name]:.2f} "
            f"ms")
    return res


# --------------------------------------------------------------- phase 14
#: the storm's grids: BASELINE config 1's class and the AROME grid
STORM_SHAPES = ((96, 128), ICING_SHAPE)
#: forecast cycles a mode runs, and the outputs a subset consumer reads
CYCLES = 6
SUBSET = (0, 7, 15)


def storm_lab():
    from mi_fieldcalc_tpu_torch import api, batch
    from mi_fieldcalc_tpu_torch.tools import perf_lab_batch
    return api, batch, perf_lab_batch


def host_ms(fn, dev, reps: int) -> list:
    """Host-clock ms of ``fn`` between two synchronisations, ``reps``
    times."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def identical(got, ref, label: str) -> None:
    """Raise unless every output equals its reference byte for byte."""
    got, ref = list(got), list(ref)
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} outputs, expected "
                             f"{len(ref)}")
    for i, (g, r) in enumerate(zip(got, ref)):
        g = np.asarray(g)
        if g.shape != r.shape or g.dtype != r.dtype \
                or g.tobytes() != r.tobytes():
            raise AssertionError(f"{label}: output {i} differs from the "
                                 f"eager call's")


def bf16_reference(a: np.ndarray) -> np.ndarray:
    """The eager float32 output as a bfloat16 fetch returns it: each value
    rounded to bfloat16 and widened, the sentinel exact."""
    import torch
    r = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return np.where(a == np.float32(1e35), np.float32(1e35), r)


def program_memory(dev, B) -> dict:
    """Device memory each cached program keeps: its CUDA graph's private
    pool (the caching allocator's segments of that pool: the capture's
    intermediates and the static outputs) and its static input stacks,
    read from the allocator's snapshot, with nothing allocated or freed
    on the way; then the bytes the allocator returns once the program
    cache is cleared."""
    import gc
    import torch
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device", dev.index) == dev.index:
            pid = tuple(seg["segment_pool_id"])
            pools[pid] = pools.get(pid, 0) + seg["total_size"]
    programs = [o for o in gc.get_objects()
                if isinstance(o, B._Program) and o.graph is not None]
    rows = [{"calls": len(p.sig), "fetch_dtype": p.fetch_dtype,
             "stacks": [list(shape) for shape, _ in p.specs],
             "pool_bytes": pools.get(tuple(p.graph.pool()), 0),
             "static_in_bytes": sum(t.numel() * t.element_size()
                                    for t in p.static_in)}
            for p in programs]
    del programs
    for r in rows:
        r["bytes"] = r["pool_bytes"] + r["static_in_bytes"]
    cached = B._compiled_batch.cache_info().currsize
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(dev)
    B._compiled_batch.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    freed = before - torch.cuda.memory_reserved(dev)
    return {"programs": rows, "cached": cached, "freed_bytes": freed}


def graphs_per_signature(stats: dict, flushes: int, label: str) -> None:
    """Raise unless the batch captured one graph per new signature and
    replayed once per flush."""
    if stats["captures"] != stats["programs"] or stats["replays"] != flushes:
        raise AssertionError(f"{label}: {stats}; expected one capture per "
                             f"new signature and {flushes} replays")


def storm_split(dev, g, ref, reps: int) -> dict:
    """One storm's replay in its parts: record (host clock), then the
    flush's stacking of the inputs into the page-locked block (host
    clock), its H2D into the graph's static inputs, the replay and the
    output copy (CUDA events around each), and D2H (host clock around
    fetching every output), each the median of ``reps``; and the whole
    flush on the host clock.  Each replay is held to ``ref`` byte for
    byte."""
    import torch
    api, B, lab = storm_lab()
    marks = {}
    orig = {k: getattr(B._Program, k) for k in ("load", "replay",
                                                 "outputs")}

    def timed(name):
        def run(self, *a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig[name](self, *a)
            e1.record()
            marks[name] = (e0, e1)
            return out
        return run

    parts = {k: [] for k in ("record", "flush", "stack", "h2d", "replay",
                             "output_copy", "d2h")}
    real_ship = B._ship
    stack_ms = []

    def ship(arrays, device):
        t = time.perf_counter()
        out = real_ship(arrays, device)
        stack_ms.append((time.perf_counter() - t) * 1e3)
        return out

    for k in orig:
        setattr(B._Program, k, timed(k))
    B._ship = ship
    try:
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with api.batch(device=dev):
                out = lab.storm(api, g, device=dev)
                t1 = time.perf_counter()
            torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            got = lab.fetch_all(out)
            t3 = time.perf_counter()
            identical(got, ref, "storm split")
            parts["record"].append((t1 - t0) * 1e3)
            parts["flush"].append((t2 - t1) * 1e3)
            parts["d2h"].append((t3 - t2) * 1e3)
            parts["stack"].append(sum(stack_ms))
            stack_ms.clear()
            for k, name in (("h2d", "load"), ("replay", "replay"),
                            ("output_copy", "outputs")):
                parts[k].append(marks[name][0].elapsed_time(
                    marks[name][1]))
    finally:
        for k, f in orig.items():
            setattr(B._Program, k, f)
        B._ship = real_ship
    return {k: statistics.median(v) for k, v in parts.items()}


def storm_case(dev, smi: str, shape, reps=5) -> dict:
    """The 22-call storm at ``shape``: eagerly through the api on the
    card, then its first flush in a batch (record, warm-up, capture and
    one replay: one capture, one replay) and repeated flushes (replays
    only), every output byte for byte the eager call's; the host-clock
    times (median of ``reps`` after the warm-up), the replay's split and
    the replay alone in CUDA events."""
    import torch
    api, B, lab = storm_lab()
    g = lab.inputs(*shape)
    eager = lab.fetch_all(lab.storm(api, g, device=dev))      # warm-up
    eager_ms = host_ms(lambda: lab.fetch_all(lab.storm(api, g, device=dev)),
                       dev, reps)

    def batched():
        with api.batch(device=dev):
            out = lab.storm(api, g, device=dev)
        return lab.fetch_all(out)

    B._program_stats(reset=True)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with api.batch(device=dev):
        out = lab.storm(api, g, device=dev)
        t1 = time.perf_counter()
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    first = lab.fetch_all(out)
    t3 = time.perf_counter()
    first_ms = (t3 - t0) * 1e3
    first_split = {"record": (t1 - t0) * 1e3, "flush": (t2 - t1) * 1e3,
                   "d2h": (t3 - t2) * 1e3}
    stats = B._program_stats()
    if (stats["captures"], stats["replays"]) != (1, 1):
        raise AssertionError(f"storm {shape}: first flush {stats}, expected "
                             f"one capture and one replay")
    identical(first, eager, f"storm {shape} first flush")
    del first, out
    replay_ms = []
    for k in range(reps):                # each result checked, then dropped
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = batched()
        torch.cuda.synchronize(dev)
        replay_ms.append((time.perf_counter() - t0) * 1e3)
        identical(out, eager, f"storm {shape} replay {k}")
        del out
    kept = []
    kept_ms = host_ms(lambda: kept.append(batched()), dev, reps)
    for k, out in enumerate(kept):
        identical(out, eager, f"storm {shape} kept replay {k}")
    del kept
    stats = B._program_stats()
    if (stats["captures"], stats["replays"]) != (1, 1 + 2 * reps):
        raise AssertionError(f"storm {shape}: {stats} after {2 * reps} "
                             f"replays")
    split = storm_split(dev, g, eager, reps)
    res = {"shape": list(shape), "calls": len(eager),
           "eager_ms": statistics.median(eager_ms), "eager_ms_all": eager_ms,
           "first_flush_ms": first_ms, "first_flush_split_ms": first_split,
           "replay_ms": statistics.median(replay_ms),
           "replay_ms_all": replay_ms,
           "replay_kept_ms": statistics.median(kept_ms),
           "replay_kept_ms_all": kept_ms, "split_ms": split,
           "graph_replay_event_ms": split["replay"],
           "programs": B._program_stats()}
    log(f"[{smi}] storm {shape[0]}x{shape[1]} ({len(eager)} calls): eager "
        f"{res['eager_ms']:.3f} ms, first flush {first_ms:.3f} ms (record "
        f"{first_split['record']:.3f}, warm-up + capture + replay "
        f"{first_split['flush']:.3f}, D2H {first_split['d2h']:.3f}), replay "
        f"{res['replay_ms']:.3f} ms ({res['eager_ms'] / res['replay_ms']:.2f}"
        f"x; {res['replay_kept_ms']:.3f} ms with every result kept); "
        f"split: "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + " ms; every output byte for byte the eager call's")
    return res


def icing_storm_calls(api, args, dev):
    """MINCOG with alt 1 and alt 2 and ModStall on one request."""
    scal = dict(zip(("vs", "alpha", "zmin", "zmax"), ICING_SCAL))
    return [api.vesselIcingMincog(*args, **scal, alt=1, device=dev),
            api.vesselIcingMincog(*args, **scal, alt=2, device=dev),
            api.vesselIcingModStall(*args, **scal, device=dev)]


def icing_storm_case(dev, smi: str, reps=5) -> dict:
    """The icing storm at 719x929 on phase 9's request 1, recorded in one
    batch: its outputs held byte for byte to the eager api calls and bit
    for bit to the plain operators on the card.  The wrappers count each
    launch they make: zeroed just before the first flush, they read B5 4
    and B6 2 after it (the eager warm-up's launches and the capture's);
    a replay runs no Python, so one replay is traced with
    ``utils.profiling.trace``, which must hold B5 twice and B6 once: those
    are the batch path's launches."""
    import tempfile
    import torch
    from mi_fieldcalc_tpu_torch import ops
    from mi_fieldcalc_tpu_torch.utils.profiling import device_events, trace
    api, B, _ = storm_lab()
    _, args, _ = icing_requests()[0]
    eager = icing_storm_calls(api, args, dev)
    scal = ICING_SCAL
    plain = [api._wrap(ops.vessel_icing_mincog, 1e35, *args,
                       scalars=scal + (alt,), device=dev) for alt in (1, 2)]
    plain.append(api._wrap(ops.vessel_icing_modstall, 1e35, *args,
                           scalars=scal, device=dev))
    identical(eager, plain, "icing storm, eager api against the plain "
              "operators")

    def batched():
        with api.batch(device=dev):
            out = icing_storm_calls(api, args, dev)
        return [np.asarray(o) for o in out]

    B._program_stats(reset=True)
    zero_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    identical(batched(), eager, "icing storm first flush")
    torch.cuda.synchronize(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    wrapped = read_launches()
    want = dict.fromkeys(wrapped, 0)
    want.update(vessel_icing_mincog_fused=4, vessel_icing_modstall_fused=2)
    if wrapped != want:
        raise AssertionError(f"icing storm first flush launches {wrapped}, "
                             f"expected {want} (warm-up and capture)")
    outs = []
    replay_ms = host_ms(lambda: outs.append(batched()), dev, reps)
    for k, out in enumerate(outs):
        identical(out, eager, f"icing storm replay {k}")
    stats = B._program_stats()
    if (stats["captures"], stats["replays"]) != (1, 1 + reps):
        raise AssertionError(f"icing storm: {stats}")
    found = None
    for attempt in range(3):
        with tempfile.TemporaryDirectory() as d:
            with trace(d) as prof:
                out = batched()
                torch.cuda.synchronize(dev)
            events = device_events(prof.trace_path)
        identical(out, eager, "icing storm traced replay")
        b5 = [e for e in events if "mincog_kernel" in e[0]]
        b6 = [e for e in events if "modstall_kernel" in e[0]]
        log(f"icing storm traced replay {attempt}: {len(events)} device "
            f"events, B5 {len(b5)}, B6 {len(b6)}")
        if len(b5) > 2 or len(b6) > 1:
            raise AssertionError("the traced replay holds more icing "
                                 "kernels than the storm launches")
        if (len(b5), len(b6)) == (2, 1):
            found = (b5, b6)
            break
    if found is None:
        raise AssertionError("no trace of an icing replay held B5 twice "
                             "and B6 once")
    b5, b6 = found
    launches = {"vessel_icing_mincog_fused": len(b5),
                "vessel_icing_modstall_fused": len(b6)}
    res = {"first_flush_ms": first_ms,
           "replay_ms": statistics.median(replay_ms),
           "replay_ms_all": replay_ms, "launches": launches,
           "first_flush_launches": wrapped,
           "trace_attempts": attempt + 1,
           "mincog_trace_ms": [e[3] / 1e3 for e in b5],
           "modstall_trace_ms": [e[3] / 1e3 for e in b6],
           "max_abs_err": 0.0}
    log(f"[{smi}] icing storm at {ICING_SHAPE[0]}x{ICING_SHAPE[1]}: first "
        f"flush {first_ms:.3f} ms, replay "
        f"{res['replay_ms']:.3f} ms; the wrappers' launches at the first "
        f"flush {wrapped}; the replay's trace holds B5 "
        f"{res['mincog_trace_ms']} ms and B6 {res['modstall_trace_ms']} "
        f"ms; byte for byte the eager api calls, bit for bit the plain "
        f"operators")
    return res


def cycle_args(base, lab, r: int):
    g = list(base)
    g[2], g[4] = lab.fresh_pair(np.random.default_rng(100 + r),
                                *ICING_SHAPE)
    return tuple(g)


def refreshed(args):
    """The cycle's two fresh inputs as new objects of the same values: the
    input cache misses them again."""
    return tuple(a.copy() if k in (2, 4) else a for k, a in enumerate(args))


def forecast_cycles(dev, smi: str) -> dict:
    """Six forecast cycles at 719x929 with ``cache_inputs=True`` and two
    fresh inputs a cycle, in four modes: fetch everything (from a cleared
    cache: the cold cycle ships every input, the later ones one 2-row
    stack), pipelined (cycle i+1 flushed before cycle i is fetched), a
    subset fetch of 3 of the 22 outputs, and fetch_dtype="bfloat16" (each
    later mode passes the fresh inputs as new copies).  Every
    cycle is held byte for byte to the eager calls (bfloat16: their
    rounding, sentinels exact); the cache's hits and misses and the
    graphs' captures and replays to the plan; ms per cycle (host clock
    around the synchronised cycle) and a replayed cycle's device busy
    share."""
    import tempfile
    import torch
    from mi_fieldcalc_tpu_torch.utils.profiling import device_busy_ms, trace
    api, B, lab = storm_lab()
    base = lab.inputs(*ICING_SHAPE)
    cycles = [cycle_args(base, lab, r) for r in range(CYCLES)]
    refs = [lab.fetch_all(lab.storm(api, c, device=dev)) for c in cycles]
    shipped = []
    real_ship = B._ship

    def ship(arrays, device):
        shipped.append(len(arrays))
        return real_ship(arrays, device)

    def run(args, **kw):
        with api.batch(cache_inputs=True, device=dev, **kw):
            return lab.storm(api, args, device=dev)

    B._ship = ship
    res = {}
    try:
        B.clear_input_cache()
        B.cache_stats(reset=True)
        B._program_stats(reset=True)
        ms, per = [], []
        for r, args in enumerate(cycles):
            shipped.clear()
            before = B.cache_stats()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = lab.fetch_all(run(args))
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            identical(out, refs[r], f"cycle {r} (fetch everything)")
            after = B.cache_stats()
            hits = after["hits"] - before["hits"]
            misses = after["misses"] - before["misses"]
            want = (0, 14, [14]) if r == 0 else (12, 2, [2])
            if (hits, misses, list(shipped)) != want:
                raise AssertionError(
                    f"cycle {r}: hits {hits}, misses {misses}, shipped "
                    f"{shipped}; expected {want}")
            per.append({"hits": hits, "misses": misses,
                        "shipped_rows": list(shipped)})
        stats = B._program_stats()
        graphs_per_signature(stats, CYCLES, "fetch-everything cycles")
        res["fetch_all"] = {"ms": ms, "steady_ms": statistics.median(
            ms[1:]), "cache": per, "programs": stats}

        B._program_stats(reset=True)
        ms, outs = [], []
        for r, args in enumerate(cycles):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            outs.append(run(refreshed(args)))
            if r:
                got = lab.fetch_all(outs[r - 1])
            ms.append((time.perf_counter() - t0) * 1e3)
            if r:
                identical(got, refs[r - 1], f"cycle {r - 1} (pipelined)")
                outs[r - 1] = got = None
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got = lab.fetch_all(outs[-1])
        ms.append((time.perf_counter() - t0) * 1e3)
        identical(got, refs[-1], f"cycle {CYCLES - 1} (pipelined)")
        del outs, got
        # ms[r] for r in 1..5: cycle r's flush and cycle r-1's fetch, which
        # queues behind it; ms[0] the first flush, ms[6] the last fetch
        res["pipelined"] = {"ms": ms,
                            "steady_ms": statistics.median(ms[1:CYCLES]),
                            "programs": B._program_stats()}

        B._program_stats(reset=True)
        ms = []
        for r, args in enumerate(cycles):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = run(refreshed(args))
            got = api.fetch(*[out[i] for i in SUBSET])
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            identical(got, [refs[r][i] for i in SUBSET],
                      f"cycle {r} (subset fetch)")
        res["subset"] = {"ms": ms, "steady_ms": statistics.median(ms),
                         "outputs": list(SUBSET),
                         "programs": B._program_stats()}

        B._program_stats(reset=True)
        ms = []
        for r, args in enumerate(cycles):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = lab.fetch_all(run(refreshed(args), fetch_dtype="bfloat16"))
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            identical(out, [bf16_reference(a) for a in refs[r]],
                      f"cycle {r} (bfloat16 fetch)")
        res["bfloat16"] = {"ms": ms, "steady_ms": statistics.median(ms[1:]),
                           "programs": B._program_stats()}
        for mode in ("pipelined", "subset", "bfloat16"):
            graphs_per_signature(res[mode]["programs"], CYCLES, mode)
        if res["bfloat16"]["programs"]["programs"] != 1:
            raise AssertionError(f"bfloat16 cycles: "
                                 f"{res['bfloat16']['programs']}")

        with tempfile.TemporaryDirectory() as d:
            with trace(d) as prof:
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                out = lab.fetch_all(run(refreshed(cycles[-1])))
                torch.cuda.synchronize(dev)
                wall = (time.perf_counter() - t0) * 1e3
            busy = device_busy_ms(prof.trace_path)
        identical(out, refs[-1], "traced cycle")
        steady = res["fetch_all"]["steady_ms"]
        res["traced_cycle"] = {"wall_ms": wall, "busy_ms": busy,
                               "busy_share": busy / wall,
                               "busy_share_untraced": busy / steady}
    finally:
        B._ship = real_ship
        B.clear_input_cache()
    log(f"[{smi}] forecast cycles at {ICING_SHAPE[0]}x{ICING_SHAPE[1]} "
        f"(cache_inputs, 2 fresh inputs a cycle), ms a cycle (steady "
        f"median): fetch everything {res['fetch_all']['steady_ms']:.3f} "
        f"(cold {res['fetch_all']['ms'][0]:.3f}), pipelined "
        f"{res['pipelined']['steady_ms']:.3f}, subset of 3 "
        f"{res['subset']['steady_ms']:.3f}, bfloat16 "
        f"{res['bfloat16']['steady_ms']:.3f}; device busy {busy:.3f} ms of "
        f"a traced cycle's {wall:.3f} ms "
        f"({res['traced_cycle']['busy_share']:.2%}; of a steady cycle's "
        f"{res['traced_cycle']['busy_share_untraced']:.2%}); every cycle byte "
        f"for byte the eager calls' (bfloat16: their rounding)")
    return res


def phase_batch(dev, smi: str) -> dict:
    """Call-storm batching on the card: the 22-call storm at 96x128 and
    719x929 and the icing storm as CUDA graphs against the eager api
    calls, and six forecast cycles in four modes.  A failed capture or
    replay fails the phase: there is no eager fallback."""
    res = {"card": smi, "storms": [storm_case(dev, smi, s)
                                   for s in STORM_SHAPES]}
    res["icing"] = icing_storm_case(dev, smi)
    res["cycles"] = forecast_cycles(dev, smi)
    _, B, _ = storm_lab()
    mem = res["program_memory"] = program_memory(dev, B)
    for r in mem["programs"]:
        log(f"[{smi}] program of {r['calls']} calls (stacks "
            f"{r['stacks']}, fetch_dtype {r['fetch_dtype']}): graph pool "
            f"{r['pool_bytes'] / 2**20:.1f} MiB + static inputs "
            f"{r['static_in_bytes'] / 2**20:.1f} MiB")
    log(f"[{smi}] {mem['cached']} cached programs hold "
        f"{sum(r['bytes'] for r in mem['programs']) / 2**20:.1f} MiB on the "
        f"card; clearing the program cache returned "
        f"{mem['freed_bytes'] / 2**20:.1f} MiB")
    return res


# --------------------------------------------------------------- phase 15
#: phase 15's process grids (gy, gx), cut from the headline 32x719x929
SHARD_GRIDS = ((2, 2), (4, 1), (1, 4))


def shard_plan(nyg: int, nxg: int, gy: int, gx: int, overlap: bool) -> list:
    """B1's launches on every shard of a (gy, gx) cut of a global
    ``(nyg, nxg)`` grid (``parallel/fused.py``'s geometry, from global
    coordinates): each launch's input window ``win`` (rows, then columns,
    half-open; its offsets are the window's origin), ``halo_rows``, and
    the part of its output (``take``, window coordinates) that lands at
    ``dest`` (global).  Without overlap a shard is one launch on its block
    and a RADIUS halo ring; with it, the block alone, then the seam strips
    of each side that has a neighbour, rows before columns."""
    from mi_fieldcalc_tpu_torch.models.pipeline import RADIUS as R
    from mi_fieldcalc_tpu_torch.parallel.mesh import block
    L = 2 * R
    plan = []
    for iy in range(gy):
        r0, r1 = block(nyg, gy, iy)
        for ix in range(gx):
            c0, c1 = block(nxg, gx, ix)
            h, w = r1 - r0, c1 - c0

            def add(kind, win, take, dest, halo):
                plan.append({"shard": (iy, ix), "kind": kind, "win": win,
                             "take": take, "dest": dest, "halo_rows": halo})

            if not overlap:
                add("halo", (r0 - R, r1 + R, c0 - R, c1 + R),
                    (R, R + h, R, R + w), (r0, r1, c0, c1), R)
                continue
            hy = R if gy > 1 else 0
            add("interior", (r0, r1, c0, c1), (0, h, 0, w),
                (r0, r1, c0, c1), 0)
            if r0 > 0:
                add("top", (r0 - R, r0 + L, c0, c1), (R, 2 * R, 0, w),
                    (r0, r0 + R, c0, c1), 0)
            if r1 < nyg:
                add("bottom", (r1 - L, r1 + R, c0, c1), (L - R, L, 0, w),
                    (r1 - R, r1, c0, c1), 0)
            if c0 > 0:
                add("left", (r0 - hy, r1 + hy, c0 - R, c0 + L),
                    (hy, hy + h, R, 2 * R), (r0, r1, c0, c0 + R), hy)
            if c1 < nxg:
                add("right", (r0 - hy, r1 + hy, c1 - L, c1 + R),
                    (hy, hy + h, L - R, L), (r0, r1, c1 - R, c1), hy)
    return plan


def window(t, win, nyg: int, nxg: int):
    """Rows ``win[0]:win[1]`` and columns ``win[2]:win[3]`` of ``t``'s
    trailing axes, zeros (mask False) beyond the global grid: what the
    halo exchange delivers there."""
    a, b, c, d = win
    out = t.new_zeros(tuple(t.shape[:-2]) + (b - a, d - c))
    ya, yb, xa, xb = max(a, 0), min(b, nyg), max(c, 0), min(d, nxg)
    out[..., ya - a:yb - a, xa - c:xb - c] = t[..., ya:yb, xa:xb]
    return out


def piece_args(args, win):
    """The pipeline's arguments cut to a launch's window."""
    from mi_fieldcalc_tpu_torch.field import Field
    nyg, nxg = args[0].values.shape[-2:]
    cut = [Field(window(f.values, win, nyg, nxg),
                 window(f.mask, win, nyg, nxg)) for f in args[:5]]
    return cut + [args[5], args[6], window(args[7], win, nyg, nxg),
                  window(args[8], win, nyg, nxg)]


def run_plan(launch, args, plan, all_defined: bool):
    """Every launch of ``plan`` through ``launch(fields, alevel, blevel,
    xmapr, ymapr, offsets, halo_rows)`` on windows of the global ``args``,
    stitched into one :class:`DerivedFieldsStacked`."""
    import torch
    from mi_fieldcalc_tpu_torch.models.pipeline import DerivedFieldsStacked
    shape = tuple(args[0].values.shape)
    dev = args[0].values.device
    values = torch.empty((12,) + shape, dtype=torch.float32, device=dev)
    masks = torch.empty((2 if all_defined else 9,) + shape,
                        dtype=torch.bool, device=dev)
    for p in plan:
        a = piece_args(args, p["win"])
        st = launch(a[:5], a[5], a[6], a[7], a[8],
                    (p["win"][0], p["win"][2]), p["halo_rows"])
        ta, tb, tc, td = p["take"]
        da, db, dc, dd = p["dest"]
        values[..., da:db, dc:dd] = st.values[..., ta:tb, tc:td]
        masks[..., da:db, dc:dd] = st.masks[..., ta:tb, tc:td]
    return DerivedFieldsStacked(values, masks)


def kept(st, take):
    """The part ``take`` (rows, then columns, half-open) of a stacked
    result."""
    from mi_fieldcalc_tpu_torch.models.pipeline import DerivedFieldsStacked
    ta, tb, tc, td = take
    return DerivedFieldsStacked(st.values[..., ta:tb, tc:td],
                                st.masks[..., ta:tb, tc:td])


def same_stacked(got, ref, label: str) -> None:
    """Masks equal and values bit for bit at every point (NaN where NaN);
    raises otherwise."""
    import torch
    if not torch.equal(got.masks, ref.masks):
        raise AssertionError(f"{label}: masks differ at "
                             f"{int((got.masks != ref.masks).sum())} points")
    bad = ~same_bits(got.values, ref.values)
    if bool(bad.any()):
        raise AssertionError(f"{label}: {int(bad.sum())} values not bit for "
                             f"bit")


def same_defined(got, ref, label: str) -> None:
    """Trees of Fields: masks equal, values bit for bit where defined."""
    import torch
    from mi_fieldcalc_tpu_torch.field import Field
    if isinstance(ref, Field):
        if not torch.equal(got.mask, ref.mask):
            raise AssertionError(f"{label}: masks differ")
        if not bool(same_bits(got.values[ref.mask],
                              ref.values[ref.mask]).all()):
            raise AssertionError(f"{label}: defined values not bit for bit")
        return
    for i, (g, r) in enumerate(zip(got, ref)):
        same_defined(g, r, f"{label}[{i}]")


def sharded_kernels(dev, smi: str, hbm: float, reps=5) -> dict:
    """(a) B1 on each shard of SHARD_GRIDS at 32x719x929, masked and
    all-defined, without and with overlap: stitched, equal to the unsharded
    launch bit for bit at every point; each shard's launches timed (the
    launch alone, queued behind a busy wait) beside a shard's bytes bound
    and the unsharded launch."""
    import torch
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.models.pipeline import RADIUS
    from mi_fieldcalc_tpu_torch.ops import fused

    res = {"card": smi, "grids": {}}
    for ad in (False, True):
        raw = make_inputs(NLEV, NY, NX, seed=11, undefs=not ad)
        args = [from_sentinel(a, device=dev) for a in raw[:5]] + [
            torch.as_tensor(a, device=dev) for a in raw[5:9]]
        del raw
        route = "all_defined" if ad else "masked"
        whole = fused.derived_fields_fused(*args, None, all_defined=ad)
        res[f"unsharded_{route}_ms"] = statistics.median(time_device_ms(
            lambda: fused._launch(*args, ad), reps))

        def launch(f, al, bl, xm, ym, offs, halo):
            return fused.derived_fields_fused(
                *f, al, bl, xm, ym, None, all_defined=ad,
                global_shape=(NY, NX), grid_offsets=offs, halo_rows=halo)

        for gy, gx in SHARD_GRIDS:
            for overlap in (False, True):
                plan = shard_plan(NY, NX, gy, gx, overlap)
                fused.derived_fields_fused.launches = 0
                same_stacked(run_plan(launch, args, plan, ad), whole,
                             f"B1 on ({gy}, {gx}) {route}"
                             f"{' overlap' if overlap else ''}")
                n = fused.derived_fields_fused.launches
                if n != len(plan):
                    raise AssertionError(f"{len(plan)} launches planned, "
                                         f"{n} counted")
                pieces = []
                for p in plan:
                    a = piece_args(args, p["win"])
                    offs = (p["win"][0], p["win"][2])
                    placement = (*offs, NY, NX)
                    ms = statistics.median(time_device_ms(
                        lambda: fused._launch(*a, ad, placement), reps))
                    hy, wx = (p["win"][1] - p["win"][0],
                              p["win"][3] - p["win"][2])
                    nbytes = layout_bytes(NLEV, hy, wx, ad)
                    pieces.append({"shard": p["shard"], "kind": p["kind"],
                                   "block": (hy, wx), "ms": ms,
                                   "bytes": nbytes,
                                   "bound_ms": nbytes / hbm * 1e3})
                key = f"{gy}x{gx}_{route}{'_overlap' if overlap else ''}"
                res["grids"][key] = {"launches": n, "pieces": pieces}
                per = {}
                for q in pieces:
                    per.setdefault(q["shard"], []).append(q)
                log(f"[{smi}] B1 on ({gy}, {gx}) {route}"
                    f"{' with overlap' if overlap else ''}: stitched == "
                    f"unsharded bit for bit; {n} launches; per shard "
                    + "; ".join(
                        f"{s}: " + " + ".join(
                            f"{q['kind']} {q['block'][0]}x{q['block'][1]} "
                            f"{q['ms']:.4f} ms (bound {q['bound_ms']:.4f})"
                            for q in qs) for s, qs in per.items())
                    + f"; unsharded {res[f'unsharded_{route}_ms']:.4f} ms")
        del whole, args
    # the plain version on shard (0, 0) of (2, 2), under its offsets
    raw = make_inputs(NLEV, NY, NX, seed=11, undefs=True)
    args = [from_sentinel(a, device=dev) for a in raw[:5]] + [
        torch.as_tensor(a, device=dev) for a in raw[5:9]]
    p = shard_plan(NY, NX, 2, 2, False)[0]
    a = piece_args(args, p["win"])
    kw = dict(global_shape=(NY, NX), grid_offsets=(-RADIUS, -RADIUS),
              halo_rows=RADIUS)
    # compared on the part kept: beyond the physical edges ps is 0, and
    # the kernel's pow takes only positive pressures
    same_stacked(kept(fused.derived_fields_fused(*a, None, **kw), p["take"]),
                 kept(fused.derived_fields_plain(*a, None, **kw), p["take"]),
                 "shard (0, 0) kernel == plain")
    res["plain_shard_ms"] = statistics.median(time_ms(
        lambda: fused.derived_fields_plain(*a, None, **kw), 3))
    log(f"[{smi}] shard (0, 0) of (2, 2): kernel == plain bit for bit; "
        f"plain {res['plain_shard_ms']:.3f} ms")
    return res


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_path(dev, smi: str) -> dict:
    """(b) The sharded path at world size 1 under NCCL: the fused pipeline
    (overlap off and on), the isobaric path at phase 7's size, the
    ensemble at phase 11's and one stencil through ``run_sharded``, each
    equal to its unsharded call, with B1 / B2 counted."""
    import torch
    import torch.distributed as dist
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.models import (STANDARD_PLEVELS,
                                               derived_fields_isobaric,
                                               ensemble_derived_summary)
    from mi_fieldcalc_tpu_torch.ops import fused, shapiro2_filter
    from mi_fieldcalc_tpu_torch.ops import vertical_fused as vf
    from mi_fieldcalc_tpu_torch.parallel import (distributed, grid_mesh,
                                                 run_sharded)
    from mi_fieldcalc_tpu_torch.parallel.fused import (
        derived_fields_fused_sharded, derived_fields_isobaric_sharded,
        ensemble_summary_sharded)

    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    res = {"backend": dist.get_backend(), "launches": {}}
    try:
        grid = grid_mesh((1, 1, 1))

        def counted(name, fn, want):
            fused.derived_fields_fused.launches = 0
            vf.hlevel_to_plevel_fused.launches = 0
            out = fn()
            torch.cuda.synchronize(dev)
            got = {"derived_fields": fused.derived_fields_fused.launches,
                   "vertical_interp": vf.hlevel_to_plevel_fused.launches}
            res["launches"][name] = got
            if got != want:
                raise AssertionError(f"{name}: launches {got}, want {want}")
            return out

        raw = make_inputs(NLEV, NY, NX, seed=12, undefs=True)
        args = [from_sentinel(a, device=dev) for a in raw[:5]] + [
            torch.as_tensor(a, device=dev) for a in raw[5:]]
        del raw
        whole = fused.derived_fields_fused(*args)
        for overlap in (False, True):
            name = "fused_overlap" if overlap else "fused"
            got = counted(name, lambda: derived_fields_fused_sharded(
                grid, *args, overlap=overlap, stacked=True),
                {"derived_fields": 1, "vertical_interp": 0})
            same_stacked(got, whole, f"sharded pipeline, {name}")
        stencil = run_sharded(shapiro2_filter, grid, 2, args[0])
        same_defined(stencil, shapiro2_filter(args[0]),
                     "run_sharded shapiro2_filter")
        del whole, args, got, stencil

        raw = make_column_inputs(*ISO_SHAPE, seed=3, undef_frac=0.005)
        args = [from_sentinel(a, device=dev) for a in raw[:5]] + [
            torch.as_tensor(a, device=dev) for a in raw[5:]]
        del raw
        got = counted("isobaric", lambda: derived_fields_isobaric_sharded(
            grid, *args, plevels=STANDARD_PLEVELS),
            {"derived_fields": 1, "vertical_interp": 1})
        compare_fields_exact(got, derived_fields_isobaric(
            *args, plevels=STANDARD_PLEVELS, fused=True),
            "sharded isobaric path")
        del args, got

        args = ensemble_inputs(dev)
        nmem = ENSEMBLE_SHAPE[0]
        got = counted("ensemble", lambda: ensemble_summary_sharded(
            grid, *args), {"derived_fields": nmem, "vertical_interp": 0})
        same_defined(got, ensemble_derived_summary(*args, fused=True),
                     "sharded ensemble summary")
        del args, got
        torch.cuda.synchronize(dev)
    finally:
        dist.destroy_process_group()
        distributed._state.update(initialized=False, device=None)
    log(f"[{smi}] the sharded path at world size 1 on {res['backend']}: "
        f"fused (overlap off / on), shapiro2_filter through run_sharded, "
        f"isobaric {ISO_SHAPE} -> {len(STANDARD_PLEVELS)}, ensemble "
        f"{ENSEMBLE_SHAPE}: each equal to its unsharded call; launches "
        f"{res['launches']}")
    return res


def shard_record(kern: dict, overlap: bool) -> dict:
    """The kernels line's numbers for B1 on shard (0, 0) of the (2, 2)
    grid, masked: its launch time (interior and strips summed with
    overlap), bytes and points, the plain version's time on it, the median
    shard's time and the whole grid's launch."""
    pieces = kern["grids"]["2x2_masked" + ("_overlap" if overlap
                                            else "")]["pieces"]
    per = {}
    for q in pieces:
        per.setdefault(tuple(q["shard"]), []).append(q)
    first = per[(0, 0)]
    return {"ms": sum(q["ms"] for q in first),
            "median_shard_ms": statistics.median(
                sum(q["ms"] for q in qs) for qs in per.values()),
            "plain_ms": kern["plain_shard_ms"],
            "unsharded_ms": kern["unsharded_masked_ms"],
            "shard_launches": len(pieces),
            "shard_bytes": sum(q["bytes"] for q in first),
            "shard_points": sum(NLEV * q["block"][0] * q["block"][1]
                                for q in first)}


def phase_sharded(dev, smi: str, hbm: float) -> dict:
    """Phase 15: B1's per-shard arguments at full width, and the sharded
    path at world size 1 under NCCL."""
    return {"kernels": sharded_kernels(dev, smi, hbm),
            "path": sharded_path(dev, smi)}


#: phase 16: B2 at more fields than one launch takes (31), from phase 7's
#: four column fields; the variant names of the JAX function
MANY_FIELDS = 40
VARIANTS = ("packed", "inplace", "carrysel")
#: phase 16 (b): the port's tour, and what of it the CPU run must match
TOUR = ROOT / "examples" / "forecast_products_torch.py"


def many_fields(base, nvar: int) -> tuple:
    """``nvar`` distinct Fields on the card from the Fields ``base``: field
    k is ``base[k % len(base)]`` plus k, its mask rolled by k columns (so
    a launch that read or wrote another group's slice would show)."""
    import torch
    from mi_fieldcalc_tpu_torch.field import Field
    return tuple(Field(base[k % len(base)].values + float(k),
                       torch.roll(base[k % len(base)].mask, k, -1))
                 for k in range(nvar))


def interp_many(dev, smi: str, hbm: float, launch4_ms: float,
                reps=10) -> dict:
    """Phase 16 (a): B2 on MANY_FIELDS fields of 137x719x929 -> the 11
    standard surfaces (phase 7's inputs, 0.5% undefined), masked and
    all-defined, under each JAX variant name: ``"inplace"`` in one call,
    ``"packed"`` and ``"carrysel"``, which refuse more than 31 fields as
    the JAX function does (checked), in calls of 31 and the rest.  Each
    result bit for bit its plain version at every point, 2 launches either
    way (as the C entry reports them to the wrapper); then the launch alone timed beside its bytes bound and 10x phase
    7's 4-field launch."""
    import torch
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.models import STANDARD_PLEVELS as tg
    from mi_fieldcalc_tpu_torch.ops import vertical_fused as vf

    nlev, ny, nx = ISO_SHAPE
    nt, nvar = len(tg), MANY_FIELDS
    t0 = time.perf_counter()
    raw = make_column_inputs(nlev, ny, nx, seed=3, undef_frac=0.005)
    base = tuple(from_sentinel(x, device=dev) for x in raw[:4])
    ps = from_sentinel(raw[4], device=dev)
    a, b = (torch.as_tensor(x, device=dev) for x in raw[5:7])
    del raw
    fields = many_fields(base, nvar)
    del base
    torch.cuda.synchronize(dev)
    in_gb = sum(f.values.numel() * 5 for f in fields) / 1e9
    log(f"B2 at {nvar} fields: inputs {in_gb:.2f} GB on the card, made in "
        f"{time.perf_counter() - t0:.1f} s")
    res = {"card": smi, "nvar": nvar, "inputs_gb": in_gb, "launches": {}}
    for ad in (False, True):
        route = "all_defined" if ad else "masked"
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ref = vf.hlevel_to_plevel_plain(fields, ps, a, b, tg, True, ad)
        ev[1].record()
        ev[1].synchronize()
        res[f"plain_{route}_ms"] = ev[0].elapsed_time(ev[1])
        for variant in VARIANTS:
            if variant != "inplace":
                try:
                    vf.hlevel_to_plevel_fused(fields, ps, a, b, tg,
                                              variant=variant)
                except ValueError as e:
                    if "at most 31 fields" not in str(e):
                        raise
                else:
                    raise AssertionError(f"variant={variant!r} took "
                                         f"{nvar} fields")
            calls = ([fields] if variant == "inplace" else
                     [fields[:vf._PACKED_VARS], fields[vf._PACKED_VARS:]])
            zero_launches()
            got = sum((vf.hlevel_to_plevel_fused(
                c, ps, a, b, tg, variant=variant, all_defined=ad)
                for c in calls), ())
            torch.cuda.synchronize(dev)
            counts = read_launches()
            want = -(-nvar // vf._GROUP_VARS)
            if counts["hlevel_to_plevel_fused"] != want or sum(
                    counts.values()) != want:
                raise AssertionError(f"B2 {variant} {route}: launches "
                                     f"{counts}, expected {want} of B2")
            res["launches"][f"{variant}_{route}"] = want
            compare_fields_exact(got, ref, f"B2 {nvar} fields {variant} "
                                 f"{route}")
            del got
        del ref
        log(f"B2 at {nvar} fields {route}: bit for bit the plain version "
            f"at every point under {', '.join(VARIANTS)}, "
            f"{res['launches'][f'inplace_{route}']} launches a call; plain "
            f"{res[f'plain_{route}_ms']:.1f} ms")
        res[f"launch_{route}_ms_all"] = time_device_ms(
            lambda: vf._launch(fields, ps, a, b, tg, True, ad), reps)
        res[f"launch_{route}_ms"] = statistics.median(
            res[f"launch_{route}_ms_all"])
    res["wrapper_ms"] = statistics.median(time_ms(
        lambda: vf.hlevel_to_plevel_fused(fields, ps, a, b, tg,
                                          variant="inplace"), reps))
    res["bytes"] = interp_bytes(nvar, nlev, nt, ny, nx, False)["bracket"]
    res["ops"] = ny * nx * nt * (nlev.bit_length() * OPS_B2_STEP
                                 + OPS_B2_TARGET)
    res["bound_ms"] = res["bytes"] / hbm * 1e3
    res["ten_4field_launch_ms"] = 10 * launch4_ms
    log(f"[{smi}] B2 at {nvar}x{nlev}x{ny}x{nx} -> {nt}: the launches "
        f"alone {res['launch_masked_ms']:.4f} ms masked, "
        f"{res['launch_all_defined_ms']:.4f} all-defined, through the "
        f"wrapper {res['wrapper_ms']:.4f}; bytes bound "
        f"{res['bound_ms']:.4f} ms ({res['bytes'] / 1e9:.3f} GB); 10x "
        f"phase 7's 4-field launch {res['ten_4field_launch_ms']:.4f} ms")
    return res


def tour_module():
    """``examples/forecast_products_torch.py``, imported from this
    checkout."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("forecast_products_torch",
                                                  TOUR)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_numbers(got: dict, ref: dict, label: str) -> None:
    """The tour's returned numbers: ints, bools and lists of names equal,
    floats within RTOL (lists element by element)."""
    if sorted(got) != sorted(ref):
        raise AssertionError(f"{label}: keys {sorted(got)} != {sorted(ref)}")
    for k, r in ref.items():
        g = got[k]
        pairs = list(zip(g, r)) if isinstance(r, list) else [(g, r)]
        if isinstance(r, list) and len(g) != len(r):
            raise AssertionError(f"{label} {k}: {g} != {r}")
        for x, y in pairs:
            if isinstance(y, float):
                ok = abs(x - y) <= RTOL * abs(y)
            else:
                ok = x == y and type(x) is type(y)
            if not ok:
                raise AssertionError(f"{label} {k}: cuda {g!r} cpu {r!r}")


def tour_kernels(tour, dev, hbm: float, peak: float, reps=10) -> dict:
    """B1 as the tour's sharded section launches it at world size 1 (the
    grid and its radius-2 ring of zeros, global offsets -2, -2) and B4 as
    its suite section does (temps 3, hums_q 1 and 9, masked), on the
    tour's state on the card: each bit for bit its plain version (B1 on
    the part kept), then the launch alone and the plain version timed.
    B1's bound counts the grid it keeps: at world size 1 the ring holds
    zeros under a False mask, which the clamped stencils never read, and
    its outputs are cropped."""
    import torch
    from mi_fieldcalc_tpu_torch.field import from_sentinel
    from mi_fieldcalc_tpu_torch.models.pipeline import RADIUS as R
    from mi_fieldcalc_tpu_torch.ops import fused
    from mi_fieldcalc_tpu_torch.ops import fused_suite as fs

    tk, q, u, v, ps, al, bl, mapr, _ = tour.synthetic_state()
    nlev, ny, nx = tk.shape
    f = [from_sentinel(x, device=dev) for x in (tk, q, u, v, ps)]
    a, b, xm = (torch.as_tensor(x, device=dev) for x in (al, bl, mapr))
    plan = shard_plan(ny, nx, 1, 1, False)[0]
    pa = piece_args(f + [a, b, xm, xm], plan["win"])
    kw = dict(global_shape=(ny, nx), grid_offsets=(-R, -R), halo_rows=R)
    same_stacked(
        kept(fused._launch(*pa, False, (-R, -R, ny, nx)), plan["take"]),
        kept(fused.derived_fields_plain(*pa, None, **kw), plan["take"]),
        "tour B1 == plain")
    reqs = fs._build_reqs("chip_smoke", (3,), (1, 9), (), (), (), ())
    plain4 = fs.hlevel_suite_plain(f[0], f[1], None, f[4], a, b, reqs, False)
    compare_suite_exact(
        fs._launch(True, f[0], f[1], None, f[4], a, b, reqs, False), plain4,
        "tour B4 == plain")
    nout = len(reqs)
    out = {
        "b1": {"ms": statistics.median(time_device_ms(
                   lambda: fused._launch(*pa, False, (-R, -R, ny, nx)),
                   reps)),
               "plain_ms": statistics.median(time_ms(
                   lambda: fused.derived_fields_plain(*pa, None, **kw),
                   reps)),
               "bytes": layout_bytes(nlev, ny, nx, False),
               "ops": OPS_B1_POINT * nlev * ny * nx},
        "b4": {"ms": statistics.median(time_device_ms(
                   lambda: fs._launch(True, f[0], f[1], None, f[4], a, b,
                                      reqs, False), reps)),
               "plain_ms": statistics.median(time_ms(
                   lambda: fs.hlevel_suite_plain(f[0], f[1], None, f[4], a,
                                                 b, reqs, False), reps)),
               "bytes": suite_bytes(2, nout, plain4.masks.shape[0], nlev,
                                    ny, nx, True, False),
               "ops": OPS_SUITE_OUTPUT * nout * nlev * ny * nx}}
    for k in out.values():
        k["bound_ms"] = max(k["bytes"] / hbm, k["ops"] / peak) * 1e3
    return out


def run_tour(dev, smi: str, hbm: float, peak: float) -> dict:
    """Phase 16 (b): the tour on the card, with every kernel's count
    zeroed before and read after (B1 twice, in its sharded section and its
    aligned ingest, B4 once, no other kernel),
    then on the CPU in this run; every number it returns must agree."""
    import contextlib
    import io
    import torch
    tour = tour_module()
    res = {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        if device == "cuda":
            zero_launches()
        with contextlib.redirect_stdout(buf):
            res[device] = tour.main(device)
        if device == "cuda":
            torch.cuda.synchronize(dev)
            res["launches"] = read_launches()
        res[f"{device}_s"] = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            log(f"  tour on {device}: {line}")
    want = {k: 0 for k in res["launches"]}
    want.update(derived_fields_fused=2, hlevel_suite_fused=1)
    if res["launches"] != want:
        raise AssertionError(f"tour launches {res['launches']}, expected "
                             f"B1 twice (sections 3 and 8) and B4 once")
    same_numbers(res["cuda"], res["cpu"], "tour cuda vs cpu")
    if not res["cuda"]["sharded_agree"]:
        raise AssertionError("tour: sharded vorticity != single-device")
    res["kernels"] = tour_kernels(tour, dev, hbm, peak)
    log(f"[{smi}] tour: {res['cuda_s']:.1f} s on the card, "
        f"{res['cpu_s']:.1f} s on the CPU, every number within rtol {RTOL}; "
        f"launches {res['launches']}; B1 (its sharded launch) "
        f"{res['kernels']['b1']['ms']:.4f} ms, plain "
        f"{res['kernels']['b1']['plain_ms']:.3f}; B4 "
        f"{res['kernels']['b4']['ms']:.4f} ms, plain "
        f"{res['kernels']['b4']['plain_ms']:.3f}")
    return res


def phase_surface_end(dev, smi: str, hbm: float, peak: float,
                      launch4_ms: float) -> dict:
    """Phase 16: B2 at 40 fields under every variant name, then the
    tour on the card and on the CPU."""
    import torch
    t0 = time.perf_counter()
    many = interp_many(dev, smi, hbm, launch4_ms)
    torch.cuda.empty_cache()
    tour = run_tour(dev, smi, hbm, peak)
    wall = time.perf_counter() - t0
    log(f"phase 16 took {wall:.1f} s")
    return {"interp_many": many, "tour": tour, "wall_s": wall}


# ---------------------------------------------------------------- phase 17

#: phase 17: the streamed steps of the aligned ingest
ALIGNED_STEPS = 3


def stager_block(stager) -> tuple:
    """A copy of what ``stager``'s last decode left in its input block:
    its layout, the value bytes and the mask bytes."""
    oshape, nps, rest, nval = stager._layout
    n = int(np.prod(oshape)) + nps
    return (stager._layout, stager._vin[:nval].numpy().tobytes(),
            stager._min[:n].numpy().tobytes())


def close_to_cpu(got: dict, ref: dict, label: str) -> None:
    """A card's sentinel dict against the CPU's: the same keys in order,
    shapes and sentinel points, values within RTOL and 2e-6 of the
    field's largest magnitude (:func:`api_mismatch`)."""
    if list(got) != list(ref):
        raise AssertionError(f"{label}: keys {list(got)} != {list(ref)}")
    for name, r in ref.items():
        why = api_mismatch(got[name], r, exact=False)
        if why:
            raise AssertionError(f"{label} {name}: {why}")


def with_gap(arrays, rows, cols) -> list:
    """``arrays`` with the patch ``rows`` x ``cols`` undefined on every
    level (a satellite gap, or land under the sea fields).  The re-grid
    renormalises a lone undefined point away (a target point is undefined
    only where all four corners are), so a patch is what keeps undefined
    lanes live on the aligned grid."""
    out = []
    for a in arrays:
        a = a.copy()
        a[..., rows, cols] = np.float32(1e35)
        out.append(a)
    return out


def aligned_requests() -> dict:
    """Phase 17's inputs on the headline grids: two pipeline requests (the
    benchmark's undefined column and a gap of 4 columns in tk, then fully
    defined), config 2's h-level set (2% undefined points and a gap in tk
    and rh), phase 9's icing request 1 with land (a 60x120 patch) under
    sst and wave, and the stream's steps (gapped and fully defined in
    turn)."""
    gap = (slice(None), slice(NX // 2, NX // 2 + 4))

    def pipeline(seed, undefs):
        args = make_inputs(NLEV, NY, NX, seed, undefs, "column")
        return (*with_gap(args[:1], *gap), *args[1:]) if undefs else args

    tk, q, rh, p, ps, al, bl = make_suite_inputs(*SUITE_SHAPE, 53, 0.02,
                                                 plant=False)
    icing = list(icing_requests()[0][1])
    icing[1], icing[6] = with_gap((icing[1], icing[6]), slice(200, 260),
                                  slice(300, 420))
    return {
        "pipeline": [("undef lanes live", pipeline(51, True)),
                     ("fully defined", pipeline(52, False))],
        "suite": (*with_gap((tk, q, rh), *gap), p, ps, al, bl),
        "icing": icing,
        "steps": [pipeline(55 + i, i % 2 == 0)
                  for i in range(ALIGNED_STEPS)]}


def aligned_entries(dev, smi: str, inp: dict) -> dict:
    """Phase 17 (a): the four entries and the stream with ``align=True``
    on the card, every kernel's count zeroed just before and read just
    after (B1 once a request and a step, B4, B5 and B6 once, no other);
    each entry then with ``device="cpu"``: the re-gridded input blocks
    byte for byte the card's, the products on the aligned grid within
    RTOL (sentinels equal); each streamed step byte for byte the single
    call."""
    import torch
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.ingest import aligned_target
    from mi_fieldcalc_tpu_torch.ops import fused_suite as fs
    tgt = aligned_target(NY, NX)
    tk, q, rh, _, ps, al, bl = inp["suite"]
    routes = [staging._decode_step(args, staging.HostStager(4), 1e35,
                                   True)[1] for _, args in inp["pipeline"]]
    routes.append(staging._suite_decode_step(
        tk, q, rh, ps, al, bl, config2_reqs(fs), staging.HostStager(3),
        1e35, True)[1])
    if routes != [False, True, False]:
        raise AssertionError(f"aligned requests routed all_defined "
                             f"{routes}, expected [False, True, False]")
    calls = [(label, 4, lambda d, a=args: staging.run_derived_fields_np(
        *a, align=True, device=d)) for label, args in inp["pipeline"]]
    calls += [("suite", 3, lambda d: staging.run_hlevel_suite_np(
                   tk, q, rh, ps, al, bl, align=True, device=d, **CONFIG2)),
              ("icing", 11, lambda d: staging.run_vessel_icing_np(
                   *inp["icing"], *ICING_SCAL, alt=1, align=True,
                   device=d))]
    zero_launches()
    t0 = time.perf_counter()
    card, blocks = {}, {}
    for label, k, call in calls:
        card[label] = call(dev)
        blocks[label] = stager_block(staging._stager_cache(
            k, 1e35, dev.type == "cuda"))
    streamed = list(staging.stream_derived_fields_np(
        inp["steps"], align=True, device=dev))
    torch.cuda.synchronize(dev)
    launches = read_launches()
    card_s = time.perf_counter() - t0
    want = {k: 0 for k in launches}
    want.update(derived_fields_fused=len(inp["pipeline"]) + ALIGNED_STEPS,
                hlevel_suite_fused=1, vessel_icing_mincog_fused=1,
                vessel_icing_modstall_fused=1)
    log(f"aligned ingest: {len(calls)} requests and {ALIGNED_STEPS} "
        f"streamed steps on the card in {card_s:.1f} s, launches {launches}")
    if launches != want:
        raise AssertionError(f"aligned ingest launches {launches}, "
                             f"expected {want}")
    for label, out in list(card.items()) + [
            (f"step {i}", s) for i, s in enumerate(streamed)]:
        bad = [k for k, a in out.items() if a.shape[-2:] != tgt]
        if bad:
            raise AssertionError(f"aligned {label}: {bad} not on {tgt}")
    cpu_s = {}
    for label, k, call in calls:
        t0 = time.perf_counter()
        ref = call("cpu")
        cpu_s[label] = time.perf_counter() - t0
        if stager_block(staging._stager_cache(k, 1e35, False)) \
                != blocks[label]:
            raise AssertionError(f"aligned {label}: the card's re-gridded "
                                 f"inputs differ from the CPU's")
        close_to_cpu(card[label], ref, f"aligned {label} cuda vs cpu")
        undef = sum(int((a == np.float32(1e35)).sum()) for a in ref.values())
        log(f"aligned {label}: inputs byte for byte, {len(ref)} products "
            f"on {tgt} == the CPU's ({undef} undefined points; the CPU "
            f"{cpu_s[label]:.1f} s)")
    check_physics(card["undef lanes live"], NLEV, *tgt)
    check_physics(card["fully defined"], NLEV, *tgt)
    check_suite_physics(card["suite"], SUITE_SHAPE[0], *tgt)
    check_icing_physics(card["icing"], *tgt)
    for i, (args, got) in enumerate(zip(inp["steps"], streamed)):
        identical_dicts(got, staging.run_derived_fields_np(
            *args, align=True, device=dev), f"aligned step {i}")
    log(f"[{smi}] aligned ingest: routes {routes}; the CPU references in "
        f"{sum(cpu_s.values()):.1f} s; {ALIGNED_STEPS} streamed steps byte "
        f"for byte the single call")
    return {"launches": launches, "card_s": card_s, "cpu_s": cpu_s,
            "routes": routes, "grid": list(tgt)}


def aligned_kernels(dev, smi: str, inp: dict, hbm: float, peak: float,
                    copy_gbps: float, f32_rate: float, reps=10) -> dict:
    """Phase 17 (b): B1, B4, B5 and B6 on the aligned inputs, each bit for
    bit its plain version, then timed: B1 and P1 in turns at 32x720x1024
    and at the ragged grid on the same request, B4's launch alone at both
    grids, B5 and B6 at 720x1024 (their operations counted from the plain
    versions' lane counts)."""
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.ingest import aligned_target
    from mi_fieldcalc_tpu_torch.ops import fused, fused_suite as fs
    from mi_fieldcalc_tpu_torch.ops.icing import _number
    from mi_fieldcalc_tpu_torch.tools import bench_copy
    res = {}
    for label, args in inp["pipeline"]:
        host, ad = staging._decode_step(args, staging.HostStager(4), 1e35,
                                        True)
        staged = staging._upload_step(host, dev)
        res.setdefault("b1_max_abs_err", 0.0)
        errs = compare_stacked(
            fused.derived_fields_fused(*staged, all_defined=ad),
            fused.derived_fields_plain(*staged, all_defined=ad),
            f"aligned B1 {label}")
        res["b1_max_abs_err"] = max(res["b1_max_abs_err"],
                                    *errs["max_abs"].values())
        del staged, host
    for (route, args), align in itertools.product(
            (("masked", inp["pipeline"][0][1]),
             ("all_defined", inp["pipeline"][1][1])), (False, True)):
        host, ad = staging._decode_step(args, staging.HostStager(4), 1e35,
                                        align)
        staged = staging._upload_step(host, dev)
        ny, nx = staged[0].values.shape[-2:]
        r = bench_copy.b1_against_copy(staged, ad, rounds=3, reps=reps)
        nb = bench_copy.copy_bytes(NLEV, ny, nx, ad)
        r.update(grid=[ny, nx], bytes=nb, bound_ms=nb / hbm * 1e3,
                 ops=OPS_B1_POINT * NLEV * ny * nx,
                 plain_ms=statistics.median(time_ms(
                     lambda: fused.derived_fields_plain(
                         *staged, all_defined=ad), reps)))
        res[f"b1_{'aligned' if align else 'ragged'}_{route}"] = r
        log(f"[{smi}] B1 {route} at {NLEV}x{ny}x{nx}: {r['b1_ms']:.4f} ms, "
            f"P1 {r['probe_ms']:.4f} ms ({r['probe_cap']}), B1 / P1 "
            f"{r['b1_over_probe']:.3f}; bytes bound {r['bound_ms']:.4f} ms "
            f"({nb / 1e9:.3f} GB): B1 at {r['bound_ms'] / r['b1_ms']:.1%}; "
            f"plain {r['plain_ms']:.2f} ms")
        del staged, host

    tk, q, rh, _, ps, al, bl = inp["suite"]
    reqs = config2_reqs(fs)
    for align in (False, True):
        host, ad = staging._suite_decode_step(
            tk, q, rh, ps, al, bl, reqs, staging.HostStager(3), 1e35, align)
        staged = staging._suite_upload_step(host, reqs, dev)
        nlev, ny, nx = staged[0].values.shape
        if align:
            compare_suite_exact(fs.hlevel_suite_stacked(*staged, reqs, ad),
                                fs.hlevel_suite_plain(*staged, reqs, ad),
                                "aligned B4")
        for _ in range(20):
            fs._launch(True, *staged, reqs, ad)
        nb = suite_bytes(3, len(reqs), len(reqs), nlev, ny, nx, True, ad)
        r = {"grid": [ny, nx], "bytes": nb, "bound_ms": nb / hbm * 1e3,
             "ops": OPS_SUITE_OUTPUT * len(reqs) * nlev * ny * nx,
             "ms": statistics.median(time_device_ms(
                 lambda: fs._launch(True, *staged, reqs, ad), reps)),
             "plain_ms": statistics.median(time_ms(
                 lambda: fs.hlevel_suite_plain(*staged, reqs, ad), reps))}
        res["b4_aligned" if align else "b4_ragged"] = r
        log(f"[{smi}] B4 (config 2, all_defined={ad}) at {nlev}x{ny}x{nx}: "
            f"the launch "
            f"alone {r['ms']:.4f} ms; bytes bound {r['bound_ms']:.4f} ms "
            f"({nb / 1e9:.3f} GB): at {r['bound_ms'] / r['ms']:.1%}; plain "
            f"{r['plain_ms']:.2f} ms")
        del staged, host

    number = _number(*ICING_SCAL[2:])
    for align in (False, True):
        stager = staging.HostStager(11, pin=True)
        if align:
            stager.decode_resample(*inp["icing"],
                                   shape_to=aligned_target(*ICING_SHAPE))
        else:
            stager.decode(*inp["icing"])
        fields = staging._icing_upload_step(stager, dev)
        npts = fields[0].values.numel()
        for name, (launch, plain, nplanes, nflags) in icing_runs(
                fields, 1).items():
            trips = {}
            bad = ~same_bits(launch(), plain(trips))
            if bool(bad.any()):
                raise AssertionError(f"{name} (align={align}): "
                                     f"{int(bad.sum())} points differ from "
                                     f"the plain version")
            for _ in range(20):
                launch()
            b = icing_bound(trips, number, npts, nplanes, nflags, copy_gbps,
                            f32_rate, 1 if name == "mincog" else None)
            r = {"grid": list(fields[0].values.shape), "bytes": b["bytes"],
                 "ops": b["ops"], "trips": trips,
                 "bound_ms": max(b["bytes"] / hbm, b["ops"] / peak) * 1e3,
                 "ms": statistics.median(time_ms(launch, reps)),
                 "plain_ms": statistics.median(time_ms(plain, 1,
                                                       warmup=False))}
            res[name if align else f"{name}_ragged"] = r
            log(f"[{smi}] {name} at {r['grid'][0]}x{r['grid'][1]}, {number} "
                f"heights: kernel {r['ms']:.4f} ms == plain "
                f"({r['plain_ms']:.1f} ms); bound {r['bound_ms']:.4f} ms "
                f"({b['ops']:.3e} operations, {b['bytes'] / 1e6:.1f} MB): at "
                f"{r['bound_ms'] / r['ms']:.1%}")
        del fields, stager
    return res


def aligned_splits(dev, smi: str, inp: dict, reps=3) -> dict:
    """Phase 17 (c): one masked pipeline request split (decode, H2D,
    kernel, D2H, encode; median of ``reps`` after the first), ragged and
    aligned on the same inputs; the codec's plain decode of the four
    stacks against its resampling decode into the same block, and the map
    ratios' and fcoriolis's re-grid in numpy (medians of 5)."""
    from mi_fieldcalc_tpu_torch import native, staging
    from mi_fieldcalc_tpu_torch.ingest import (aligned_target,
                                               resample_align, resample_maps)
    args = inp["pipeline"][0][1]
    res = {}
    for align in (False, True):
        stager = staging.HostStager(4, pin=True)
        first, med = request_split(
            reps, dev,
            lambda: staging._decode_step(args, stager, 1e35, align),
            lambda host: staging._upload_step(host, dev),
            staging._compute,
            lambda out: staging._fetch(out, stager),
            lambda fetched: staging._encode_step(fetched, 1e35))
        key = "aligned" if align else "ragged"
        res[key] = {"first": first, **med}
        log(f"[{smi}] request ({key}, masked) median of {reps}, ms: "
            + " ".join(f"{k}={v:.2f}" for k, v in med.items()))
    stacks = [np.ascontiguousarray(a) for a in args[:4]]
    xm, ym, fc = args[7:]
    tgt = aligned_target(NY, NX)
    codec = {}
    for key, shape, fn in (
            ("decode_pad_batch", (NY, NX), lambda o, m: native.
             decode_pad_batch(stacks, NY, NX, out=o, mask=m)),
            ("decode_resample_batch", tgt, lambda o, m: native.
             decode_resample_batch(stacks, *tgt, out=o, mask=m)),
            ("maps_and_fcoriolis", tgt, lambda o, m: (
                resample_maps(xm, ym, NY, NX, tgt),
                resample_align(fc, shape_to=tgt, mask_aware=False)))):
        o = np.empty((4, NLEV) + shape, np.float32)
        m = np.empty(o.shape, np.uint8)
        fn(o, m)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(o, m)
            ts.append((time.perf_counter() - t0) * 1e3)
        codec[key] = statistics.median(ts)
    stager = staging.HostStager(4, pin=True)
    tk, q, u, v, ps, al, bl = args[:7]
    for key, fn in (
            ("stager_decode", lambda: stager.decode(
                tk, q, u, v, ps=ps, rest=(al, bl, xm, ym, fc))),
            ("stager_decode_resample", lambda: stager.decode_resample(
                tk, q, u, v, shape_to=tgt, ps=ps,
                rest=(al, bl, xm, ym, fc)))):
        fn()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        codec[key] = statistics.median(ts)
    res["codec_ms"] = codec
    log(f"[{smi}] the stager's decode of the request: plain "
        f"{codec['stager_decode']:.2f} ms, resampling "
        f"{codec['stager_decode_resample']:.2f} ms (its maps and fcoriolis "
        f"as given)")
    log(f"[{smi}] the codec on the four stacks: plain decode "
        f"{codec['decode_pad_batch']:.2f} ms, resampling decode onto {tgt} "
        f"{codec['decode_resample_batch']:.2f} ms; the map ratios and "
        f"fcoriolis re-gridded in numpy {codec['maps_and_fcoriolis']:.2f} "
        f"ms (medians of 5)")
    return res


def phase_aligned(dev, smi: str, hbm: float, peak: float, copy_gbps: float,
                  f32_rate: float) -> dict:
    """Phase 17: the aligned ingest (``align=True``) through the four
    entries and the stream, its kernels and its request split."""
    t0 = time.perf_counter()
    inp = aligned_requests()
    res, walls = {}, {"inputs": time.perf_counter() - t0}
    for key, fn in (
            ("entries", lambda: aligned_entries(dev, smi, inp)),
            ("kernels", lambda: aligned_kernels(dev, smi, inp, hbm, peak,
                                                copy_gbps, f32_rate)),
            ("splits", lambda: aligned_splits(dev, smi, inp))):
        t = time.perf_counter()
        res[key] = fn()
        walls[key] = time.perf_counter() - t
    res["wall_s"] = time.perf_counter() - t0
    res["walls_s"] = walls
    log(f"phase 17 took {res['wall_s']:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()))
    return res


#: --icing-times / --suite-times: the cases timed in each checkout, and
#: the part of the kernels' names whose ptxas lines and SASS are logged
TIME_CASES = {"icing": (icing_time_cases, "vessel_icing"),
              "suite": (suite_time_cases, "suite_kernel"),
              "pipeline": (pipeline_time_cases, "derived_fields_kernel"),
              "interp": (interp_time_cases, "interp_kernel")}

#: run in a checkout by :func:`time_checkouts` (argv[1]: this script,
#: whose inputs, cases and timers it uses; argv[2]: the family; the
#: package is the checkout's)
_TIMES = r"""
import importlib.util, json, sys
import torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke_runner",
                                              sys.argv[1])
c = importlib.util.module_from_spec(spec)
spec.loader.exec_module(c)
from mi_fieldcalc_tpu_torch import _build
out = c.TIME_CASES[sys.argv[2]][0](torch.device("cuda", 0))
print("times " + json.dumps({"library": str(_build.build()), **out}))
"""


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output -> {function: [instruction, ...]}, the
    predicate guards dropped."""
    import re
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+([^;]*);", line)
        if m and cur is not None:
            ins = m.group(1).strip()
            if ins.startswith("@"):
                ins = ins.split(None, 1)[1]
            cur.append(ins)
    return funcs


def sass_summary(instrs: list, per_thread: int = 1) -> dict:
    """Counts of one kernel's SASS: all instructions but NOPs, its main
    body (up to the last EXIT before the first subroutine's RET; the IEEE
    division's slow path and other called routines follow it), per point
    (the main body over the points a thread takes), and some opcodes."""
    ops = [i.split()[0] for i in instrs if not i.startswith("NOP")]
    rets = [k for k, o in enumerate(ops) if o.startswith("RET")]
    head = ops[:rets[0]] if rets else ops
    exits = [k for k, o in enumerate(head) if o.startswith("EXIT")]
    main = head[:exits[-1] + 1] if exits else head
    by = {}
    for o in main:
        base = o.split(".")[0]
        by[base] = by.get(base, 0) + 1
    keys = ("LDC", "LDS", "LDG", "STG", "ST", "MUFU", "CALL", "FSETP", "ISETP",
            "BRA", "IMAD", "FMUL", "FADD", "SEL", "FSEL")
    return {"total": len(ops), "main": len(main),
            "per_point": len(main) / per_thread,
            "opcodes": {k: by.get(k, 0) for k in keys}}


def cuobjdump_sass(path) -> dict:
    """:func:`sass_functions` of the cubin or library at ``path``, dumped
    by the cuobjdump beside nvcc."""
    from mi_fieldcalc_tpu_torch._build import find_nvcc
    nvcc = find_nvcc()
    tool = Path(nvcc).parent / "cuobjdump" if nvcc else None
    if tool is None or not tool.is_file():
        raise OSError("cuobjdump not found beside nvcc")
    return sass_functions(subprocess.run(
        [str(tool), "-sass", str(path)], capture_output=True, text=True,
        check=True, timeout=300).stdout)


def ptxas_lines(lib: str, pattern: str) -> list:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) that the
    build kept beside ``lib`` for the kernels whose names hold
    ``pattern``."""
    report = Path(lib + ".log")
    out, ours = [], False
    for line in (report.read_text().splitlines() if report.is_file()
                 else ()):
        if "entry function" in line or "Function properties" in line:
            ours = pattern in line
        if ours:
            out.append(line.strip())
    return out


def time_checkouts(family: str, dirs) -> int:
    """``TIME_CASES[family]`` alone in each checkout of ``dirs`` in turn,
    one process (and one build) each, with the SM clock before and after,
    then the ptxas lines and SASS counts of the family's kernels as built;
    fails if a kernel differs from its plain version."""
    import torch
    if not dirs or not torch.cuda.is_available():
        print(f"chip_smoke --{family}-times: needs checkouts and a CUDA "
              f"device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    pattern = TIME_CASES[family][1]
    log(smi_line())
    for d in dirs:
        clock = sm_clock()
        proc = subprocess.run(
            [sys.executable, "-c", _TIMES, str(Path(__file__).resolve()),
             family], cwd=d, capture_output=True, text=True, timeout=900)
        lines = [x for x in proc.stdout.splitlines()
                 if x.startswith("times ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:] + proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(lines[-1].split(" ", 1)[1])
        lib = res.pop("library")
        log(f"{d}: SM clock {clock:.0f} / {sm_clock():.0f} MHz before / after; "
            + "; ".join(f"{k} {v['ms']:.4f} ms" for k, v in res.items()))
        log(f"{d}: {family}-times " + json.dumps(res))
        if not all(v["equal"] for v in res.values()):
            print(f"{d}: a kernel differs from its plain version",
                  file=sys.stderr)
            return 1
        for line in ptxas_lines(lib, pattern):
            log(f"{d}:   ptxas: {line}")
        try:
            sass = {name: sass_summary(instrs) for name, instrs in
                    cuobjdump_sass(lib).items() if pattern in name}
        except (OSError, subprocess.SubprocessError) as e:
            sass = {"error": repr(e)}
        log(f"{d}: sass " + json.dumps(sass))
    return 0


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch does not import: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import mi_fieldcalc_tpu_torch  # noqa: F401  (fails outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t_start = time.perf_counter()
    log("== phase 1: environment")
    smi, env = phase_env()
    log("== phase 2: build")
    build = phase_build()
    log("== phase 3: kernel vs plain version on the card")
    worst = phase_kernel(dev)
    log("== phase 4: main path, 3 requests through run_derived_fields_np")
    main_path = phase_main_path(dev)
    log("== phase 5: times on this card")
    times = phase_times(dev, smi, request_reps=3)
    log("== phase 6: interpolation and suite kernels vs plain versions")
    new_worst = phase_new_kernels(dev)
    log("== phase 7: the isobaric path at 137x719x929 -> 11 surfaces")
    iso = phase_isobaric(dev, smi, times["copy_gbps"])
    log("== phase 8: the suite entry and the a-level suite at full size")
    suites = phase_suites(dev, smi, times["copy_gbps"])
    log("== phase 9: vessel icing")
    icing_kernels = phase_icing_kernels(dev)
    icing_path = phase_icing_path(dev)
    icing_golden = phase_icing_golden(dev)
    icing_times = phase_icing_times(dev, smi, times["copy_gbps"],
                                    env["f32_rate"])
    log("== phase 10: measurement probes")
    probe_err = phase_probe_kernels(dev)
    probes = phase_probe_times(dev, smi, env["f32_rate"])
    request_trace = phase_request_trace(dev, smi)
    log("== phase 11: the operator surface")
    goldens = phase_goldens(dev)
    number_args = phase_number_args(dev)
    configs = phase_configs(dev, smi)
    ens = phase_ensemble(dev, smi)
    log("== phase 12: the streaming executor and the page-locked copies")
    stream = phase_stream(dev, smi)
    log("== phase 13: the drop-in api on the card")
    api_res = phase_api(dev, smi, times["copy_gbps"], env["f32_rate"])
    log("== phase 14: call-storm batching on the card")
    batch_res = phase_batch(dev, smi)
    log("== phase 15: B1 per shard, and the sharded path under NCCL")
    sharded = phase_sharded(dev, smi, probes["hbm_bytes_per_s"])
    log("== phase 16: B2 at 40 fields under every variant name, and the "
        "tour")
    surface_end = phase_surface_end(dev, smi, probes["hbm_bytes_per_s"],
                                    probes["f32_flops"],
                                    iso["times"]["interp_launch_ms"])
    log("== phase 17: the aligned ingest (align=True) through the four "
        "entries and the stream")
    aligned = phase_aligned(dev, smi, probes["hbm_bytes_per_s"],
                            probes["f32_flops"], times["copy_gbps"],
                            env["f32_rate"])
    wall = time.perf_counter() - t_start
    log(f"all phases passed in {wall:.1f} s")

    log("record: " + json.dumps({
        "env": env, "build": build, "kernel_max_rel_err": worst,
        "main_path": main_path, "times": times,
        "new_kernels_max_abs_err": new_worst, "isobaric": iso,
        "suites": suites, "icing": {
            "kernels": icing_kernels, "path": icing_path,
            "golden": icing_golden, "times": icing_times},
        "probes": {"max_abs_err": probe_err, **probes},
        "request_trace": request_trace,
        "surface": {"goldens": goldens, "number_args": number_args,
                    "configs": configs, "ensemble": ens}, "stream": stream,
        "api": api_res, "batch": batch_res, "sharded": sharded,
        "surface_end": surface_end, "aligned": aligned, "wall_s": wall}))
    src, ref = "mi_fieldcalc_tpu_torch/csrc/", "mi_fieldcalc_tpu/ops/"
    copy = times["copy_gbps"]
    hbm, peak = probes["hbm_bytes_per_s"], probes["f32_flops"]

    def bound(nbytes, ops, library_ms=None):
        """``bound_ms`` at the card's published rates; ``copy_bound_ms``
        at this run's device-copy rate and the un-fused issue rate, the
        bound of the records before phase 10."""
        b_ms, o_ms = nbytes / copy / 1e6, ops / env["f32_rate"] * 1e3
        pb_ms, po_ms = nbytes / hbm * 1e3, ops / peak * 1e3
        log(f"bound of {nbytes / 1e9:.3f} GB and {ops:.3e} operations: "
            f"published bytes {pb_ms:.4f} ms, operations {po_ms:.4f} ms; "
            f"at the copy rate {b_ms:.4f} ms, at the un-fused issue rate "
            f"{o_ms:.4f} ms")
        return {"bound_ms": max(pb_ms, po_ms),
                "bound_by": "bytes" if pb_ms >= po_ms else "operations",
                "copy_bound_ms": max(b_ms, o_ms),
                "copy_bound_by": "bytes" if b_ms >= o_ms else "operations",
                "library_ms": library_ms}

    pts1 = NLEV * NY * NX
    many, tour = surface_end["interp_many"], surface_end["tour"]
    shard_recs = {ov: shard_record(sharded["kernels"], ov)
                  for ov in (False, True)}
    nlev4, ny4, nx4 = ISO_SHAPE
    from mi_fieldcalc_tpu_torch.models import STANDARD_PLEVELS
    nt4 = len(STANDARD_PLEVELS)
    an, ay, ax = A_SUITE_SHAPE
    nout = len(CONFIG2["temps"] + CONFIG2["hums_q"] + CONFIG2["hums_rh"])
    bounds = {
        "derived_fields": bound(layout_bytes(NLEV, NY, NX, False),
                                OPS_B1_POINT * pts1),
        "vertical_interp": bound(
            iso["interp_bytes"]["bracket"],
            ny4 * nx4 * nt4 * (nlev4.bit_length() * OPS_B2_STEP
                               + OPS_B2_TARGET)),
        "alevel_suite": bound(suites["bytes"]["alevel"],
                              OPS_SUITE_OUTPUT * nout * an * ay * ax),
        "hlevel_suite": bound(suites["bytes"]["hlevel"],
                              OPS_SUITE_OUTPUT * nout * pts1)}
    kernels = [{
        "name": "derived_fields",
        "route": "cuda",
        "source": src + "derived_fields.cu",
        "replaces": ref + "fused.py:301",
        "launches": main_path["launches"],
        "max_abs_err": main_path["max_abs_err"],
        "ms": times["masked"]["kernel_ms"],
        "launch_ms": times["masked"]["launch_ms"],
        "plain_ms": times["masked"]["plain_ms"],
        **bounds["derived_fields"],
    }, {
        "name": "derived_fields",
        "path": "ensemble_derived_summary",
        "route": "cuda",
        "source": src + "derived_fields.cu",
        "replaces": ref + "fused.py:301",
        "launches": ens["launches"],
        "max_abs_err": ens["max_abs_err"],
        "ms": ens["b1_per_member_ms"],
        "plain_ms": ens["plain_member_ms"],
        **bound(layout_bytes(*ENSEMBLE_SHAPE[1:], False),
                OPS_B1_POINT * int(np.prod(ENSEMBLE_SHAPE[1:]))),
    }, {
        "name": "derived_fields",
        "path": "stream_derived_fields_np",
        "route": "cuda",
        "source": src + "derived_fields.cu",
        "replaces": ref + "fused.py:301",
        "launches": stream["launches"]["derived_fields_fused"],
        "max_abs_err": stream["b1"]["max_abs_err"],
        "ms": stream["b1"]["kernel_ms"],
        "plain_ms": stream["b1"]["plain_ms"],
        **bound(layout_bytes(NLEV, NY, NX, False), OPS_B1_POINT * pts1),
    }] + [{
        "name": "derived_fields",
        "path": "derived_fields_fused_sharded" + (
            " (overlap)" if overlap else ""),
        "route": "cuda",
        "source": src + "derived_fields.cu",
        "replaces": ref + "fused.py:301",
        "launches": sharded["path"]["launches"][
            "fused_overlap" if overlap else "fused"]["derived_fields"],
        "max_abs_err": 0.0,
        **shard_recs[overlap],
        **bound(shard_recs[overlap]["shard_bytes"],
                OPS_B1_POINT * shard_recs[overlap]["shard_points"]),
    } for overlap in (False, True)] + [{
        "name": "vertical_interp",
        "route": "cuda",
        "source": src + "vertical_interp.cu",
        "replaces": ref + "vertical_fused.py:54",
        "launches": iso["launches"]["interp"],
        "max_abs_err": max(iso["max_abs_err"], new_worst["interp"]),
        "ms": iso["times"]["interp_ms"],
        "launch_ms": iso["times"]["interp_launch_ms"],
        "smooth_ps_launch_ms": iso["times"]["interp_smooth_launch_ms"],
        "plain_ms": iso["times"]["interp_plain_ms"],
        **bounds["vertical_interp"],
    }, {
        "name": "vertical_interp",
        "path": f"hlevel_to_plevel_fused ({MANY_FIELDS} fields)",
        "route": "cuda",
        "source": src + "vertical_interp.cu",
        "replaces": ref + "vertical_fused.py:54",
        "launches": many["launches"]["inplace_masked"],
        "max_abs_err": 0.0,
        "ms": many["launch_masked_ms"],
        "all_defined_ms": many["launch_all_defined_ms"],
        "wrapper_ms": many["wrapper_ms"],
        "ten_4field_launch_ms": many["ten_4field_launch_ms"],
        "plain_ms": many["plain_masked_ms"],
        **bound(many["bytes"], many["ops"]),
    }, {
        "name": "alevel_suite",
        "route": "cuda",
        "source": src + "level_suite.cu",
        "replaces": ref + "fused_suite.py:230",
        "launches": suites["alevel_launches"],
        "max_abs_err": max(suites["alevel_max_abs_err"],
                           new_worst["alevel_suite"]),
        "ms": suites["times"]["alevel_ms"],
        "launch_ms": suites["times"]["alevel_launch_ms"],
        "plain_ms": suites["times"]["alevel_plain_ms"],
        **bounds["alevel_suite"],
    }, {
        "name": "hlevel_suite",
        "route": "cuda",
        "source": src + "level_suite.cu",
        "replaces": ref + "fused_suite.py:377",
        "launches": suites["hlevel_launches"],
        "max_abs_err": max(suites["hlevel_max_abs_err"],
                           new_worst["hlevel_suite"]),
        "ms": suites["times"]["hlevel_ms"],
        "launch_ms": suites["times"]["hlevel_launch_ms"],
        "plain_ms": suites["times"]["hlevel_plain_ms"],
        **bounds["hlevel_suite"],
    }] + [{
        "name": f"vessel_icing_{name}",
        "route": "cuda",
        "source": src + "vessel_icing.cu",
        "replaces": ref + ("icing_fused.py:69" if name == "mincog"
                           else "icing_fused.py:186"),
        "launches": icing_path["launches"][name],
        "max_abs_err": icing_kernels["max_abs_err"][name],
        "ms": icing_times[name]["kernel_ms"],
        "plain_ms": icing_times[name]["plain_ms"],
        **bound(icing_times[name]["bytes"], icing_times[name]["ops"]),
    } for name in ("mincog", "modstall")] + [{
        "name": name,
        "path": "forecast_products_torch",
        "route": "cuda",
        "source": src + source,
        "replaces": ref + replaces,
        "launches": tour["launches"][wrapper],
        "max_abs_err": 0.0,
        "ms": tour["kernels"][key]["ms"],
        "plain_ms": tour["kernels"][key]["plain_ms"],
        **bound(tour["kernels"][key]["bytes"], tour["kernels"][key]["ops"]),
    } for name, key, wrapper, source, replaces in (
        ("derived_fields", "b1", "derived_fields_fused", "derived_fields.cu",
         "fused.py:301"),
        ("hlevel_suite", "b4", "hlevel_suite_fused", "level_suite.cu",
         "fused_suite.py:377"))] + [{
        "name": f"vessel_icing_{key}",
        "path": f"api.{name}",
        "route": "cuda",
        "source": src + "vessel_icing.cu",
        "replaces": ref + ("icing_fused.py:69" if key == "mincog"
                           else "icing_fused.py:186"),
        "launches": api_res["launches"][wrapper],
        "max_abs_err": api_res[key]["max_abs_err"],
        "ms": api_res[key]["kernel_ms"],
        "plain_ms": api_res[key]["plain_ms"],
        "api_call_ms": api_res[key]["api_ms"],
        **bound(api_res[key]["bytes"], api_res[key]["ops"]),
    } for name, (wrapper, _, key) in API_KERNELS.items()] + [{
        "name": f"vessel_icing_{key}",
        "path": "api.batch (CUDA graph replay)",
        "route": "cuda",
        "source": src + "vessel_icing.cu",
        "replaces": ref + ("icing_fused.py:69" if key == "mincog"
                           else "icing_fused.py:186"),
        "launches": batch_res["icing"]["launches"][wrapper],
        "max_abs_err": batch_res["icing"]["max_abs_err"],
        "ms": statistics.median(batch_res["icing"][f"{key}_trace_ms"]),
        "plain_ms": api_res[key]["plain_ms"],
        **bound(api_res[key]["bytes"], api_res[key]["ops"]),
    } for wrapper, _, key in API_KERNELS.values()]
    ak, al = aligned["kernels"], aligned["entries"]["launches"]
    kernels += [{
        "name": name,
        "path": path + " (align=True)",
        "route": "cuda",
        "source": src + source,
        "replaces": ref + replaces,
        "launches": al[wrapper],
        "max_abs_err": 0.0,
        "ms": ak[key]["b1_ms" if key.startswith("b1") else "ms"],
        "grid": ak[key]["grid"],
        "plain_ms": ak[key]["plain_ms"],
        **bound(ak[key]["bytes"], ak[key]["ops"]),
    } for name, path, key, wrapper, source, replaces in (
        ("derived_fields", "run_derived_fields_np, stream_derived_fields_np",
         "b1_aligned_masked", "derived_fields_fused", "derived_fields.cu",
         "fused.py:301"),
        ("hlevel_suite", "run_hlevel_suite_np", "b4_aligned",
         "hlevel_suite_fused", "level_suite.cu", "fused_suite.py:377"),
        ("vessel_icing_mincog", "run_vessel_icing_np", "mincog",
         "vessel_icing_mincog_fused", "vessel_icing.cu", "icing_fused.py:69"),
        ("vessel_icing_modstall", "run_vessel_icing_np", "modstall",
         "vessel_icing_modstall_fused", "vessel_icing.cu",
         "icing_fused.py:186"))]
    grid = probes["solver"]["grid"]
    p1 = probes["copy_masked"]
    kernels += [{
        "name": "probe_copy", "route": "cuda", "source": src + "probes.cu",
        "replaces": "bench.py:212",
        "launches": probes["launches"]["copy"],
        "max_abs_err": probe_err["copy"],
        "ms": p1["probe_ms"], "plain_ms": p1["plain_ms"],
        **bound(p1["bytes"], OPS_COPY_POINT * NLEV * NY * NX),
    }, {
        "name": "probe_add1", "route": "cuda", "source": src + "probes.cu",
        "replaces": "tools/perf_lab_dma.py:43",
        "launches": probes["launches"]["add1"],
        "max_abs_err": probe_err["add1"],
        "ms": probes["add1"]["ms"], "plain_ms": probes["add1"]["plain_ms"],
        **bound(probes["add1"]["bytes"], NLEV * NY * NX,
                probes["add1"]["library_ms"]),
    }, {
        "name": "probe_window", "route": "cuda", "source": src + "probes.cu",
        "replaces": "tools/perf_lab_element.py:28",
        "launches": probes["launches"]["window"],
        "max_abs_err": probe_err["window"],
        "ms": probes["window"]["ms"],
        "plain_ms": probes["window"]["plain_ms"],
        **bound(probes["window"]["bytes"], NLEV * NY * NX),
    }, {
        "name": "probe_solver", "route": "cuda", "source": src + "probes.cu",
        "replaces": "tools/probe_mincog_kernel.py:20",
        "launches": probes["launches"]["solver"],
        "max_abs_err": probe_err["solver"],
        "ms": grid["ms"], "plain_ms": grid["plain_ms"],
        **bound(grid["bytes"], grid["ops"]),
        "chain_floor_ms": grid["chain_ms"],
        "bound_with_chain_ms": grid["bound_ms"],
        "bound_with_chain_by": grid["bound_by"],
    }]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def checkout_package(d, alias: str):
    """The ``mi_fieldcalc_tpu_torch`` package of checkout ``d``, imported
    as ``alias``, so that two checkouts' packages (and their CUDA
    libraries) live side by side in one process."""
    import importlib
    import importlib.util
    init = Path(d).resolve() / "mi_fieldcalc_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def quartiles(xs) -> list:
    """The 25th, 50th and 75th percentiles of ``xs``."""
    return [float(q) for q in np.percentile(np.asarray(xs), (25, 50, 75))]


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def ab_rounds(dirs, libs, cases: dict, run, rounds: int, reps: int,
              warm_s: float, sass_names=None) -> dict:
    """Time ``cases`` in the checkouts ``dirs`` within this one process.
    ``run(k, label)`` launches case ``label`` of checkout ``k`` (each
    already held to its plain version).  The card is warmed by ``warm_s``
    seconds of every case of every checkout (the SM clock read before and
    after), then ``rounds`` rounds, the checkouts in order and in reverse
    in turn, each timing every case ``reps`` times a checkout (the launch
    alone, :func:`time_device_ms`).  Logs and returns the quartiles of each
    checkout's samples and of its round medians, the rounds in which each
    later checkout was faster than the first, and the SASS instruction
    counts of each library's kernels whose names hold one of
    ``sass_names`` (every kernel when None), with its 128-bit global
    loads and stores."""
    import torch

    def wide(instrs, op):
        return sum(i.split()[0].split(".")[0] == op
                   and ".128" in i.split()[0] for i in instrs)

    n = len(dirs)
    clock = [sm_clock()]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        for label in cases:
            for k in range(n):
                run(k, label)
        torch.cuda.synchronize()
    clock.append(sm_clock())
    samples = {label: [[] for _ in dirs] for label in cases}
    round_medians = {label: [[] for _ in dirs] for label in cases}
    for r in range(rounds):
        for k in (range(n) if r % 2 == 0 else reversed(range(n))):
            for label in cases:
                ms = time_device_ms(lambda: run(k, label), reps)
                samples[label][k] += ms
                round_medians[label][k].append(statistics.median(ms))
    clock.append(sm_clock())
    res = {"dirs": list(dirs), "rounds": rounds, "reps": reps,
           "sm_clock_mhz": clock, "cases": {}}
    for label in cases:
        q = [quartiles(x) for x in samples[label]]
        rq = [quartiles(x) for x in round_medians[label]]
        faster = [sum(y < x for x, y in zip(round_medians[label][0],
                                            round_medians[label][k]))
                  for k in range(n)]
        res["cases"][label] = {"quartiles_ms": q, "round_quartiles_ms": rq,
                               "round_medians_ms": round_medians[label],
                               "rounds_faster_than_first": faster}
        log(f"{label}: " + "; ".join(
            f"{chr(65 + k)} {dirs[k]} median {q[k][1]:.4f} ms "
            f"(quartiles {q[k][0]:.4f}-{q[k][2]:.4f}; round medians "
            f"{rq[k][0]:.4f}-{rq[k][2]:.4f})"
            + ("" if k == 0 else f", faster than {dirs[0]} in {faster[k]} "
               f"of {rounds} rounds") for k in range(n)))
    log(f"SM clock {clock} MHz: before the warm-up, after it, after the "
        f"rounds")
    for d, lib in zip(dirs, libs):
        try:
            sass = {name: {"total": sass_summary(instrs)["total"],
                           "ldg128": wide(instrs, "LDG"),
                           "stg128": wide(instrs, "STG")}
                    for name, instrs in cuobjdump_sass(lib).items()
                    if sass_names is None
                    or any(x in name for x in sass_names)}
        except (OSError, subprocess.SubprocessError) as e:
            sass = {"error": repr(e)}
        res.setdefault("sass", {})[d] = sass
        log(f"{d}: sass instructions " + json.dumps(sass))
    return res


def interp_ab(dirs, rounds=10, reps=30, warm_s=3.0) -> int:
    """``--interp-ab DIR_A DIR_B``: B2 at config 4 (the four cases of
    :func:`interp_time_cases`) from the packages of two checkouts, loaded
    side by side in this one process, each checkout's launch held to its
    plain version bit for bit, then timed in turns by :func:`ab_rounds`
    with the SASS counts of each library's interp kernels."""
    import importlib
    import torch
    if len(dirs) != 2 or not torch.cuda.is_available():
        print("chip_smoke --interp-ab: needs two checkouts and a CUDA "
              "device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mi_fieldcalc_tpu_torch.field import Field, from_sentinel
    from mi_fieldcalc_tpu_torch.models import STANDARD_PLEVELS as tg
    from mi_fieldcalc_tpu_torch.ops import vertical_fused as vf
    dev = torch.device("cuda", 0)
    log(smi_line())
    pkgs = [checkout_package(d, f"ab_checkout_{k}")
            for k, d in enumerate(dirs)]
    vfs = [importlib.import_module(f"{p.__name__}.ops.vertical_fused")
           for p in pkgs]
    libs = [str(importlib.import_module(f"{p.__name__}._build").build())
            for p in pkgs]
    nlev, ny, nx = ISO_SHAPE
    raw = make_column_inputs(nlev, ny, nx, seed=3, undef_frac=0.005)
    fields = tuple(from_sentinel(x, device=dev) for x in raw[:4])
    ps_r = from_sentinel(raw[4], device=dev)
    ps_s = Field(torch.as_tensor(smooth_ps(ny, nx, 3), device=dev), ps_r.mask)
    a, b = (torch.as_tensor(x, device=dev) for x in raw[5:7])
    del raw
    cases = {f"config4 {kind} ps {'all_defined' if ad else 'masked'}":
             (ps, ad) for kind, ps in (("random", ps_r), ("smooth", ps_s))
             for ad in (False, True)}

    def run(k, label):
        ps, ad = cases[label]
        return vfs[k]._launch(fields, ps, a, b, tg, True, ad)

    for label, (ps, ad) in cases.items():
        ref = vf.hlevel_to_plevel_plain(fields, ps, a, b, tg, True, ad)
        for k in range(2):
            compare_fields_exact(run(k, label), ref, f"{dirs[k]} {label}")
        del ref
    res = ab_rounds(dirs, libs, cases, run, rounds, reps, warm_s,
                    ("interp_kernel",))
    log("interp-ab " + json.dumps(res))
    return 0


#: --probes-ab: P2's (ty, nbuf, threads) cases, ``ny`` standing for the
#: flat variant
PROBE_AB_ADD1 = ((48, 1, 256), (4, 1, 256), (48, 12, 256), ("ny", 1, 256))


def probes_ab(dirs, rounds=10, reps=30, warm_s=3.0) -> int:
    """``--probes-ab DIR_A DIR_B [DIR ...]``: P1, P2 and P4 from the
    packages of two or more checkouts, loaded side by side in this one
    process: P1 masked and all-defined at 32x719x929 (phase 5's inputs) at
    every cap of ``bench_copy.CAPS``, P2 at :data:`PROBE_AB_ADD1` and
    ``torch.add(x, 1)`` on the same x in the same rounds, P4 at 719x929,
    at the tool's 64x256 and on one capped lane alone.  Each checkout's
    launches are held to the plain versions bit for bit first; then
    :func:`ab_rounds` times them in turns and logs every library's SASS
    counts (B1-B6 and the probes).  Logs each checkout's best cap a route,
    P2 over ``torch.add``, and each P4 case's time in every round over the
    first checkout's in that round.  B1 / P1 is phase 10's, which times
    the two in turns."""
    import importlib
    import torch
    if len(dirs) < 2 or not torch.cuda.is_available():
        print("chip_smoke --probes-ab: needs two or more checkouts and a "
              "CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mi_fieldcalc_tpu_torch import staging
    from mi_fieldcalc_tpu_torch.tools import (
        bench_copy, perf_lab_dma, probe_mincog_kernel)
    dev = torch.device("cuda", 0)
    log(smi_line())
    pkgs = [checkout_package(d, f"ab_checkout_{k}")
            for k, d in enumerate(dirs)]
    copies = [importlib.import_module(f"{p.__name__}.tools.bench_copy")
              for p in pkgs]
    dmas = [importlib.import_module(f"{p.__name__}.tools.perf_lab_dma")
            for p in pkgs]
    solvers = [importlib.import_module(
        f"{p.__name__}.tools.probe_mincog_kernel") for p in pkgs]
    libs = [str(importlib.import_module(f"{p.__name__}._build").build())
            for p in pkgs]
    staged = {}
    for ad, undefs in ((False, True), (True, False)):
        host, got = staging._decode_step(make_inputs(NLEV, NY, NX, 4, undefs,
                                                     "column"),
                                         staging.HostStager(4), 1e35)
        assert got == ad
        staged[ad] = staging._upload_step(host, dev)
    x = torch.randn((NLEV, NY, NX), generator=torch.Generator(device=dev)
                    .manual_seed(0), device=dev)
    cases = {}
    for ad in (False, True):
        for cap in bench_copy.CAPS:
            cases[f"P1 {'all_defined' if ad else 'masked'} cap {cap}"] = (
                "copy", ad, cap)
    for ty, nbuf, threads in PROBE_AB_ADD1:
        ty = NY if ty == "ny" else ty
        cases[f"P2 ty={ty} nbuf={nbuf} threads={threads}"] = (
            "add1", nbuf, ty, threads)
    cases["torch.add(x, 1)"] = ("library",)
    m = probe_mincog_kernel
    grid = m.solver_inputs(m.GRID_SHAPE, 0, dev)
    first = int(torch.nonzero(~m.solver_trips(*grid[:2])[1].flatten())[0])
    solver_in = {
        "P4 719x929": grid, "P4 64x256": m.solver_inputs(m.TOOL_SHAPE, 0, dev),
        "P4 one capped lane": (grid[0].flatten()[first:first + 1],
                               grid[1].flatten()[first:first + 1], grid[2])}
    for label in solver_in:
        cases[label] = ("solver",)

    def run(k, label):
        case = cases[label]
        if case[0] == "copy":
            args = staged[case[1]]
            return copies[k].copy_probe(*args[:5], *args[7:9], case[1],
                                        case[2])
        if case[0] == "add1":
            return dmas[k].add1(x, *case[1:])
        if case[0] == "solver":
            return solvers[k].solver(*solver_in[label])
        return torch.add(x, 1.0)

    for ad in (False, True):
        args = staged[ad]
        ref = bench_copy.copy_probe_plain(*args[:5], *args[7:9], ad)
        for label, case in cases.items():
            if case[:2] == ("copy", ad):
                for k in range(len(dirs)):
                    _exact(run(k, label), ref, f"{dirs[k]} {label}")
        del ref
    for label, case in cases.items():
        if case[0] in ("add1", "solver"):
            ref = (perf_lab_dma.add1_plain(x, case[1]) if case[0] == "add1"
                   else m.solver_plain(*solver_in[label]))
            for k in range(len(dirs)):
                _exact(run(k, label), ref, f"{dirs[k]} {label}")
            del ref
    for d, lib in zip(dirs, libs):
        for pattern in ("copy_kernel", "add1_kernel", "solver_kernel"):
            for line in ptxas_lines(lib, pattern):
                log(f"{d}:   ptxas: {line}")
    res = ab_rounds(dirs, libs, cases, run, rounds, reps, warm_s)
    med = {label: [q[1] for q in c["quartiles_ms"]]
           for label, c in res["cases"].items()}
    add1_1 = "P2 ty={} nbuf={} threads={}".format(*PROBE_AB_ADD1[0])
    res["summary"] = {}
    for k, d in enumerate(dirs):
        best = {}
        for ad in (False, True):
            route = "all_defined" if ad else "masked"
            cap = min(bench_copy.CAPS, key=lambda c: med[
                f"P1 {route} cap {c}"][k])
            best[route] = {"cap": cap, "ms": med[f"P1 {route} cap {cap}"][k]}
        best["p2_over_torch_add"] = (med[add1_1][k]
                                     / med["torch.add(x, 1)"][k])
        res["summary"][d] = best
        for label in solver_in:
            ratios = [mine / ref for ref, mine in zip(
                *(res["cases"][label]["round_medians_ms"][j]
                  for j in (0, k)))]
            best[label] = {"ms": med[label][k], "round_over_first": ratios}
        log(f"{d}: P1 masked {best['masked']['ms']:.4f} ms at cap "
            f"{best['masked']['cap']}, all-defined "
            f"{best['all_defined']['ms']:.4f} ms at cap "
            f"{best['all_defined']['cap']}; P2 {PROBE_AB_ADD1[0]} / torch.add "
            f"{best['p2_over_torch_add']:.3f}; " + ", ".join(
                f"{label} {best[label]['ms']:.4f} ms (over {dirs[0]} per "
                f"round {min(best[label]['round_over_first']):.3f}-"
                f"{max(best[label]['round_over_first']):.3f})"
                for label in solver_in))
    log("probes-ab " + json.dumps(res))
    return 0


if __name__ == "__main__":
    for family in TIME_CASES:
        if sys.argv[1:2] == [f"--{family}-times"]:
            sys.exit(time_checkouts(family, sys.argv[2:]))
    if sys.argv[1:2] == ["--interp-ab"]:
        sys.exit(interp_ab(sys.argv[2:]))
    if sys.argv[1:2] == ["--probes-ab"]:
        sys.exit(probes_ab(sys.argv[2:]))
    sys.exit(main())
