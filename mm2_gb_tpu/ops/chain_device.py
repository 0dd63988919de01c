"""Device chain scoring: mm2-gb's GPU forward DP as one Pallas kernel.

Device analog of the reference's GPU chaining stage (gpu/plrange.cu +
gpu/plscore.cu):

- **Range selection** (plrange.cu:38-76 analog): per-anchor successor
  count, computed on the host as one vectorized binary search over the
  (group, position) composite key.
- **Segment cutting** (plrange.cu:70-74 analog): the anchor stream is
  severed wherever range == 0; no valid pair crosses such a cut, so
  segments are independent DP problems.  Unlike the reference (which
  probes cuts only at 512-anchor boundaries), we cut at every zero-range
  anchor.
- **Forward score kernel** (plscore.cu:109-187 analog): anchor i relaxes
  successors i+1..i+range[i]:  f[j] = max(f[j], f[i] + sc(j, i)).  One
  program (a Pallas/Triton block) walks one segment's anchors in order;
  for each anchor its lanes relax the successor window in BLOCK-wide
  chunks (as many as range[i] needs), and a block barrier separates
  anchors — plscore.cu's one-block-per-segment loop with
  __syncthreads.  Programs launch longest segment first, the analog of
  the reference's long-segment work queue (plscore.cu:420-451).  The
  anchors stay in batch order, so the kernel reads and writes the flat
  (x, y, range, f, p) arrays in place.
- Tie-breaking reproduces the CPU scan order: anchors relax in ascending
  order on `sc >= f[j]` but never when sc equals the successor's init
  value (the reference GPU uses the same trick with its fixed MM_QSPAN,
  plscore.cu:140).  Like the reference GPU path, the device kernel
  assumes a uniform minimizer span (non-HPC presets; plscore.cuh:11); HPC
  batches chain on the host.

Scores use float32 penalty math identical to the host oracle (comput_sc,
lchain.c:113-138), including the bit-exact mg_log2 approximation, so the
device output backtracks to byte-identical PAF.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# successor lanes relaxed per inner step; a wider range takes several
# steps, so BLOCK bounds nothing but the work wasted on short ranges
BLOCK = 256
NUM_WARPS = 4


class NoDeviceError(RuntimeError):
    """--gpu-chain was asked for, but JAX found no GPU."""


def use_interpret() -> bool:
    """Compiled kernels on a GPU; the Pallas interpreter only when the
    process was put on the CPU explicitly (JAX_PLATFORMS=cpu).  Any other
    backend is an error, never a silent fallback."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu" and jax.config.jax_platforms == "cpu":
        return True
    raise NoDeviceError(
        f"--gpu-chain needs an NVIDIA GPU, but JAX found only '{backend}'; "
        "set JAX_PLATFORMS=cpu to run the chain kernel in interpret mode")


# --------------------------------------------------------------------------
# range selection + segment cutting (host, vectorized)
# --------------------------------------------------------------------------

def compute_ranges(ax: np.ndarray, read_bounds: np.ndarray,
                   max_dist_x: int, max_iter: int) -> np.ndarray:
    """Successor count per anchor (plrange analog).

    `ax` is the concatenated anchor x-column of a batch of reads, each
    read's slice sorted; `read_bounds` are start offsets per read (with a
    trailing total).  range[i] = #succ j>i in the same (read, strand, rid)
    group with rpos_j <= rpos_i + max_dist_x, capped at max_iter.
    """
    n = ax.shape[0]
    if n == 0:
        return np.empty(0, np.int32)
    from mm2_gb_tpu.utils import native
    if native.available():
        return native.compute_ranges(ax, read_bounds, max_dist_x, max_iter)
    hi = (ax >> np.uint64(32)).astype(np.int64)       # rev|rid
    grp_change = np.zeros(n, dtype=bool)
    grp_change[0] = True
    grp_change[1:] = hi[1:] != hi[:-1]
    starts = read_bounds[:-1]
    grp_change[starts[starts < n]] = True  # anchor-less reads share bounds
    g = np.cumsum(grp_change).astype(np.int64)
    rpos = (ax & np.uint64(0xFFFFFFFF)).astype(np.int64)
    comp = (g << 33) | rpos
    hi_idx = np.searchsorted(comp, (g << 33) | (rpos + max_dist_x),
                             side="right")
    rng = hi_idx - np.arange(n, dtype=np.int64) - 1
    return np.minimum(rng, max_iter).astype(np.int32)


def cut_segments(rng: np.ndarray) -> np.ndarray:
    """Segment start offsets (with trailing total).

    A cut after every anchor with range == 0 is provably safe: positions
    are sorted, so if the next anchor is out of the gap window for i it is
    out of the window for every j < i as well.
    """
    n = rng.shape[0]
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    ends = np.nonzero(rng == 0)[0] + 1
    return np.concatenate(([0], ends)).astype(np.int64)


def plan_programs(bounds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One program per segment of two or more anchors (a lone anchor has
    no successor to relax), as [lo, hi) anchor ranges sorted longest
    first: the GPU's block scheduler then starts the longest sequential
    walks first (longest-processing-time-first, the reference's
    long-segment queue, plscore.cu:420-451)."""
    lo, hi = bounds[:-1], bounds[1:]
    keep = hi - lo >= 2
    lo, hi = lo[keep], hi[keep]
    order = np.argsort(lo - hi, kind="stable")
    return lo[order].astype(np.int32), hi[order].astype(np.int32)


# --------------------------------------------------------------------------
# score function
# --------------------------------------------------------------------------

def _nofma(x: jnp.ndarray) -> jnp.ndarray:
    """Pin an intermediate float32 rounding.

    XLA and LLVM contract f32 mul+add into a single-rounding fma (the CPU
    backend even through lax.optimization_barrier); the host oracle (and
    the C reference it byte-matches) rounds the product first.  Routing
    the product through a maximum with -FLT_MAX is value-neutral for
    every finite input but cannot be folded away (x could be -inf for all
    the compiler knows), so the add's operand is no longer a multiply and
    fmuladd formation is blocked on every backend.

    FINITE-RANGE ASSUMPTION: a true -inf product would be clamped to
    -FLT_MAX here and diverge from the oracle's -inf.  Not reachable with
    the bounded operands we feed it — dd/dg < 2*max_dist <= 2^31 and
    |cg|,|cs| <= 255*0.99 (mm_mapopt_update caps chn_pen_gap/skip at
    0.99*avg_qspan, avg_qspan <= 255), so |product| < 2^40 << FLT_MAX —
    but any NEW caller must keep its operands finite-bounded.
    """
    return jnp.maximum(x, jnp.float32(-3.4028235e38))


def _mg_log2_f32(x: jnp.ndarray) -> jnp.ndarray:
    """Bit-exact mg_log2 (mmpriv.h:118-126) on float32 tensors."""
    zi = jax.lax.bitcast_convert_type(x, jnp.uint32)
    e = ((zi >> jnp.uint32(23)) & jnp.uint32(255)).astype(jnp.int32) - 128
    zi = (zi & jnp.uint32(0x807FFFFF)) + jnp.uint32(127 << 23)
    zf = jax.lax.bitcast_convert_type(zi, jnp.float32)
    c1 = jnp.float32(-0.34484843)
    c2 = jnp.float32(2.02466578)
    c3 = jnp.float32(-0.67487759)
    r = _nofma(c1 * zf) + c2
    r = _nofma(r * zf)
    r = r + c3
    return e.astype(jnp.float32) + r


def _pair_score(xs, ys, ss, xp, yp, sp, fp,
                max_dist_x, max_dist_y, bw, cg, cs, is_cdna=False):
    """Score of predecessor (xp, yp, span sp, score fp) against successors
    (xs, ys, span ss).  Returns (total, valid) int32/bool tensors.

    Single-segment-read form of comput_sc (lchain.c:113-138) — the same
    scope the reference GPU kernels support (plscore.cu:74-104).
    is_cdna (splice chaining): a deletion-side gap (dr > dq, a candidate
    intron) pays min(lin_pen, log_pen) instead of lin + 0.5*log
    (lchain.c:128-133; GPU majorAdjustment plscore.cu:97-101).
    """
    dq = ys - yp
    dr = xs - xp
    dd = jnp.abs(dr - dq)
    valid = (dq > 0) & (dq <= max_dist_x) & (dr != 0) & (dd <= bw)
    if max_dist_y != max_dist_x:   # statics: folds away when equal
        valid &= dq <= max_dist_y
    dg = jnp.minimum(dr, dq)
    sc = jnp.minimum(sp, dg)
    lin = (_nofma(cg * dd.astype(jnp.float32))
           + _nofma(cs * dg.astype(jnp.float32)))
    log_pen = jnp.where(dd >= 1, _mg_log2_f32((dd + 1).astype(jnp.float32)),
                        jnp.float32(0.0))
    pen = (lin + _nofma(jnp.float32(0.5) * log_pen)).astype(jnp.int32)
    if is_cdna:
        pen_min = jnp.minimum(lin, log_pen).astype(jnp.int32)
        pen = jnp.where(dr > dq, pen_min, pen)
    sc = jnp.where((dd != 0) | (dg > sp), sc - pen, sc)
    return sc + fp, valid


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

def _chain_kernel(lo_ref, hi_ref, x_ref, y_ref, r_ref, f_in, p_in,
                  f_ref, p_ref, *, span, max_dist_x, max_dist_y, bw, cg,
                  cs, is_cdna, interpret):
    """One program: anchors lo..hi-1 in order, each relaxing its window.

    Anchor i+1 reads the f[i+1] that anchor i's lanes may just have
    stored, so a block barrier separates anchors (the interpreter runs
    lanes in lock step and needs none)."""
    del f_in, p_in  # aliased outputs arrive pre-initialized to (span, -1)
    cg = jnp.float32(cg)
    cs = jnp.float32(cs)
    span_i = jnp.int32(span)
    pid = pl.program_id(0)
    lanes = jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)

    def anchor(i, carry):
        xi = x_ref[i]
        yi = y_ref[i]
        ri = r_ref[i]
        fi = f_ref[i]

        def chunk(c, carry):
            j0 = i + 1 + c * BLOCK
            m = lanes < ri - c * BLOCK
            win = pl.ds(j0, BLOCK)
            xj = plgpu.load(x_ref.at[win], mask=m, other=0)
            yj = plgpu.load(y_ref.at[win], mask=m, other=0)
            fj = plgpu.load(f_ref.at[win], mask=m, other=0)
            tot, valid = _pair_score(xj, yj, span_i, xi, yi, span_i, fi,
                                     max_dist_x, max_dist_y, bw, cg, cs,
                                     is_cdna)
            ok = m & valid & (tot != span_i) & (tot >= fj)
            plgpu.store(f_ref.at[win], tot, mask=ok)
            plgpu.store(p_ref.at[win], jnp.full((BLOCK,), i, jnp.int32),
                        mask=ok)
            return carry

        jax.lax.fori_loop(0, (ri + BLOCK - 1) // BLOCK, chunk, None)
        if not interpret:
            plgpu.debug_barrier()
        return carry

    jax.lax.fori_loop(lo_ref[pid], hi_ref[pid], anchor, None)


@functools.partial(jax.jit, static_argnames=(
    "span", "max_dist_x", "max_dist_y", "bw", "cg", "cs", "is_cdna",
    "interpret"))
def chain_kernel(prog, ops, *, span, max_dist_x, max_dist_y, bw, cg, cs,
                 is_cdna=False, interpret=False):
    """Forward DP over the flat batch arrays.

    `prog` is [2, P] int32: program k walks anchors prog[0, k] ..
    prog[1, k] - 1.  `ops` is [3, N] int32 rows x, y, range, padded with
    at least BLOCK trailing entries so every window slice stays in
    bounds.  Returns (f, p): the chain score and the predecessor's batch
    index (-1 for none)."""
    x = ops[0]
    kern = functools.partial(
        _chain_kernel, span=span, max_dist_x=max_dist_x,
        max_dist_y=max_dist_y, bw=bw, cg=float(cg), cs=float(cs),
        is_cdna=is_cdna, interpret=interpret)
    f0 = jnp.full(x.shape, span, jnp.int32)
    p0 = jnp.full(x.shape, -1, jnp.int32)
    out = jax.ShapeDtypeStruct(x.shape, jnp.int32)
    return pl.pallas_call(
        kern, out_shape=(out, out), grid=(prog.shape[1],),
        input_output_aliases={5: 0, 6: 1},
        backend="triton", name="chain_dp",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
    )(prog[0], prog[1], x, ops[1], ops[2], f0, p0)


# --------------------------------------------------------------------------
# host packing + dispatch
# --------------------------------------------------------------------------

def _quant_size(n: int, floor: int = 2048) -> int:
    """Quantize a compiled operand length to quarter-power-of-two steps
    ({2^k, 1.25*2^k, 1.5*2^k, 1.75*2^k}), min `floor`, so batches of
    varying size reuse at most 4 compiled executables per octave while
    wasting at most 25% of the transfer as padding."""
    if n <= floor:
        return floor
    k = (n - 1).bit_length() - 3        # step = quarter of the octave base
    return -(-n // (1 << k)) * (1 << k)


# The Pallas interpreter copies a whole operand on every load and store,
# so interpret mode walks a batch in parts of about this many anchors
# (whole segments each); compiled kernels take the batch in one launch.
INTERPRET_PART = 4096


def _parts(bounds: np.ndarray, limit: int | None) -> list[tuple[int, int]]:
    """Contiguous [s, e) anchor ranges of whole segments, each ending at
    the first segment boundary past a multiple of `limit` (one range
    when limit is None)."""
    n = int(bounds[-1])
    if limit is None:
        return [(0, n)]
    starts = bounds[:-1]
    key = starts // limit
    cut = starts[np.append(True, key[1:] != key[:-1])]
    return list(zip(cut.tolist(), np.append(cut[1:], n).tolist()))


class PendingScores:
    """In-flight device chain scores for one macro-batch.

    dispatch_scores() launches the kernel without blocking (JAX async
    dispatch); collect() fetches the results — the host backtracks and
    aligns the *previous* batch between the two, the analog of the
    reference's drain-previous-while-next-runs stream design
    (plchain.cu:292-306).
    """

    def __init__(self, n: int):
        self.f = np.zeros(n, dtype=np.int32)
        self.p = np.full(n, -1, dtype=np.int64)
        self.parts: list = []   # (s, e, device (f, p)) while in flight

    def collect(self) -> tuple[np.ndarray, np.ndarray]:
        """Block on the device results (f, p over the batch)."""
        for s, e, dev in self.parts:
            fd, pd = jax.device_get(dev)
            self.f[s:e] = fd[:e - s]
            pd = pd[:e - s].astype(np.int64)
            self.p[s:e] = np.where(pd >= 0, pd + s, -1)
        self.parts = []
        return self.f, self.p


def dispatch_scores(ax: np.ndarray, ay: np.ndarray,
                    read_bounds: np.ndarray, max_dist_x: int,
                    max_dist_y: int, bw: int, max_iter: int,
                    cg: float, cs: float, metrics=None,
                    device=None, is_cdna: bool = False) -> PendingScores:
    """Plan and asynchronously launch chain scoring for a whole batch.

    Host-side work (range selection, cutting, program planning) happens
    here; the kernel is dispatched without blocking.  Non-uniform-span
    (HPC) input computes on the host immediately, mirroring the reference
    GPU path's fixed-span restriction (plscore.cuh:11).

    `device` pins the launch to a specific jax.Device — the data-parallel
    multi-GPU path dispatches one shard per card this way (computation
    follows committed operands; zero collectives).
    """
    import time

    from mm2_gb_tpu.ops.chain import _chain_dp_scores

    n = ax.shape[0]
    pend = PendingScores(n)
    if n == 0:
        return pend
    if max_dist_x < bw:
        max_dist_x = bw
    if max_dist_y < bw:
        max_dist_y = bw

    t0 = time.perf_counter()
    rng = compute_ranges(ax, read_bounds, max_dist_x, max_iter)
    bounds = cut_segments(rng)
    if metrics is not None:
        metrics.t_range += time.perf_counter() - t0
        metrics.n_segs += int(bounds.shape[0] - 1)
        metrics.n_pairs += int(rng.sum(dtype=np.int64))

    span32 = ((ay >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    span = int(span32[0])
    if not np.all(span32 == span):
        if metrics is not None:
            metrics.n_host_segs += int(bounds.shape[0] - 1)
        pend.f, pend.p = _chain_dp_scores(
            ax, ay, max_dist_x, max_dist_y, bw, 2**31 - 1, max_iter,
            np.float32(cg), np.float32(cs), is_cdna, 1)
        return pend

    interpret = use_interpret()
    x32 = (ax & np.uint64(0xFFFFFFFF)).astype(np.int32)
    y32 = (ay & np.uint64(0xFFFFFFFF)).astype(np.int32)
    for s, e in _parts(bounds, INTERPRET_PART if interpret else None):
        t0 = time.perf_counter()
        sub = bounds[(bounds >= s) & (bounds <= e)] - s
        lo, hi = plan_programs(sub)
        m = e - s
        ops = np.zeros((3, _quant_size(m + BLOCK)), np.int32)
        ops[0, :m] = x32[s:e]
        ops[1, :m] = y32[s:e]
        ops[2, :m] = rng[s:e]
        prog = np.zeros((2, _quant_size(lo.shape[0], floor=64)), np.int32)
        prog[0, :lo.shape[0]] = lo    # pad programs are empty runs
        prog[1, :hi.shape[0]] = hi
        if metrics is not None:
            metrics.t_pack += time.perf_counter() - t0
            metrics.n_dispatch += 1
        t0 = time.perf_counter()
        ops, prog = jax.device_put((ops, prog), device)
        pend.parts.append((s, e, chain_kernel(
            prog, ops, span=span, max_dist_x=max_dist_x,
            max_dist_y=max_dist_y, bw=bw, cg=cg, cs=cs, is_cdna=is_cdna,
            interpret=interpret)))
        if metrics is not None:
            metrics.t_dispatch += time.perf_counter() - t0
    return pend


def chain_scores_device(ax: np.ndarray, ay: np.ndarray,
                        read_bounds: np.ndarray, max_dist_x: int,
                        max_dist_y: int, bw: int, max_iter: int,
                        cg: float, cs: float, is_cdna: bool = False
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Synchronous dispatch + collect (see dispatch_scores)."""
    return dispatch_scores(ax, ay, read_bounds, max_dist_x, max_dist_y,
                           bw, max_iter, cg, cs, is_cdna=is_cdna).collect()
