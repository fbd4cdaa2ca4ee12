"""Row-sharded CompositeV2: z-slab level regions + surface-run exchange.

Multi-chip form of the north-star operator (ops/composite2.py).  The
reference has no distributed code (SURVEY.md §2.2); the design target is the
writeup's own edge-fraction analysis (/root/reference/Writeup/notes.tex:332:
7-14% of points sit on box surfaces), which says the only data that must
cross chips per SpMV is surface-proportional.  Decomposition:

* BULK (per-level interior stencils, ~93% of rows): each level's region is
  cut into z-slabs, one per device; the SpMV is the same ppermute-halo
  code as the sharded StencilOperator (parallel/distributed.py:
  _stencil_local_matvec — ring halo planes + local taps).  Traffic: 2
  boundary planes per level per step.

* INTERFACE (strided signature classes + block-ELL tail, the box-surface
  rows): every tap of every class reads a slab that is THIN along at least
  one axis (a face/edge/corner of the box structure).  At build time the
  planner (_plan_support) covers all tap slices and ELL columns with a small
  static set of axis-aligned SURFACE RUNS per level — full extent in two
  axes, a few units wide in the third.  Per matvec each device exchanges
  exactly these runs (all_gather for x/y-thin runs, a masked psum for
  z-runs), reconstructs a support-correct full region locally, and applies
  the single-device interface code verbatim (ops.composite2.
  interface_apply_full — literally the same function), keeping its own
  z-portion of the result.  Exchanged bytes per device = run volume =
  O(surface), not O(P·D) as v1's face-table all-gathers.

Interface COMPUTE is replicated across devices: the class applications are
face-sized slices whose cost is per operation rather than per byte, so
sharding them would save little while requiring per-tap point-to-point
schedules.

Layout: device-major.  Device d owns, for every level, z-planes
[d*nz_l/D, (d+1)*nz_l/D) of the level's region; its local vector is the
concatenation of those slabs (level order, raster within).  ``idx_map``
maps level-major region slots (the single-device CompositeV2 layout) to
sharded slots; requires nz_l % D == 0 for every level.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.composite import IFC_W
from ..ops.composite2 import CompositeV2, interface_apply_full
from ..ops.operators import LinearOperator
from .distributed import _stencil_local_matvec
from .mesh import ROWS

__all__ = ["ShardedCompositeV2", "shard_composite_v2"]


def _merge_intervals(iv, ext, gap=2):
    """Merge [lo, hi) intervals, closing gaps <= ``gap`` (fewer, slightly
    wider runs beat many narrow ones: each run is one collective)."""
    iv = sorted((max(0, lo), min(ext, hi)) for lo, hi in iv if hi > lo)
    out = []
    for lo, hi in iv:
        if out and lo <= out[-1][1] + gap:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _plan_support(comp: CompositeV2, degenerate_frac: float = 0.6):
    """Static per-level surface runs covering every interface read.

    Returns (runs, stats): ``runs[l]`` is a tuple of (axis, lo, hi) — full
    extent along the other two axes — such that every grid-class tap slice
    and every ELL-tail column of level ``l`` lies inside at least one run.
    A level whose run volume would exceed 60% of its region degenerates to
    one full z-run (plain all-gather) — correct, just not surface-thin.
    """
    level_meta = comp.level_meta
    nlev = len(level_meta)
    m = int(comp.diag.shape[0])
    iv = [[[] for _ in range(3)] for _ in range(nlev)]

    # Grid-class taps: cover along the tap's thinnest axis (ties prefer
    # x, then y — all_gather runs — over z, which needs the psum path).
    for (row_level, out_start, interior, acc_shape, taps) in comp.grid_meta:
        for (ls, start, limit, stride) in taps:
            extents = [limit[ax] - start[ax] for ax in range(3)]
            best = min(extents)
            for cand in (2, 1, 0):
                if extents[cand] == best:
                    ax = cand
                    break
            iv[ls][ax].append((start[ax], limit[ax]))

    # ELL-tail columns: every slot of every referenced block must be
    # covered.  Cover the stragglers along the axis with the fewest
    # distinct uncovered coordinate values.
    starts = np.array([st for (a, ext, st) in level_meta] + [m])
    exts = [ext for (a, ext, st) in level_meta]
    blocks = [np.asarray(b[1]).ravel() for b in comp.ifc_buckets]
    if blocks:
        blk = np.unique(np.concatenate(blocks))
        slots = (blk[:, None] * IFC_W + np.arange(IFC_W)).ravel()
        slots = slots[slots < m]
        li_of = np.searchsorted(starts, slots, side="right") - 1
        for li in range(nlev):
            pts = slots[li_of == li] - level_meta[li][2]
            if not len(pts):
                continue
            ext = exts[li]
            plane = ext[1] * ext[2]
            c = np.stack([pts // plane, (pts % plane) // ext[2],
                          pts % ext[2]])  # (3, n) coords z, y, x
            cov = np.zeros(len(pts), dtype=bool)
            for ax in range(3):
                for lo, hi in iv[li][ax]:
                    cov |= (c[ax] >= lo) & (c[ax] < hi)
            if (~cov).any():
                un = ~cov
                counts = [len(np.unique(c[ax][un])) for ax in range(3)]
                best = min(counts)
                for cand in (2, 1, 0):
                    if counts[cand] == best:
                        ax = cand
                        break
                for v in np.unique(c[ax][un]):
                    iv[li][ax].append((int(v), int(v) + 1))

    runs = []
    stats = {"run_volume": 0, "total_volume": 0}
    for li in range(nlev):
        ext = exts[li]
        vol = int(np.prod(ext))
        lv_runs = []
        rv = 0
        for ax in range(3):
            for lo, hi in _merge_intervals(iv[li][ax], ext[ax]):
                lv_runs.append((ax, lo, hi))
                rv += (hi - lo) * vol // ext[ax]
        if rv > degenerate_frac * vol:
            lv_runs = [(0, 0, ext[0])]  # degenerate: full-level all-gather
            rv = vol
        runs.append(tuple(lv_runs))
        stats["run_volume"] += rv
        stats["total_volume"] += vol
    return tuple(runs), stats


@dataclasses.dataclass(frozen=True)
class ShardedCompositeV2Host:
    """Host-side maps for the sharded layout (not a pytree leaf)."""

    num_devices: int
    P_loc: int
    idx_map: np.ndarray  # level-major region slot -> sharded slot
    live_levelmajor: np.ndarray

    def to_sharded(self, x_levelmajor: np.ndarray) -> np.ndarray:
        out = np.zeros(self.num_devices * self.P_loc, np.asarray(x_levelmajor).dtype)
        out[self.idx_map] = x_levelmajor
        return out

    def from_sharded(self, x_sharded: np.ndarray) -> np.ndarray:
        return np.asarray(x_sharded)[self.idx_map]

    def live_mask(self) -> np.ndarray:
        """1.0 on slots holding a lattice point, 0.0 on dead region slots
        (mask start vectors with this — dead lambda=0 modes must never
        enter the Krylov basis)."""
        out = np.zeros(self.num_devices * self.P_loc, dtype=np.float64)
        out[self.idx_map] = self.live_levelmajor
        return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedCompositeV2(LinearOperator):
    """LinearOperator facade: matvec on global device-major vectors, SPMD
    body via shard_map (nests inside jit, so eigsh_restarted / lanczos run
    unchanged — their dense algebra partitions under GSPMD once V/u carry
    the row sharding, exactly like ops.composite.ShardedCompositeOperator).
    """

    diag: jax.Array  # (D*P_loc,)
    keep: jax.Array
    level_weights: Tuple[jax.Array, ...]  # replicated stencil weights
    grid_w: Tuple[jax.Array, ...]
    ifc_buckets: Tuple[Tuple[jax.Array, jax.Array, jax.Array], ...]
    # static geometry
    level_meta: Tuple = dataclasses.field(metadata=dict(static=True))
    # (a, ext (3), st_levelmajor, sl_local, nz_loc) per level
    grid_meta: Tuple = dataclasses.field(metadata=dict(static=True))
    support_runs: Tuple = dataclasses.field(metadata=dict(static=True))
    level_ops_static: Tuple = dataclasses.field(metadata=dict(static=True))
    # per level: (offsets, graded) for the local stencil closure
    mesh: jax.sharding.Mesh = dataclasses.field(metadata=dict(static=True))
    axis_name: str = dataclasses.field(metadata=dict(static=True))
    symmetric: bool = dataclasses.field(default=False, metadata=dict(static=True))

    @property
    def shape(self):
        p = self.diag.shape[0]
        return (p, p)

    @property
    def dtype(self):
        return self.diag.dtype

    def exchange_elements(self) -> dict:
        """Per-device exchanged element counts per matvec (the
        surface-proportionality contract, tested in test_distributed.py):
        halo planes for the bulk stencils + the support runs."""
        halo = sum(2 * ext[1] * ext[2] for (a, ext, st, sl, nzl) in self.level_meta)
        runs = 0
        for (a, ext, st, sl, nzl), lv_runs in zip(self.level_meta, self.support_runs):
            vol = ext[0] * ext[1] * ext[2]
            for ax, lo, hi in lv_runs:
                runs += (hi - lo) * vol // ext[ax]
        return {"halo": halo, "support_runs": runs,
                "total": halo + runs,
                "operator_dim": int(self.diag.shape[0])}

    def _body(self):
        level_meta = self.level_meta
        grid_meta = self.grid_meta
        support_runs = self.support_runs
        axis_name = self.axis_name
        num_devices = self.mesh.shape[axis_name]
        ifc_level_meta = tuple(
            (a, ext, st) for (a, ext, st, sl, nzl) in level_meta
        )

        # Per-level local stencil closures (ppermute halo + local taps) —
        # rebuilt per trace from static geometry; the weights arrays flow
        # through shard_map inputs.
        from ..ops.operators import StencilOperator

        local_mvs = []
        for (a, ext, st, sl, nzl), w, (offsets, graded) in zip(
            level_meta, self.level_weights, self.level_ops_static
        ):
            op_l = StencilOperator(
                weights=w, diag=None, grid_shape=ext, offsets=offsets,
                graded=graded,
            )
            local_mvs.append(
                _stencil_local_matvec(op_l, num_devices, axis_name)
            )

        def body(diag_l, keep_l, weights, grid_w, buckets, x_local):
            my = jax.lax.axis_index(axis_name)
            x3loc = []
            y_parts = []
            for li, (a, ext, st, sl, nzl) in enumerate(level_meta):
                nloc = nzl * ext[1] * ext[2]
                xl = jax.lax.slice(x_local, (sl,), (sl + nloc,))
                kl = jax.lax.slice(keep_l, (sl,), (sl + nloc,))
                x3loc.append(xl.reshape(nzl, ext[1], ext[2]))
                y_parts.append(local_mvs[li](weights[li], None, xl) * kl)

            # Reconstruct support-correct full regions from surface runs.
            xs3 = []
            for li, (a, ext, st, sl, nzl) in enumerate(level_meta):
                runs = support_runs[li]
                xg = x3loc[li]
                if len(runs) == 1 and runs[0] == (0, 0, ext[0]):
                    xs3.append(
                        jax.lax.all_gather(xg, axis_name, tiled=True)
                    )
                    continue
                buf = jnp.zeros(ext, x_local.dtype)
                my_z0 = my * nzl
                for ax, lo, hi in runs:
                    if ax == 0:
                        # z-run: planes owned by varying devices; build the
                        # run with clamped dynamic plane reads masked to the
                        # owner, then one psum (SPMD-uniform).
                        planes = []
                        for zi in range(lo, hi):
                            lz = zi - my_z0
                            inb = (lz >= 0) & (lz < nzl)
                            pl = jax.lax.dynamic_slice_in_dim(
                                xg, jnp.clip(lz, 0, nzl - 1), 1, axis=0
                            )[0]
                            planes.append(
                                jnp.where(inb, pl, jnp.zeros_like(pl))
                            )
                        run = jax.lax.psum(jnp.stack(planes), axis_name)
                        buf = buf.at[lo:hi].set(run)
                    elif ax == 1:
                        run = jax.lax.all_gather(
                            xg[:, lo:hi, :], axis_name, tiled=True
                        )
                        buf = buf.at[:, lo:hi, :].set(run)
                    else:
                        run = jax.lax.all_gather(
                            xg[:, :, lo:hi], axis_name, tiled=True
                        )
                        buf = buf.at[:, :, lo:hi].set(run)
                xs3.append(buf)

            # Single-device interface code on the reconstructed support
            # (replicated face-sized compute), then keep my z-portion.
            xs_flat = jnp.concatenate([v.reshape(-1) for v in xs3])
            yifc = interface_apply_full(
                xs3, xs_flat, grid_meta, grid_w, ifc_level_meta, buckets
            )
            for li, (a, ext, st, sl, nzl) in enumerate(level_meta):
                vol = ext[0] * ext[1] * ext[2]
                yl3 = jax.lax.slice(yifc, (st,), (st + vol,)).reshape(ext)
                mine = jax.lax.dynamic_slice_in_dim(
                    yl3, my * nzl, nzl, axis=0
                )
                y_parts[li] = y_parts[li] + mine.reshape(-1)
            return jnp.concatenate(y_parts) + diag_l * x_local

        return body

    def matvec(self, x):
        from jax.sharding import PartitionSpec as P

        row = P(self.axis_name)
        rep = P()
        body = self._body()
        mapped = jax.shard_map(
            body,
            mesh=self.mesh,
            in_specs=(
                row, row,
                tuple(rep for _ in self.level_weights),
                tuple(rep for _ in self.grid_w),
                tuple((rep, rep, rep) for _ in self.ifc_buckets),
                row,
            ),
            out_specs=row,
            check_vma=False,
        )
        return mapped(
            self.diag, self.keep, tuple(self.level_weights),
            tuple(self.grid_w), tuple(self.ifc_buckets), x,
        )

    def rmatvec(self, x):
        if self.symmetric:
            return self.matvec(x)
        raise NotImplementedError(
            "sharded CompositeV2 rmatvec requires symmetric=True"
        )

    def matmat(self, X):
        cols = [self.matvec(X[:, i]) for i in range(X.shape[1])]
        return jnp.stack(cols, axis=1)


def shard_composite_v2(
    comp: CompositeV2,
    mesh: jax.sharding.Mesh,
    axis_name: str = ROWS,
    degenerate_frac: float = 0.6,
) -> ShardedCompositeV2:
    """Re-partition a CompositeV2 for a D-device row mesh.

    Every level's region z-extent must divide by D (choose n_fine so that
    n_fine/box_depth and the coarse extents do — e.g. multiples of
    8*box_depth*max_spacing).  The returned operator acts on device-major
    vectors; translate layouts through ``.host`` (to_sharded/from_sharded/
    live_mask).  Numerically identical to ``comp`` (tests pin matvec and
    the restarted solve).
    """
    D = int(mesh.shape[axis_name])
    m = int(comp.diag.shape[0])
    level_meta = []
    sl = 0
    for (a, ext, st) in comp.level_meta:
        if ext[0] % D:
            raise ValueError(
                f"level a={a} z-extent {ext[0]} does not divide across "
                f"{D} devices (choose n_fine a multiple of "
                f"{D}*box_depth*max_spacing)"
            )
        nzl = ext[0] // D
        level_meta.append((a, ext, st, sl, nzl))
        sl += nzl * ext[1] * ext[2]
    P_loc = sl
    assert P_loc * D == m

    idx_map = np.empty(m, dtype=np.int64)
    for (a, ext, st, sl, nzl) in level_meta:
        vol = int(np.prod(ext))
        plane = ext[1] * ext[2]
        i = np.arange(vol, dtype=np.int64)
        z = i // plane
        d = z // nzl
        idx_map[st + i] = d * P_loc + sl + (z - d * nzl) * plane + i % plane

    dt = np.asarray(comp.diag).dtype
    diag_s = np.zeros(D * P_loc, dtype=dt)
    diag_s[idx_map] = np.asarray(comp.diag)
    keep_s = np.zeros(D * P_loc, dtype=dt)
    keep_s[idx_map] = np.asarray(comp.keep)

    support_runs, stats = _plan_support(comp, degenerate_frac)

    op = ShardedCompositeV2(
        diag=jnp.asarray(diag_s),
        keep=jnp.asarray(keep_s),
        level_weights=tuple(op_l.weights for op_l in comp.level_ops),
        grid_w=tuple(comp.grid_w),
        ifc_buckets=tuple(comp.ifc_buckets),
        level_meta=tuple(level_meta),
        grid_meta=tuple(comp.grid_meta),
        support_runs=support_runs,
        level_ops_static=tuple(
            (op_l.offsets, op_l.graded) for op_l in comp.level_ops
        ),
        mesh=mesh,
        axis_name=axis_name,
        symmetric=comp.symmetric,
    )
    host = ShardedCompositeV2Host(
        num_devices=D,
        P_loc=P_loc,
        idx_map=idx_map,
        live_levelmajor=np.asarray(comp.live, dtype=np.float64),
    )
    object.__setattr__(op, "host", host)
    return op
